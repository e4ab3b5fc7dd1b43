"""Convolution primitives with Caffe shape/layout conventions.

Reference: src/caffe/layers/base_conv_layer.cpp and cudnn_conv_layer.cpp;
the JAX package calls `lax.conv_general_dilated` (caffe_mpi_tpu/ops/conv.py).
The port calls `F.conv2d`, which runs on cuDNN on the card: the JAX package
never had a hand-written convolution kernel, so the library op is the port
of XLA's stock lowering. Layouts follow Caffe — activations NCHW, weights
OIHW (out, in/group, kh, kw).

Output dim: floor((H + 2p - ((k-1)*dilation + 1)) / s) + 1 — conv uses floor
(conv_layer.cpp compute_output_shape), unlike pooling's ceil.

Deconvolution is `F.conv_transpose2d`: Caffe's deconv weight (Cin,
Cout/group, kh, kw) is already its layout, and its output dim is
s*(H-1) + d*(k-1) + 1 - 2p (deconv_layer.cpp compute_output_shape).
Im2col is `F.unfold`, whose channel order (C, kh, kw) is Caffe's
(util/im2col.cpp). The JAX package runs both outside Pallas.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def conv_output_dim(size: int, kernel: int, pad: int, stride: int, dilation: int) -> int:
    kernel_ext = dilation * (kernel - 1) + 1
    return (size + 2 * pad - kernel_ext) // stride + 1


def conv2d(x: torch.Tensor, w: torch.Tensor, stride: tuple[int, int],
           pad: tuple[int, int], dilation: tuple[int, int] = (1, 1),
           groups: int = 1, bias: torch.Tensor | None = None) -> torch.Tensor:
    """x: (N, Cin, H, W); w: (Cout, Cin/groups, kh, kw) -> (N, Cout, oh, ow)."""
    return F.conv2d(x, w, bias, stride=tuple(stride), padding=tuple(pad),
                    dilation=tuple(dilation), groups=groups)


def deconv2d(x: torch.Tensor, w: torch.Tensor, stride: tuple[int, int],
             pad: tuple[int, int], dilation: tuple[int, int] = (1, 1),
             groups: int = 1, bias: torch.Tensor | None = None
             ) -> torch.Tensor:
    """x: (N, Cin, H, W); w: (Cin, Cout/groups, kh, kw) -> (N, Cout, oh,
    ow), the transpose of conv2d."""
    return F.conv_transpose2d(x, w, bias, stride=tuple(stride),
                              padding=tuple(pad), groups=groups,
                              dilation=tuple(dilation))


def im2col(x: torch.Tensor, kernel: tuple[int, int],
           stride: tuple[int, int], pad: tuple[int, int],
           dilation: tuple[int, int] = (1, 1)) -> torch.Tensor:
    """(N, C, H, W) -> (N, C*kh*kw, oh, ow) patches."""
    n, c, h, w = x.shape
    oh = conv_output_dim(h, kernel[0], pad[0], stride[0], dilation[0])
    ow = conv_output_dim(w, kernel[1], pad[1], stride[1], dilation[1])
    cols = F.unfold(x, tuple(kernel), dilation=tuple(dilation),
                    padding=tuple(pad), stride=tuple(stride))
    return cols.reshape(n, c * kernel[0] * kernel[1], oh, ow)
