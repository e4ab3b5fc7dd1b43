"""Convolution primitives with Caffe shape/layout conventions.

Reference: src/caffe/layers/base_conv_layer.cpp and cudnn_conv_layer.cpp;
the JAX package calls `lax.conv_general_dilated` (caffe_mpi_tpu/ops/conv.py).
The port calls `F.conv2d`, which runs on cuDNN on the card: the JAX package
never had a hand-written convolution kernel, so the library op is the port
of XLA's stock lowering. Layouts follow Caffe — activations NCHW, weights
OIHW (out, in/group, kh, kw).

Output dim: floor((H + 2p - ((k-1)*dilation + 1)) / s) + 1 — conv uses floor
(conv_layer.cpp compute_output_shape), unlike pooling's ceil.
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
