"""Spatial layers: Convolution, Pooling, LRN.

Reference implementations: src/caffe/layers/{base_conv,conv,pooling,lrn}_
layer.{cpp,cu}; JAX package caffe_mpi_tpu/layers/vision.py. Each layer is
Caffe shape semantics + one op: `F.conv2d` for Convolution (the JAX package
leaves convolution to XLA, outside any Pallas kernel), Caffe's ceil-and-clip
pooling (ops/pool.py), and the across-channel LRN kernel (ops/lrn.py).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.conv import conv2d, conv_output_dim
from ..ops.lrn import lrn_across_channels
from ..ops.pool import avg_pool2d, max_pool2d, pool_output_dim
from ..proto.config import ConvolutionParameter, FillerParameter, LRNParameter
from .base import Layer, Shape, register


def _spatial_params(p: ConvolutionParameter) -> tuple[tuple, tuple, tuple, tuple]:
    """Resolve Caffe's repeated kernel_size/stride/pad + legacy _h/_w fields
    (base_conv_layer.cpp LayerSetUp)."""
    def resolve(rep: list[int], h: int, w: int, default: int) -> tuple[int, int]:
        if h or w:
            return (h, w)
        if not rep:
            return (default, default)
        if len(rep) == 1:
            return (rep[0], rep[0])
        return (rep[0], rep[1])

    kernel = resolve(p.kernel_size, p.kernel_h, p.kernel_w, 0)
    stride = resolve(p.stride, p.stride_h, p.stride_w, 1)
    pad = resolve(p.pad, p.pad_h, p.pad_w, 0)
    dil = tuple(p.dilation) * (2 // max(len(p.dilation), 1)) if p.dilation else (1, 1)
    if len(dil) == 1:
        dil = (dil[0], dil[0])
    if kernel[0] <= 0 or kernel[1] <= 0:
        raise ValueError("convolution kernel_size must be positive")
    return kernel, stride, pad, dil


@register("Convolution")
class ConvolutionLayer(Layer):
    def setup(self, in_shapes: list[Shape]) -> list[Shape]:
        p = self.lp.convolution_param or ConvolutionParameter()
        self.p = p
        self.kernel, self.stride, self.pad, self.dilation = _spatial_params(p)
        n, cin, h, w = in_shapes[0]
        if cin % p.group or p.num_output % p.group:
            raise ValueError(f"{self.name}: channels not divisible by group")
        self.declare("weight",
                     (p.num_output, cin // p.group, *self.kernel),
                     p.weight_filler)
        if p.bias_term:
            self.declare("bias", (p.num_output,),
                         p.bias_filler or FillerParameter(type="constant"))
        oh = conv_output_dim(h, self.kernel[0], self.pad[0], self.stride[0], self.dilation[0])
        ow = conv_output_dim(w, self.kernel[1], self.pad[1], self.stride[1], self.dilation[1])
        return [(n, p.num_output, oh, ow)]

    def forward(self, bottoms):
        x = self.f(bottoms[0])
        bias = self.f(self.bias) if self.p.bias_term else None
        with self.policy.math(x.device):
            y = conv2d(x, self.f(self.weight), self.stride, self.pad,
                       self.dilation, self.p.group, bias)
        return [y]


@register("Pooling")
class PoolingLayer(Layer):
    def setup(self, in_shapes: list[Shape]) -> list[Shape]:
        p = self.lp.pooling_param
        self.p = p
        n, c, h, w = in_shapes[0]
        if p.global_pooling:
            self.kernel = (h, w)
            self.stride = (1, 1)
            self.pad = (0, 0)
        else:
            kh = p.kernel_h or p.kernel_size
            kw = p.kernel_w or p.kernel_size
            if kh <= 0 or kw <= 0:
                raise ValueError(f"{self.name}: pooling kernel_size required")
            self.kernel = (kh, kw)
            self.stride = (p.stride_h or p.stride, p.stride_w or p.stride)
            self.pad = (p.pad_h or p.pad, p.pad_w or p.pad)
        any_pad = self.pad[0] > 0 or self.pad[1] > 0
        oh = pool_output_dim(h, self.kernel[0], self.pad[0], self.stride[0], any_pad)
        ow = pool_output_dim(w, self.kernel[1], self.pad[1], self.stride[1], any_pad)
        self.method = str(p.pool).upper()
        if self.method not in ("MAX", "AVE"):
            raise ValueError(f"{self.name}: {self.method} pooling is not "
                             "ported (MAX and AVE are)")
        return [(n, c, oh, ow)]

    def forward(self, bottoms):
        x = self.f(bottoms[0])
        if self.method == "AVE":
            return [avg_pool2d(x, self.kernel, self.stride, self.pad)]
        return [max_pool2d(x, self.kernel, self.stride, self.pad)]


@register("LRN")
class LRNLayer(Layer):
    """Local response normalization (lrn_layer.cpp):
    y = x * (k + (alpha/n) * sum_window(x^2))^(-beta).

    ACROSS_CHANNELS goes through `ops.lrn.lrn_across_channels` for every
    float dtype: the CUDA kernel on the card, its plain version on the CPU.
    WITHIN_CHANNEL stays plain torch (the JAX package never had a kernel
    for it)."""

    def setup(self, in_shapes: list[Shape]) -> list[Shape]:
        p = self.lp.lrn_param or LRNParameter()
        if p.local_size % 2 != 1:
            raise ValueError("LRN local_size must be odd")
        self.p = p
        self.region = str(p.norm_region).upper()
        return [in_shapes[0]]

    def forward(self, bottoms):
        x = self.f(bottoms[0])
        p = self.p
        if self.region != "WITHIN_CHANNEL":
            return [lrn_across_channels(x, p.local_size, p.alpha, p.beta, p.k)]
        # spatial window, divisor is the full window size (lrn pads with 0)
        half = (p.local_size - 1) // 2
        window_sum = F.avg_pool2d(x * x, p.local_size, stride=1, padding=half,
                                  count_include_pad=True, divisor_override=1)
        scale = p.k + window_sum * (p.alpha / (p.local_size * p.local_size))
        return [x * torch.pow(scale, -p.beta)]
