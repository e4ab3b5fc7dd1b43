"""Spatial layers: Convolution, Deconvolution, Pooling, LRN, Im2col, Crop,
SPP.

Reference implementations: src/caffe/layers/{base_conv,conv,deconv,pooling,
lrn,im2col,crop,spp}_layer.{cpp,cu}; JAX package caffe_mpi_tpu/layers/
vision.py. Each layer is Caffe shape semantics + one op: `F.conv2d` for
Convolution and `F.conv_transpose2d` for Deconvolution (the JAX package
leaves both to XLA, outside any Pallas kernel), Caffe's ceil-and-clip
pooling (ops/pool.py: MAX, AVE and STOCHASTIC), and the across-channel LRN
kernel (ops/lrn.py).

STOCHASTIC pooling in TRAIN draws one uniform a window. As Dropout's
mask, the draw is made ahead of the forward (`draw_mask`) or handed in
(`mask`), so a replayed CUDA graph or a recompute reads the same draw.

Convolution with group 1 takes `param_sharding` over a mesh's 'model'
axis as InnerProduct does (layers/dense.py): "rows" splits the output
channels and their bias, "cols" the input channels.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..ops.conv import conv2d, conv_output_dim, deconv2d, im2col
from ..ops.lrn import lrn_across_channels
from ..ops.pool import (avg_pool2d, max_pool2d, pool_output_dim,
                        stochastic_output, stochastic_pool2d)
from ..parallel import mesh as mesh_mod
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

    def accepts_shards(self, shards: dict) -> bool:
        return not shards or self.p.group == 1 and shards in (
            {"weight": 0}, {"weight": 0, "bias": 0}, {"weight": 1})

    def forward(self, bottoms):
        x = self.f(bottoms[0])
        bias = self.f(self.bias) if self.p.bias_term else None
        mp = self.model_plan()
        split = self.shards.get("weight") if mp is not None else None
        if split == 0:
            # rows: output channels (and their bias) over the model ranks
            x = mesh_mod.copy_to_model(x, mp)
        elif split == 1:
            # cols: input channels over the model ranks, partial sums
            x = mesh_mod.split_to_model(x, mp, 1)
        # a whole bias under a split weight (cols, or rows in a layer that
        # shares only the weight) adds after the gather or the sum
        late = split is not None and bias is not None \
            and "bias" not in self.shards
        with self.policy.math(x.device):
            y = conv2d(x, self.f(self.weight), self.stride, self.pad,
                       self.dilation, self.p.group, None if late else bias)
        if split == 0:
            y = mesh_mod.gather_from_model(y, mp, 1)
        elif split == 1:
            y = mesh_mod.reduce_from_model(y, mp)
        if late:
            y = y + bias.reshape(1, -1, 1, 1)
        return [y]


@register("Deconvolution")
class DeconvolutionLayer(Layer):
    """The transpose of Convolution; weight (Cin, Cout/group, kh, kw)."""

    def setup(self, in_shapes: list[Shape]) -> list[Shape]:
        p = self.lp.convolution_param or ConvolutionParameter()
        self.p = p
        self.kernel, self.stride, self.pad, self.dilation = _spatial_params(p)
        n, cin, h, w = in_shapes[0]
        self.declare("weight", (cin, p.num_output // p.group, *self.kernel),
                     p.weight_filler)
        if p.bias_term:
            self.declare("bias", (p.num_output,),
                         p.bias_filler or FillerParameter(type="constant"))
        oh, ow = (self.stride[i] * (d - 1)
                  + self.dilation[i] * (self.kernel[i] - 1) + 1
                  - 2 * self.pad[i] for i, d in enumerate((h, w)))
        return [(n, p.num_output, oh, ow)]

    def forward(self, bottoms):
        x = self.f(bottoms[0])
        bias = self.f(self.bias) if self.p.bias_term else None
        with self.policy.math(x.device):
            y = deconv2d(x, self.f(self.weight), self.stride, self.pad,
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
        if self.method == "STOCHASTIC" and (self.pad[0] or self.pad[1]):
            raise ValueError("STOCHASTIC pooling does not support padding "
                             "(reference pooling_layer.cpp CHECKs the same)")
        self.needs_rng = self.method == "STOCHASTIC"
        return [(n, c, oh, ow)]

    def draw_mask(self, generator: torch.Generator,
                  shape=None) -> torch.Tensor:
        """STOCHASTIC: the uniforms a TRAIN forward of a bottom of
        `shape` (default: the net's) draws from `generator`, one a
        window."""
        n, c, h, w = shape or self.in_shapes[0]
        return torch.rand((n, c, *stochastic_output(h, w, self.kernel,
                                                    self.stride)),
                          generator=generator, device=self.device)

    def forward(self, bottoms, *, generator=None, mask=None):
        x = self.f(bottoms[0])
        if self.method == "AVE":
            return [avg_pool2d(x, self.kernel, self.stride, self.pad)]
        if self.method == "STOCHASTIC":
            u = None
            if self.training:
                u = mask
                if u is None:
                    if generator is None:
                        raise ValueError(f"{self.name}: stochastic pooling "
                                         "needs a generator or a draw")
                    u = self.draw_mask(generator, x.shape)
                u = u.to(x.device)
            return [stochastic_pool2d(x, self.kernel, self.stride, u)]
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


@register("Im2col")
class Im2colLayer(Layer):
    def setup(self, in_shapes: list[Shape]) -> list[Shape]:
        p = self.lp.convolution_param or ConvolutionParameter()
        self.kernel, self.stride, self.pad, self.dilation = _spatial_params(p)
        n, c, h, w = in_shapes[0]
        oh = conv_output_dim(h, self.kernel[0], self.pad[0], self.stride[0],
                             self.dilation[0])
        ow = conv_output_dim(w, self.kernel[1], self.pad[1], self.stride[1],
                             self.dilation[1])
        return [(n, c * self.kernel[0] * self.kernel[1], oh, ow)]

    def forward(self, bottoms):
        return [im2col(self.f(bottoms[0]), self.kernel, self.stride,
                       self.pad, self.dilation)]


@register("Crop")
class CropLayer(Layer):
    """Crop bottom[0] to bottom[1]'s shape from `axis` on, at `offset`:
    one offset for every axis or one an axis (crop_layer.cpp)."""

    def setup(self, in_shapes: list[Shape]) -> list[Shape]:
        p = self.lp.crop_param
        axis = p.axis if p else 2
        offsets = list(p.offset) if p else []
        a, b = in_shapes[0], in_shapes[1]
        out = list(a)
        self.starts = [0] * len(a)
        for i in range(axis, len(a)):
            off = 0
            if offsets:
                off = offsets[i - axis] if len(offsets) > 1 else offsets[0]
            if off + b[i] > a[i]:
                raise ValueError(
                    f"{self.name}: crop exceeds bottom size on axis {i}")
            self.starts[i] = off
            out[i] = b[i]
        self.out = tuple(out)
        return [self.out]

    def forward(self, bottoms):
        return [bottoms[0][tuple(slice(s, s + d) for s, d
                                 in zip(self.starts, self.out))]]


@register("SPP")
class SPPLayer(Layer):
    """Spatial pyramid pooling (spp_layer.cpp): level l pools into 2^l x
    2^l bins (a Caffe ceil-mode pool with the JAX layer's pad rule, cut
    to the bins), each flattened, all concatenated."""

    def setup(self, in_shapes: list[Shape]) -> list[Shape]:
        p = self.lp.spp_param
        self.method = str(p.pool).upper() if p else "MAX"
        if self.method not in ("MAX", "AVE"):
            raise ValueError(f"{self.name}: SPP pools MAX or AVE")
        n, c, h, w = in_shapes[0]
        self.levels = []
        for level in range(p.pyramid_height):
            bins = 2 ** level
            kh, kw = math.ceil(h / bins), math.ceil(w / bins)
            pad = ((kh * bins - h + 1) // 2, (kw * bins - w + 1) // 2)
            self.levels.append(((kh, kw), pad, bins))
        return [(n, sum(c * bins * bins for *_, bins in self.levels))]

    def forward(self, bottoms):
        x = self.f(bottoms[0])
        pool = avg_pool2d if self.method == "AVE" else max_pool2d
        return [torch.cat([pool(x, kernel, kernel, pad)[:, :, :bins, :bins]
                           .reshape(x.shape[0], -1)
                           for kernel, pad, bins in self.levels], dim=1)]
