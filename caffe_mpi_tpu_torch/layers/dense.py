"""Dense layers: InnerProduct, Embed, Bias.

Reference: src/caffe/layers/{inner_product,embed,bias}_layer.{cpp,cu}; JAX
package caffe_mpi_tpu/layers/dense.py. The cuBLAS gemm stays a library
call (`torch.matmul`), as the JAX package left it to XLA; Embed is a
gather, Bias broadcast arithmetic.
"""

from __future__ import annotations

import math

import torch

from ..proto.config import FillerParameter
from .base import Layer, Shape, register


@register("InnerProduct")
class InnerProductLayer(Layer):
    def setup(self, in_shapes: list[Shape]) -> list[Shape]:
        p = self.lp.inner_product_param
        self.p = p
        self.axis = p.axis % len(in_shapes[0]) if p.axis < 0 else p.axis
        k = math.prod(in_shapes[0][self.axis:])
        self.k = k
        # Caffe stores (num_output, K), or (K, num_output) when transpose
        wshape = (k, p.num_output) if p.transpose else (p.num_output, k)
        self.declare("weight", wshape, p.weight_filler)
        if p.bias_term:
            self.declare("bias", (p.num_output,),
                         p.bias_filler or FillerParameter(type="constant"))
        return [(*in_shapes[0][: self.axis], p.num_output)]

    def forward(self, bottoms):
        x = self.f(bottoms[0])
        lead = tuple(x.shape[: self.axis])
        x2 = x.reshape(math.prod(lead) if lead else 1, self.k)
        w = self.f(self.weight)
        with self.policy.math(x.device):
            y = torch.matmul(x2, w if self.p.transpose else w.t())
        if self.p.bias_term:
            y = y + self.f(self.bias)
        return [y.reshape(*lead, self.p.num_output)]


@register("Embed")
class EmbedLayer(Layer):
    """Index lookup (embed_layer.cu's one-hot product) as a gather: the
    bottom holds ids in [0, input_dim), truncated to integers."""

    def setup(self, in_shapes: list[Shape]) -> list[Shape]:
        p = self.lp.embed_param
        self.p = p
        self.declare("weight", (p.input_dim, p.num_output), p.weight_filler)
        if p.bias_term:
            self.declare("bias", (p.num_output,),
                         p.bias_filler or FillerParameter(type="constant"))
        return [(*in_shapes[0], p.num_output)]

    def forward(self, bottoms):
        y = self.f(self.weight)[bottoms[0].long()]
        if self.p.bias_term:
            y = y + self.f(self.bias)
        return [y]


def _broadcast_along(vec: torch.Tensor, nd: int, axis: int) -> torch.Tensor:
    """Reshape a (num_axes...)-shaped operand so that it broadcasts
    against an nd-dim input starting at `axis` (bias_layer.cpp)."""
    shape = [1] * nd
    for i, s in enumerate(vec.shape):
        shape[axis + i] = s
    return vec.reshape(shape)


@register("Bias")
class BiasLayer(Layer):
    """y = x + b, b broadcast from `axis`: the second bottom, or a learned
    `operand` of the bottom's shape[axis : axis + num_axes] (num_axes -1:
    to the end)."""

    def setup(self, in_shapes: list[Shape]) -> list[Shape]:
        p = self.lp.bias_param
        axis, num_axes = (p.axis, p.num_axes) if p else (1, 1)
        nd = len(in_shapes[0])
        self.axis = axis % nd if axis < 0 else axis
        self.two_bottom = len(in_shapes) > 1
        if not self.two_bottom:
            end = nd if num_axes == -1 else self.axis + num_axes
            self.declare("operand", tuple(in_shapes[0][self.axis:end]),
                         (p.filler if p else None)
                         or FillerParameter(type="constant"))
        return [in_shapes[0]]

    def forward(self, bottoms):
        x = self.f(bottoms[0])
        b = bottoms[1] if self.two_bottom else self.operand
        return [x + _broadcast_along(self.f(b), x.dim(), self.axis)]
