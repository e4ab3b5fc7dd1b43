"""Dense layers: InnerProduct, Embed, Scale, Bias.

Reference: src/caffe/layers/{inner_product,embed,scale,bias}_layer.
{cpp,cu}; JAX package caffe_mpi_tpu/layers/dense.py. The cuBLAS gemm
stays a library call (`torch.matmul`), as the JAX package left it to XLA;
Embed is a gather, Scale and Bias broadcast arithmetic.

Under a mesh's 'model' axis (`param_sharding`, the layer's `shards`)
InnerProduct runs Megatron-style: "rows" (weight dim 0 and the bias
split) copies the input to the shards and gathers their output features;
"cols" (weight dim 1 split) splits the input features, sums the partial
products over the model ranks and adds the replicated bias. Any other
split (a transposed layer's, a split bias under a cols weight, a split
over 'data') is gathered whole before the forward (`Net.place`).
"""

from __future__ import annotations

import math

import torch

from ..parallel import mesh as mesh_mod
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

    def accepts_shards(self, shards: dict) -> bool:
        return not shards or not self.p.transpose and shards in (
            {"weight": 0}, {"weight": 0, "bias": 0}, {"weight": 1})

    def forward(self, bottoms):
        x = self.f(bottoms[0])
        lead = tuple(x.shape[: self.axis])
        x2 = x.reshape(math.prod(lead) if lead else 1, self.k)
        w = self.f(self.weight)
        mp = self.model_plan()
        if mp is not None and self.shards.get("weight") == 0:
            # rows (column-parallel): every shard reads the whole input,
            # computes its output features, and the features gather
            x2 = mesh_mod.copy_to_model(x2, mp)
        elif mp is not None and self.shards.get("weight") == 1:
            # cols (row-parallel): each shard takes its input features,
            # and the partial products sum over the model ranks
            x2 = mesh_mod.split_to_model(x2, mp, 1)
        with self.policy.math(x.device):
            y = torch.matmul(x2, w if self.p.transpose else w.t())
        if mp is not None and self.shards.get("weight") == 1:
            y = mesh_mod.reduce_from_model(y, mp)
        # a bias split with the rows adds before the gather, a whole one
        # (a layer that shares only the weight) after it
        split_bias = "bias" in self.shards
        if self.p.bias_term and split_bias:
            y = y + self.f(self.bias)
        if mp is not None and self.shards.get("weight") == 0:
            y = mesh_mod.gather_from_model(y, mp, 1)
        if self.p.bias_term and not split_bias:
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


class _ScaleBiasBase(Layer):
    """Scale's and Bias's shared shape logic (scale_layer.cpp,
    bias_layer.cpp): the operand is the second bottom, or a learned
    `operand` of the bottom's shape[axis : axis + num_axes] (num_axes -1:
    to the end), broadcast from `axis`."""

    def _setup(self, in_shapes, axis: int, num_axes: int, filler,
               default_fill: float) -> list[Shape]:
        nd = len(in_shapes[0])
        self.axis = axis % nd if axis < 0 else axis
        self.two_bottom = len(in_shapes) > 1
        if self.two_bottom:
            self.op_shape = tuple(in_shapes[1])
        else:
            end = nd if num_axes == -1 else self.axis + num_axes
            self.op_shape = tuple(in_shapes[0][self.axis:end])
            self.declare("operand", self.op_shape, filler or FillerParameter(
                type="constant", value=default_fill))
        return [in_shapes[0]]

    def _operand(self, bottoms, nd: int) -> torch.Tensor:
        b = bottoms[1] if self.two_bottom else self.operand
        return _broadcast_along(self.f(b), nd, self.axis)


@register("Scale")
class ScaleLayer(_ScaleBiasBase):
    """y = x * s [+ b]: s the second bottom or a learned `operand`
    (filler default constant 1), b a learned `bias` of the operand's
    shape when `bias_term` (bias_filler default constant 0)."""

    def setup(self, in_shapes: list[Shape]) -> list[Shape]:
        p = self.lp.scale_param
        out = self._setup(in_shapes, p.axis if p else 1,
                          p.num_axes if p else 1,
                          p.filler if p else None, default_fill=1.0)
        self.bias_term = bool(p and p.bias_term)
        if self.bias_term:
            self.declare("bias", self.op_shape, p.bias_filler
                         or FillerParameter(type="constant"))
        return out

    def forward(self, bottoms):
        x = self.f(bottoms[0])
        y = x * self._operand(bottoms, x.dim())
        if self.bias_term:
            y = y + _broadcast_along(self.f(self.bias), x.dim(), self.axis)
        return [y]


@register("Bias")
class BiasLayer(_ScaleBiasBase):
    """y = x + b, b the second bottom or a learned `operand` (filler
    default constant 0)."""

    def setup(self, in_shapes: list[Shape]) -> list[Shape]:
        p = self.lp.bias_param
        return self._setup(in_shapes, p.axis if p else 1,
                           p.num_axes if p else 1,
                           p.filler if p else None, default_fill=0.0)

    def forward(self, bottoms):
        x = self.f(bottoms[0])
        return [x + self._operand(bottoms, x.dim())]
