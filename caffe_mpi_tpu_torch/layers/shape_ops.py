"""Shape and combination layers: Concat, Eltwise.

Reference: src/caffe/layers/{concat,eltwise}_layer.{cpp,cu}; JAX package
caffe_mpi_tpu/layers/shape_ops.py. Concat is `torch.cat`; Eltwise is
elementwise PROD, MAX, or SUM with optional per-bottom coefficients, as
torch expressions.
"""

from __future__ import annotations

import torch

from .base import Layer, Shape, register


@register("Concat")
class ConcatLayer(Layer):
    """Join the bottoms along `axis` (default 1; the legacy `concat_dim`
    when `axis` is unset; negative counts from the end)."""

    def setup(self, in_shapes: list[Shape]) -> list[Shape]:
        p = self.lp.concat_param
        axis = p.axis if p else 1
        if p and not p.has("axis") and p.has("concat_dim"):
            axis = p.concat_dim
        self.axis = axis % len(in_shapes[0]) if axis < 0 else axis
        out = list(in_shapes[0])
        out[self.axis] = sum(s[self.axis] for s in in_shapes)
        return [tuple(out)]

    def forward(self, bottoms):
        return [torch.cat([self.f(b) for b in bottoms], dim=self.axis)]


@register("Eltwise")
class EltwiseLayer(Layer):
    def setup(self, in_shapes: list[Shape]) -> list[Shape]:
        p = self.lp.eltwise_param
        self.op = str(p.operation).upper() if p else "SUM"
        self.coeff = list(p.coeff) if p else []
        if self.coeff and len(self.coeff) != len(self.lp.bottom):
            raise ValueError(f"{self.name}: coeff count != bottom count")
        return [in_shapes[0]]

    def forward(self, bottoms):
        xs = [self.f(b) for b in bottoms]
        y = xs[0]
        if self.op == "PROD":
            for x in xs[1:]:
                y = y * x
        elif self.op == "MAX":
            for x in xs[1:]:
                y = torch.maximum(y, x)
        elif self.coeff:  # SUM
            y = sum(c * x for c, x in zip(self.coeff, xs))
        else:
            y = sum(xs[1:], xs[0])
        return [y]
