"""Shape and combination layers: Eltwise.

Reference: src/caffe/layers/eltwise_layer.{cpp,cu}; JAX package
caffe_mpi_tpu/layers/shape_ops.py. Elementwise PROD, MAX, or SUM with
optional per-bottom coefficients, as torch expressions.
"""

from __future__ import annotations

import torch

from .base import Layer, Shape, register


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
