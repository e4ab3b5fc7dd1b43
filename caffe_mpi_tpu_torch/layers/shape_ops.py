"""Shape and combination layers: Concat, Slice, Tile, Eltwise.

Reference: src/caffe/layers/{concat,slice,tile,eltwise}_layer.{cpp,cu};
JAX package caffe_mpi_tpu/layers/shape_ops.py. Concat is `torch.cat`,
Slice views of the bottom between its slice points, Tile `Tensor.repeat`
along one axis; Eltwise is elementwise PROD, MAX, or SUM with optional
per-bottom coefficients, as torch expressions.
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


@register("Slice")
class SliceLayer(Layer):
    """Split the bottom along `axis` (default 1; the legacy `slice_dim`
    when `axis` is unset) at `slice_point`s, or into equal parts, one a
    top."""

    def setup(self, in_shapes: list[Shape]) -> list[Shape]:
        p = self.lp.slice_param
        axis = p.axis if p else 1
        if p and not p.has("axis") and p.has("slice_dim"):
            axis = p.slice_dim
        self.axis = axis % len(in_shapes[0]) if axis < 0 else axis
        total = in_shapes[0][self.axis]
        n_top = len(self.lp.top)
        points = list(p.slice_point) if p else []
        if points:
            if len(points) != n_top - 1:
                raise ValueError(f"{self.name}: need {n_top - 1} slice points")
            bounds = [0] + points + [total]
        else:
            if total % n_top:
                raise ValueError(
                    f"{self.name}: {total} not divisible by {n_top} tops")
            step = total // n_top
            bounds = [i * step for i in range(n_top + 1)]
        self.bounds = bounds
        outs = []
        for i in range(n_top):
            s = list(in_shapes[0])
            s[self.axis] = bounds[i + 1] - bounds[i]
            outs.append(tuple(s))
        return outs

    def forward(self, bottoms):
        x = self.f(bottoms[0])
        return [x.narrow(self.axis, lo, hi - lo)
                for lo, hi in zip(self.bounds, self.bounds[1:])]


@register("Tile")
class TileLayer(Layer):
    """Repeat the bottom `tiles` times along `axis` (default 1)."""

    def setup(self, in_shapes: list[Shape]) -> list[Shape]:
        p = self.lp.tile_param
        self.axis = (p.axis if p else 1) % len(in_shapes[0])
        self.tiles = p.tiles if p else 1
        out = list(in_shapes[0])
        out[self.axis] *= self.tiles
        return [tuple(out)]

    def forward(self, bottoms):
        reps = [1] * bottoms[0].dim()
        reps[self.axis] = self.tiles
        return [bottoms[0].repeat(*reps)]


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
