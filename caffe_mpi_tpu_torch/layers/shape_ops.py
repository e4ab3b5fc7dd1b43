"""Shape and combination layers: Concat, Slice, Split, Flatten, Reshape,
Tile, Eltwise, Reduction, ArgMax, Silence, BatchReindex.

Reference: src/caffe/layers/{concat,slice,split,flatten,reshape,tile,
eltwise,reduction,argmax,silence,batch_reindex}_layer.{cpp,cu}; JAX package
caffe_mpi_tpu/layers/shape_ops.py. Concat is `torch.cat`, Slice views of
the bottom between its slice points, Tile `Tensor.repeat` along one axis;
Eltwise is elementwise PROD, MAX, or SUM with optional per-bottom
coefficients; Split hands its bottom to every top (autograd sums their
gradients, as the reference's split layer does); Flatten and Reshape are
views; Reduction reduces every axis from `axis` on; BatchReindex gathers
batch items by an index blob.

ArgMax orders equal values by index, lowest first, as `jax.lax.top_k`
does: a stable descending sort, whose order does not depend on the
device (`torch.topk` does not promise one for ties).
"""

from __future__ import annotations

import math

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


@register("Split")
class SplitLayer(Layer):
    def setup(self, in_shapes: list[Shape]) -> list[Shape]:
        return [in_shapes[0]] * len(self.lp.top)

    def forward(self, bottoms):
        return [bottoms[0]] * len(self.lp.top)


@register("Flatten")
class FlattenLayer(Layer):
    """Merge axes `axis`..`end_axis` (default 1..-1) into one."""

    def setup(self, in_shapes: list[Shape]) -> list[Shape]:
        p = self.lp.flatten_param
        shape = in_shapes[0]
        nd = len(shape)
        axis = (p.axis if p else 1) % nd
        end = (p.end_axis if p else -1) % nd
        self.out = (*shape[:axis], math.prod(shape[axis:end + 1]),
                    *shape[end + 1:])
        return [self.out]

    def forward(self, bottoms):
        return [bottoms[0].reshape(self.out)]


@register("Reshape")
class ReshapeLayer(Layer):
    """Replace axes [axis, axis + num_axes) by `shape`: a dim of 0 copies
    the bottom's, one dim of -1 is inferred (reshape_layer.cpp)."""

    def setup(self, in_shapes: list[Shape]) -> list[Shape]:
        p = self.lp.reshape_param
        spec = list(p.shape.dim) if (p and p.shape) else []
        in_shape = in_shapes[0]
        nd = len(in_shape)
        start = (p.axis if p else 0) % (nd + 1)
        num_axes = p.num_axes if p else -1
        end = nd if num_axes == -1 else start + num_axes
        head, mid_in, tail = in_shape[:start], in_shape[start:end], \
            in_shape[end:]
        mid = [mid_in[i] if d == 0 else d for i, d in enumerate(spec)]
        if -1 in mid:
            known = math.prod(d for d in mid if d != -1)
            total = math.prod(mid_in)
            if known == 0 or total % known:
                raise ValueError(f"{self.name}: cannot infer -1 dimension")
            mid[mid.index(-1)] = total // known
        if math.prod(mid) != math.prod(mid_in):
            raise ValueError(
                f"{self.name}: reshape count mismatch {mid_in} -> {mid}")
        self.out = (*head, *mid, *tail)
        return [self.out]

    def forward(self, bottoms):
        return [bottoms[0].reshape(self.out)]


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


@register("Reduction")
class ReductionLayer(Layer):
    """SUM, ASUM, SUMSQ or MEAN over the axes from `axis` on, times
    `coeff` (reduction_layer.cpp)."""

    def setup(self, in_shapes: list[Shape]) -> list[Shape]:
        p = self.lp.reduction_param
        self.op = str(p.operation).upper() if p else "SUM"
        self.axis = (p.axis if p else 0) % len(in_shapes[0])
        self.coeff = p.coeff if p else 1.0
        return [in_shapes[0][:self.axis]]

    def forward(self, bottoms):
        x = self.f(bottoms[0])
        dims = tuple(range(self.axis, x.dim()))
        if self.op == "ASUM":
            x = torch.abs(x)
        elif self.op == "SUMSQ":
            x = torch.square(x)
        y = torch.mean(x, dim=dims) if self.op == "MEAN" \
            else torch.sum(x, dim=dims)
        return [self.coeff * y]


def _top_k(x: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis, equal
    values lowest index first."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


@register("ArgMax")
class ArgMaxLayer(Layer):
    """The top_k indices (float) of each item, or with `out_max_val` the
    (index, value) pairs; along `axis` when given, the values alone
    under out_max_val (argmax_layer.cpp)."""

    def setup(self, in_shapes: list[Shape]) -> list[Shape]:
        p = self.lp.argmax_param
        self.top_k = p.top_k if p else 1
        self.out_max_val = bool(p and p.out_max_val)
        self.axis = p.axis if (p and p.axis is not None) else None
        n = in_shapes[0][0]
        if self.axis is not None:
            out = list(in_shapes[0])
            out[self.axis % len(out)] = self.top_k
            return [tuple(out)]
        return [(n, 2 if self.out_max_val else 1, self.top_k)]

    def forward(self, bottoms):
        x = self.f(bottoms[0]).float()
        if self.axis is not None:
            ax = self.axis % x.dim()
            vals, idx = _top_k(torch.movedim(x, ax, -1), self.top_k)
            out = vals if self.out_max_val else idx.float()
            return [torch.movedim(out, -1, ax)]
        vals, idx = _top_k(x.reshape(x.shape[0], -1), self.top_k)
        if self.out_max_val:
            return [torch.stack([idx.float(), vals], dim=1)]
        return [idx.float()[:, None, :]]


@register("Silence")
class SilenceLayer(Layer):
    """Consumes its bottoms, produces nothing (silence_layer.cpp)."""

    def setup(self, in_shapes: list[Shape]) -> list[Shape]:
        return []

    def forward(self, bottoms):
        return []


@register("BatchReindex")
class BatchReindexLayer(Layer):
    """bottom[0]'s items at the indices of bottom[1]
    (batch_reindex_layer.cpp)."""

    def setup(self, in_shapes: list[Shape]) -> list[Shape]:
        return [(in_shapes[1][0], *in_shapes[0][1:])]

    def forward(self, bottoms):
        idx = bottoms[1].reshape(-1).long().to(bottoms[0].device)
        return [torch.index_select(self.f(bottoms[0]), 0, idx)]
