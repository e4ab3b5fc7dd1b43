"""Extension layers: Python (user-defined), Filter, HDF5Output, Parameter.

Reference: src/caffe/layers/python_layer.cpp, filter_layer.cpp,
hdf5_output_layer.cpp, include/caffe/layers/parameter_layer.hpp; JAX
package caffe_mpi_tpu/layers/extension.py.

Python runs user numpy code on the host with the JAX package's protocol:
the user class defines `infer_shapes(bottom_shapes) -> top_shapes`, an
optional `setup(bottom_shapes)`, `forward(bottoms) -> tops` and an
optional `backward(top_diffs, bottoms) -> bottom_diffs`, on float32
arrays. With a `backward` the layer is an autograd Function that copies
to the host and back both ways; without one the gradient stops at the
layer's inputs. Its forward copies to the host, so it is a host step
(`host_step`): the solver runs its chunks eagerly. Over data-parallel
ranks the user's `forward` and `backward` see the global batch, as the
JAX layer's `jax.pure_callback` is handed it under a mesh
(extension.py:69, :89): the bottoms are all-gathered over 'data', a top
of the global batch keeps this rank's rows (a top the batch does not
split, a loss, stays whole), and the backward gathers the top diffs (a
whole top's summed over the ranks, each rank's loss being one of the
mean's terms) and keeps the rank's rows of the bottom diffs.

Filter keeps the JAX semantics, not the reference's compaction: the batch
keeps its size, the items whose selector (the last bottom) is 0 are
zeroed, and an extra top name gives the 0/1 mask.

Parameter exposes a learnable blob of the prototxt's shape
(constant-filled) as its one top. HDF5Output is registered only to be
refused: the card's machine has no h5py.
"""

from __future__ import annotations

import importlib

import numpy as np
import torch

from ..proto.config import FillerParameter
from .base import Layer, Shape, register


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _device(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32)).to(device)


def _host_forward(impl, device, mesh, shapes, bottoms):
    """The user's forward on the bottoms (over `mesh`'s data ranks the
    global batch's): (global bottoms, this rank's tops, which tops are
    split by rows)."""
    if mesh is not None:
        bottoms = [mesh.gather_rows(b) for b in bottoms]
    tops = [_device(o, device)
            for o in impl.forward([_host(b) for b in bottoms])]
    split = [mesh is not None and t.dim() > 0 and len(s) > 0
             and t.shape[0] == s[0] * mesh.n_data
             for t, s in zip(tops, shapes)]
    tops = [mesh.shard(t) if cut else t for t, cut in zip(tops, split)]
    return bottoms, tops, split


class _HostLayer(torch.autograd.Function):
    """A user layer's forward and backward on host arrays."""

    @staticmethod
    def forward(ctx, impl, device, mesh, shapes, *bottoms):
        whole, tops, split = _host_forward(impl, device, mesh, shapes,
                                           bottoms)
        ctx.impl, ctx.mesh, ctx.split = impl, mesh, split
        ctx.save_for_backward(*whole)
        return tuple(tops)

    @staticmethod
    def backward(ctx, *top_diffs):
        bottoms, mesh = ctx.saved_tensors, ctx.mesh
        if mesh is not None:
            top_diffs = [mesh.gather_rows(g) if cut
                         else mesh.all_reduce_(g.clone())
                         for g, cut in zip(top_diffs, ctx.split)]
        diffs = [_device(d, b.device).to(b.dtype) for d, b in zip(
            ctx.impl.backward([_host(g) for g in top_diffs],
                              [_host(b) for b in bottoms]), bottoms)]
        if mesh is not None:
            diffs = [mesh.shard(d) for d in diffs]
        return (None, None, None, None, *diffs)


@register("Python")
class PythonLayer(Layer):
    host_step = True

    def setup(self, in_shapes: list[Shape]) -> list[Shape]:
        p = self.lp.python_param
        if p is None or not p.module or not p.layer:
            raise ValueError(
                f"{self.name}: python_param.module/layer required")
        cls = getattr(importlib.import_module(p.module), p.layer)
        self.impl = cls()
        self.impl.param_str = p.param_str
        if not hasattr(self.impl, "infer_shapes"):
            raise ValueError(
                f"{self.name}: python layer {p.layer!r} must define "
                "infer_shapes(bottom_shapes) -> top_shapes (the functional "
                "equivalent of the reference's setup/reshape)")
        if hasattr(self.impl, "setup"):
            self.impl.setup(in_shapes)
        return [tuple(s) for s in self.impl.infer_shapes(in_shapes)]

    def forward(self, bottoms):
        mesh, shapes = self.host_ranks(), self.out_shapes
        if hasattr(self.impl, "backward"):
            tops = _HostLayer.apply(self.impl, self.device, mesh, shapes,
                                    *bottoms)
        else:
            tops = _host_forward(self.impl, self.device, mesh, shapes,
                                 [b.detach() for b in bottoms])[1]
        return [t.to(self.policy.forward) for t in tops]


@register("Filter")
class FilterLayer(Layer):
    def setup(self, in_shapes: list[Shape]) -> list[Shape]:
        outs = [tuple(s) for s in in_shapes[:-1]]
        if len(self.lp.top) == len(in_shapes):
            outs.append((in_shapes[-1][0],))
        return outs

    def forward(self, bottoms):
        mask = bottoms[-1].reshape(-1) != 0
        tops = [x * mask.reshape([x.shape[0]] + [1] * (x.dim() - 1)).to(
                    x.dtype) for x in bottoms[:-1]]
        if len(self.lp.top) == len(bottoms):
            tops.append(mask.float())
        return tops


@register("HDF5Output")
class HDF5OutputLayer(Layer):
    def setup(self, in_shapes: list[Shape]) -> list[Shape]:
        raise NotImplementedError(
            f"layer {self.name!r}: the {self.type_name} layer is not ported "
            "yet (ROADMAP.md §1 item 7): it writes HDF5 files, and the "
            "card's machine has no h5py")


@register("Parameter")
class ParameterLayer(Layer):
    def setup(self, in_shapes: list[Shape]) -> list[Shape]:
        pp = self.lp.parameter_param
        if pp is None or pp.shape is None or not pp.shape.dim:
            raise ValueError(f"{self.name}: parameter_param.shape required")
        shape = tuple(int(d) for d in pp.shape.dim)
        self.declare("weight", shape, FillerParameter(type="constant"))
        return [shape]

    def forward(self, bottoms):
        return [self.f(self.weight)]
