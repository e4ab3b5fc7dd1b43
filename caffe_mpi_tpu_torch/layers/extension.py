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
(`host_step`): the solver runs its chunks eagerly and data parallelism
refuses it.

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


class _HostLayer(torch.autograd.Function):
    """A user layer's forward and backward on host arrays."""

    @staticmethod
    def forward(ctx, impl, device, *bottoms):
        ctx.impl = impl
        ctx.save_for_backward(*bottoms)
        return tuple(_device(o, device)
                     for o in impl.forward([_host(b) for b in bottoms]))

    @staticmethod
    def backward(ctx, *top_diffs):
        bottoms = ctx.saved_tensors
        diffs = ctx.impl.backward([_host(g) for g in top_diffs],
                                  [_host(b) for b in bottoms])
        return (None, None, *(_device(d, b.device).to(b.dtype)
                              for d, b in zip(diffs, bottoms)))


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
        if hasattr(self.impl, "backward"):
            tops = _HostLayer.apply(self.impl, self.device, *bottoms)
        else:
            tops = [_device(o, self.device) for o in self.impl.forward(
                [_host(b) for b in bottoms])]
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
