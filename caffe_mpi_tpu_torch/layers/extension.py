"""Extension layers: Parameter.

Reference: include/caffe/layers/parameter_layer.hpp; JAX package
caffe_mpi_tpu/layers/extension.py. Parameter exposes a learnable blob of
the prototxt's shape (constant-filled) as its one top.
"""

from __future__ import annotations

from ..proto.config import FillerParameter
from .base import Layer, Shape, register


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
