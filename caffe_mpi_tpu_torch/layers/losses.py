"""Softmax. The loss layers arrive with the training path.

Reference: src/caffe/layers/softmax_layer.{cpp,cu}; JAX package
caffe_mpi_tpu/layers/losses.py.
"""

from __future__ import annotations

import torch

from .base import Layer, Shape, register


def _softmax_axis(lp, nd: int) -> int:
    axis = lp.softmax_param.axis if lp.softmax_param else 1
    return axis % nd if axis < 0 else axis


@register("Softmax")
class SoftmaxLayer(Layer):
    def setup(self, in_shapes: list[Shape]) -> list[Shape]:
        self.axis = _softmax_axis(self.lp, len(in_shapes[0]))
        return [in_shapes[0]]

    def forward(self, bottoms):
        return [torch.softmax(self.f(bottoms[0]), dim=self.axis)]
