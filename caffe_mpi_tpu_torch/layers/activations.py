"""Elementwise activation layers: ReLU, Dropout.

Reference: src/caffe/layers/{relu,dropout}_layer.{cpp,cu}; JAX package
caffe_mpi_tpu/layers/activations.py. Each is one torch expression.
"""

from __future__ import annotations

import torch

from .base import Layer, Shape, register


class _Elementwise(Layer):
    def setup(self, in_shapes: list[Shape]) -> list[Shape]:
        return [in_shapes[0]]


@register("ReLU")
class ReLULayer(_Elementwise):
    def forward(self, bottoms):
        x = self.f(bottoms[0])
        slope = self.lp.relu_param.negative_slope if self.lp.relu_param else 0.0
        if slope:
            return [torch.where(x > 0, x, slope * x)]
        # not in place: the bottom blob may still be read by another layer
        return [torch.relu(x)]


@register("Dropout")
class DropoutLayer(_Elementwise):
    """Identity at TEST (dropout_layer.cpp scales at train time, so the
    test-time forward passes x through). Train-time inverted dropout
    arrives with the training path."""

    def forward(self, bottoms):
        if self.training:
            raise NotImplementedError(
                f"dropout layer {self.name!r}: train-time dropout is not "
                "ported yet; the port runs nets in TEST phase")
        return [self.f(bottoms[0])]
