"""Elementwise activation layers: ReLU, Sigmoid, Dropout.

Reference: src/caffe/layers/{relu,sigmoid,dropout}_layer.{cpp,cu}; JAX package
caffe_mpi_tpu/layers/activations.py. Each is one torch expression.

Dropout is the one layer that draws random numbers: `needs_rng` tells
`Net.forward` to hand it the net's generator and, where the caller gives
one, the mask to use instead of a draw.
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


@register("Sigmoid")
class SigmoidLayer(_Elementwise):
    def forward(self, bottoms):
        return [torch.sigmoid(self.f(bottoms[0]))]


@register("Dropout")
class DropoutLayer(_Elementwise):
    """Inverted dropout (dropout_layer.cpp): at train time
    y = where(mask, x / keep, 0) with mask ~ Bernoulli(keep); at TEST the
    identity. The mask is drawn from `generator` on x's device unless
    `mask` (a bool tensor of x's shape) is given; `draw_mask` makes the
    same draw ahead of the forward (the solver draws every mask of an
    iteration before it runs, so a replayed CUDA graph reads them)."""

    needs_rng = True

    def keep(self) -> float:
        ratio = (self.lp.dropout_param.dropout_ratio
                 if self.lp.dropout_param else 0.5)
        return 1.0 - ratio

    def draw_mask(self, generator: torch.Generator,
                  shape=None) -> torch.Tensor:
        """The mask a TRAIN forward of a bottom of `shape` (default: the
        net's) draws from `generator`."""
        return torch.rand(shape or self.in_shapes[0], generator=generator,
                          device=self.device) < self.keep()

    def forward(self, bottoms, *, generator=None, mask=None):
        x = self.f(bottoms[0])
        if not self.training:
            return [x]
        if mask is None:
            if generator is None:
                raise ValueError(f"dropout layer {self.name!r} needs a "
                                 "generator or a mask in train mode")
            mask = self.draw_mask(generator, x.shape)
        elif mask.shape != x.shape or mask.dtype != torch.bool:
            raise ValueError(f"dropout layer {self.name!r}: mask "
                             f"{tuple(mask.shape)} {mask.dtype}, want bool "
                             f"{tuple(x.shape)}")
        return [torch.where(mask.to(x.device), x / self.keep(), 0.0)]
