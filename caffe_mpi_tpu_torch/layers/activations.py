"""Elementwise activation layers: ReLU, PReLU, ELU, Sigmoid, TanH, BNLL,
Power, Exp, Log, AbsVal, Threshold, Dropout.

Reference: src/caffe/layers/{relu,prelu,elu,sigmoid,tanh,bnll,power,exp,
log,absval,threshold,dropout}_layer.{cpp,cu}; JAX package
caffe_mpi_tpu/layers/activations.py. Each is one torch expression, in the
JAX layer's form (so the same autograd formula). PReLU learns `slope`, one
a channel or one shared (default filler constant 0.25); Threshold's top
carries no gradient.

Dropout is the one layer that draws random numbers: `needs_rng` tells
`Net.forward` to hand it the net's generator and, where the caller gives
one, the mask to use instead of a draw.
"""

from __future__ import annotations

import math

import torch

from ..proto.config import FillerParameter
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


@register("PReLU")
class PReLULayer(_Elementwise):
    def setup(self, in_shapes: list[Shape]) -> list[Shape]:
        p = self.lp.prelu_param
        channels = in_shapes[0][1] if len(in_shapes[0]) > 1 else 1
        self.channels = 1 if (p and p.channel_shared) else channels
        filler = (p.filler if p else None) or FillerParameter(
            type="constant", value=0.25)
        self.declare("slope", (self.channels,), filler)
        return [in_shapes[0]]

    def forward(self, bottoms):
        x = self.f(bottoms[0])
        shape = [1] * x.dim()
        if self.channels > 1:
            shape[1] = self.channels
        slope = self.f(self.slope).reshape(shape)
        return [torch.where(x > 0, x, slope * x)]


@register("ELU")
class ELULayer(_Elementwise):
    def forward(self, bottoms):
        x = self.f(bottoms[0])
        alpha = self.lp.elu_param.alpha if self.lp.elu_param else 1.0
        return [torch.where(x > 0, x, alpha * (torch.exp(
            torch.clamp(x, max=0)) - 1))]


@register("Sigmoid")
class SigmoidLayer(_Elementwise):
    def forward(self, bottoms):
        return [torch.sigmoid(self.f(bottoms[0]))]


@register("TanH")
class TanHLayer(_Elementwise):
    def forward(self, bottoms):
        return [torch.tanh(self.f(bottoms[0]))]


@register("BNLL")
class BNLLLayer(_Elementwise):
    """y = log(1 + exp(x)), computed stably (bnll_layer.cpp)."""

    def forward(self, bottoms):
        x = self.f(bottoms[0])
        return [torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                               device=x.device))]


@register("Power")
class PowerLayer(_Elementwise):
    """y = (shift + scale*x)^power (power_layer.cpp)."""

    def forward(self, bottoms):
        p = self.lp.power_param
        power, scale, shift = (p.power, p.scale, p.shift) if p \
            else (1.0, 1.0, 0.0)
        base = shift + scale * self.f(bottoms[0])
        return [base if power == 1.0 else torch.pow(base, power)]


@register("Exp")
class ExpLayer(_Elementwise):
    """y = base^(shift + scale*x); base -1 means e (exp_layer.cpp)."""

    def forward(self, bottoms):
        p = self.lp.exp_param
        base, scale, shift = (p.base, p.scale, p.shift) if p \
            else (-1.0, 1.0, 0.0)
        inner = shift + scale * self.f(bottoms[0])
        if base == -1.0:
            return [torch.exp(inner)]
        return [torch.exp(inner * math.log(base))]


@register("Log")
class LogLayer(_Elementwise):
    """y = log_base(shift + scale*x); base -1 means e (log_layer.cpp)."""

    def forward(self, bottoms):
        p = self.lp.log_param
        base, scale, shift = (p.base, p.scale, p.shift) if p \
            else (-1.0, 1.0, 0.0)
        y = torch.log(shift + scale * self.f(bottoms[0]))
        return [y if base == -1.0 else y / math.log(base)]


@register("AbsVal")
class AbsValLayer(_Elementwise):
    def forward(self, bottoms):
        return [torch.abs(self.f(bottoms[0]))]


@register("Threshold")
class ThresholdLayer(_Elementwise):
    """y = (x > t) ? 1 : 0, no gradient (threshold_layer.cpp)."""

    def forward(self, bottoms):
        t = self.lp.threshold_param.threshold \
            if self.lp.threshold_param else 0.0
        x = self.f(bottoms[0]).detach()
        return [(x > t).to(x.dtype)]


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
