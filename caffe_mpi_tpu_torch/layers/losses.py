"""Softmax, the loss base, SoftmaxWithLoss and Accuracy.

Reference: src/caffe/layers/{softmax,softmax_loss,accuracy,loss}_layer.
{cpp,cu}; JAX package caffe_mpi_tpu/layers/losses.py. Plain torch: the JAX
package has no Pallas kernel for these.

Loss semantics kept as the JAX package keeps them: the normalization modes
FULL/VALID/BATCH_SIZE/NONE (loss_layer.cpp GetNormalizer; VALID, the
default, divides by the count of targets not ignored), `ignore_label`
masking in the loss and in accuracy, and a scalar first top that the Net
multiplies by its loss weight.
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


class LossBase(Layer):
    def is_loss(self) -> bool:
        return True

    def default_loss_weight(self, top_idx: int) -> float:
        # first top of a *Loss layer carries weight 1 (layer.hpp
        # SetLossWeights)
        return 1.0 if top_idx == 0 else 0.0

    def _normalizer(self, mode: str, outer: int, full: int,
                    valid: torch.Tensor | int):
        """loss_layer.cpp GetNormalizer. `valid` is a count on the device
        where labels are ignored, else the plain int `full`."""
        mode = mode.upper()
        if mode == "FULL":
            return float(full)
        if mode == "VALID":
            if isinstance(valid, int):
                return float(max(valid, 1))
            return torch.clamp(valid.float(), min=1.0)
        if mode == "BATCH_SIZE":
            return float(outer)
        if mode == "NONE":
            return 1.0
        raise ValueError(f"unknown loss normalization {mode!r}")

    def _norm_mode(self) -> str:
        p = self.lp.loss_param
        if p is None:
            return "VALID"
        # legacy flag (softmax_loss_layer.cpp:35-38): normalize:false means
        # BATCH_SIZE, normalize:true (or absent) means the modern default
        if not p.has("normalization") and p.has("normalize") \
                and not p.normalize:
            return "BATCH_SIZE"
        return p.normalization

    def _ignore_label(self):
        p = self.lp.loss_param
        return p.ignore_label if p and p.has("ignore_label") else None


def _labels_last(scores: torch.Tensor, labels: torch.Tensor, axis: int):
    """Scores with the class axis moved last, and the labels as int64 of
    the remaining shape."""
    s_last = torch.movedim(scores, axis, -1)
    return s_last, labels.long().reshape(s_last.shape[:-1])


@register("SoftmaxWithLoss")
class SoftmaxWithLossLayer(LossBase):
    """Fused log-softmax + NLL in f32 (softmax_loss_layer.cpp). The second
    top, when requested, is the softmax output."""

    def setup(self, in_shapes: list[Shape]) -> list[Shape]:
        self.axis = _softmax_axis(self.lp, len(in_shapes[0]))
        tops = [()]
        if len(self.lp.top) > 1:
            tops.append(in_shapes[0])
        return tops

    def forward(self, bottoms):
        logits = self.f(bottoms[0]).float()
        log_p = torch.log_softmax(logits, dim=self.axis)
        lp_last, labels = _labels_last(log_p, bottoms[1], self.axis)
        ignore = self._ignore_label()
        if ignore is not None:
            mask = labels != ignore
            # a gathered index must be in range even where it is ignored
            nll = -torch.gather(lp_last, -1, torch.where(
                mask, labels, 0)[..., None])[..., 0]
            nll = torch.where(mask, nll, torch.zeros_like(nll))
            valid = mask.sum()
        else:
            nll = -torch.gather(lp_last, -1, labels[..., None])[..., 0]
            valid = nll.numel()
        norm = self._normalizer(self._norm_mode(), logits.shape[0],
                                nll.numel(), valid)
        tops = [nll.sum() / norm]
        if len(self.lp.top) > 1:
            tops.append(torch.exp(log_p))
        return tops


@register("Accuracy")
class AccuracyLayer(Layer):
    """Top-k accuracy by rank (accuracy_layer.cpp): a row is right when
    fewer than k classes score strictly higher than its label. Not a loss
    (weight 0); optional second top = per-class accuracy."""

    def setup(self, in_shapes: list[Shape]) -> list[Shape]:
        p = self.lp.accuracy_param
        self.top_k = p.top_k if p else 1
        self.axis = (p.axis if p else 1) % len(in_shapes[0])
        self.ignore = p.ignore_label if (p and p.has("ignore_label")) \
            else None
        tops = [()]
        if len(self.lp.top) > 1:
            tops.append((in_shapes[0][self.axis],))
        return tops

    def forward(self, bottoms):
        s_last, given = _labels_last(self.f(bottoms[0]).float(),
                                     bottoms[1], self.axis)
        labels = given
        if self.ignore is not None:
            mask = given != self.ignore
            labels = torch.where(mask, given, 0)
        true_score = torch.gather(s_last, -1, labels[..., None])
        higher = (s_last > true_score).sum(-1)
        correct = (higher < self.top_k).float()
        if self.ignore is not None:
            correct = torch.where(mask, correct, torch.zeros_like(correct))
            denom = torch.clamp(mask.sum(), min=1)
        else:
            denom = correct.numel()
        tops = [correct.sum() / denom]
        if len(self.lp.top) > 1:
            k = s_last.shape[-1]
            # a label outside [0, k) (an ignored one) has no class row
            in_range = (given >= 0) & (given < k)
            onehot = torch.nn.functional.one_hot(
                torch.where(in_range, given, 0), k).float() \
                * in_range[..., None]
            dims = tuple(range(onehot.dim() - 1))
            per_class = (onehot * correct[..., None]).sum(dims)
            tops.append(per_class / torch.clamp(onehot.sum(dims), min=1.0))
        return tops
