"""Softmax, the loss base, SoftmaxWithLoss, EuclideanLoss, L1Loss,
SigmoidCrossEntropyLoss, HingeLoss, MultinomialLogisticLoss, InfogainLoss,
ContrastiveLoss and Accuracy.

Reference: src/caffe/layers/{softmax,softmax_loss,euclidean_loss,
sigmoid_cross_entropy_loss,hinge_loss,multinomial_logistic_loss,
infogain_loss,contrastive_loss,accuracy,loss}_layer.{cpp,cu} and NVCaffe's
l1_loss_layer.cpp; JAX package caffe_mpi_tpu/layers/losses.py. Plain
torch: the JAX package has no Pallas kernel for these. InfogainLoss takes
its matrix H from a third bottom or from `infogain_loss_param.source`, a
BlobProto file read at setup relative to the net's model_dir.

Loss semantics kept as the JAX package keeps them: the normalization modes
FULL/VALID/BATCH_SIZE/NONE (loss_layer.cpp GetNormalizer; VALID, the
default, divides by the count of targets not ignored), `ignore_label`
masking in the loss and in accuracy, and a scalar first top that the Net
multiplies by its loss weight.

Under data parallelism (`Net.bind_mesh`, N > 1 ranks, each on its slice
of the global batch) a batch-wide top is the rank's share of the global
value: the mean over the ranks of each rank's top is the top of the whole
batch, and the solver averages the loss (and a test pass its scores)
over the ranks. A normalizer proportional to the rank's batch (FULL,
BATCH_SIZE, VALID with nothing ignored, EuclideanLoss's N, ...) is that
already. A count that depends on the data (VALID with `ignore_label`,
Accuracy's with `ignore_label` and its per-class counts) is all-reduced
and divided by N; NONE divides by 1/N. The gradient each rank's backward
takes is then N times its share of the global one, which the gradient
reduce's 1/N undoes.
"""

from __future__ import annotations

import os

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
        where labels are ignored, else the plain int `full`. Under data
        parallelism, the rank's share of the global normalizer."""
        mode = mode.upper()
        n = _ranks(self)
        if mode == "FULL":
            return float(full)
        if mode == "VALID":
            if isinstance(valid, int):
                return float(max(valid, 1))
            return _global_count(self, valid.float()) / n
        if mode == "BATCH_SIZE":
            return float(outer)
        if mode == "NONE":
            return 1.0 / n
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


def _ranks(layer) -> int:
    mesh = layer.mesh_plan
    return 1 if mesh is None else mesh.n_data


def _global_count(layer, count: torch.Tensor) -> torch.Tensor:
    """A count of the rank's batch summed over the ranks, at least 1
    (elementwise for a vector of counts)."""
    if _ranks(layer) > 1:
        count = layer.mesh_plan.all_reduce_(count.clone())
    return torch.clamp(count, min=1.0)


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


@register("EuclideanLoss")
class EuclideanLossLayer(LossBase):
    """sum((a - b)^2) / (2N), N the batch (euclidean_loss_layer.cpp)."""

    def setup(self, in_shapes: list[Shape]) -> list[Shape]:
        return [()]

    def forward(self, bottoms):
        a = self.f(bottoms[0]).float()
        b = self.f(bottoms[1]).float()
        return [torch.sum(torch.square(a - b)) / (2.0 * a.shape[0])]


@register("L1Loss")
class L1LossLayer(LossBase):
    """sum(|a - b|) / N, N the batch; one bottom is |a| (NVCaffe
    l1_loss_layer.cpp)."""

    def setup(self, in_shapes: list[Shape]) -> list[Shape]:
        return [()]

    def forward(self, bottoms):
        a = self.f(bottoms[0]).float()
        d = a - self.f(bottoms[1]).float() if len(bottoms) > 1 else a
        return [torch.sum(torch.abs(d)) / a.shape[0]]


@register("SigmoidCrossEntropyLoss")
class SigmoidCrossEntropyLossLayer(LossBase):
    """Stable BCE with logits, max(x, 0) - x*t + log(1 + exp(-|x|)),
    summed over the batch size N (sigmoid_cross_entropy_loss_layer.cpp);
    targets equal to `ignore_label` add nothing."""

    def setup(self, in_shapes: list[Shape]) -> list[Shape]:
        return [()]

    def forward(self, bottoms):
        x = self.f(bottoms[0]).float()
        t = self.f(bottoms[1]).float()
        per = torch.clamp(x, min=0) - x * t \
            + torch.log1p(torch.exp(-torch.abs(x)))
        ignore = self._ignore_label()
        if ignore is not None:
            per = torch.where(bottoms[1] != ignore, per,
                              torch.zeros((), device=per.device))
        return [torch.sum(per) / x.shape[0]]


@register("HingeLoss")
class HingeLossLayer(LossBase):
    """One-vs-all hinge on raw scores, sum(max(0, 1 - s*x)) / N with s =
    +1 at the label and -1 elsewhere, squared under `norm: L2`
    (hinge_loss_layer.cpp)."""

    def setup(self, in_shapes: list[Shape]) -> list[Shape]:
        return [()]

    def forward(self, bottoms):
        x = self.f(bottoms[0]).float()
        n = x.shape[0]
        x2 = x.reshape(n, -1)
        labels = bottoms[1].reshape(-1).long().to(x.device)
        sign = 1.0 - 2.0 * torch.nn.functional.one_hot(labels, x2.shape[1])
        margins = torch.clamp(1.0 + sign * x2, min=0.0)
        p = self.lp.hinge_loss_param
        if p and str(p.norm).upper() == "L2":
            margins = torch.square(margins)
        return [torch.sum(margins) / n]


def _log_prob(prob: torch.Tensor) -> torch.Tensor:
    """log of probabilities, floored at 1e-20 (the reference's kLOG_THRESHOLD)."""
    return torch.log(torch.clamp(prob, min=1e-20))


@register("MultinomialLogisticLoss")
class MultinomialLogisticLossLayer(LossBase):
    """-sum(log p[label]) / N on already normalized probabilities
    (multinomial_logistic_loss_layer.cpp)."""

    def setup(self, in_shapes: list[Shape]) -> list[Shape]:
        return [()]

    def forward(self, bottoms):
        prob = self.f(bottoms[0]).float()
        n = prob.shape[0]
        labels = bottoms[1].reshape(-1).long().to(prob.device)
        picked = torch.gather(prob.reshape(n, -1), 1, labels[:, None])
        return [-torch.sum(_log_prob(picked)) / n]


@register("InfogainLoss")
class InfogainLossLayer(LossBase):
    """-sum_k H[label, k] log p[k] / N (infogain_loss_layer.cpp)."""

    def setup(self, in_shapes: list[Shape]) -> list[Shape]:
        if len(in_shapes) >= 3:
            self.register_buffer("h_file", None, persistent=False)
        else:
            p = self.lp.infogain_loss_param
            if not (p and p.source):
                raise ValueError(f"{self.name}: infogain needs H as third "
                                 "bottom or a source file")
            from ..io import load_blob_binaryproto
            k = in_shapes[0][1]
            h = load_blob_binaryproto(os.path.join(self.model_dir, p.source))
            self.register_buffer("h_file", torch.from_numpy(
                h.reshape(k, k).astype("float32")).to(self.device),
                persistent=False)
        return [()]

    def forward(self, bottoms):
        prob = self.f(bottoms[0]).float()
        n, k = prob.shape[0], prob.shape[1]
        labels = bottoms[1].reshape(-1).long().to(prob.device)
        h = self.h_file if self.h_file is not None \
            else self.f(bottoms[2]).float().reshape(k, k)
        rows = torch.index_select(h, 0, labels)
        return [-torch.sum(rows * _log_prob(prob.reshape(n, -1))) / n]


@register("ContrastiveLoss")
class ContrastiveLossLayer(LossBase):
    """Siamese-pair loss (contrastive_loss_layer.cpp) over d^2 = |a - b|^2
    a pair: y = 1 (similar) adds d^2, y = 0 adds max(margin - d, 0)^2, or
    max(margin - d^2, 0) under `legacy_version`; the sum over 2N."""

    def setup(self, in_shapes: list[Shape]) -> list[Shape]:
        return [()]

    def forward(self, bottoms):
        a = self.f(bottoms[0]).float()
        b = self.f(bottoms[1]).float()
        y = bottoms[2].float().reshape(-1)
        p = self.lp.contrastive_loss_param
        margin = p.margin if p else 1.0
        d2 = torch.sum(torch.square(a - b), dim=1)
        if p and p.legacy_version:
            dissim = torch.clamp(margin - d2, min=0.0)
        else:
            dissim = torch.square(torch.clamp(
                margin - torch.sqrt(d2 + 1e-12), min=0.0))
        per = y * d2 + (1.0 - y) * dissim
        return [torch.sum(per) / (2.0 * a.shape[0])]


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
            denom = _global_count(self, mask.sum().float()) / _ranks(self)
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
            tops.append(per_class / (_global_count(self, onehot.sum(dims))
                                     / _ranks(self)))
        return tops
