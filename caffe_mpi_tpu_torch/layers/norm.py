"""Normalization layers: BatchNorm.

Reference: src/caffe/layers/batch_norm_layer.{cpp,cu} (NVCaffe); JAX
package caffe_mpi_tpu/layers/norm.py, which uses XLA's stock lowering, so
the port uses PyTorch's stock ops (cuDNN's batch norm on the card).

NVCaffe BatchNorm stores blobs [mean(C), var(C), correction(1), scale(C)?,
bias(C)?] (batch_norm_layer.cpp:39-60). The running statistics are state
buffers (`mean`, `var`, float32, zero at init); scale and bias are
params. In a TRAIN forward with batch statistics the buffers are updated
in place, `(1 - f) * batch + f * running` with f =
moving_average_fraction and the BIASED batch variance, as the JAX layer
returns its new state; every net holding the same buffers (test nets,
serving buckets) sees the update. eps is clamped to >= 1e-5.

Never hand `F.batch_norm` the running buffers in TRAIN: its own update
uses the unbiased variance and momentum = 1 - f. The batch-statistics
path normalises with the buffers left out and updates them itself, from
`torch.var_mean` of the detached input (`_update_running`), with no host
synchronisation.

Two designs compute the batch-statistics forward; `BATCH_STATS` picks one
(chip_smoke.py's resnet50 phase times both on ResNet-50):
- "fused": `F.batch_norm(x, None, None, scale, bias, training=True)`,
  cuDNN's fused forward and backward on the card (PyTorch's own fused
  kernels for a bfloat16 input, whose scale and bias are bfloat16 as the
  JAX layer casts them), plus one `torch.var_mean` pass in float32 for
  the update (float32 and bfloat16 inputs; others take the composite);
- "composite": the JAX layer's arithmetic as torch ops, the statistics
  from one `torch.var_mean` that serves both the normalisation and the
  update, autograd through each op.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..proto.config import BatchNormParameter, FillerParameter
from .base import Layer, Shape, register

DESIGNS = ("fused", "composite")
BATCH_STATS = "fused"
FUSED_DTYPES = (torch.float32, torch.bfloat16)


@register("BatchNorm")
class BatchNormLayer(Layer):
    def setup(self, in_shapes: list[Shape]) -> list[Shape]:
        p = self.lp.batch_norm_param or BatchNormParameter()
        self.p = p
        self.channels = in_shapes[0][1] if len(in_shapes[0]) > 1 else 1
        self.eps = max(p.eps, 1e-5)
        # scale_bias implicit-on when a filler is given
        # (batch_norm_layer.cpp:28-30)
        self.scale_bias = bool(p.scale_bias or p.has("scale_filler")
                               or p.has("bias_filler"))
        self.declare_state("mean", (self.channels,))
        self.declare_state("var", (self.channels,))
        if self.scale_bias:
            self.declare("scale", (self.channels,), p.scale_filler
                         or FillerParameter(type="constant", value=1.0))
            self.declare("bias", (self.channels,), p.bias_filler
                         or FillerParameter(type="constant", value=0.0))
        # use_global_stats: an explicit setting wins; else the phase
        # decides
        self.use_global = bool(p.use_global_stats) \
            if p.has("use_global_stats") else self.phase == "TEST"
        return [in_shapes[0]]

    def caffe_blobs(self):
        """mean, var, the variance-correction scalar, [scale, bias]
        (batch_norm_layer.cpp:39-60). The correction is written as 1 and
        divided out on import (BVLC models store mean and var scaled by
        it)."""
        blobs = [("state", "mean"), ("state", "var"), ("correction", "")]
        if self.scale_bias:
            blobs += [("param", "scale"), ("param", "bias")]
        return blobs

    def _affine(self):
        if not self.scale_bias:
            return None, None
        return self.f(self.scale), self.f(self.bias)

    def forward(self, bottoms):
        x = self.f(bottoms[0])
        scale, bias = self._affine()
        if self.use_global or not self.training:
            # frozen statistics: the gradient reaches x, scale and bias
            return [_normalize(x, self.mean, self.var, scale, bias,
                               self.eps)]
        dims = [i for i in range(x.dim()) if i != 1]
        f = self.p.moving_average_fraction
        if BATCH_STATS == "fused" and x.dtype in FUSED_DTYPES:
            y = F.batch_norm(x, None, None, scale, bias, training=True,
                             eps=self.eps)
            with torch.no_grad():
                var, mean = torch.var_mean(x.detach().float(), dims,
                                           correction=0)
                _update_running(self.mean, self.var, mean, var, f)
            return [y]
        var, mean = torch.var_mean(x.float(), dims, correction=0)
        with torch.no_grad():
            _update_running(self.mean, self.var, mean.detach(),
                            var.detach(), f)
        return [_normalize(x, mean, var, scale, bias, self.eps)]


def _normalize(x, mean, var, scale, bias, eps):
    """(x - mean) / sqrt(var + eps) [* scale + bias] over axis 1, in the
    JAX layer's order of operations: the statistics in f32, then cast to
    x's type."""
    shape = [1] * x.dim()
    shape[1] = x.shape[1] if x.dim() > 1 else 1
    inv_std = 1.0 / torch.sqrt(var + eps)
    y = (x - mean.reshape(shape).to(x.dtype)) \
        * inv_std.reshape(shape).to(x.dtype)
    if scale is not None:
        y = y * scale.reshape(shape) + bias.reshape(shape)
    return y


def _update_running(run_mean, run_var, mean, var, f):
    """The running update in place: (1 - f) * batch + f * running."""
    run_mean.copy_((1.0 - f) * mean + f * run_mean)
    run_var.copy_((1.0 - f) * var + f * run_var)
