"""Normalization layers: BatchNorm, MVN.

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

Under data parallelism (`Net.bind_mesh`, more than one rank) the TRAIN
batch statistics are the global batch's, as the JAX mesh computes them
over the whole sharded batch: `_GlobalBatchNorm`, an autograd Function.
Its forward all-gathers each rank's per-channel (mean, M2) and merges
them in rank order (Chan's pairwise rule, every rank the same sums), so
the normalisation and the running update use the global mean and biased
variance on every rank. Its backward all-reduces the per-channel sums
of dy and dy·x̂ and forms dx from the global means; the scale and bias
gradients stay the rank's own sums, which the solver's gradient reduce
averages like any other.
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
        mesh = self.mesh_plan
        if mesh is not None and mesh.n_data > 1:
            y, mean, var = _GlobalBatchNorm.apply(x, scale, bias, self.eps,
                                                  mesh)
            with torch.no_grad():
                _update_running(self.mean, self.var, mean, var, f)
            return [y]
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


class _GlobalBatchNorm(torch.autograd.Function):
    """Batch normalisation with the statistics of the global batch, over
    the ranks of `mesh`. Returns (y, mean, var); mean and var (float32,
    per channel) feed the running update and take no gradient."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps, mesh):
        dims = [i for i in range(x.dim()) if i != 1]
        xf = x.float()
        n = xf.numel() // xf.shape[1]
        var_l, mean_l = torch.var_mean(xf, dims, correction=0)
        parts = mesh.all_gather(torch.stack([mean_l, var_l * n]))
        means, m2s = parts[:, 0], parts[:, 1]
        mean = means.mean(0)
        var = (m2s.sum(0) + n * torch.square(means - mean).sum(0)) \
            / (n * mesh.n_data)
        shape = [1] * x.dim()
        shape[1] = x.shape[1]
        inv_std = 1.0 / torch.sqrt(var + eps)
        xhat = (x - mean.reshape(shape).to(x.dtype)) \
            * inv_std.reshape(shape).to(x.dtype)
        y = xhat if scale is None \
            else xhat * scale.reshape(shape) + bias.reshape(shape)
        ctx.save_for_backward(xhat, inv_std, scale)
        ctx.mesh, ctx.dims, ctx.count = mesh, dims, n * mesh.n_data
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        xhat, inv_std, scale = ctx.saved_tensors
        dims, shape = ctx.dims, [1] * xhat.dim()
        shape[1] = xhat.shape[1]
        dyf, xh = dy.float(), xhat.float()
        local = torch.stack([dyf.sum(dims), (dyf * xh).sum(dims)])
        sums = ctx.mesh.all_reduce_(local.clone()) / ctx.count
        g = inv_std if scale is None else inv_std * scale.float()
        dx = g.reshape(shape) * (dyf - sums[0].reshape(shape)
                                 - xh * sums[1].reshape(shape))
        dscale = dbias = None
        if scale is not None:
            dscale, dbias = (local[1].to(scale.dtype),
                             local[0].to(scale.dtype))
        return dx.to(dy.dtype), dscale, dbias, None, None


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


@register("MVN")
class MVNLayer(Layer):
    """Mean-variance normalization of each item (mvn_layer.cpp): subtract
    the mean over the spatial axes (and the channels under
    `across_channels`), then, under `normalize_variance`, divide by the
    std + eps (eps added to the std, as the reference and the JAX layer
    do, not to the variance)."""

    def setup(self, in_shapes: list[Shape]) -> list[Shape]:
        from ..proto.config import MVNParameter
        self.p = self.lp.mvn_param or MVNParameter()
        return [in_shapes[0]]

    def forward(self, bottoms):
        x = self.f(bottoms[0])
        nd = x.dim()
        if self.p.across_channels:
            dims = tuple(range(1, nd))
        else:
            dims = tuple(range(2, nd)) if nd > 2 else (1,)
        y = x - torch.mean(x, dim=dims, keepdim=True)
        if self.p.normalize_variance:
            std = torch.sqrt(torch.mean(torch.square(y), dim=dims,
                                        keepdim=True))
            y = y / (std + self.p.eps)
        return [y]
