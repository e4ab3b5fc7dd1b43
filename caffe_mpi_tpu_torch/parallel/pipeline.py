"""Pipeline parallelism over the mesh's 'model' axis: the port's
counterpart of the JAX package's caffe_mpi_tpu/parallel/pipeline.py.

Stages are structurally identical (one block, `num_stages` copies with
their own weights), so their params stack on a leading stage dim
(`stack_stage_params`). Under a mesh whose model axis has one rank a
stage, model rank s holds stage s only: the model memory is partitioned.

`pipeline_apply` runs the shift register of the JAX schedule: at tick t
stage s applies itself to microbatch t - s. Stage 0 reads microbatch t
from the input (which every model rank holds alike, as the layers before
the pipeline run replicated), every stage then passes its output one
rank down the ring (`MeshPlan.model_shift`, one send/recv pair a rank a
tick), and the last stage keeps what it finishes. Its outputs are
broadcast over the model ranks at the end, so the layers after the
pipeline run replicated too.

The JAX function is differentiated through `ppermute`; the port has no
such AD, so `_Pipeline` writes the backward by hand. Each rank keeps its
stage's local autograd graph for each microbatch, built from detached
inputs. The backward runs the reverse wavefront: at tick u stage s takes
microbatch u - (S - 1 - s), the last stage with its own copy of the
replicated output gradient (not a sum over the ranks: every rank holds
the same one), and every stage passes its input gradient one rank up the
ring. Stage 0's input gradients are broadcast over the model ranks, and
each rank's param gradients are its own stage's.
"""

from __future__ import annotations

import torch


def stack_stage_params(per_stage: list[dict]) -> dict:
    """[stage 0's {name: tensor}, stage 1's, ...] -> {name: (S, ...)};
    every stage must have the same names and shapes."""
    names = list(per_stage[0])
    for s, p in enumerate(per_stage):
        if list(p) != names or any(p[k].shape != per_stage[0][k].shape
                                   for k in names):
            raise ValueError(f"stage {s}'s params differ from stage 0's: "
                             "pipeline stages must be structurally "
                             "identical")
    return {k: torch.stack([p[k] for p in per_stage]) for k in names}


class _Pipeline(torch.autograd.Function):
    """forward(ctx, stage_fn, names, plan, need_grad, microbatches,
    *params) -> the outputs (M, ...) on every model rank. `params` are
    this rank's stage's tensors, in `names` order."""

    @staticmethod
    def forward(ctx, stage_fn, names, plan, need_grad, mb, *params):
        n, s = plan.n_model, plan.model_index
        m = mb.shape[0]
        last = s == n - 1
        if need_grad:
            leaves = [p.detach().requires_grad_(p.requires_grad)
                      for p in params]
        else:
            leaves = [p.detach() for p in params]
        stage = dict(zip(names, leaves))
        graphs = {}         # microbatch -> (its detached input, output)
        outs = torch.zeros_like(mb)
        held = torch.zeros_like(mb[0])   # what the previous stage sent
        for t in range(m + n - 1):
            j = t - s
            y = torch.zeros_like(mb[0])
            if 0 <= j < m:
                x = mb[j] if s == 0 else held
                x = x.detach().requires_grad_(need_grad)
                with torch.set_grad_enabled(need_grad):
                    y = stage_fn(stage, x)
                if need_grad:
                    graphs[j] = (x, y)
                y = y.detach()
                if last:
                    outs[j] = y
            if t < m + n - 2:
                held, = plan.model_shift([y], 1)
        plan.model_broadcast_(outs, n - 1)
        ctx.plan, ctx.graphs, ctx.leaves = plan, graphs, leaves
        return outs

    @staticmethod
    def backward(ctx, dout):
        plan, graphs, leaves = ctx.plan, ctx.graphs, ctx.leaves
        n, s = plan.n_model, plan.model_index
        m = dout.shape[0]
        want = [p for p in leaves if p.requires_grad]
        grads = [torch.zeros_like(p) for p in want]
        dx_all = torch.zeros_like(dout)
        held = torch.zeros_like(dout[0])  # the input gradient from s + 1
        for u in range(m + n - 1):
            j = u - (n - 1 - s)
            dx = torch.zeros_like(dout[0])
            if 0 <= j < m:
                # the last stage reads its own copy of the replicated
                # gradient; the others what stage s + 1 sent
                dy = dout[j] if s == n - 1 else held
                x, y = graphs.pop(j)
                got = torch.autograd.grad(y, [x, *want], dy,
                                          allow_unused=True)
                dx = got[0] if got[0] is not None else torch.zeros_like(x)
                for g, gp in zip(grads, got[1:]):
                    if gp is not None:
                        g.add_(gp)
                if s == 0:
                    dx_all[j] = dx
            if u < m + n - 2:
                held, = plan.model_shift([dx.contiguous()], -1)
        plan.model_broadcast_(dx_all, 0)
        it = iter(grads)
        pgrads = [next(it) if p.requires_grad else None for p in leaves]
        return (None, None, None, None, dx_all, *pgrads)


def pipeline_apply(stage_fn, stage_params: dict, microbatches: torch.Tensor,
                   plan) -> torch.Tensor:
    """Run a homogeneous stage stack pipelined over `plan`'s model axis.

    stage_fn(params, x) -> y      one stage, shape-preserving
    stage_params                  {name: tensor}: this rank's stage's
                                  params (model index s holds stage s)
    microbatches: (n_micro, ...)  alike on every model rank

    Returns (n_micro, ...) outputs on every model rank, equal to applying
    the stages in order to each microbatch. Every model rank calls it, in
    the same order."""
    if microbatches.shape[0] < 1:
        raise ValueError("need at least one microbatch")
    names = list(stage_params)
    params = [stage_params[k] for k in names]
    need_grad = torch.is_grad_enabled() and (
        microbatches.requires_grad or any(p.requires_grad for p in params))
    return _Pipeline.apply(stage_fn, names, plan, need_grad, microbatches,
                           *params)
