"""Mixture-of-Experts FFN on one device.

JAX package: caffe_mpi_tpu/ops/moe.py (`moe_ffn`, `moe_ffn_dense_reference`),
the GShard dispatch/combine formulation:

  router:   logits = x @ gate -> softmax -> top-k experts per token
            (argmax takes the first maximum; experts already chosen are
            masked to -inf for the next pick)
  capacity: each expert takes at most C tokens, in token order (a cumsum
            of the one-hot choices); overflow tokens are dropped from that
            expert (combine weight zero)
  dispatch: one-hot (T, E, C) from the routing decision itself, not from
            combine > 0; expert inputs = einsum to (E, C, F)
  experts:  per-expert 2-layer ReLU FFN as batched (E, ...) einsums
  combine:  gate-weighted einsum back to (T, F)

The gradient reaches `gate` through the chosen gate weights and the aux
loss's mean probabilities only (routing and dispatch are integer or
boolean). The products are torch ops (cuBLAS on the card), as the JAX
package leaves them to XLA.

Not ported yet (ROADMAP.md): expert parallelism (`shard_experts`, the
`mesh=` argument).
"""

from __future__ import annotations

import math

import torch


def moe_ffn(params: dict, x: torch.Tensor, *, top_k: int = 1,
            capacity_factor: float = 2.0):
    """x: (T, F) tokens -> ((T, F), aux), aux the Switch/GShard
    load-balancing loss n_experts * sum_e(frac_tokens_e * mean_prob_e)."""
    t, _ = x.shape
    e = params["w1"].shape[0]
    cap = max(int(capacity_factor * top_k * t / e), top_k)
    cap = min(cap, t)

    logits = x @ params["gate"]                      # (T, E)
    probs = torch.softmax(logits, dim=-1)

    slots = torch.arange(cap, device=x.device)
    combine = torch.zeros((t, e, cap), dtype=x.dtype, device=x.device)
    dispatch_m = torch.zeros((t, e, cap), dtype=torch.bool, device=x.device)
    counts = torch.zeros((e,), dtype=torch.long, device=x.device)
    for choice in _route(logits, top_k).unbind(1):
        onehot = torch.nn.functional.one_hot(choice, e)
        pos = counts[None, :] + torch.cumsum(onehot, dim=0) - onehot
        keep = (onehot > 0) & (pos < cap)
        gate_w = torch.gather(probs, 1, choice[:, None])[:, 0]
        slot = keep[:, :, None] & (pos[:, :, None] == slots)
        combine = combine + slot.to(x.dtype) * gate_w[:, None, None]
        dispatch_m = dispatch_m | slot
        counts = counts + (onehot * keep).sum(0)

    dispatch = dispatch_m.to(x.dtype)                # (T, E, C)
    xe = torch.einsum("tec,tf->ecf", dispatch, x)
    h = torch.relu(torch.einsum("ecf,efh->ech", xe, params["w1"])
                   + params["b1"][:, None, :])
    ye = torch.einsum("ech,ehf->ecf", h, params["w2"]) \
        + params["b2"][:, None, :]
    y = torch.einsum("tec,ecf->tf", combine, ye)     # back to tokens

    frac_tokens = (dispatch.sum(2) > 0).float().mean(0)
    frac_probs = probs.mean(0)
    aux = (frac_tokens * frac_probs).sum() * e
    return y, aux


def _route(logits: torch.Tensor, top_k: int) -> torch.Tensor:
    """The experts each token picks, in pick order: (T, top_k) int64.
    Each pick is the first maximum of the logits with the experts already
    picked masked to -inf (capacity drops come after, in moe_ffn)."""
    logits = logits.detach()
    picked = torch.zeros_like(logits, dtype=torch.bool)
    choices = []
    for _ in range(top_k):
        choice = torch.argmax(torch.where(picked, -math.inf, logits), dim=-1)
        choices.append(choice)
        picked = picked | torch.nn.functional.one_hot(
            choice, logits.shape[1]).bool()
    return torch.stack(choices, dim=1)


def routing(params: dict, x: torch.Tensor, *, top_k: int = 1
            ) -> torch.Tensor:
    """The routes of moe_ffn for tokens x (before capacity drops): (T,
    top_k) expert ids — for comparing routes across devices."""
    return _route(x @ params["gate"], top_k)


def moe_ffn_dense_reference(params: dict, x: torch.Tensor, *,
                            top_k: int = 1) -> torch.Tensor:
    """Unbatched per-expert loop, no capacity limit — the numerical oracle
    for tests (matches moe_ffn when no token overflows)."""
    logits = x @ params["gate"]
    probs = torch.softmax(logits, dim=-1)
    e = params["w1"].shape[0]
    topi = torch.topk(logits, top_k, dim=-1).indices
    y = torch.zeros_like(x)
    for kk in range(top_k):
        idx = topi[:, kk]
        gate_w = torch.gather(probs, 1, idx[:, None])[:, 0]
        for ei in range(e):
            sel = idx == ei
            h = torch.relu(x @ params["w1"][ei] + params["b1"][ei])
            out = h @ params["w2"][ei] + params["b2"][ei]
            y = y + torch.where(sel[:, None], out * gate_w[:, None], 0.0)
    return y
