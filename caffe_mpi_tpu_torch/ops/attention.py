"""Single-device multi-head attention.

JAX package: caffe_mpi_tpu/ops/attention.py (`_block_attn`, `attention`).
`attention` computes scaled-dot-product attention over (B, S, H, D)
tensors with an optional causal mask. With `use_flash` it goes through
`ops/flash_attention.py` (K3 forward, K4/K5 backward on the card);
otherwise it is two products and a guarded softmax in torch ops, as the
JAX package leaves it to XLA.

Not ported yet (ROADMAP.md): `ring_attention`, `ring_flash_attention` and
`sequence_parallel_attention`, which need several devices.
"""

from __future__ import annotations

import math

import torch


def _block_attn(q, k, v, *, scale, mask=None):
    """One q-block x k-block attention with running-softmax stats.

    q: (B, Sq, H, D), k/v: (B, Sk, H, D). Returns (out_unnorm, row_max,
    row_sum) where out_unnorm = sum_j exp(s_ij - row_max) v_j; a fully
    masked row has row_max 0 and contributes zeros."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if mask is not None:
        s = torch.where(mask, s, -math.inf)
    m = s.amax(-1)                                  # (B, H, Sq)
    m_safe = torch.where(torch.isneginf(m), 0.0, m)
    p = torch.exp(s - m_safe[..., None])
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    l = p.sum(-1)                                   # (B, H, Sq)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v)
    return out, m_safe, l


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = False, use_flash: bool = False) -> torch.Tensor:
    """Single-device attention: q, k, v (B, S, H, D) -> (B, S, H, D).
    use_flash: the flash kernels (differentiable; lengths padded to their
    tiles and masked)."""
    if use_flash:
        from .flash_attention import flash_attention
        return flash_attention(q, k, v, causal=causal)
    scale = 1.0 / math.sqrt(q.shape[-1])
    mask = None
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        mask = torch.tril(torch.ones((sq, sk), dtype=torch.bool,
                                     device=q.device))[None, None]
    out, _, l = _block_attn(q, k, v, scale=scale, mask=mask)
    return out / torch.clamp(l, min=1e-30)[..., None].transpose(1, 2)
