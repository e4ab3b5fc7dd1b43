"""Multi-head attention on one device and over a ring of model ranks.

JAX package: caffe_mpi_tpu/ops/attention.py. `attention` computes
scaled-dot-product attention over (B, S, H, D) tensors with an optional
causal mask. With `use_flash` it goes through `ops/flash_attention.py`
(K3 forward, K4/K5 backward on the card); otherwise it is two products
and a guarded softmax in torch ops, as the JAX package leaves it to XLA.

Sequence parallelism over the mesh's 'model' axis (a parallel.MeshPlan):
each model rank holds one (B, S/n, H, D) shard of q, k and v, and the
K/V shards make one trip around the ring (`MeshPlan.model_shift`, the
JAX `ppermute` j -> j - 1) while an online softmax merges the blocks.
The JAX functions are differentiated through `ppermute`; here each ring
is a `torch.autograd.Function` whose backward makes the same trip by
hand against the ring-merged (out, lse): every block's recomputed P is
then the global softmax restricted to the block, dQ sums over the blocks
and dK/dV ride the ring with K and V so that they end at their owner.

- `ring_attention`: the plain ring, the JAX function's forward (every
  block masked, none skipped, the (out, max, sum) merge), its backward in
  torch ops. The CPU path, and the card's reference for
- `ring_flash_attention`: each live block through `flash_block` (K3) and
  `flash_block_bwd` (K4, K5) as the JAX `_ring_flash` runs it:
  `_block_bias` masks the padded tail, `_block_pred` skips the blocks
  strictly in the causal future and the shards that are all padding (a
  correctness requirement: a fully masked flash block emits lse
  log(1e-30)), `_merge_blocks` merges in f32, and one global `delta`
  serves every block;
- `sequence_parallel_attention`: global (B, S, H, D) in, S padded to a
  multiple of the ring (or, under use_flash with shards over one tile,
  of n x 128), split over the ranks, the ring, the shards gathered back
  and the pad sliced off.
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


# ---------------------------------------------------------------------------
# Sequence parallelism: the ring over the mesh's 'model' axis
# ---------------------------------------------------------------------------

def _to_heads2(t):
    b, s, h, d = t.shape
    return t.permute(0, 2, 1, 3).reshape(b * h, s, d)


def _from_heads2(t2, b, h):
    bh, s, d = t2.shape
    return t2.reshape(b, h, s, d).permute(0, 2, 1, 3)


def _block_bias(src, s_loc, valid_len, device):
    """(1, s_loc) f32 additive score bias for the K/V block of ring
    position `src`: 0 for keys inside the global valid length, -inf for
    the tail padding (which lives in the last shard)."""
    cols = src * s_loc + torch.arange(s_loc, device=device)
    return torch.where(cols < valid_len, 0.0, -math.inf).to(
        torch.float32)[None, :]


def _block_pred(i, causal, my, src, s_loc, valid_len) -> bool:
    """Whether ring step i's K/V block contributes anything (the JAX
    `_block_pred`): not a causal block strictly in the future (i > 0, src
    > my), and not a shard that is all padding (src * s_loc >=
    valid_len)."""
    if causal and i > 0 and not src < my:
        return False
    return valid_len is None or src * s_loc < valid_len


def ring_flash_launches(n: int, causal: bool, s_loc: int,
                        valid_len: int | None = None) -> list[int]:
    """The blocks (K3 launches a forward, K4 and K5 a backward) each of
    the n ring positions runs, from `_block_pred`."""
    return [sum(_block_pred(i, causal, my, (my + i) % n, s_loc, valid_len)
                for i in range(n)) for my in range(n)]


def _merge_blocks(O, LSE, out_b, lse_b):
    """Online-softmax merge of a normalized block (out_b, lse_b) into the
    running (O, LSE), all f32; O (BH, S, D), LSE (BH, S)."""
    M = torch.maximum(LSE, lse_b)
    a = torch.exp(LSE - M)        # 0 at the -inf start
    bw = torch.exp(lse_b - M)
    denom = a + bw
    O = (O * a[..., None] + out_b * bw[..., None]) / denom[..., None]
    return O, M + torch.log(denom)


def _ring_mask(my, src, s_loc, causal, valid_len, device):
    """The plain ring's (S/n, S/n) block mask (ring_attention), or
    None."""
    a = torch.arange(s_loc, device=device)[:, None]
    col = torch.arange(s_loc, device=device)[None, :]
    mask = None
    if causal:
        mask = (my * s_loc + a) >= (src * s_loc + col)
    if valid_len is not None:
        ok = (src * s_loc + col) < valid_len
        mask = ok if mask is None else mask & ok
    return mask


def _plain_block_bwd(q2, kk, vv, do2, lse, delta, mask, scale):
    """One block's (dq, dk, dv) in f32 against the global (lse, delta):
    P = exp(s - lse) on the mask, dS = P (dO V^T - delta)."""
    qf, kf, vf, dof = q2.float(), kk.float(), vv.float(), do2.float()
    s = torch.matmul(qf, kf.transpose(1, 2)) * scale
    p = torch.exp(s - lse[..., None])
    if mask is not None:
        p = torch.where(mask[None], p, 0.0)
    dp = torch.matmul(dof, vf.transpose(1, 2))
    ds = p * (dp - delta[..., None])
    return (torch.matmul(ds, kf) * scale,
            torch.matmul(ds.transpose(1, 2), qf) * scale,
            torch.matmul(p.transpose(1, 2), dof))


def _ring_plain_fwd(q, k, v, plan, causal, valid_len):
    """The JAX `ring_attention` forward on the local (B, S/n, H, D)
    shards; returns (out, lse (B*H, S/n) f32)."""
    n, my = plan.n_model, plan.model_index
    b, s, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    out = torch.zeros_like(q)
    m = torch.full((b, h, s), -math.inf, dtype=q.dtype, device=q.device)
    l = torch.zeros((b, h, s), dtype=q.dtype, device=q.device)
    kk, vv = k, v
    for i in range(n):
        src = (my + i) % n
        mask = _ring_mask(my, src, s, causal, valid_len, q.device)
        blk_out, blk_m, blk_l = _block_attn(
            q, kk, vv, scale=scale,
            mask=None if mask is None else mask[None, None])
        new_m = torch.maximum(m, blk_m)
        alpha, beta = torch.exp(m - new_m), torch.exp(blk_m - new_m)
        l = l * alpha + blk_l * beta
        out = (out * alpha[..., None].transpose(1, 2)
               + blk_out * beta[..., None].transpose(1, 2))
        m = new_m
        if i < n - 1:
            kk, vv = plan.model_shift([kk, vv])
    l_safe = torch.clamp(l, min=1e-30)
    out = out / l_safe[..., None].transpose(1, 2)
    lse = (m + torch.log(l_safe)).float().reshape(b * h, s)
    return out, lse


def _ring_flash_fwd(q2, k2, v2, plan, causal, valid_len):
    """The JAX `_ring_flash_loop`: (O, LSE) f32 of the local rows."""
    from .flash_attention import flash_block
    n, my = plan.n_model, plan.model_index
    bh, s, d = q2.shape
    O = torch.zeros((bh, s, d), dtype=torch.float32, device=q2.device)
    LSE = torch.full((bh, s), -math.inf, dtype=torch.float32,
                     device=q2.device)
    kk, vv = k2, v2
    for i in range(n):
        src = (my + i) % n
        if _block_pred(i, causal, my, src, s, valid_len):
            bias = None if valid_len is None \
                else _block_bias(src, s, valid_len, q2.device)
            out_b, lse_b = flash_block(q2, kk, vv, causal=causal and i == 0,
                                       k_bias=bias)
            O, LSE = _merge_blocks(O, LSE, out_b.float(), lse_b)
        if i < n - 1:
            kk, vv = plan.model_shift([kk, vv])
    return O, LSE


class _Ring(torch.autograd.Function):
    """The ring over the model ranks, forward and backward; `flash`
    picks the blocks: K3 / K4 and K5 through the flash block API, or the
    plain torch blocks."""

    @staticmethod
    def forward(ctx, q, k, v, plan, causal, valid_len, flash):
        b, s, h, d = q.shape
        if flash:
            O, lse = _ring_flash_fwd(_to_heads2(q), _to_heads2(k),
                                     _to_heads2(v), plan, causal, valid_len)
            out = _from_heads2(O.to(q.dtype), b, h)
        else:
            out, lse = _ring_plain_fwd(q, k, v, plan, causal, valid_len)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.plan, ctx.causal, ctx.valid_len, ctx.flash = \
            plan, causal, valid_len, flash
        return out

    @staticmethod
    def backward(ctx, dout):
        from .flash_attention import _delta, flash_block_bwd
        q, k, v, out, lse = ctx.saved_tensors
        plan, causal, valid_len = ctx.plan, ctx.causal, ctx.valid_len
        n, my = plan.n_model, plan.model_index
        b, s, h, d = q.shape
        scale = 1.0 / math.sqrt(d)
        q2, k2, v2 = _to_heads2(q), _to_heads2(k), _to_heads2(v)
        out2 = _to_heads2(out).contiguous()
        do2 = _to_heads2(dout).contiguous()
        delta = _delta(do2, out2)   # global rowsum(dO * O), every block's
        dq = torch.zeros(q2.shape, dtype=torch.float32, device=q.device)
        dkk = torch.zeros(k2.shape, dtype=torch.float32, device=q.device)
        dvv = torch.zeros(v2.shape, dtype=torch.float32, device=q.device)
        kk, vv = k2.contiguous(), v2.contiguous()
        for i in range(n):
            src = (my + i) % n
            if ctx.flash:
                if _block_pred(i, causal, my, src, s, valid_len):
                    bias = None if valid_len is None \
                        else _block_bias(src, s, valid_len, q.device)
                    dq_i, dk_b, dv_b = flash_block_bwd(
                        q2, kk, vv, out2, lse, do2, causal=causal and i == 0,
                        k_bias=bias, delta=delta)
                    dq = dq + dq_i.float()
                    dkk = dkk + dk_b.float()
                    dvv = dvv + dv_b.float()
            else:
                mask = _ring_mask(my, src, s, causal, valid_len, q.device)
                dq_i, dk_b, dv_b = _plain_block_bwd(
                    q2, kk, vv, do2, lse, delta, mask, scale)
                dq, dkk, dvv = dq + dq_i, dkk + dk_b, dvv + dv_b
            # the K/V blocks and their gradient sums ride the ring
            # together: after n hops each dK/dV sum is back at the rank
            # that owns its shard (the last hop moves the sums only)
            if i < n - 1:
                kk, vv, dkk, dvv = plan.model_shift([kk, vv, dkk, dvv])
            else:
                dkk, dvv = plan.model_shift([dkk, dvv])
        return (_from_heads2(dq.to(q.dtype), b, h),
                _from_heads2(dkk.to(k.dtype), b, h),
                _from_heads2(dvv.to(v.dtype), b, h), None, None, None, None)


def ring_attention(q, k, v, plan, *, causal: bool = False,
                   valid_len: int | None = None) -> torch.Tensor:
    """Sequence-parallel attention on this model rank's (B, S/n, H, D)
    shards over `plan`'s model axis (every rank of it calls this, in the
    same order). valid_len: global key positions >= valid_len are
    padding, masked in every block. Differentiable."""
    return _Ring.apply(q, k, v, plan, bool(causal), valid_len, False)


def ring_flash_attention(q, k, v, plan, *, causal: bool = False,
                         valid_len: int | None = None) -> torch.Tensor:
    """ring_attention with flash blocks (K3; K4 and K5 in the backward):
    the local shard length must meet the flash tile rule (<= 128 or a
    multiple of 128), which sequence_parallel_attention's padding
    gives."""
    return _Ring.apply(q, k, v, plan, bool(causal), valid_len, True)


def sequence_parallel_attention(q, k, v, plan, *, causal: bool = False,
                                use_flash: bool = False) -> torch.Tensor:
    """q, k, v: (B, S, H, D), alike on the model ranks of one data index
    (the batch stays split over 'data'); S is split over the model axis,
    the ring runs, and the output is gathered back to (B, S, H, D). A
    length that does not divide is padded up to a multiple of the ring
    size, or under use_flash with shards over one tile of n x 128; the
    pad keys are masked and the pad rows sliced off."""
    from ..parallel import mesh as mesh_mod
    n = plan.n_model
    s = q.shape[1]
    if use_flash and -(-s // n) > 128:
        pad = (-s) % (n * 128)
    else:
        pad = (-s) % n
    valid_len = s if pad else None
    if pad:
        q, k, v = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad))
                   for t in (q, k, v))
    ql, kl, vl = (mesh_mod.split_to_model(t, plan, 1) for t in (q, k, v))
    ring = ring_flash_attention if use_flash else ring_attention
    out = ring(ql, kl, vl, plan, causal=causal, valid_len=valid_len)
    out = mesh_mod.gather_from_model(out, plan, 1)
    return out[:, :s] if pad else out
