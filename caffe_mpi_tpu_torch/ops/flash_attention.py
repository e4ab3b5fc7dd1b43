"""Flash attention, forward and backward: the CUDA kernels and their plain
versions.

Replaces the TPU kernels of `caffe_mpi_tpu/ops/flash_attention.py`
(Pallas): `_fwd_kernel` (K3), `_bwd_dq_kernel` (K4) and `_bwd_dkv_kernel`
(K5). On (B*H, S, D) tensors, scale = 1/sqrt(D):

    s   = (q . k) * scale [+ k_bias], -inf outside the mask
    O   = softmax(s) V,  lse = log sum exp(s)           (K3)
    P   = exp(s - lse),  dS = P * (dO . V^T - delta)
    dQ  = scale * dS K                                  (K4)
    dV  = P^T dO,  dK = scale * dS^T Q                  (K5)

with delta = rowsum(dO * O) in f32 (torch ops, as XLA computes it outside
Pallas). The mask of K3 and K4: key column < sk_valid, and row >= column
when causal. K5 takes the causal mask only: a padded query row carries
dO = 0 and padded key rows are sliced off by `flash_attention`, as in the
TPU kernel. A row with no unmasked key gets O = 0 and lse = log(1e-30).

Kernels: `flash_fwd` (K3), `flash_bwd_dq` (K4), `flash_bwd_dkv` (K5). For
tensors on the card each launches its kernel from `csrc/flash_attention.cu`
(float32 or bfloat16, any head dim, any lengths, any batch x heads: the
kernels put B*H on the grid's second axis, so the wrapper launches runs
of at most 65,535, each a launch); for tensors on the
CPU each takes its plain version (`*_ref`): plain torch, f32 math (f64 for
float64), over 64-wide key tiles with K3's online softmax. K3, K4 and K5
multiply on the tensor cores (3xTF32 for f32, bf16 with f32 operands
split in two), so on the card they agree with the plain versions to
rounding, not bitwise. There is no fallback: a CUDA tensor the kernels
cannot take, a failed build or a refused launch raises. Each of the three
has a `.launches` count, raised by one where it launches its kernel and
nowhere else.

Two kernels stand behind each entry, chosen by the head dim: up to
`TENSOR_CORE_HEAD_DIM` (128) the tensor-core kernels, whose tilings hold
a row group's accumulators in registers (K3 at D 128 takes 179 a thread);
past it the wide kernels (`*_wide_*` in the same source), one warp a row
with its accumulators in shared memory, on the CUDA cores in f32: any D,
as the JAX package takes, and slow (PERF.md). A wide launch is a K3, K4
or K5 launch and counts as one.

Entries, as in the JAX package:
- `flash_attention(q, k, v, causal=)`: (B, S, H, D) -> (B, S, H, D),
  differentiable through `_FlashFunction` (K3 forward; K4 and K5
  backward). Lengths over 128 are padded up to a multiple of 128 (the JAX
  package's `_pad_len`): padded key columns are masked by sk_valid,
  padded query rows sliced off.
- `flash_block`, `flash_block_bwd`: the raw (B*H, S, D) block API with an
  optional (1, Sk) f32 key bias (0 live, -inf masked), which ring
  attention (not ported yet) calls with the ring-merged (out, lse).
"""

from __future__ import annotations

import ctypes
import math

import torch

_KERNEL_SOURCE = "flash_attention.cu"
_FWD = {torch.float32: "flash_fwd_f32", torch.bfloat16: "flash_fwd_bf16"}
_DQ = {torch.float32: "flash_bwd_dq_f32", torch.bfloat16: "flash_bwd_dq_bf16"}
_DKV = {torch.float32: "flash_bwd_dkv_f32",
        torch.bfloat16: "flash_bwd_dkv_bf16"}
# the TPU kernels these replace, for reports
REPLACES = "caffe_mpi_tpu/ops/flash_attention.py:66 _fwd_kernel"
REPLACES_DQ = "caffe_mpi_tpu/ops/flash_attention.py:127 _bwd_dq_kernel"
REPLACES_DKV = "caffe_mpi_tpu/ops/flash_attention.py:168 _bwd_dkv_kernel"

TILE = 64        # the plain versions' key tile (the kernels take 16-128
                 # rows and 32-64 keys a warp)
PAD_TILE = 128   # the JAX package's tile, which sets the padding rule
TENSOR_CORE_HEAD_DIM = 128  # wider heads take the wide kernels (docstring)
MAX_GRID_Y = 65535  # batch x heads a launch: the grid's second axis


# -- shapes -------------------------------------------------------------------

def _check_tiles(sq: int, sk: int) -> tuple[int, int]:
    """The JAX package's rule for the block API: each length a multiple of
    min(128, length)."""
    bq, bk = min(PAD_TILE, sq), min(PAD_TILE, sk)
    if sq % bq or sk % bk:
        raise ValueError(f"sequence lengths ({sq},{sk}) must be multiples "
                         f"of the tile sizes ({bq},{bk})")
    return bq, bk


def _pad_len(s: int, tile: int = PAD_TILE) -> int:
    """A single short tile as it is; longer lengths round up to a tile
    multiple (the JAX package's padding rule)."""
    return s if s <= tile else -(-s // tile) * tile


def _check_block(q, k, v, k_bias) -> None:
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError(f"flash attention takes (B*H, S, D) tensors, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    bh, _, d = q.shape
    if k.shape[0] != bh or k.shape[2] != d or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} do not agree")
    if k_bias is not None and k_bias.numel() != k.shape[1]:
        raise ValueError(f"k_bias {tuple(k_bias.shape)} is not (1, "
                         f"{k.shape[1]})")
    devs = {t.device for t in (q, k, v)}
    if len(devs) != 1 or next(iter(devs)).type not in ("cuda", "cpu"):
        raise ValueError("flash attention: tensors on "
                         f"{sorted(map(str, devs))}, want one cuda or cpu "
                         "device")


def _math(x: torch.Tensor) -> torch.Tensor:
    """x in the plain versions' math type: f32, or f64 for a float64 x."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _delta(do: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """rowsum(dO * O) in f32 (f64 for float64): (B*H, Sq). Under bf16 it
    reads the bf16 output, as the JAX package's `_delta` does."""
    return (_math(do) * _math(out)).sum(-1)


# -- plain versions -----------------------------------------------------------

def _scores(qf, kf, c0, c1, scale, k_bias):
    s = torch.matmul(qf, kf[:, c0:c1].transpose(1, 2)) * scale
    if k_bias is not None:
        s = s + _math(k_bias).reshape(-1)[c0:c1]
    return s


def _cols(c0, c1, sq, device, causal, sk_valid=None):
    """The (Sq, c1 - c0) mask of key columns c0..c1: causal (row >= col)
    and, where sk_valid is given, col < sk_valid."""
    cols = torch.arange(c0, c1, device=device)[None, :]
    ok = torch.ones((sq, c1 - c0), dtype=torch.bool, device=device)
    if causal:
        ok = ok & (torch.arange(sq, device=device)[:, None] >= cols)
    if sk_valid is not None:
        ok = ok & (cols < sk_valid)
    return ok


def flash_fwd_ref(q, k, v, *, causal=False, sk_valid=None, k_bias=None):
    """Plain K3, any device: (out in q's dtype, lse f32 (B*H, Sq)). The
    kernel's online softmax over 64-wide key tiles, all query rows at
    once (a tile the kernel skips is fully masked, and a fully masked
    tile changes nothing here)."""
    _check_block(q, k, v, k_bias)
    bh, sq, d = q.shape
    sk = k.shape[1]
    sk_valid = sk if sk_valid is None else sk_valid
    qf, kf, vf = _math(q), _math(k), _math(v)
    scale = 1.0 / math.sqrt(d)
    out = torch.zeros_like(qf)
    m = torch.full((bh, sq), -math.inf, dtype=qf.dtype, device=q.device)
    l = torch.zeros((bh, sq), dtype=qf.dtype, device=q.device)
    for c0 in range(0, sk_valid, TILE):
        c1 = min(c0 + TILE, sk)
        ok = _cols(c0, c1, sq, q.device, causal, sk_valid)
        s = torch.where(ok, _scores(qf, kf, c0, c1, scale, k_bias),
                        -math.inf)
        m_new = torch.maximum(m, s.amax(-1))
        m_use = torch.where(torch.isneginf(m_new), 0.0, m_new)
        alpha = torch.exp(m - m_use)
        p = torch.exp(s - m_use[..., None])
        l = l * alpha + p.sum(-1)
        out = out * alpha[..., None] + torch.matmul(p, vf[:, c0:c1])
        m = m_new
    l_safe = torch.clamp(l, min=1e-30)
    lse = torch.where(torch.isneginf(m), 0.0, m) + torch.log(l_safe)
    return (out / l_safe[..., None]).to(q.dtype), lse.to(
        torch.promote_types(q.dtype, torch.float32))


def _probs(qf, kf, lse, c0, c1, scale, k_bias, ok):
    s = _scores(qf, kf, c0, c1, scale, k_bias)
    return torch.where(ok, torch.exp(s - lse[..., None]), 0.0)


def flash_bwd_dq_ref(q, k, v, do, lse, delta, *, causal=False,
                     sk_valid=None, k_bias=None):
    """Plain K4, any device: dQ in q's dtype, over the kernel's key tiles
    with the forward's mask."""
    _check_block(q, k, v, k_bias)
    d = q.shape[2]
    sk = k.shape[1]
    sk_valid = sk if sk_valid is None else sk_valid
    qf, kf, vf, dof = _math(q), _math(k), _math(v), _math(do)
    lse, delta = _math(lse).reshape(q.shape[:2]), _math(delta).reshape(
        q.shape[:2])
    scale = 1.0 / math.sqrt(d)
    dq = torch.zeros_like(qf)
    for c0 in range(0, sk_valid, TILE):
        c1 = min(c0 + TILE, sk)
        ok = _cols(c0, c1, q.shape[1], q.device, causal, sk_valid)
        p = _probs(qf, kf, lse, c0, c1, scale, k_bias, ok)
        dp = torch.matmul(dof, vf[:, c0:c1].transpose(1, 2))
        dq = dq + torch.matmul(p * (dp - delta[..., None]), kf[:, c0:c1])
    return (dq * scale).to(q.dtype)


def flash_bwd_dkv_ref(q, k, v, do, lse, delta, *, causal=False,
                      k_bias=None):
    """Plain K5, any device: (dK, dV) in k's and v's dtypes. The causal
    mask only, as the TPU kernel: no sk_valid mask."""
    _check_block(q, k, v, k_bias)
    d = q.shape[2]
    sk = k.shape[1]
    qf, kf, vf, dof = _math(q), _math(k), _math(v), _math(do)
    lse, delta = _math(lse).reshape(q.shape[:2]), _math(delta).reshape(
        q.shape[:2])
    scale = 1.0 / math.sqrt(d)
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    for c0 in range(0, sk, TILE):
        c1 = min(c0 + TILE, sk)
        ok = _cols(c0, c1, q.shape[1], q.device, causal)
        p = _probs(qf, kf, lse, c0, c1, scale, k_bias, ok)
        dp = torch.matmul(dof, vf[:, c0:c1].transpose(1, 2))
        ds = p * (dp - delta[..., None])
        dv[:, c0:c1] = torch.matmul(p.transpose(1, 2), dof)
        dk[:, c0:c1] = torch.matmul(ds.transpose(1, 2), qf)
    return (dk * scale).to(k.dtype), dv.to(v.dtype)


# -- the kernels --------------------------------------------------------------

_I, _F, _P = ctypes.c_int, ctypes.c_float, ctypes.c_void_p


def _check_bwd(q, do, lse, delta) -> None:
    rows = q.shape[0] * q.shape[1]
    if do.shape != q.shape or lse.numel() != rows or delta.numel() != rows:
        raise ValueError(f"flash backward: do {tuple(do.shape)}, lse "
                         f"{tuple(lse.shape)}, delta {tuple(delta.shape)} "
                         f"do not fit q {tuple(q.shape)}")


def _kernel(table: dict, name: str, q, tensors, k_bias, argtypes):
    """The C function for q's dtype and head dim (the wide kernel past
    TENSOR_CORE_HEAD_DIM), after the checks the kernels need."""
    from . import build
    fn_name = table.get(q.dtype)
    if fn_name is None:
        raise TypeError(f"{name} kernel takes float32 or bfloat16, got "
                        f"{q.dtype}")
    for t in tensors:
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name}: every tensor must be {q.dtype} on "
                             f"{q.device}, got {t.dtype} on {t.device}")
    if q.shape[2] < 1:
        raise ValueError(f"{name} kernel takes head dims from 1, got "
                         f"{q.shape[2]}")
    if q.shape[2] > TENSOR_CORE_HEAD_DIM:
        fn_name = fn_name.replace(f"{name}_", f"{name}_wide_")
    if k_bias is not None and (k_bias.dtype != torch.float32
                               or k_bias.device != q.device):
        raise ValueError(f"{name}: k_bias must be float32 on {q.device}")
    fn = getattr(build.load(_KERNEL_SOURCE), fn_name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _bh_chunks(bh: int) -> list[tuple[int, int]]:
    """(first head, heads) of each launch: runs of at most MAX_GRID_Y."""
    return [(i, min(MAX_GRID_Y, bh - i)) for i in range(0, bh, MAX_GRID_Y)]


def _run(fn, counter, blocks, bh, rest, device):
    """Launch `fn` once a chunk of batch x heads (`_bh_chunks`), raising
    `counter.launches` (the entry point's) by one a launch. `blocks` are
    the pointer arguments
    as (tensor or None, elements a head) pairs, each moved on to the
    chunk's first head; `rest` the arguments after BH."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        for b0, m in _bh_chunks(bh):
            ptrs = [None if t is None
                    else t.data_ptr() + b0 * per * t.element_size()
                    for t, per in blocks]
            err = fn(*ptrs, m, *rest, stream)
            if err != 0:
                raise RuntimeError(f"{counter.__name__} kernel launch "
                                   f"failed: cudaError {err}")
            counter.launches += 1


def _bias(k_bias):
    return None if k_bias is None else k_bias.contiguous().reshape(-1)


def _launch_fwd(q, k, v, causal, sk_valid, k_bias):
    fn = _kernel(_FWD, "flash_fwd", q, (k, v), k_bias,
                 [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P])
    q, k, v, k_bias = q.contiguous(), k.contiguous(), v.contiguous(), \
        _bias(k_bias)
    bh, sq, d = q.shape
    sk = k.shape[1]
    out = torch.empty_like(q)
    lse = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    _run(fn, flash_fwd,
         [(q, sq * d), (k, sk * d), (v, sk * d), (k_bias, 0), (out, sq * d),
          (lse, sq)], bh,
         (sq, sk, d, sk_valid, int(causal), 1.0 / math.sqrt(d)), q.device)
    return out, lse


def _launch_dq(q, k, v, do, lse, delta, causal, sk_valid, k_bias):
    fn = _kernel(_DQ, "flash_bwd_dq", q, (k, v, do), k_bias,
                 [_P] * 8 + [_I] * 6 + [_F, _P])
    q, k, v, do = (t.contiguous() for t in (q, k, v, do))
    lse, delta = (t.float().contiguous() for t in (lse, delta))
    k_bias = _bias(k_bias)
    bh, sq, d = q.shape
    sk = k.shape[1]
    dq = torch.empty_like(q)
    if dq.numel() == 0:
        return dq
    _run(fn, flash_bwd_dq,
         [(q, sq * d), (k, sk * d), (v, sk * d), (do, sq * d), (lse, sq),
          (delta, sq), (k_bias, 0), (dq, sq * d)], bh,
         (sq, sk, d, sk_valid, int(causal), 1.0 / math.sqrt(d)), q.device)
    return dq


def _launch_dkv(q, k, v, do, lse, delta, causal, k_bias):
    fn = _kernel(_DKV, "flash_bwd_dkv", q, (k, v, do), k_bias,
                 [_P] * 9 + [_I] * 5 + [_F, _P])
    q, k, v, do = (t.contiguous() for t in (q, k, v, do))
    lse, delta = (t.float().contiguous() for t in (lse, delta))
    k_bias = _bias(k_bias)
    bh, sq, d = q.shape
    sk = k.shape[1]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if dk.numel() == 0:
        return dk, dv
    _run(fn, flash_bwd_dkv,
         [(q, sq * d), (k, sk * d), (v, sk * d), (do, sq * d), (lse, sq),
          (delta, sq), (k_bias, 0), (dk, sk * d), (dv, sk * d)], bh,
         (sq, sk, d, int(causal), 1.0 / math.sqrt(d)), q.device)
    return dk, dv


def _sk_valid(k, sk_valid):
    sk = k.shape[1]
    if sk_valid is None:
        return sk
    if not 0 <= sk_valid <= sk:
        raise ValueError(f"sk_valid {sk_valid} outside 0..{sk}")
    return int(sk_valid)


def flash_fwd(q, k, v, *, causal=False, sk_valid=None, k_bias=None):
    """K3: (B*H, Sq, D) x (B*H, Sk, D) -> (out in q's dtype, lse f32
    (B*H, Sq)). On the card: the CUDA kernel (the tensor-core one up to D
    128, the wide one past it); on the CPU: the plain version."""
    _check_block(q, k, v, k_bias)
    sk_valid = _sk_valid(k, sk_valid)
    if q.device.type == "cuda":
        return _launch_fwd(q, k, v, bool(causal), sk_valid, k_bias)
    return flash_fwd_ref(q, k, v, causal=causal, sk_valid=sk_valid,
                         k_bias=k_bias)


def flash_bwd_dq(q, k, v, do, lse, delta, *, causal=False, sk_valid=None,
                 k_bias=None):
    """K4: dQ from the global (lse, delta) of these query rows. On the
    card the kernel is chosen by D, as for K3."""
    _check_block(q, k, v, k_bias)
    _check_bwd(q, do, lse, delta)
    sk_valid = _sk_valid(k, sk_valid)
    if q.device.type == "cuda":
        return _launch_dq(q, k, v, do, lse, delta, bool(causal), sk_valid,
                          k_bias)
    return flash_bwd_dq_ref(q, k, v, do, lse, delta, causal=causal,
                            sk_valid=sk_valid, k_bias=k_bias)


def flash_bwd_dkv(q, k, v, do, lse, delta, *, causal=False, k_bias=None):
    """K5: (dK, dV) from the global (lse, delta) of the query rows. On
    the card the kernel is chosen by D, as for K3."""
    _check_block(q, k, v, k_bias)
    _check_bwd(q, do, lse, delta)
    if q.device.type == "cuda":
        return _launch_dkv(q, k, v, do, lse, delta, bool(causal), k_bias)
    return flash_bwd_dkv_ref(q, k, v, do, lse, delta, causal=causal,
                             k_bias=k_bias)


flash_fwd.launches = 0
flash_bwd_dq.launches = 0
flash_bwd_dkv.launches = 0


# -- entries ------------------------------------------------------------------

def _bwd(q, k, v, out, lse, do, causal, sk_valid=None, k_bias=None,
         delta=None):
    if delta is None:
        delta = _delta(do, out)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, causal=causal,
                      sk_valid=sk_valid, k_bias=k_bias)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, causal=causal,
                           k_bias=k_bias)
    return dq, dk, dv


def flash_block(q, k, v, *, causal=False, k_bias=None):
    """(B*H, Sq, D) x (B*H, Sk, D) -> (normalized out, lse). k_bias: (1, Sk)
    f32, 0 for live keys and -inf for masked ones."""
    _check_tiles(q.shape[1], k.shape[1])
    return flash_fwd(q, k, v, causal=causal, k_bias=k_bias)


def flash_block_bwd(q, k, v, out, lse, do, *, causal=False, k_bias=None,
                    delta=None):
    """Backward of one block against the GLOBAL (out, lse) of its query
    rows: (dq_partial, dk_block, dv_block)."""
    _check_tiles(q.shape[1], k.shape[1])
    return _bwd(q, k, v, out, lse, do, causal, k_bias=k_bias, delta=delta)


class _FlashFunction(torch.autograd.Function):
    """K3 forward, K4 and K5 backward on the card; the plain trio on the
    CPU. Residuals: q, k, v, out and lse."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sk_valid):
        out, lse = flash_fwd(q, k, v, causal=causal, sk_valid=sk_valid)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.sk_valid = causal, sk_valid
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _bwd(q, k, v, out, lse, do.contiguous(), ctx.causal,
                          ctx.sk_valid)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False) -> torch.Tensor:
    """q, k, v: (B, S, H, D) -> (B, S, H, D), differentiable. Lengths over
    128 are padded to a multiple of 128: padded key columns are masked,
    padded query rows sliced off (their gradients vanish through the zero
    cotangent). Any head dim, any B*H and any lengths are taken (module
    docstring)."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    sq_p, sk_p = _pad_len(sq), _pad_len(sk)
    if sq_p != sq:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, sq_p - sq))
    if sk_p != sk:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, sk_p - sk))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, sk_p - sk))
    qt = q.permute(0, 2, 1, 3).reshape(b * h, sq_p, d)
    kt = k.permute(0, 2, 1, 3).reshape(b * h, sk_p, d)
    vt = v.permute(0, 2, 1, 3).reshape(b * h, sk_p, d)
    out = _FlashFunction.apply(qt, kt, vt, bool(causal),
                               sk if sk_p != sk else None)
    out = out.reshape(b, h, sq_p, d).permute(0, 2, 1, 3)
    return out[:, :sq] if sq_p != sq else out
