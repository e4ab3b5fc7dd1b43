"""The arithmetic of the tensor-core flash-attention backward (K4, K5 in
`caffe_mpi_tpu_torch/csrc/flash_attention.cu`), emulated in numpy on the
CPU and held to `chip_smoke.py`'s FLASH_TOL against the plain versions.

The kernels feed their `mma.sync` products with:
- f32 inputs: 3xTF32. x = big + small: big is x with its low 13
  mantissa bits cleared (a TF32 value, exact), small = x - big rounded to
  nearest TF32 (ties away, as `cvt.rna.tf32.f32`); a product keeps
  small.big' + big.small' + big.big', summed in f32.
- bf16 inputs: Q K^T and dO V^T multiply the bf16 values as they are
  (their products are exact in f32); an f32 operand (P or dS) meeting a
  bf16 one is split into hi = bf16(x), lo = bf16(x - hi), two products.

A product of two TF32 (11-bit) or bf16 (8-bit) significands is exact in
f32, so an f32 numpy product of the rounded parts is the tensor core's
product; the sums differ from the card's in order only. The limit is
FLASH_TOL as chip_smoke.py holds the card to it: f32 rtol 1e-5 plus 1e-5
of the largest element, bf16 rtol 8e-3 (one bf16 ulp). A single TF32 pass
fails the f32 limit, so the limit has teeth.
"""

import math

import numpy as np
import pytest
import torch

import chip_smoke
from caffe_mpi_tpu_torch.ops import flash_attention as pf

# the same block shapes as tests/test_torch_flash_attention.py, and a
# training length
BLOCKS = [(3, 64, 16), (2, 256, 32), (2, 128, 20)]
LONG = (2, 1024, 64)


def tf32(x):
    """Round f32 to TF32 (10 stored mantissa bits), to nearest, ties away
    from zero: cvt.rna.tf32.f32."""
    b = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((b + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def tf32_trunc(x):
    """f32 cut to TF32 by clearing its low 13 mantissa bits: what the
    tensor cores do with an f32 they are given, and the kernels' big part."""
    b = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return (b & np.uint32(0xFFFFE000)).view(np.float32)


def bf16(x):
    """Round f32 to bf16, to nearest even, kept as f32."""
    b = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    rnd = ((b >> np.uint32(16)) & np.uint32(1)) + np.uint32(0x7FFF)
    return ((b + rnd) & np.uint32(0xFFFF0000)).view(np.float32)


def mm_3xtf32(a, b):
    ab, bb = tf32_trunc(a), tf32_trunc(b)
    as_, bs = tf32(a - ab), tf32(b - bb)
    return (as_ @ bb + ab @ bs) + ab @ bb


def mm_1xtf32(a, b):
    """One TF32 product of f32 operands, as the tensor cores take them."""
    return tf32_trunc(a) @ tf32_trunc(b)


def mm_bf16_exact(a, b):
    """bf16 x bf16, both already bf16 values: the f32 product is exact."""
    return a @ b


def mm_bf16_split(a, b):
    """An f32 left operand split into two bf16 parts against a bf16 one."""
    hi = bf16(a)
    return bf16(a - hi) @ b + hi @ b


SCHEMES = {"3xtf32": (mm_3xtf32, mm_3xtf32),
           "1xtf32": (mm_1xtf32, mm_1xtf32),
           "bf16": (mm_bf16_exact, mm_bf16_split)}


def emulate(q, k, v, do, lse, delta, causal, sk_valid, bias, scheme):
    """dQ, dK, dV as the kernels form them, on (BH, S, D) f32 arrays:
    `ss` multiplies two input operands, `cs` an f32 P or dS by one."""
    ss, cs = SCHEMES[scheme]
    bh, s, d = q.shape
    scale = np.float32(1.0 / math.sqrt(d))
    row = np.arange(s)[:, None]
    col = np.arange(s)[None, :]
    live = np.ones((s, s), bool) if not causal else row >= col
    sc = np.stack([ss(q[i], k[i].T) for i in range(bh)]) * scale
    if bias is not None:
        sc = sc + bias[None, None, :]
    dp = np.stack([ss(do[i], v[i].T) for i in range(bh)])
    out = []
    for mask in (live & (col < sk_valid), live):  # K4's mask, K5's
        with np.errstate(over="ignore", invalid="ignore"):
            p = np.where(mask, np.exp(sc - lse[..., None]), np.float32(0))
        out.append((p.astype(np.float32),
                    (p * (dp - delta[..., None])).astype(np.float32)))
    (_, ds4), (p5, ds5) = out
    dq = np.stack([cs(ds4[i], k[i]) for i in range(bh)]) * scale
    dk = np.stack([cs(ds5[i].T, q[i]) for i in range(bh)]) * scale
    dv = np.stack([cs(p5[i].T, do[i]) for i in range(bh)])
    return dq, dk, dv


def within(got, want, dtype):
    """chip_smoke's _flash_close check, on arrays: (holds, max abs err)."""
    rtol, share = chip_smoke.FLASH_TOL[dtype]
    w = want.float().numpy()
    diff = np.abs(got - w)
    limit = share * np.abs(w).max() + rtol * np.abs(w)
    return bool(np.all(diff <= limit)), float(diff.max())


def _case(shape, dtype, causal, seed, sk_valid=None, with_bias=False):
    bh, s, d = shape
    rs = np.random.RandomState(seed)
    arrs = [rs.randn(bh, s, d).astype(np.float32) for _ in range(4)]
    if sk_valid is not None:
        for a in arrs:
            a[:, sk_valid:] = 0
    if dtype == torch.bfloat16:
        arrs = [bf16(a) for a in arrs]
    q, k, v, do = (torch.from_numpy(a).to(dtype) for a in arrs)
    kb = None
    if with_bias:
        b = np.zeros(s, np.float32)
        b[:128] = np.linspace(-1.0, 1.0, 128)
        b[128:] = -np.inf
        kb = torch.from_numpy(b).reshape(1, s)
    o, lse = pf.flash_fwd_ref(q, k, v, causal=causal, sk_valid=sk_valid,
                              k_bias=kb)
    delta = pf._delta(do, o)
    refs = (pf.flash_bwd_dq_ref(q, k, v, do, lse, delta, causal=causal,
                                sk_valid=sk_valid, k_bias=kb),
            *pf.flash_bwd_dkv_ref(q, k, v, do, lse, delta, causal=causal,
                                  k_bias=kb))
    scheme = "3xtf32" if dtype == torch.float32 else "bf16"
    args = (*arrs, lse.numpy(), delta.numpy().astype(np.float32), causal,
            s if sk_valid is None else sk_valid,
            None if kb is None else kb.numpy()[0])
    return args, refs, scheme


def _held(args, refs, scheme, dtype, keep):
    grads = emulate(*args, scheme)
    if dtype == torch.bfloat16:  # stored in the input type
        grads = [bf16(g) for g in grads]
    return [within(g[:, rows], r[:, rows], dtype)
            for g, r, rows in zip(grads, refs, keep)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", BLOCKS + [LONG])
def test_split_products_meet_flash_tol(shape, causal, dtype):
    """dQ, dK, dV from the kernels' split products meet FLASH_TOL against
    flash_bwd_dq_ref / flash_bwd_dkv_ref."""
    args, refs, scheme = _case(shape, dtype, causal, seed=sum(shape))
    every = slice(None)
    for name, (ok, err) in zip(("dQ", "dK", "dV"),
                               _held(args, refs, scheme, dtype,
                                     (every,) * 3)):
        assert ok, f"{name} {scheme}: max abs err {err:.3g}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
def test_split_products_with_padding_and_a_bias(causal, dtype):
    """The masks: S 256 padded past sk_valid 200 (K5's rows past it are
    sliced off by flash_attention, as chip_smoke compares them), and a key
    bias masking the second 128-wide tile."""
    args, refs, scheme = _case((2, 256, 32), dtype, causal, seed=7,
                               sk_valid=200)
    keep = (slice(None), slice(0, 200), slice(0, 200))
    assert all(ok for ok, _ in _held(args, refs, scheme, dtype, keep))
    args, refs, scheme = _case((2, 256, 32), dtype, causal, seed=8,
                               with_bias=True)
    assert all(ok for ok, _ in _held(args, refs, scheme, dtype,
                                     (slice(None),) * 3))


def test_a_single_tf32_pass_fails_the_f32_limit():
    """One TF32 product (what the tensor cores give for plain f32 inputs)
    misses FLASH_TOL's f32 limit at a training length; 3xTF32 meets it."""
    args, refs, _ = _case(LONG, torch.float32, True, seed=1)
    every = (slice(None),) * 3
    one = _held(args, refs, "1xtf32", torch.float32, every)
    three = _held(args, refs, "3xtf32", torch.float32, every)
    assert not any(ok for ok, _ in one), one
    assert all(ok for ok, _ in three), three
    assert min(err for _, err in one) > 10 * max(err for _, err in three)


def test_the_roundings_are_the_hardwares():
    """tf32 keeps 10 mantissa bits rounding ties away from zero, or cuts
    the rest; bf16 keeps 7 rounding ties to even; a split's parts sum back
    to x within the second part's own rounding."""
    one = np.float32(1.0)
    ulp_tf32, ulp_bf16 = 2.0 ** -10, 2.0 ** -7
    x = np.array([1 + ulp_tf32 / 2, -(1 + ulp_tf32 / 2), 1 + ulp_tf32 / 4],
                 np.float32)
    assert tf32(x).tolist() == [1 + ulp_tf32, -(1 + ulp_tf32), 1.0]
    y = np.array([1 + ulp_bf16 / 2, 1 + 1.5 * ulp_bf16], np.float32)
    assert bf16(y).tolist() == [1.0, 1 + 2 * ulp_bf16]
    assert tf32_trunc(x).tolist() == [1.0, -1.0, 1.0]
    r = np.random.RandomState(0).randn(1000).astype(np.float32)
    big = tf32_trunc(r)
    assert np.all(r - big == (r.astype(np.float64) - big))  # exact
    assert np.all(np.abs(r - big - tf32(r - big)) <= np.abs(r) * 2.0 ** -22)
    hi = bf16(r)
    assert np.all(np.abs(r - hi - bf16(r - hi)) <= np.abs(r) * 2.0 ** -15)
    assert tf32(np.array([one]))[0] == one
