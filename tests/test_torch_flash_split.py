"""The arithmetic of the tensor-core flash-attention kernels (the forward
K3 and the backward K4, K5 in `caffe_mpi_tpu_torch/csrc/flash_attention.cu`),
emulated in numpy on the CPU and held to `chip_smoke.py`'s FLASH_TOL
against the plain versions.

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

K3 is emulated with the kernel's tiling as its launcher picks it: key
tiles of BN keys a warp (64, or 32 from head dim 64 up and for split row
groups), the online softmax a tile, each tile's P V summed apart and
added as O = O * alpha + tile, and, where the grid is small (one row
group a block), two warps each taking half of every tile with their own
(m, l, O), merged at the end rescaled to the common max.
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


SMS = 132  # the H100 SXM's SMs, which the launcher's choice of W reads


def kernel_tiles(bh, s):
    """K3's (BN, SPLIT) as its launcher picks them for BH heads of S rows,
    at any head dim and type: W the largest of 8, 4, 2 row groups whose
    grid gives every SM a block, else 1 with two warps a row group taking
    32 keys each; one warp a row group takes 64."""
    w = next((w for w in (8, 4, 2) if -(-s // (16 * w)) * bh >= SMS), 1)
    return (32, 2) if w == 1 else (64, 1)


def emulate_fwd(q, k, v, causal, sk_valid, bias, scheme, bn, split):
    """(O, lse) as K3 forms them, on (BH, S, D) f32 arrays: the scores by
    `ss`, P V by `cs` (P an f32 operand), over key tiles of bn x split
    keys, warp `part` taking keys [part * bn, (part + 1) * bn) of each."""
    ss, cs = SCHEMES[scheme]
    bh, sq, d = q.shape
    sk = k.shape[1]
    scale = np.float32(1.0 / math.sqrt(d))
    rows = np.arange(sq)[:, None]
    f32 = np.float32
    st = [[np.full((bh, sq), -np.inf, f32), np.zeros((bh, sq), f32),
           np.zeros((bh, sq, d), f32)] for _ in range(split)]
    with np.errstate(over="ignore", invalid="ignore", divide="ignore"):
        for t0 in range(0, sk_valid, bn * split):
            for part, (m, l, acc) in enumerate(st):
                c0 = t0 + part * bn
                c1 = min(c0 + bn, sk)
                if c0 >= c1:
                    continue
                cols = np.arange(c0, c1)[None, :]
                ok = cols < sk_valid
                if causal:
                    ok = ok & (rows >= cols)
                s = np.stack([ss(q[i], k[i, c0:c1].T)
                              for i in range(bh)]) * scale
                if bias is not None:
                    s = s + bias[None, None, c0:c1]
                s = np.where(ok, s, f32(-np.inf)).astype(f32)
                m_new = np.maximum(m, s.max(-1))
                m_use = np.where(m_new == -np.inf, f32(0), m_new)
                alpha = np.exp(m - m_use)
                p = np.exp(s - m_use[..., None]).astype(f32)
                pv = np.stack([cs(p[i], v[i, c0:c1]) for i in range(bh)])
                st[part] = [m_new, (l * alpha + p.sum(-1)).astype(f32),
                            (acc * alpha[..., None] + pv).astype(f32)]
        m, l, acc = st[0]
        for m1, l1, acc1 in st[1:]:  # the split warps' merge
            m_new = np.maximum(m, m1)
            mu = np.where(m_new == -np.inf, f32(0), m_new)
            a0, a1 = np.exp(m - mu), np.exp(m1 - mu)
            l = (l * a0 + l1 * a1).astype(f32)
            acc = (acc * a0[..., None] + acc1 * a1[..., None]).astype(f32)
            m = m_new
    l_safe = np.maximum(l, f32(1e-30))
    lse = np.where(m == -np.inf, f32(0), m) + np.log(l_safe)
    return (acc / l_safe[..., None]).astype(f32), lse.astype(f32)


def _fwd_case(shape, dtype, causal, seed, sk_valid=None, with_bias=False):
    """Inputs made with numpy, the plain forward's (O, lse), and the
    emulation's arguments."""
    bh, s, d = shape
    rs = np.random.RandomState(seed)
    arrs = [rs.randn(bh, s, d).astype(np.float32) for _ in range(3)]
    if sk_valid is not None:
        for a in arrs:
            a[:, sk_valid:] = 0
    if dtype == torch.bfloat16:
        arrs = [bf16(a) for a in arrs]
    kb = None
    if with_bias:
        b = np.zeros(s, np.float32)
        b[:128] = np.linspace(-1.0, 1.0, 128)
        b[128:] = -np.inf
        kb = torch.from_numpy(b).reshape(1, s)
    q, k, v = (torch.from_numpy(a).to(dtype) for a in arrs)
    ref = pf.flash_fwd_ref(q, k, v, causal=causal, sk_valid=sk_valid,
                           k_bias=kb)
    args = (*arrs, causal, s if sk_valid is None else sk_valid,
            None if kb is None else kb.numpy()[0])
    return args, ref


def _fwd_held(args, ref, scheme, dtype, bn, split):
    o, lse = emulate_fwd(*args, scheme, bn, split)
    if dtype == torch.bfloat16:  # O stored in the input type
        o = bf16(o)
    return [within(o, ref[0], dtype), within(lse, ref[1], torch.float32)]


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


@pytest.mark.parametrize("tiling", ["launcher", "one_warp"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", BLOCKS + [LONG])
def test_fwd_split_products_meet_flash_tol(shape, causal, dtype, tiling):
    """K3's O and lse from its split products (3xTF32; bf16 Q K^T as it
    is and P split hi/lo), key tiles, per-tile sums and rescale, meet
    FLASH_TOL against flash_fwd_ref: with the launcher's tiling (two warps
    a row group at these small grids, merged) and with one warp a row
    group over the same BN."""
    bn, split = kernel_tiles(*shape[:2])
    if tiling == "one_warp":
        split = 1
    args, ref = _fwd_case(shape, dtype, causal, seed=sum(shape) + 1)
    scheme = "3xtf32" if dtype == torch.float32 else "bf16"
    for name, (ok, err) in zip(("O", "lse"), _fwd_held(args, ref, scheme,
                                                       dtype, bn, split)):
        assert ok, f"{name} {scheme} bn {bn} split {split}: max abs err " \
            f"{err:.3g}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
def test_fwd_split_products_with_padding_and_a_bias(causal, dtype):
    """K3's masks: S 256 padded past sk_valid 200, and a key bias masking
    the second 128-wide tile, at the launcher's tiling and at BN 64."""
    shape = (2, 256, 32)
    scheme = "3xtf32" if dtype == torch.float32 else "bf16"
    for tiles in (kernel_tiles(*shape[:2]), (64, 1)):
        args, ref = _fwd_case(shape, dtype, causal, seed=9, sk_valid=200)
        held = _fwd_held(args, ref, scheme, dtype, *tiles)
        assert all(ok for ok, _ in held), (tiles, held)
        args, ref = _fwd_case(shape, dtype, causal, seed=10, with_bias=True)
        held = _fwd_held(args, ref, scheme, dtype, *tiles)
        assert all(ok for ok, _ in held), (tiles, held)


def test_fwd_a_single_tf32_pass_fails_the_f32_limit():
    """K3 with one TF32 product for Q K^T and P V misses FLASH_TOL's f32
    limit at a training length; 3xTF32 meets it."""
    args, ref = _fwd_case(LONG, torch.float32, True, seed=2)
    tiles = kernel_tiles(*LONG[:2])
    one = _fwd_held(args, ref, "1xtf32", torch.float32, *tiles)
    three = _fwd_held(args, ref, "3xtf32", torch.float32, *tiles)
    assert not one[0][0], one
    assert all(ok for ok, _ in three), three
    assert one[0][1] > 10 * three[0][1]


def test_kernel_tiles_follow_the_launcher():
    """The emulated tiling is the launcher's: the path's shape splits,
    a long sequence takes 8 row groups and one warp each."""
    assert kernel_tiles(32, 64) == (32, 2)
    assert kernel_tiles(32, 2048) == (64, 1)
    assert kernel_tiles(32, 256) == (64, 1)
    assert kernel_tiles(8, 100) == (32, 2)
