"""Port parity: the flash-attention kernels' plain versions (K3 forward, K4
dQ, K5 dK/dV), the port's `flash_attention` with its autograd, and the
plain `attention`, against the JAX package's Pallas kernels run in
interpret mode on the CPU (caffe_mpi_tpu/ops/flash_attention.py) and its
`attention`.

On the CPU the port's wrappers take the plain versions, which follow the
CUDA kernels' online softmax over 64-wide key tiles; the Pallas kernels
take 128-wide tiles. Both compute in f32, so the sums differ in order
only. Tolerances:
- O: rtol 1e-5 / atol 1e-6; lse: atol 1e-5 (a log of a sum of up to 256
  terms of size ~1, rounded in other orders);
- dQ, dK, dV: rtol 1e-5 / atol 1e-5 (products over the whole sequence);
- bf16 inputs: rtol 8e-3 (one bf16 ulp), atol 1e-6 / 1e-5 as in f32;
- gradients through `flash_attention` and `attention`: rtol 1e-5 /
  atol 1e-5.
"""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caffe_mpi_tpu.ops import attention as jax_attn
from caffe_mpi_tpu.ops import flash_attention as jf
from caffe_mpi_tpu.ops import lrn as jax_lrn
from caffe_mpi_tpu_torch.ops import attention as port_attn
from caffe_mpi_tpu_torch.ops import build
from caffe_mpi_tpu_torch.ops import flash_attention as pf
from caffe_mpi_tpu_torch.ops import lrn as lrn_op

O_TOL = dict(rtol=1e-5, atol=1e-6)
LSE_TOL = dict(rtol=0, atol=1e-5)
GRAD_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=8e-3, atol=1e-6)

# (BH, S, D) block shapes: one tile, two JAX tiles (four of the port's),
# and a head dim that is not a multiple of 16
BLOCKS = [(3, 64, 16), (2, 256, 32), (2, 128, 20)]


def _inputs(shape, seed, n=4, scale=1.0):
    rs = np.random.RandomState(seed)
    return [(rs.randn(*shape) * scale).astype(np.float32) for _ in range(n)]


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _jax_fwd_bwd(q, k, v, do, causal, k_bias=None):
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    jb = None if k_bias is None else jnp.asarray(k_bias)
    o, lse = jf.flash_block(jq, jk, jv, causal=causal, k_bias=jb,
                            interpret=True)
    grads = jf.flash_block_bwd(jq, jk, jv, o, lse, jdo, causal=causal,
                               k_bias=jb, interpret=True)
    return np.asarray(o), np.asarray(lse)[:, 0], [np.asarray(g)
                                                  for g in grads]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", BLOCKS)
def test_plain_kernels_match_the_pallas_kernels(shape, causal):
    q, k, v, do = _inputs(shape, seed=shape[1] + causal)
    o, lse, (dq, dk, dv) = _jax_fwd_bwd(q, k, v, do, causal)
    po, plse = pf.flash_fwd(*_t(q, k, v), causal=causal)
    np.testing.assert_allclose(po.numpy(), o, **O_TOL)
    np.testing.assert_allclose(plse.numpy(), lse, **LSE_TOL)
    tq, tk, tv, tdo = _t(q, k, v, do)
    delta = pf._delta(tdo, po)
    pdq = pf.flash_bwd_dq(tq, tk, tv, tdo, plse, delta, causal=causal)
    pdk, pdv = pf.flash_bwd_dkv(tq, tk, tv, tdo, plse, delta, causal=causal)
    for got, want in ((pdq, dq), (pdk, dk), (pdv, dv)):
        np.testing.assert_allclose(got.numpy(), want, **GRAD_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_bf16_inputs_match_within_one_ulp(causal):
    q, k, v, do = (a.astype(jnp.bfloat16) for a in
                   _inputs((2, 128, 32), seed=5 + causal))
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    o, lse = jf._fwd_impl(jq, jk, jv, causal, True)
    dq, dk, dv = jf._bwd_impl(jq, jk, jv, o, lse, jdo, causal, True)
    tq, tk, tv, tdo = (torch.from_numpy(np.asarray(a, np.float32))
                       .to(torch.bfloat16) for a in (q, k, v, do))
    po, plse = pf.flash_fwd(tq, tk, tv, causal=causal)
    assert po.dtype == torch.bfloat16 and plse.dtype == torch.float32
    np.testing.assert_allclose(po.float().numpy(),
                               np.asarray(o, np.float32), **BF16_TOL)
    np.testing.assert_allclose(plse.numpy(), np.asarray(lse)[:, 0],
                               **LSE_TOL)
    # the backward from the JAX forward's residuals (its bf16 O and f32
    # lse), so the kernels alone are compared
    pdq, pdk, pdv = pf._bwd(tq, tk, tv,
                            torch.from_numpy(np.asarray(o, np.float32))
                            .to(torch.bfloat16),
                            torch.from_numpy(np.asarray(lse)[:, 0]), tdo,
                            causal)
    for got, want in ((pdq, dq), (pdk, dk), (pdv, dv)):
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), rtol=8e-3,
                                   atol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_k_bias_masking_a_whole_tile(causal):
    """flash_block with a (1, Sk) bias: -inf over the second 128-wide tile
    (two of the port's tiles) and graded values elsewhere."""
    q, k, v, do = _inputs((2, 256, 16), seed=11)
    bias = np.zeros((1, 256), np.float32)
    bias[0, :128] = np.linspace(-1.0, 1.0, 128)
    bias[0, 128:] = -np.inf
    o, lse, (dq, dk, dv) = _jax_fwd_bwd(q, k, v, do, causal, bias)
    tq, tk, tv, tdo = _t(q, k, v, do)
    tb = torch.from_numpy(bias)
    po, plse = pf.flash_block(tq, tk, tv, causal=causal, k_bias=tb)
    np.testing.assert_allclose(po.numpy(), o, **O_TOL)
    np.testing.assert_allclose(plse.numpy(), lse, **LSE_TOL)
    grads = pf.flash_block_bwd(tq, tk, tv, po, plse, tdo, causal=causal,
                               k_bias=tb)
    for got, want in zip(grads, (dq, dk, dv)):
        np.testing.assert_allclose(got.numpy(), want, **GRAD_TOL)
    # the masked keys get exactly zero dK and dV
    assert not grads[1][:, 128:].any() and not grads[2][:, 128:].any()


def test_fully_masked_rows_give_zero_output_and_the_clamped_lse():
    """Every key biased out: O = 0 and lse = log(1e-30) with no NaN, in
    both packages (the ring's merge depends on that value)."""
    q, k, v, do = _inputs((2, 128, 16), seed=12)
    bias = np.full((1, 128), -np.inf, np.float32)
    o, lse, grads = _jax_fwd_bwd(q, k, v, do, False, bias)
    po, plse = pf.flash_block(*_t(q, k, v), k_bias=torch.from_numpy(bias))
    assert not po.any() and not o.any()
    np.testing.assert_allclose(plse.numpy(), lse, **LSE_TOL)
    np.testing.assert_allclose(plse.numpy(), math.log(1e-30), rtol=1e-6)
    pgrads = pf.flash_block_bwd(*_t(q, k, v), po, plse,
                                torch.from_numpy(do),
                                k_bias=torch.from_numpy(bias))
    for got, want in zip(pgrads, grads):
        assert np.isfinite(got.numpy()).all()
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("causal", [True, False])
def test_padded_lengths_forward_and_gradients(causal):
    """S = 160 through flash_attention: padded to 256, with the sk_valid
    mask in K3 and K4 and none in K5; the output slice and the gradients
    with respect to the unpadded inputs."""
    q, k, v, w = _inputs((2, 160, 2, 16), seed=21 + causal)

    def jloss(a, b, c):
        return jnp.sum(jf.flash_attention(a, b, c, causal=causal,
                                          interpret=True) * w)

    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want = jf.flash_attention(jq, jk, jv, causal=causal, interpret=True)
    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    got = pf.flash_attention(tq, tk, tv, causal=causal)
    assert tuple(got.shape) == (2, 160, 2, 16)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **O_TOL)
    (got * torch.from_numpy(w)).sum().backward()
    for t, g in zip((tq, tk, tv), jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), **GRAD_TOL)


def test_padded_block_through_the_kernels_entry_points():
    """The block entries of a padded call: K3 and K4 take sk_valid, K5
    none; rows of dK and dV past sk_valid are what the JAX kernel leaves
    there too."""
    q, k, v, do = _inputs((2, 256, 16), seed=31)
    k[:, 200:] = v[:, 200:] = q[:, 200:] = do[:, 200:] = 0.0
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    o, lse = jf._fwd_impl(jq, jk, jv, True, True, sk_valid=200)
    dq, dk, dv = jf._bwd_impl(jq, jk, jv, o, lse, jdo, True, True,
                              sk_valid=200)
    tq, tk, tv, tdo = _t(q, k, v, do)
    po, plse = pf.flash_fwd(tq, tk, tv, causal=True, sk_valid=200)
    np.testing.assert_allclose(po.numpy(), np.asarray(o), **O_TOL)
    np.testing.assert_allclose(plse.numpy(), np.asarray(lse)[:, 0],
                               **LSE_TOL)
    grads = pf._bwd(tq, tk, tv, po, plse, tdo, True, sk_valid=200)
    for got, want in zip(grads, (dq, dk, dv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **GRAD_TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("seq", [16, 64])
def test_autograd_through_flash_attention_matches_jax_grad(seq, causal):
    """The path's own call: (B, S, H, D) = (2, seq, 2, 16), one tile; the
    port's autograd Function against jax.grad through the custom_vjp."""
    q, k, v, w = _inputs((2, seq, 2, 16), seed=seq + causal)

    def jloss(a, b, c):
        return jnp.sum(jf.flash_attention(a, b, c, causal=causal,
                                          interpret=True) * w)

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray,
                                                     (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = pf.flash_attention(tq, tk, tv, causal=causal)
    assert out.grad_fn is not None
    (out * torch.from_numpy(w)).sum().backward()
    for t, g in zip((tq, tk, tv), jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), **GRAD_TOL)


@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_matches_jax(causal, use_flash):
    """ops.attention with and without use_flash against the JAX
    `attention` (jnp path), forward and gradients."""
    q, k, v, w = _inputs((2, 24, 3, 8), seed=41 + causal)

    def jloss(a, b, c):
        return jnp.sum(jax_attn.attention(a, b, c, causal=causal) * w)

    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want = jax_attn.attention(jq, jk, jv, causal=causal)
    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    got = port_attn.attention(tq, tk, tv, causal=causal, use_flash=use_flash)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **O_TOL)
    (got * torch.from_numpy(w)).sum().backward()
    for t, g in zip((tq, tk, tv), jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), **GRAD_TOL)


def test_block_attn_guards_fully_masked_rows():
    q, k, v = _inputs((1, 4, 2, 8), seed=51, n=3)
    mask = np.ones((1, 1, 4, 4), bool)
    mask[..., 1, :] = False
    jo, jm, jl = jax_attn._block_attn(*map(jnp.asarray, (q, k, v)),
                                      scale=0.5, mask=jnp.asarray(mask))
    po, pm, pl = port_attn._block_attn(*_t(q, k, v), scale=0.5,
                                       mask=torch.from_numpy(mask))
    for got, want in ((po, jo), (pm, jm), (pl, jl)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **O_TOL)
    assert float(pm[0, 0, 1]) == 0.0 and not po[0, 1].any()


def test_cpu_calls_take_the_plain_versions_and_launch_nothing():
    before = (pf.flash_fwd.launches, pf.flash_bwd_dq.launches,
              pf.flash_bwd_dkv.launches)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_()
                  for a in _inputs((1, 8, 1, 4), seed=61, n=3))
    pf.flash_attention(tq, tk, tv, causal=True).sum().backward()
    assert (pf.flash_fwd.launches, pf.flash_bwd_dq.launches,
            pf.flash_bwd_dkv.launches) == before
    assert tq.grad is not None and tk.grad.abs().sum() > 0


def test_block_api_checks_its_inputs():
    q, k, v = _t(*_inputs((2, 64, 8), seed=71, n=3))
    with pytest.raises(ValueError, match="multiples"):
        pf.flash_block(q[:, :40], torch.cat([k, k, k], 1),
                       torch.cat([v, v, v], 1))
    with pytest.raises(ValueError, match="do not agree"):
        pf.flash_fwd(q, k[:1], v[:1])
    with pytest.raises(ValueError, match="k_bias"):
        pf.flash_fwd(q, k, v, k_bias=torch.zeros(1, 63))
    with pytest.raises(ValueError, match="sk_valid"):
        pf.flash_fwd(q, k, v, sk_valid=65)
    with pytest.raises(ValueError, match="do not fit"):
        pf.flash_bwd_dq(q, k, v, q[:, :10], torch.zeros(2, 64),
                        torch.zeros(2, 64))


@pytest.mark.parametrize("s,want", [(1, 1), (64, 64), (128, 128), (129, 256),
                                    (160, 256), (256, 256), (300, 384)])
def test_padding_rule_is_the_jax_packages(s, want):
    assert pf._pad_len(s) == jf._pad_len(s, jf.BQ) == want


@pytest.mark.parametrize("cite,fn", [
    (pf.REPLACES, jf._fwd_kernel), (pf.REPLACES_DQ, jf._bwd_dq_kernel),
    (pf.REPLACES_DKV, jf._bwd_dkv_kernel),
    (lrn_op.REPLACES, jax_lrn._fwd_kernel),
    (lrn_op.REPLACES_BWD, jax_lrn._bwd_kernel)])
def test_replaces_cites_the_tpu_kernels_line(cite, fn):
    """Each kernel's report names its TPU kernel by file, line and name."""
    where, name = cite.split()
    path, line = where.split(":")
    assert fn.__name__ == name
    assert fn.__code__.co_firstlineno == int(line)
    assert fn.__code__.co_filename.endswith(path)


def test_cuda_source_holds_the_three_kernels_and_is_built():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "caffe_mpi_tpu_torch", "csrc",
        "flash_attention.cu")
    with open(path) as f:
        src = f.read()
    for fn in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        for dtype in ("f32", "bf16"):
            assert f"int {fn}_{dtype}(" in src
            assert f"int {fn}_wide_{dtype}(" in src
    for kernel in ("_fwd_kernel", "_bwd_dq_kernel", "_bwd_dkv_kernel"):
        assert kernel in src
    assert "flash_attention.cu" in build.SOURCES


@pytest.mark.parametrize("bh", [1, 65535, 65536, 70000, 3 * 65535 + 7])
def test_heads_past_the_grid_axis_are_launched_in_runs(bh):
    """B*H sits on the kernels' grid y axis (65,535 at most): the wrapper
    cuts it into runs that cover every head once, each at most that."""
    chunks = pf._bh_chunks(bh)
    assert [c[0] for c in chunks] == list(range(0, bh, pf.MAX_GRID_Y))
    assert sum(m for _, m in chunks) == bh
    assert all(1 <= m <= 65535 for _, m in chunks)
    assert len(chunks) == -(-bh // 65535)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [160, 256])
def test_plain_kernels_match_the_pallas_kernels_at_wide_heads(d, causal):
    """Past the tensor-core kernels' 128 the card takes the wide kernels,
    held against these plain versions; here the plain K3, K4 and K5 at
    D 160 and 256 against the Pallas kernels, with a ragged sk_valid (S
    256, 200 valid: K3 and K4 take the mask, K5 none)."""
    q, k, v, do = _inputs((2, 256, d), seed=d + causal, scale=0.5)
    for t in (q, k, v, do):
        t[:, 200:] = 0.0
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    o, lse = jf._fwd_impl(jq, jk, jv, causal, True, sk_valid=200)
    dq, dk, dv = jf._bwd_impl(jq, jk, jv, o, lse, jdo, causal, True,
                              sk_valid=200)
    tq, tk, tv, tdo = _t(q, k, v, do)
    po, plse = pf.flash_fwd(tq, tk, tv, causal=causal, sk_valid=200)
    np.testing.assert_allclose(po.numpy(), np.asarray(o), **O_TOL)
    np.testing.assert_allclose(plse.numpy(), np.asarray(lse)[:, 0],
                               **LSE_TOL)
    grads = pf._bwd(tq, tk, tv, po, plse, tdo, causal, sk_valid=200)
    for got, want in zip(grads, (dq, dk, dv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **GRAD_TOL)


@pytest.mark.parametrize("d,wide", [(128, False), (129, True), (256, True)])
def test_each_head_dim_reaches_its_kernels_entry_point(d, wide,
                                                       monkeypatch):
    """The wrappers with the built library replaced by recorders: up to
    D 128 the tensor-core entry points, past it the wide ones, with the
    same arguments and one counted launch each."""
    import contextlib
    import types
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=7))
    calls = []

    def recorder(fn_name):
        def fn(*args):
            calls.append((fn_name, args))
            return 0
        fn.argtypes = None
        return fn

    names = [f"{fn}{w}_{dt}" for fn in ("flash_fwd", "flash_bwd_dq",
                                        "flash_bwd_dkv")
             for w in ("", "_wide") for dt in ("f32", "bf16")]
    lib = types.SimpleNamespace(**{n: recorder(n) for n in names})
    monkeypatch.setattr(build, "load", lambda source: lib)
    q = torch.zeros(3, 8, d)
    lse = torch.zeros(3, 8)
    counts = [f.launches for f in (pf.flash_fwd, pf.flash_bwd_dq,
                                   pf.flash_bwd_dkv)]
    pf._launch_fwd(q, q, q, True, 8, None)
    pf._launch_dq(q, q, q, q, lse, lse, True, 8, None)
    pf._launch_dkv(q, q, q, q, lse, lse, True, None)
    suffix = "_wide_f32" if wide else "_f32"
    assert [c[0] for c in calls] == [f"flash_fwd{suffix}",
                                     f"flash_bwd_dq{suffix}",
                                     f"flash_bwd_dkv{suffix}"]
    for fn_name, args in calls:
        assert args[-1] == 7 and d in args
    assert [f.launches for f in (pf.flash_fwd, pf.flash_bwd_dq,
                                 pf.flash_bwd_dkv)] == [c + 1 for c in counts]
    for f, c in zip((pf.flash_fwd, pf.flash_bwd_dq, pf.flash_bwd_dkv),
                    counts):
        f.launches = c
    assert pf.TENSOR_CORE_HEAD_DIM == 128
    assert not hasattr(pf, "MAX_HEAD_DIM")


def test_a_launch_cut_into_head_runs_moves_each_pointer_and_counts(
        monkeypatch):
    """The flash wrappers' launch loop with the C function replaced by a
    recorder and runs of 2 heads: each run of heads moves every pointer
    by its own per-head stride (none for the shared key bias) and is one
    counted launch."""
    import contextlib
    import types
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: types.SimpleNamespace(cuda_stream=7))
    monkeypatch.setattr(pf, "MAX_GRID_Y", 2)
    calls = []
    q, lse = torch.zeros(5, 4, 8), torch.zeros(5, 4)
    kb = torch.zeros(1, 6)
    before = pf.flash_fwd.launches
    pf._run(lambda *a: calls.append(a) or 0, pf.flash_fwd,
            [(q, 4 * 8), (kb, 0), (None, 0), (lse, 4)], 5, (4, 6), "cpu")
    assert pf.flash_fwd.launches == before + 3
    assert calls == [(q.data_ptr() + b * 4 * 8 * 4, kb.data_ptr(), None,
                      lse.data_ptr() + b * 4 * 4, m, 4, 6, 7)
                     for b, m in ((0, 2), (2, 2), (4, 1))]
    pf.flash_fwd.launches = before
