"""Port parity: across-channel LRN (caffe_mpi_tpu_torch/ops/lrn.py).

The port's plain LRN — the version its wrapper takes for a CPU tensor —
against the JAX package's Pallas kernel (caffe_mpi_tpu/ops/lrn.py
_fwd_kernel, run in interpret mode as the JAX suite runs it on the CPU) and
against the JAX LRNLayer's f32 lax path, on the same numpy inputs.

Tolerances: float32 at rtol 1e-5 / atol 1e-6 (same f32 math, sums and
exp/log in another order and library); bfloat16 I/O compared in float32 at
one bf16 ulp (rtol 8e-3 > 2^-7), since both compute in f32 and round once.
The CUDA kernel itself is held against the same plain version on the card
by chip_smoke.py.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caffe_mpi_tpu.core.types import DtypePolicy as JaxPolicy
from caffe_mpi_tpu.layers import create_layer as jax_create_layer
from caffe_mpi_tpu.ops.lrn import lrn_across_channels as jax_lrn_kernel
from caffe_mpi_tpu.proto import LayerParameter as JaxLP
from caffe_mpi_tpu_torch.core.types import DtypePolicy
from caffe_mpi_tpu_torch.layers import create_layer
from caffe_mpi_tpu_torch.ops import lrn as lrn_op
from caffe_mpi_tpu_torch.proto import LayerParameter

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [(2, 96, 13, 13), (1, 3, 5, 5), (2, 16, 1, 1), (1, 8, 7, 9)]
SIZES = [3, 5, 7, 17]  # 17: past the kernels' templated windows
# more images than the kernels' old 65,535-image grid axis held
MANY_IMAGES = (70000, 3, 1, 1)
ALPHA, BETA, K = 0.05, 0.75, 2.0
F32 = dict(rtol=1e-5, atol=1e-6)
BF16 = dict(rtol=8e-3, atol=1e-6)


def _x(shape, seed=0):
    return (np.random.RandomState(seed).randn(*shape) * 2).astype(np.float32)


def _lrn_text(size, region="ACROSS_CHANNELS"):
    return ('name: "n" type: "LRN" bottom: "x" top: "y" lrn_param { '
            f'local_size: {size} alpha: {ALPHA} beta: {BETA} k: {K} '
            f'norm_region: {region} }}')


def _jax_layer(text, shape):
    layer = jax_create_layer(JaxLP.from_text(text), JaxPolicy(), "TEST")
    layer.out_shapes = layer.setup([shape])
    return layer


def _port_layer(text, shape):
    layer = create_layer(LayerParameter.from_text(text), DtypePolicy(),
                         "TEST", torch.device("cpu"))
    layer.out_shapes = layer.setup([shape])
    return layer.eval()


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_pallas_kernel_f32(shape, size):
    x = _x(shape)
    want = jax_lrn_kernel(jnp.asarray(x), size, ALPHA, BETA, K,
                          interpret=True)
    got = lrn_op.lrn_across_channels_ref(torch.from_numpy(x), size, ALPHA,
                                         BETA, K)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_jax_lax_layer_f32(shape, size, monkeypatch):
    monkeypatch.delenv("CAFFE_LRN_PALLAS", raising=False)  # f32 -> lax
    x = _x(shape, seed=1)
    (want,), _ = _jax_layer(_lrn_text(size), shape).apply(
        {}, {}, [jnp.asarray(x)], train=False, rng=None)
    (got,) = _port_layer(_lrn_text(size), shape)([torch.from_numpy(x)])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("size", [5, 17])
def test_plain_matches_jax_lax_layer_past_65535_images(size, monkeypatch):
    """The plain version at more images than a CUDA grid's second axis
    holds, against the JAX lax layer as the test above runs it (the
    Pallas kernel in interpret mode would take 70,000 programs)."""
    monkeypatch.delenv("CAFFE_LRN_PALLAS", raising=False)  # f32 -> lax
    x = _x(MANY_IMAGES, seed=5)
    (want,), _ = _jax_layer(_lrn_text(size), MANY_IMAGES).apply(
        {}, {}, [jnp.asarray(x)], train=False, rng=None)
    (got,) = _port_layer(_lrn_text(size), MANY_IMAGES)(
        [torch.from_numpy(x)])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("module", ["lrn.py", "flash_attention.py"])
def test_no_grid_axis_cap_is_left_in_the_wrappers(module):
    """The wrappers cut a launch into runs instead of refusing more than
    65,535 images or batch x heads."""
    path = os.path.join(_ROOT, "caffe_mpi_tpu_torch", "ops", module)
    with open(path) as f:
        src = f.read()
    assert not re.search(r"[<>]=?\s*(65535|MAX_GRID_Y)\b", src)
    assert "at most 65535" not in src


@pytest.mark.parametrize("n,c,hw", [(70000, 3, 1), (1, 96, 3025),
                                    (256, 96, 3025), (2**31 - 1, 1, 1),
                                    (2**31 - 1, 17, 1), (300000, 96, 3025)])
def test_image_chunks_cover_the_images_within_the_grid(n, c, hw):
    chunks = lrn_op._image_chunks(n, c, hw)
    assert chunks[0][0] == 0 and sum(m for _, m in chunks) == n
    assert all(a + m == b for (a, m), (b, _) in zip(chunks, chunks[1:]))
    most = -(-c // 8) * -(-hw // 128)  # runs of 8, blocks of 128
    assert all(m * most <= 2**31 - 1 for _, m in chunks)
    # as few launches as runs of the most images a launch holds
    assert len(chunks) == -(-n // ((2**31 - 1) // most))


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_pallas_kernel_bf16(shape):
    x = _x(shape, seed=2)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = jax_lrn_kernel(xb, 5, ALPHA, BETA, K, interpret=True)
    # the same bf16 values on the port side
    xt = torch.from_numpy(np.array(xb.astype(jnp.float32))).bfloat16()
    got = lrn_op.lrn_across_channels_ref(xt, 5, ALPHA, BETA, K)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)), **BF16)


def test_within_channel_layer_matches_jax():
    shape = (2, 4, 7, 9)
    x = _x(shape, seed=3)
    text = _lrn_text(3, "WITHIN_CHANNEL")
    (want,), _ = _jax_layer(text, shape).apply(
        {}, {}, [jnp.asarray(x)], train=False, rng=None)
    (got,) = _port_layer(text, shape)([torch.from_numpy(x)])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_even_local_size_raises():
    x = torch.zeros(1, 4, 2, 2)
    with pytest.raises(ValueError, match="odd"):
        lrn_op.lrn_across_channels(x, 4, ALPHA, BETA, K)
    with pytest.raises(ValueError, match="odd"):
        lrn_op.lrn_across_channels_ref(x, 4, ALPHA, BETA, K)
    with pytest.raises(ValueError, match="odd"):
        _port_layer(_lrn_text(4), (1, 4, 2, 2))


def test_non_nchw_raises():
    with pytest.raises(ValueError, match="NCHW"):
        lrn_op.lrn_across_channels(torch.zeros(4, 2, 2), 5, ALPHA, BETA, K)


def test_cpu_tensor_takes_the_plain_version_and_launches_nothing():
    x = torch.from_numpy(_x((2, 16, 5, 5), seed=4))
    before = lrn_op.lrn_across_channels.launches
    got = lrn_op.lrn_across_channels(x, 5, ALPHA, BETA, K)
    assert lrn_op.lrn_across_channels.launches == before
    assert torch.equal(got, lrn_op.lrn_across_channels_ref(x, 5, ALPHA,
                                                            BETA, K))


def test_other_devices_raise_instead_of_falling_back():
    x = torch.empty(1, 8, 3, 3, device="meta")
    with pytest.raises(ValueError, match="device"):
        lrn_op.lrn_across_channels(x, 5, ALPHA, BETA, K)


def test_cuda_source_exists_and_names_the_tpu_kernel():
    path = os.path.join(_ROOT, "caffe_mpi_tpu_torch", "csrc", "lrn.cu")
    with open(path) as f:
        src = f.read()
    assert "caffe_mpi_tpu/ops/lrn.py:_fwd_kernel" in src
    assert 'extern "C" int lrn_fwd_f32' in src
    assert 'extern "C" int lrn_fwd_bf16' in src
    assert lrn_op.REPLACES.startswith("caffe_mpi_tpu/ops/lrn.py:")


def test_a_launch_cut_into_image_runs_moves_each_pointer_and_counts(
        monkeypatch):
    """The wrapper's launch loop with the C function replaced by a recorder
    and the grid cut to 3 images a launch: every run of images gets its
    own pointers and count, and each is one counted launch."""
    import contextlib
    import types
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: types.SimpleNamespace(cuda_stream=7))
    monkeypatch.setattr(lrn_op, "_image_chunks",
                        lambda n, c, hw: [(i, min(3, n - i))
                                          for i in range(0, n, 3)])
    calls = []

    def fn(*args):
        calls.append(args)
        return 0

    x, y = torch.zeros(8, 4, 2, 3), torch.zeros(8, 4, 2, 3)
    before = lrn_op.lrn_across_channels.launches
    lrn_op._run(fn, lrn_op.lrn_across_channels, (x, y), 5, 0.1, 0.75, 2.0)
    assert lrn_op.lrn_across_channels.launches == before + 3
    step = 4 * 2 * 3 * 4
    assert [c[:5] for c in calls] == [
        (x.data_ptr() + i * step, y.data_ptr() + i * step, m, 4, 6)
        for i, m in ((0, 3), (3, 3), (6, 2))]
    assert all(c[5:] == (5, 0.1, 0.75, 2.0, 7) for c in calls)
    lrn_op.lrn_across_channels.launches = before
    with pytest.raises(RuntimeError, match="lrn_across_channels kernel "
                       "launch failed: cudaError 9"):
        lrn_op._run(lambda *a: 9, lrn_op.lrn_across_channels, (x, y), 5,
                    0.1, 0.75, 2.0)
    assert lrn_op.lrn_across_channels.launches == before
