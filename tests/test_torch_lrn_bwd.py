"""Port parity: the across-channel LRN backward (K2) and its autograd wiring.

The port's plain backward `lrn_across_channels_bwd_ref` — what its
`_LRNFunction` takes for a CPU tensor — against `jax.vjp` of the JAX
package's Pallas kernels (caffe_mpi_tpu/ops/lrn.py `_bwd_kernel`, reached
through its custom_vjp, run in interpret mode as the JAX suite runs it on
the CPU) and against `jax.grad` of the JAX LRNLayer's f32 lax path, on the
same numpy inputs and cotangents, at the edge shapes of test_torch_lrn.py.

Tolerances: against the Pallas kernel, float32 at rtol 1e-5 / atol 1e-6
(the same f32 arithmetic in the same order; exp/log from other libraries);
bfloat16 I/O compared in float32 at one bf16 ulp (rtol 8e-3 > 2^-7, atol
1e-6), since both compute in f32 and round once. Against the lax layer's
autodiff, rtol 1e-5 / atol 1e-5: XLA differentiates `x * pow(scale, -beta)`
by another formula, and the subtraction in dx cancels. The CUDA kernel is
held against the same plain version on the card by chip_smoke.py.
"""

import os
import re

import jax
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
SIZES = [3, 5, 7, 17, 19]  # 17, 19: K2's runtime-window kernel
MANY_IMAGES = (70000, 3, 1, 1)  # past the old 65,535-image grid axis
ALPHA, BETA, K = 0.05, 0.75, 2.0
F32 = dict(rtol=1e-5, atol=1e-6)
BF16 = dict(rtol=8e-3, atol=1e-6)
LAX = dict(rtol=1e-5, atol=1e-5)


def _arr(shape, seed, scale=2.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _lrn_text(size, region="ACROSS_CHANNELS"):
    return ('name: "n" type: "LRN" bottom: "x" top: "y" lrn_param { '
            f'local_size: {size} alpha: {ALPHA} beta: {BETA} k: {K} '
            f'norm_region: {region} }}')


def _pallas_vjp(x, dy, size):
    _, vjp = jax.vjp(lambda t: jax_lrn_kernel(t, size, ALPHA, BETA, K,
                                              interpret=True), x)
    return vjp(dy)[0]


def _jax_layer_grad(text, x, dy):
    layer = jax_create_layer(JaxLP.from_text(text), JaxPolicy(), "TEST")
    layer.out_shapes = layer.setup([x.shape])

    def f(t):
        (y,), _ = layer.apply({}, {}, [t], train=False, rng=None)
        return jnp.sum(y * dy)
    return np.asarray(jax.grad(f)(jnp.asarray(x)))


def _port_layer_grad(text, x, dy):
    layer = create_layer(LayerParameter.from_text(text), DtypePolicy(),
                         "TEST", torch.device("cpu"))
    layer.out_shapes = layer.setup([x.shape])
    xt = torch.from_numpy(x).requires_grad_()
    (y,) = layer([xt])
    y.backward(torch.from_numpy(dy))
    return xt.grad.numpy()


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_bwd_matches_pallas_bwd_kernel_f32(shape, size):
    x, dy = _arr(shape, 0), _arr(shape, 1, 1.0)
    want = _pallas_vjp(jnp.asarray(x), jnp.asarray(dy), size)
    got = lrn_op.lrn_across_channels_bwd_ref(
        torch.from_numpy(x), torch.from_numpy(dy), size, ALPHA, BETA, K)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("shape", SHAPES)
def test_autograd_matches_jax_grad_of_lax_layer(shape, size, monkeypatch):
    monkeypatch.delenv("CAFFE_LRN_PALLAS", raising=False)  # f32 -> lax
    x, dy = _arr(shape, 2), _arr(shape, 3, 1.0)
    text = _lrn_text(size)
    np.testing.assert_allclose(_port_layer_grad(text, x, dy),
                               _jax_layer_grad(text, x, dy), **LAX)


@pytest.mark.parametrize("size", [5, 17])
def test_autograd_past_65535_images_matches_jax_grad_of_lax_layer(
        size, monkeypatch):
    """The plain backward at more images than a CUDA grid's second axis
    holds, against jax.grad of the lax layer as the test above runs it."""
    monkeypatch.delenv("CAFFE_LRN_PALLAS", raising=False)  # f32 -> lax
    x, dy = _arr(MANY_IMAGES, 12), _arr(MANY_IMAGES, 13, 1.0)
    text = _lrn_text(size)
    np.testing.assert_allclose(_port_layer_grad(text, x, dy),
                               _jax_layer_grad(text, x, dy), **LAX)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_bwd_matches_pallas_bwd_kernel_bf16(shape):
    xb = jnp.asarray(_arr(shape, 4)).astype(jnp.bfloat16)
    dyb = jnp.asarray(_arr(shape, 5, 1.0)).astype(jnp.bfloat16)
    want = _pallas_vjp(xb, dyb, 5)
    assert want.dtype == jnp.bfloat16
    # the same bf16 values on the port side
    xt = torch.from_numpy(np.array(xb.astype(jnp.float32))).bfloat16()
    dyt = torch.from_numpy(np.array(dyb.astype(jnp.float32))).bfloat16()
    got = lrn_op.lrn_across_channels_bwd_ref(xt, dyt, 5, ALPHA, BETA, K)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)), **BF16)


def test_within_channel_layer_grad_matches_jax():
    shape = (2, 4, 7, 9)
    x, dy = _arr(shape, 6), _arr(shape, 7, 1.0)
    text = _lrn_text(3, "WITHIN_CHANNEL")
    np.testing.assert_allclose(_port_layer_grad(text, x, dy),
                               _jax_layer_grad(text, x, dy), **LAX)


@pytest.mark.parametrize("shape,size", [((2, 7, 3, 4), 5), ((1, 3, 2, 2), 3),
                                        ((1, 9, 1, 2), 7)])
def test_lrn_function_passes_gradcheck_in_float64(shape, size):
    x = torch.from_numpy(_arr(shape, 8).astype(np.float64)).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda t: lrn_op.lrn_across_channels(t, size, ALPHA, BETA, K), (x,))


def test_output_carries_a_graph_through_the_lrn_function():
    """The K1 output must be a node of autograd's graph, or a loss above
    the LRN would give conv1 and conv2 no gradient."""
    x = torch.from_numpy(_arr((2, 8, 3, 3), 9)).requires_grad_()
    y = lrn_op.lrn_across_channels(x, 5, ALPHA, BETA, K)
    assert y.grad_fn is not None
    assert type(y.grad_fn).__name__ == "_LRNFunctionBackward"
    y.sum().backward()
    assert x.grad is not None and float(x.grad.abs().sum()) > 0
    # without requires_grad there is no graph
    assert lrn_op.lrn_across_channels(x.detach(), 5, ALPHA, BETA,
                                      K).grad_fn is None


def test_cpu_backward_takes_the_plain_version_and_launches_nothing():
    x, dy = (torch.from_numpy(_arr((2, 16, 5, 5), s)) for s in (10, 11))
    fwd0 = lrn_op.lrn_across_channels.launches
    bwd0 = lrn_op.lrn_across_channels_bwd.launches
    xr = x.clone().requires_grad_()
    lrn_op.lrn_across_channels(xr, 5, ALPHA, BETA, K).backward(dy)
    got = lrn_op.lrn_across_channels_bwd(x, dy, 5, ALPHA, BETA, K)
    assert lrn_op.lrn_across_channels.launches == fwd0
    assert lrn_op.lrn_across_channels_bwd.launches == bwd0
    want = lrn_op.lrn_across_channels_bwd_ref(x, dy, 5, ALPHA, BETA, K)
    assert torch.equal(got, want)
    assert torch.equal(xr.grad, want)


def test_bwd_rejects_mismatched_dy_and_other_devices():
    x = torch.zeros(1, 8, 3, 3)
    with pytest.raises(ValueError, match="does not match"):
        lrn_op.lrn_across_channels_bwd(x, torch.zeros(1, 8, 3, 2), 5,
                                       ALPHA, BETA, K)
    with pytest.raises(ValueError, match="does not match"):
        lrn_op.lrn_across_channels_bwd(x, x.double(), 5, ALPHA, BETA, K)
    with pytest.raises(ValueError, match="odd"):
        lrn_op.lrn_across_channels_bwd(x, x, 4, ALPHA, BETA, K)
    m = torch.empty(1, 8, 3, 3, device="meta")
    with pytest.raises(ValueError, match="device"):
        lrn_op.lrn_across_channels_bwd(m, m, 5, ALPHA, BETA, K)


def test_cuda_source_has_the_backward_and_names_its_tpu_kernel():
    path = os.path.join(_ROOT, "caffe_mpi_tpu_torch", "csrc", "lrn.cu")
    with open(path) as f:
        src = f.read()
    assert "caffe_mpi_tpu/ops/lrn.py:_bwd_kernel" in src
    assert 'extern "C" int lrn_bwd_f32' in src
    assert 'extern "C" int lrn_bwd_bf16' in src
    assert lrn_op.REPLACES_BWD.startswith("caffe_mpi_tpu/ops/lrn.py:70")


def test_bwd_kernel_windows_reach_the_wrappers_limit():
    """The window picks K2's kernel: the register kernel takes its
    half-width as a template argument, cases 0..kMaxHalf = 7 (local_size
    1..15); a wider window launches the runtime-window kernel from the
    same C function. The wrapper refuses no odd size."""
    path = os.path.join(_ROOT, "caffe_mpi_tpu_torch", "csrc", "lrn.cu")
    with open(path) as f:
        src = f.read()
    halves = [int(h) for h in re.findall(r"LRN_BWD_CASE\((\d)\)", src)]
    assert sorted(set(halves)) == list(range(8))
    assert int(re.search(r"kMaxHalf = (\d+);", src).group(1)) == max(halves)
    body = src[src.index("int launch_bwd("):]
    body = body[:body.index("\n}\n")]
    assert "if (half > kMaxHalf) {" in body
    assert "lrn_bwd_any_kernel<T><<<" in body
    assert not hasattr(lrn_op, "MAX_BWD_SIZE")
