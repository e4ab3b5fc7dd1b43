"""Port parity: the transformer's layers and the MoE op against the
JAX package, forward and gradient, on the CPU.

The same prototxt layer text builds the JAX layer and the port's; the
params are drawn with numpy (normals, so scales and biases are not at
their constant fills and routes are distinct) and go into both, as do
the bottoms. The gradient is that of sum_i <top_i, w_i> with respect to
every param and every float bottom, through jax.grad and through torch
autograd. Attention with `use_flash` runs the Pallas kernels in interpret
mode on the JAX side and the kernels' plain versions on the port's.

Tolerances, f32 throughout: forward rtol 1e-5 / atol 1e-6; gradients
rtol 1e-5 / atol 1e-5 of the gradient's largest element (the same math,
products and reductions summed in another order: a weight gradient of
size ~10 that sums terms of that size to ~0.1 carries ~1e-5 of rounding).
Embed's gather, Bias, Eltwise and Parameter are the same
elementwise operations and are held to rtol 1e-6 / atol 1e-7 (of the
largest element, for gradients).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caffe_mpi_tpu.core.types import DtypePolicy as JaxPolicy
from caffe_mpi_tpu.layers import create_layer as jax_create_layer
from caffe_mpi_tpu.ops import moe as jax_moe
from caffe_mpi_tpu.proto import LayerParameter as JaxLP
from caffe_mpi_tpu_torch.core.types import DtypePolicy
from caffe_mpi_tpu_torch.layers import create_layer
from caffe_mpi_tpu_torch.ops import moe as port_moe
from caffe_mpi_tpu_torch.proto import LayerParameter

FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-5, atol=1e-5)  # atol: of the largest element
EXACT = dict(rtol=1e-6, atol=1e-7)


def _both(text, bottoms, seed=0, param_scale=0.5, fwd=FWD, grad=GRAD):
    """Run one layer in both packages; return (port layer, port tops)."""
    shapes = [tuple(b.shape) for b in bottoms]
    jl = jax_create_layer(JaxLP.from_text(text), JaxPolicy(), "TRAIN")
    jl.in_shapes = shapes
    jl.out_shapes = jl.setup(shapes)
    tl = create_layer(LayerParameter.from_text(text), DtypePolicy(), "TRAIN",
                      torch.device("cpu"))
    tl.in_shapes = shapes
    tl.out_shapes = tl.setup(shapes)
    assert list(tl.decls) == list(jl.params)
    assert [tuple(s) for s in tl.out_shapes] == \
        [tuple(s) for s in jl.out_shapes]
    rs = np.random.RandomState(seed)
    params = {n: (rs.randn(*d.shape) * param_scale).astype(np.float32)
              for n, d in jl.params.items()}
    weights = [np.asarray(rs.randn(*s), np.float32) for s in jl.out_shapes]
    floats = [i for i, b in enumerate(bottoms) if b.dtype == np.float32]

    def jloss(p, fb):
        bs = [jnp.asarray(b) for b in bottoms]
        for i, b in zip(floats, fb):
            bs[i] = b
        tops, _ = jl.apply(p, {}, bs, train=True, rng=jax.random.PRNGKey(0))
        return sum(jnp.sum(t * w) for t, w in zip(tops, weights)), tops

    jp = {n: jnp.asarray(a) for n, a in params.items()}
    (_, jtops), (jgp, jgb) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(
        jp, [jnp.asarray(bottoms[i]) for i in floats])

    with torch.no_grad():
        for n, a in params.items():
            getattr(tl, n).copy_(torch.from_numpy(a))
    for n in params:
        getattr(tl, n).requires_grad_(True)
    tb = [torch.from_numpy(b.copy()) for b in bottoms]
    for i in floats:
        tb[i].requires_grad_(True)
    tops = tl(tb)
    assert len(tops) == len(jtops)
    for got, want in zip(tops, jtops):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   **fwd)
    sum((t * torch.from_numpy(w)).sum() for t, w in
        zip(tops, weights)).backward()
    got_want = [(getattr(tl, n).grad, jgp[n], n) for n in params] + \
        [(tb[i].grad, g, f"bottom {i}") for i, g in zip(floats, jgb)]
    for got, want, name in got_want:
        want = np.asarray(want)
        np.testing.assert_allclose(
            got.numpy(), want, rtol=grad["rtol"],
            atol=grad["atol"] * max(float(np.abs(want).max()), 1.0),
            err_msg=name)
    return tl, tops


def _x(*shape, seed=1):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# -- LayerNorm ----------------------------------------------------------------

@pytest.mark.parametrize("extra", ["", "layer_norm_param { eps: 0.01 }",
                                   "layer_norm_param { scale_bias: false }"])
def test_layer_norm_matches_jax(extra):
    text = f'name: "ln" type: "LayerNorm" bottom: "x" top: "y" {extra}'
    tl, _ = _both(text, [_x(2, 5, 12) * 3 + 1])
    assert list(tl.decls) == ([] if "false" in extra else ["scale", "bias"])


# -- Attention ----------------------------------------------------------------

@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("extra", ["causal: true", "causal: false",
                                   "causal: true bias_term: false",
                                   "causal: true sequence_parallel: true"])
def test_attention_layer_matches_jax(extra, use_flash):
    flash = " use_flash: true" if use_flash else ""
    text = ('name: "attn" type: "Attention" bottom: "x" top: "y" '
            f'attention_param {{ num_heads: 2 {extra}{flash} }}')
    tl, _ = _both(text, [_x(2, 8, 16)])
    want = ["qkv_weight", "proj_weight"] + \
        ([] if "bias_term: false" in extra else ["qkv_bias", "proj_bias"])
    assert list(tl.decls) == want


def test_attention_layer_reaches_qkv_weight_through_the_flash_backward():
    """The qkv weight's gradient comes only through K4/K5 (their plain
    versions here): a broken graph would leave it zero."""
    text = ('name: "attn" type: "Attention" bottom: "x" top: "y" '
            'attention_param { num_heads: 2 causal: true use_flash: true }')
    tl, tops = _both(text, [_x(1, 16, 8)], seed=3)
    assert tops[0].grad_fn is not None
    assert float(tl.qkv_weight.grad.abs().max()) > 0


# -- MoE ----------------------------------------------------------------------

MOE = [
    # (moe_param, bottom shape, aux-loss top): top-1 with room, capacity
    # overflow, top-2, top-2 with overflow, and one without the aux top
    ("num_experts: 4 hidden_dim: 8", (2, 8, 6), True),
    ("num_experts: 4 hidden_dim: 8 capacity_factor: 0.5", (2, 8, 6), True),
    ("num_experts: 4 hidden_dim: 8 top_k: 2", (2, 8, 6), True),
    ("num_experts: 3 hidden_dim: 5 top_k: 2 capacity_factor: 0.75",
     (3, 4, 6), True),
    ("num_experts: 4 hidden_dim: 8 capacity_factor: 0.5", (2, 8, 6), False),
]


@pytest.mark.parametrize("param,shape,aux", MOE)
def test_moe_layer_matches_jax(param, shape, aux):
    tops = 'top: "y" top: "aux" loss_weight: 0 loss_weight: 0.01' if aux \
        else 'top: "y"'
    text = (f'name: "moe" type: "MoE" bottom: "x" {tops} '
            f'moe_param {{ {param} }}')
    tl, out = _both(text, [_x(*shape, seed=2)], seed=4, param_scale=0.7)
    assert list(tl.decls) == ["gate", "w1", "b1", "w2", "b2"]
    assert len(out) == (2 if aux else 1)
    # the gate learns through the gate weights (and the aux term)
    assert float(tl.gate.grad.abs().max()) > 0


def _moe_params(rs, c, e, h, gate_scale=1.0):
    return {"gate": rs.randn(c, e).astype(np.float32) * gate_scale,
            "w1": rs.randn(e, c, h).astype(np.float32) * 0.5,
            "b1": rs.randn(e, h).astype(np.float32) * 0.1,
            "w2": rs.randn(e, h, c).astype(np.float32) * 0.5,
            "b2": rs.randn(e, c).astype(np.float32) * 0.1}


@pytest.mark.parametrize("top_k,cf", [(1, 2.0), (1, 0.5), (2, 2.0),
                                      (2, 0.5), (3, 1.0)])
def test_moe_ffn_matches_jax_with_and_without_overflow(top_k, cf):
    rs = np.random.RandomState(7 + top_k)
    params = _moe_params(rs, 6, 4, 8)
    x = rs.randn(20, 6).astype(np.float32)
    jy, jaux = jax_moe.moe_ffn({k: jnp.asarray(v) for k, v in params.items()},
                               jnp.asarray(x), top_k=top_k,
                               capacity_factor=cf)
    py, paux = port_moe.moe_ffn({k: torch.from_numpy(v)
                                 for k, v in params.items()},
                                torch.from_numpy(x), top_k=top_k,
                                capacity_factor=cf)
    np.testing.assert_allclose(py.numpy(), np.asarray(jy), **FWD)
    np.testing.assert_allclose(float(paux), float(jaux), rtol=1e-6)


def test_moe_capacity_drops_follow_token_order():
    """Every token routes to expert 0 (a gate column far above the rest):
    with capacity 2 only the first two tokens are kept, and the rest get
    y = 0, in both packages."""
    rs = np.random.RandomState(8)
    params = _moe_params(rs, 4, 4, 8)
    x = np.abs(rs.randn(8, 4)).astype(np.float32) + 0.1
    params["gate"][:] = 0.0
    params["gate"][:, 0] = 5.0
    jy, _ = jax_moe.moe_ffn({k: jnp.asarray(v) for k, v in params.items()},
                            jnp.asarray(x), capacity_factor=1.0)
    py, _ = port_moe.moe_ffn({k: torch.from_numpy(v)
                              for k, v in params.items()},
                             torch.from_numpy(x), capacity_factor=1.0)
    np.testing.assert_allclose(py.numpy(), np.asarray(jy), **FWD)
    assert py[:2].abs().sum() > 0 and not py[2:].any()


def test_moe_ties_pick_the_first_expert():
    """Equal logits (a zero gate): argmax takes the first maximum, and the
    second pick of top-2 the next one, in both packages."""
    params = _moe_params(np.random.RandomState(9), 4, 3, 5)
    params["gate"][:] = 0.0
    x = np.random.RandomState(10).randn(6, 4).astype(np.float32)
    got = port_moe.routing({"gate": torch.from_numpy(params["gate"])},
                           torch.from_numpy(x), top_k=2)
    assert got.tolist() == [[0, 1]] * 6
    jy, _ = jax_moe.moe_ffn({k: jnp.asarray(v) for k, v in params.items()},
                            jnp.asarray(x), top_k=2)
    py, _ = port_moe.moe_ffn({k: torch.from_numpy(v)
                              for k, v in params.items()},
                             torch.from_numpy(x), top_k=2)
    np.testing.assert_allclose(py.numpy(), np.asarray(jy), **FWD)


@pytest.mark.parametrize("top_k", [1, 2])
def test_dense_reference_matches_jax_and_moe_ffn_without_overflow(top_k):
    rs = np.random.RandomState(11 + top_k)
    params = _moe_params(rs, 6, 4, 8)
    x = rs.randn(12, 6).astype(np.float32)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    want = jax_moe.moe_ffn_dense_reference(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x),
        top_k=top_k)
    got = port_moe.moe_ffn_dense_reference(tp, torch.from_numpy(x),
                                           top_k=top_k)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)
    # capacity factor 4 leaves room for every token
    y, _ = port_moe.moe_ffn(tp, torch.from_numpy(x), top_k=top_k,
                            capacity_factor=4.0)
    np.testing.assert_allclose(y.numpy(), got.numpy(), **FWD)


# -- Embed, Bias, Eltwise, Parameter -----------------------------------

@pytest.mark.parametrize("bias", ["false", "true"])
def test_embed_matches_jax(bias):
    text = ('name: "embed" type: "Embed" bottom: "tok" top: "y" '
            f'embed_param {{ input_dim: 11 num_output: 5 bias_term: {bias} }}')
    tok = np.random.RandomState(5).randint(0, 11, (3, 7))
    tl, (y,) = _both(text, [tok], fwd=EXACT, grad=EXACT)
    assert tuple(y.shape) == (3, 7, 5)


def test_embed_takes_float_ids_truncated():
    text = ('name: "embed" type: "Embed" bottom: "tok" top: "y" '
            'embed_param { input_dim: 6 num_output: 3 }')
    ids = np.array([[0.0, 2.7, 5.2]], np.float32)
    tl = create_layer(LayerParameter.from_text(text), DtypePolicy(),
                      "TRAIN", torch.device("cpu"))
    tl.setup([(1, 3)])
    tl.init_params(torch.Generator().manual_seed(0))
    (y,) = tl([torch.from_numpy(ids)])
    torch.testing.assert_close(y[0], tl.weight[[0, 2, 5]])


BIAS = [
    # (layer text, bottom shapes): the transformer's two-bottom Bias, a
    # learned Bias over one axis, and one over the trailing axes
    ('name: "b" type: "Bias" bottom: "x" bottom: "pos" top: "y" '
     'bias_param { axis: 1 }', [(2, 6, 4), (6, 4)]),
    ('name: "b" type: "Bias" bottom: "x" top: "y"', [(2, 3, 4, 5)]),
    ('name: "b" type: "Bias" bottom: "x" top: "y" '
     'bias_param { axis: 1 num_axes: -1 }', [(2, 3, 4)]),
    ('name: "b" type: "Bias" bottom: "x" bottom: "c" top: "y" '
     'bias_param { axis: 0 }', [(2, 3, 4), (2, 3)]),
]


@pytest.mark.parametrize("text,shapes", BIAS)
def test_bias_matches_jax(text, shapes):
    _both(text, [_x(*s, seed=i + 1) for i, s in enumerate(shapes)],
          fwd=EXACT, grad=EXACT)


@pytest.mark.parametrize("param", [
    "", "eltwise_param { operation: SUM coeff: 0.5 coeff: -2 coeff: 3 }",
    "eltwise_param { operation: PROD }", "eltwise_param { operation: MAX }"])
def test_eltwise_matches_jax(param):
    text = ('name: "e" type: "Eltwise" bottom: "a" bottom: "b" bottom: "c" '
            f'top: "y" {param}')
    _both(text, [_x(2, 3, 4, seed=s) for s in (1, 2, 3)], fwd=EXACT,
          grad=EXACT)


def test_eltwise_refuses_a_wrong_coeff_count():
    text = ('name: "e" type: "Eltwise" bottom: "a" bottom: "b" top: "y" '
            'eltwise_param { coeff: 1 }')
    layer = create_layer(LayerParameter.from_text(text), DtypePolicy(),
                         "TRAIN", torch.device("cpu"))
    with pytest.raises(ValueError, match="coeff"):
        layer.setup([(2, 3), (2, 3)])


def test_parameter_matches_jax():
    text = ('name: "pos" type: "Parameter" top: "pos" '
            'parameter_param { shape { dim: 6 dim: 4 } }')
    tl, (y,) = _both(text, [], fwd=EXACT, grad=EXACT)
    assert y is tl.weight or torch.equal(y, tl.weight)
