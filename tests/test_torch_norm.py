"""Port parity: BatchNorm (with its running statistics), Scale and Concat
against the JAX package's layers, forward, state and gradient, on the CPU.

The same prototxt layer text builds the JAX layer and the port's; params,
state and bottoms are drawn with numpy and go into both. The gradient is
that of sum_i <top_i, w_i> with respect to every param and every bottom,
through jax.grad (with the JAX layer's `train` flag set as the solver sets
it: True in TRAIN, False in TEST) and through torch autograd.

Tolerances, f32 throughout, as tests/test_torch_sequence.py states them:
forward and state rtol 1e-5 / atol 1e-6; gradients rtol 1e-5 / atol 1e-5
of the gradient's largest element (the same math, reductions summed in
another order). Concat is data movement and is held bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caffe_mpi_tpu.core.types import DtypePolicy as JaxPolicy
from caffe_mpi_tpu.layers import create_layer as jax_create_layer
from caffe_mpi_tpu.proto import LayerParameter as JaxLP
from caffe_mpi_tpu_torch.core.types import DtypePolicy
from caffe_mpi_tpu_torch.layers import create_layer
from caffe_mpi_tpu_torch.layers import norm as port_norm
from caffe_mpi_tpu_torch.proto import LayerParameter

FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-5, atol=1e-5)  # atol: of the largest element


def _layers(text, shapes, phase):
    jl = jax_create_layer(JaxLP.from_text(text), JaxPolicy(), phase)
    jl.in_shapes = shapes
    jl.out_shapes = jl.setup(shapes)
    tl = create_layer(LayerParameter.from_text(text), DtypePolicy(), phase,
                      torch.device("cpu"))
    tl.in_shapes = shapes
    tl.out_shapes = tl.setup(shapes)
    tl.train(phase == "TRAIN")
    assert list(tl.decls) == list(jl.params)
    assert [tuple(s) for s in tl.out_shapes] == \
        [tuple(s) for s in jl.out_shapes]
    return jl, tl


def _close_grad(got, want, name):
    want = np.asarray(want)
    np.testing.assert_allclose(
        got.numpy(), want, rtol=GRAD["rtol"],
        atol=GRAD["atol"] * max(float(np.abs(want).max()), 1.0),
        err_msg=name)


def _step(jl, tl, params, state, bottoms, weights, train):
    """One forward and backward of both layers from `params` and `state`
    (numpy); checks tops, new state and gradients; returns the JAX side's
    new state as numpy."""
    def jloss(p, bs):
        tops, new = jl.apply(p, state, bs, train=train,
                             rng=jax.random.PRNGKey(0))
        return sum(jnp.sum(t * w) for t, w in zip(tops, weights)), \
            (tops, new)

    jp = {n: jnp.asarray(a) for n, a in params.items()}
    (_, (jtops, jnew)), (jgp, jgb) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(
        jp, [jnp.asarray(b) for b in bottoms])
    with torch.no_grad():
        for n, a in params.items():
            getattr(tl, n).copy_(torch.from_numpy(a))
        for n, a in state.items():
            getattr(tl, n).copy_(torch.from_numpy(np.array(a)))
    for n in params:
        getattr(tl, n).requires_grad_(True)
        getattr(tl, n).grad = None
    tb = [torch.from_numpy(b.copy()).requires_grad_(True) for b in bottoms]
    tops = tl(tb)
    for got, want in zip(tops, jtops):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   **FWD)
    for n in state:
        np.testing.assert_allclose(getattr(tl, n).numpy(),
                                   np.asarray(jnew[n]), err_msg=n, **FWD)
    sum((t * torch.from_numpy(w)).sum() for t, w in
        zip(tops, weights)).backward()
    for n in params:
        _close_grad(getattr(tl, n).grad, jgp[n], n)
    for i, (b, g) in enumerate(zip(tb, jgb)):
        _close_grad(b.grad, g, f"bottom {i}")
    return {n: np.asarray(a) for n, a in jnew.items()}


def _x(*shape, seed=1):
    return np.asarray(np.random.RandomState(seed).randn(*shape), np.float32)


# -- BatchNorm ----------------------------------------------------------------

BN = 'name: "bn" type: "BatchNorm" bottom: "x" top: "y" '


@pytest.fixture(params=port_norm.DESIGNS)
def design(request, monkeypatch):
    """Both batch-statistics designs compute the JAX layer's function."""
    monkeypatch.setattr(port_norm, "BATCH_STATS", request.param)
    return request.param


@pytest.mark.parametrize("phase,extra,frozen", [
    ("TRAIN", "", False),
    ("TRAIN", "batch_norm_param { scale_bias: true }", False),
    ("TRAIN", "batch_norm_param { scale_filler { type: 'constant' "
              "value: 2 } }", False),
    ("TRAIN", "batch_norm_param { bias_filler { type: 'constant' "
              "value: 0.5 } }", False),
    ("TRAIN", "batch_norm_param { use_global_stats: true scale_bias: true }",
     True),
    ("TRAIN", "batch_norm_param { use_global_stats: false }", False),
    ("TEST", "", True),
    ("TEST", "batch_norm_param { use_global_stats: false scale_bias: true }",
     True),
    ("TRAIN", "batch_norm_param { eps: 1e-7 scale_bias: true }", False),
    ("TEST", "batch_norm_param { eps: 1e-7 }", True),
])
@pytest.mark.parametrize("shape", [(4, 3, 5, 6), (6, 5)])
def test_batch_norm_matches_jax(design, phase, extra, frozen, shape):
    """Forward, new state and gradients of x, scale and bias over three
    steps from a random running state: batch statistics and a running
    update in TRAIN unless use_global_stats is set, the running
    statistics (unchanged) in TEST whatever use_global_stats says."""
    text = BN + extra
    jl, tl = _layers(text, [shape], phase)
    sb = "scale_bias" in extra or "filler" in extra
    assert list(tl.decls) == (["scale", "bias"] if sb else [])
    assert list(tl.state_shapes) == ["mean", "var"]
    assert tl.eps == jl.eps == max(float(tl.p.eps), 1e-5)
    rs = np.random.RandomState(7)
    c = shape[1]
    params = {n: (1 + 0.5 * rs.randn(c)).astype(np.float32)
              for n in tl.decls}
    state = {"mean": rs.randn(c).astype(np.float32),
             "var": (0.5 + rs.rand(c)).astype(np.float32)}
    train = phase == "TRAIN"
    for step in range(3):
        x = _x(*shape, seed=step) * 3 + 1
        w = [_x(*shape, seed=10 + step)]
        new = _step(jl, tl, params, state, [x], w, train)
        moved = not np.array_equal(new["mean"], state["mean"])
        assert moved == (not frozen)
        state = new


def test_batch_norm_running_update_uses_the_biased_variance(design):
    """From zero state with f = 0.9: mean 0.1 x the batch mean, var 0.1 x
    the biased batch variance (F.batch_norm's own update would give the
    unbiased one with momentum 0.1)."""
    text = BN + "batch_norm_param { moving_average_fraction: 0.9 }"
    _, tl = _layers(text, [(2, 3, 2, 2)], "TRAIN")
    x = _x(2, 3, 2, 2)
    tl([torch.from_numpy(x)])
    xs = x.transpose(1, 0, 2, 3).reshape(3, -1).astype(np.float64)
    np.testing.assert_allclose(tl.mean.numpy(), 0.1 * xs.mean(1), **FWD)
    np.testing.assert_allclose(tl.var.numpy(), 0.1 * xs.var(1), **FWD)


def test_batch_norm_init_and_blobs_follow_the_jax_layer():
    """Zero state, the fillers' constants (1 and 0 by default, the
    given ones otherwise) and the blob order mean, var, correction,
    scale, bias."""
    for extra, scale, bias in (
            ("batch_norm_param { scale_bias: true }", 1.0, 0.0),
            ("batch_norm_param { scale_filler { type: 'constant' "
             "value: 2 } }", 2.0, 0.0),
            ("batch_norm_param { bias_filler { type: 'constant' "
             "value: 0.5 } }", 1.0, 0.5)):
        jl, tl = _layers(BN + extra, [(2, 3, 4, 4)], "TRAIN")
        tl.init_params(torch.Generator().manual_seed(0))
        jp = jl.init_params(jax.random.PRNGKey(0))
        np.testing.assert_array_equal(tl.scale.detach().numpy(),
                                      np.full(3, scale, np.float32))
        np.testing.assert_array_equal(tl.bias.detach().numpy(),
                                      np.full(3, bias, np.float32))
        for n in ("scale", "bias"):
            np.testing.assert_array_equal(getattr(tl, n).detach().numpy(),
                                          np.asarray(jp[n]))
        for n, a in jl.init_state().items():
            np.testing.assert_array_equal(getattr(tl, n).numpy(),
                                          np.asarray(a))
        assert tl.caffe_blobs() == jl.caffe_blobs()
    _, plain = _layers(BN, [(2, 3)], "TRAIN")
    assert plain.caffe_blobs() == [("state", "mean"), ("state", "var"),
                                   ("correction", "")]


def test_batch_norm_update_keeps_the_buffers_and_stays_on_the_device():
    """The update is in place (a net sharing the buffer sees it) and
    never reads a value back to the host."""
    _, tl = _layers(BN, [(4, 3, 2, 2)], "TRAIN")
    mean, var = tl.mean, tl.var
    shared = mean  # another net's reference to the same buffer
    tl([torch.from_numpy(_x(4, 3, 2, 2))])
    assert tl.mean is mean and tl.var is var
    assert float(shared.abs().sum()) > 0


# -- Scale --------------------------------------------------------------------

SC = 'name: "sc" type: "Scale" bottom: "x" '


@pytest.mark.parametrize("extra,shapes", [
    ("", [(2, 3, 4, 5)]),
    ("scale_param { bias_term: true }", [(2, 3, 4, 5)]),
    ("scale_param { axis: 2 num_axes: 2 bias_term: true }", [(2, 3, 4, 5)]),
    ("scale_param { axis: 1 num_axes: -1 }", [(2, 3, 4, 5)]),
    ("scale_param { axis: -2 num_axes: 1 bias_term: true }", [(2, 3, 4, 5)]),
    ("scale_param { axis: 0 num_axes: 0 }", [(2, 3, 4)]),
    ("", [(2, 3, 4, 5), (3,)]),
    ("scale_param { axis: 1 }", [(2, 3, 4, 5), (3, 4)]),
    ("scale_param { axis: 0 bias_term: true }", [(2, 3, 4), (2, 3)]),
])
def test_scale_matches_jax(extra, shapes):
    """One bottom (a learned operand of shape[axis:axis+num_axes]) or two
    (the second bottom is the operand), with and without the bias; the
    gradient reaches x, the operand (param or bottom) and the bias."""
    bottoms = "".join(f'bottom: "b{i}" ' for i in range(1, len(shapes)))
    text = SC + bottoms + 'top: "y" ' + extra
    jl, tl = _layers(text, shapes, "TRAIN")
    rs = np.random.RandomState(3)
    params = {n: np.asarray(rs.randn(*d.shape), np.float32)
              for n, d in jl.params.items()}
    xs = [_x(*s, seed=i) for i, s in enumerate(shapes)]
    _step(jl, tl, params, {}, xs, [_x(*shapes[0], seed=9)], True)


def test_scale_and_bias_fill_their_defaults():
    """Scale's operand fills with constant 1 and its bias with 0, Bias's
    operand with 0, as the JAX layers' defaults."""
    gen = torch.Generator().manual_seed(0)
    _, sc = _layers(SC + 'top: "y" scale_param { bias_term: true }',
                    [(2, 3, 4)], "TRAIN")
    sc.init_params(gen)
    assert torch.equal(sc.operand, torch.ones(3))
    assert torch.equal(sc.bias, torch.zeros(3))
    _, bi = _layers('name: "b" type: "Bias" bottom: "x" top: "y"',
                    [(2, 3, 4)], "TRAIN")
    bi.init_params(gen)
    assert torch.equal(bi.operand, torch.zeros(3))


@pytest.mark.parametrize("extra,shapes", [
    ("", [(2, 3, 4)]),
    ("bias_param { axis: 1 num_axes: -1 }", [(2, 3, 4)]),
    ("", [(2, 3, 4), (3,)]),
])
def test_bias_on_the_shared_base_matches_jax(extra, shapes):
    bottoms = "".join(f'bottom: "b{i}" ' for i in range(1, len(shapes)))
    text = 'name: "bi" type: "Bias" bottom: "x" ' + bottoms + 'top: "y" ' \
        + extra
    jl, tl = _layers(text, shapes, "TRAIN")
    params = {n: _x(*d.shape, seed=5) for n, d in jl.params.items()}
    _step(jl, tl, params, {}, [_x(*s, seed=i) for i, s in enumerate(shapes)],
          [_x(*shapes[0], seed=9)], True)


# -- Concat -------------------------------------------------------------------

@pytest.mark.parametrize("extra,shapes", [
    ("", [(2, 3, 4), (2, 5, 4)]),
    ("concat_param { axis: 0 }", [(2, 3, 4), (1, 3, 4)]),
    ("concat_param { axis: -1 }", [(2, 3, 4), (2, 3, 1), (2, 3, 2)]),
    ("concat_param { concat_dim: 2 }", [(2, 3, 4), (2, 3, 6)]),
    ("", [(2, 1, 3, 3), (2, 4, 3, 3), (2, 2, 3, 3)]),
])
def test_concat_matches_jax(extra, shapes):
    """Axes 0, 1 and -1, the legacy concat_dim, two and three bottoms;
    forward bitwise, each bottom's gradient the slice of the top's."""
    bottoms = "".join(f'bottom: "b{i}" ' for i in range(len(shapes)))
    text = 'name: "cat" type: "Concat" ' + bottoms + 'top: "y" ' + extra
    jl, tl = _layers(text, shapes, "TRAIN")
    assert tl.axis == jl.axis
    xs = [_x(*s, seed=i) for i, s in enumerate(shapes)]
    out = tl.out_shapes[0]
    w = _x(*out, seed=9)
    jtop = np.asarray(jl.apply({}, {}, [jnp.asarray(x) for x in xs],
                               train=True, rng=None)[0][0])
    tb = [torch.from_numpy(x).requires_grad_(True) for x in xs]
    top = tl(tb)[0]
    np.testing.assert_array_equal(top.detach().numpy(), jtop)
    (top * torch.from_numpy(w)).sum().backward()
    jg = jax.grad(lambda bs: jnp.sum(jl.apply({}, {}, bs, train=True,
                                              rng=None)[0][0] * w))(
        [jnp.asarray(x) for x in xs])
    for b, g in zip(tb, jg):
        np.testing.assert_array_equal(b.grad.numpy(), np.asarray(g))
