"""Port parity: the training path (losses, Dropout, Net TRAIN phase, LR
policies, update rules, Solver, snapshots, CLI train) against the JAX
package, on the CPU.

The net is the narrowed AlexNet of test_torch_net.py with a label input,
a SoftmaxWithLoss for TRAIN and an Accuracy for TEST. Dropout masks: JAX
draws them as bernoulli(fold_in(split(fold_in(PRNGKey(seed), it+1),
iter_size)[m], layer index)); a torch generator cannot give that stream,
so the test draws those masks with jax.random and hands them to the port
through `dropout_masks`.

Tolerances, float32 throughout:
- loss layers and Dropout with a given mask: rtol 1e-6 / atol 1e-7 (the
  same elementwise math; log-softmax and sums from other libraries);
- LR and momentum schedules: rtol 1e-6 + it x 2^-24 (JAX evaluates them
  in f32 on the device, the port in Python doubles; where JAX raises its
  f32-rounded gamma to the power it, that one rounding grows it-fold),
  atol 1e-30 (XLA flushes f32 subnormals, such as 0.05 x 0.5^123, to
  zero);
- update rules, three chained steps: rtol 1e-5 / atol 1e-8 (f32 vs the
  port's double-precision scalar products such as rate x lr_mult); for
  Adam the atol is 1e-4 of the largest step, because JAX forms the bias
  correction 1 - beta2^t in f32, where it cancels to a relative error of
  about 2^-24 / (1 - beta2) = 6e-5;
- 5 SGD iterations of the narrowed AlexNet: losses rtol 1e-5, every
  parameter and history slot rtol 1e-5 / atol 1e-6 (eight layers of f32
  sums in another order, forward and backward, five times over; measured
  ~5e-7 on the losses and ~3e-8 on the parameters).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caffe_mpi_tpu import io as jax_io
from caffe_mpi_tpu.core.types import DtypePolicy as JaxPolicy
from caffe_mpi_tpu.layers import create_layer as jax_create_layer
from caffe_mpi_tpu.proto import LayerParameter as JaxLP
from caffe_mpi_tpu.proto import SolverParameter as JaxSP
from caffe_mpi_tpu.solver import Solver as JaxSolver
from caffe_mpi_tpu.solver import lr_policy as jax_lr
from caffe_mpi_tpu.solver import updates as jax_updates
from caffe_mpi_tpu.tools.cli import _synthetic_feed as jax_synthetic_feed
from caffe_mpi_tpu_torch import io as port_io
from caffe_mpi_tpu_torch.core.types import DtypePolicy
from caffe_mpi_tpu_torch.layers import create_layer
from caffe_mpi_tpu_torch.net import Net
from caffe_mpi_tpu_torch.proto import LayerParameter, NetParameter
from caffe_mpi_tpu_torch.proto import SolverParameter
from caffe_mpi_tpu_torch.solver import Solver
from caffe_mpi_tpu_torch.solver import lr_policy, updates
from caffe_mpi_tpu_torch.tools import cli
from caffe_mpi_tpu_torch.weights import load_jax_opt_state, load_jax_params
from test_torch_net import small_alexnet

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 4
SEED = 3
ELEM = dict(rtol=1e-6, atol=1e-7)
STEP = dict(rtol=1e-5, atol=1e-6)


def train_val(batch=B):
    """The narrowed AlexNet with a label input, a TRAIN loss and a TEST
    accuracy, as models/alexnet/train_val.prototxt has them."""
    t = small_alexnet(batch=batch).replace(
        f'top: "data" input_param {{ shape {{ dim: {batch} dim: 3 dim: 67 '
        'dim: 67 } }',
        f'top: "data" top: "label" input_param {{ shape {{ dim: {batch} '
        f'dim: 3 dim: 67 dim: 67 }} shape {{ dim: {batch} }} }}')
    t = t[:t.index('layer { name: "prob"')]
    return t + (
        'layer { name: "loss" type: "SoftmaxWithLoss" bottom: "fc8" '
        'bottom: "label" top: "loss" include { phase: TRAIN } }\n'
        'layer { name: "accuracy" type: "Accuracy" bottom: "fc8" '
        'bottom: "label" top: "accuracy" include { phase: TEST } }\n')


def solver_text(extra="", batch=B):
    body = train_val(batch)
    return ('net_param { ' + body[body.index("layer"):] + ' }\n'
            'base_lr: 0.01 lr_policy: "step" gamma: 0.1 stepsize: 3 '
            'momentum: 0.9 weight_decay: 0.0005 max_iter: 5 '
            f'random_seed: {SEED} test_iter: 2 test_interval: 100\n' + extra)


def _feeds(n, batch=B, seed=0):
    rs = np.random.RandomState(seed)
    return [{"data": rs.randn(batch, 3, 67, 67).astype(np.float32),
             "label": rs.randint(0, 10, batch).astype(np.int32)}
            for _ in range(n)]


def _torch_feeds(feeds):
    return lambda k: {key: torch.from_numpy(v) for key, v in
                      feeds[k].items()}


def _jax_masks(jsolver, seed=SEED):
    """The masks the JAX solver draws at (iteration, micro), as tensors."""
    net = jsolver.net
    drops = {layer.name: (i, net.blob_shapes[layer.lp.bottom[0]],
                          1.0 - layer.lp.dropout_param.dropout_ratio)
             for i, layer in enumerate(net.layers)
             if layer.lp.type == "Dropout"}
    iter_size = max(jsolver.sp.iter_size, 1)
    base = jax.random.PRNGKey(seed)

    def masks(it, m):
        rng = jax.random.split(jax.random.fold_in(base, it + 1),
                               iter_size)[m]
        return {name: torch.from_numpy(np.array(jax.random.bernoulli(
            jax.random.fold_in(rng, i), keep, shape)))
            for name, (i, shape, keep) in drops.items()}
    return masks


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_params_equal(jparams, net, **tol):
    for lname, blobs in jparams.items():
        for pname, arr in blobs.items():
            got = getattr(net.layer_by_name(lname), pname).detach().numpy()
            np.testing.assert_allclose(got, np.asarray(arr),
                                       err_msg=f"{lname}.{pname}", **tol)


# -- loss layers, Dropout ----------------------------------------------------

def _pair(text, shapes):
    jl = jax_create_layer(JaxLP.from_text(text), JaxPolicy(), "TRAIN")
    jl.out_shapes = jl.setup(shapes)
    pl = create_layer(LayerParameter.from_text(text), DtypePolicy(),
                      "TRAIN", torch.device("cpu"))
    pl.out_shapes = pl.setup(shapes)
    return jl, pl


LOSS_PARAMS = ["", "loss_param { normalization: FULL }",
               "loss_param { normalization: BATCH_SIZE }",
               "loss_param { normalization: NONE }",
               "loss_param { normalize: false }",
               "loss_param { ignore_label: 2 }",
               "loss_param { ignore_label: 2 normalization: FULL }"]


@pytest.mark.parametrize("shape", [(6, 10), (3, 5, 2, 4)])
@pytest.mark.parametrize("extra", LOSS_PARAMS)
def test_softmax_with_loss_matches_jax(extra, shape):
    text = ('name: "loss" type: "SoftmaxWithLoss" bottom: "s" bottom: "l" '
            f'top: "loss" top: "prob" {extra}')
    lshape = (shape[0], *shape[2:])
    jl, pl = _pair(text, [shape, lshape])
    rs = np.random.RandomState(0)
    s = (rs.randn(*shape) * 3).astype(np.float32)
    lab = rs.randint(0, shape[1], lshape).astype(np.int32)
    want, _ = jl.apply({}, {}, [jnp.asarray(s), jnp.asarray(lab)],
                       train=True, rng=None)
    got = pl([torch.from_numpy(s), torch.from_numpy(lab)])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **ELEM)
    assert pl.is_loss() and pl.default_loss_weight(0) == 1.0
    assert pl.default_loss_weight(1) == 0.0


@pytest.mark.parametrize("extra", ["", "accuracy_param { top_k: 3 }",
                                   "accuracy_param { ignore_label: 1 }",
                                   "accuracy_param { top_k: 2 "
                                   "ignore_label: 0 }"])
def test_accuracy_matches_jax(extra):
    text = ('name: "acc" type: "Accuracy" bottom: "s" bottom: "l" '
            f'top: "acc" top: "per_class" {extra}')
    jl, pl = _pair(text, [(32, 5), (32,)])
    rs = np.random.RandomState(1)
    s = rs.randn(32, 5).astype(np.float32)
    lab = rs.randint(0, 5, 32).astype(np.int32)
    want, _ = jl.apply({}, {}, [jnp.asarray(s), jnp.asarray(lab)],
                       train=False, rng=None)
    got = pl([torch.from_numpy(s), torch.from_numpy(lab)])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **ELEM)
    assert not pl.is_loss() and pl.default_loss_weight(0) == 0.0


def test_dropout_with_given_mask_matches_jax_draw():
    text = ('name: "drop" type: "Dropout" bottom: "x" top: "x" '
            'dropout_param { dropout_ratio: 0.3 }')
    jl, pl = _pair(text, [(4, 16)])
    x = np.random.RandomState(2).randn(4, 16).astype(np.float32)
    rng = jax.random.PRNGKey(5)
    (want,), _ = jl.apply({}, {}, [jnp.asarray(x)], train=True, rng=rng)
    mask = np.array(jax.random.bernoulli(rng, 0.7, (4, 16)))
    (got,) = pl.train()([torch.from_numpy(x)],
                        mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ELEM)
    # a drawn mask keeps about keep of the entries, scaled by 1/keep
    g = torch.Generator().manual_seed(0)
    (drawn,) = pl([torch.ones(200, 100)], generator=g)
    kept = drawn != 0
    assert abs(float(kept.float().mean()) - 0.7) < 0.01
    assert torch.allclose(drawn[kept], torch.full_like(drawn[kept], 1 / 0.7))
    # TEST phase: identity
    (same,) = pl.eval()([torch.from_numpy(x)])
    assert torch.equal(same, torch.from_numpy(x))
    with pytest.raises(ValueError, match="generator or a mask"):
        pl.train()([torch.from_numpy(x)])
    with pytest.raises(ValueError, match="mask"):
        pl([torch.from_numpy(x)], mask=torch.ones(4, 15, dtype=torch.bool))


# -- Net TRAIN phase ---------------------------------------------------------

def test_net_loss_weights_and_propagate_down():
    text = ('name: "n" layer { name: "in" type: "Input" top: "x" top: "l" '
            'input_param { shape { dim: 4 dim: 6 } shape { dim: 4 } } }\n'
            'layer { name: "ip" type: "InnerProduct" bottom: "x" top: "y" '
            'inner_product_param { num_output: 5 '
            'weight_filler { type: "gaussian" std: 0.5 } } }\n'
            'layer { name: "a" type: "SoftmaxWithLoss" bottom: "y" '
            'bottom: "l" top: "la" loss_weight: 0.5 }\n'
            'layer { name: "b" type: "SoftmaxWithLoss" bottom: "y" '
            'bottom: "l" top: "lb" propagate_down: true '
            'propagate_down: false }\n'
            'layer { name: "c" type: "SoftmaxWithLoss" bottom: "y" '
            'bottom: "l" top: "lc" propagate_down: false '
            'propagate_down: false }\n')
    net = Net(NetParameter.from_text(text), "TRAIN", device="cpu")
    assert net.loss_blobs == [("la", 0.5), ("lb", 1.0), ("lc", 1.0)]
    net.init(0)
    w = net.layer_by_name("ip").weight.requires_grad_()
    x = torch.randn(4, 6, generator=torch.Generator().manual_seed(1))
    blobs, loss = net({"x": x, "l": torch.tensor([0, 1, 2, 3])})
    want = 0.5 * blobs["la"] + blobs["lb"] + blobs["lc"]
    assert torch.allclose(loss, want)
    loss.backward()
    # "c" blocks its bottom: the gradient is that of 1.5 x the loss
    w2 = w.detach().clone().requires_grad_()
    y = x @ w2.t() + net.layer_by_name("ip").bias
    (1.5 * torch.nn.functional.cross_entropy(
        y, torch.tensor([0, 1, 2, 3]))).backward()
    assert torch.allclose(w.grad, w2.grad, rtol=1e-5, atol=1e-7)


def test_mixed_math_precision_is_refused():
    text = solver_text().replace(
        'name: "conv1" type: "Convolution"',
        'name: "conv1" type: "Convolution" forward_math: FLOAT')
    with pytest.raises(NotImplementedError, match="mixes math"):
        Solver(SolverParameter.from_text(text), device="cpu")
    strict = Solver(SolverParameter.from_text(
        solver_text().replace("net_param {", 'net_param { '
                              'default_forward_math: FLOAT ')), device="cpu")
    assert strict.net.math_precision() == "highest"


def test_solver_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        Solver(SolverParameter.from_text(solver_text()))


# -- LR policies, update rules -----------------------------------------------

POLICIES = [
    'lr_policy: "fixed"',
    'lr_policy: "step" stepsize: 10 gamma: 0.5',
    'lr_policy: "exp" gamma: 0.999',
    'lr_policy: "inv" gamma: 0.001 power: 0.75',
    'lr_policy: "multistep" gamma: 0.3 stepvalue: 5 stepvalue: 20 '
    'stepvalue: 100',
    'lr_policy: "poly" power: 2 max_iter: 200 min_lr: 0.0001',
    'lr_policy: "sigmoid" gamma: -0.05 stepsize: 50',
    'lr_policy: "step" stepsize: 10 gamma: 0.5 rampup_interval: 20 '
    'rampup_lr: 0.001',
    'lr_policy: "fixed" momentum_policy: "poly" max_momentum: 0.99 '
    'momentum_power: 2 max_iter: 200',
    'lr_policy: "inv" gamma: 0.01 power: 0.5 momentum_policy: "opt"',
    'lr_policy: "inv" gamma: 0.01 power: 0.5 momentum_policy: "opt" '
    'max_momentum: 0.95',
]


@pytest.mark.parametrize("policy", POLICIES)
def test_lr_policy_matches_jax(policy):
    text = f"base_lr: 0.05 momentum: 0.9 {policy}"
    jsp, psp = JaxSP.from_text(text), SolverParameter.from_text(text)
    for it in (0, 1, 4, 5, 10, 17, 19, 20, 99, 100, 150, 1234):
        jr, jm = jax_lr.schedule(jsp, jnp.int32(it))
        pr, pm = lr_policy.schedule(psp, it)
        tol = dict(rtol=1e-6 + it * 2.0**-24, atol=1e-30, err_msg=it)
        np.testing.assert_allclose(pr, float(jr), **tol)
        np.testing.assert_allclose(pm, float(jm), **tol)


@pytest.mark.parametrize("l1", [False, True])
@pytest.mark.parametrize("rule", sorted(jax_updates.UPDATE_FNS))
def test_update_rule_matches_jax(rule, l1):
    rs = np.random.RandomState(4)
    w = rs.randn(7, 5).astype(np.float32)
    k = jax_updates.n_slots(rule)
    assert updates.n_slots(rule) == k
    slots = tuple(np.abs(rs.randn(7, 5)).astype(np.float32) * 1e-2
                  for _ in range(k))
    jw, js = jnp.asarray(w), tuple(jnp.asarray(s) for s in slots)
    pw, ps = torch.from_numpy(w), tuple(torch.from_numpy(s) for s in slots)
    for t in range(1, 4):
        g = rs.randn(7, 5).astype(np.float32)
        jh = jax_updates.Hyper(rate=jnp.float32(0.01), momentum=jnp.float32(
            0.9), momentum2=0.999, delta=1e-8, weight_decay=5e-4,
            reg_l1=l1, t=jnp.int32(t))
        ph = updates.Hyper(rate=0.01, momentum=0.9, momentum2=0.999,
                           delta=1e-8, weight_decay=5e-4, reg_l1=l1, t=t)
        jw0 = jw
        jw, js = jax_updates.UPDATE_FNS[rule](jw, jnp.asarray(g), js, jh,
                                              2.0, 0.5)
        pw, ps = updates.UPDATE_FNS[rule](pw, torch.from_numpy(g), ps, ph,
                                          2.0, 0.5)
        atol = 1e-8
        if rule == "Adam":
            atol = 1e-4 * float(jnp.abs(jw - jw0).max())
        np.testing.assert_allclose(pw.numpy(), np.asarray(jw), rtol=1e-5,
                                   atol=atol)
        for a, b in zip(ps, js):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-8)


# -- Solver against the JAX Solver ---------------------------------------------

@pytest.fixture(scope="module")
def five_steps():
    """5 SGD iterations of the JAX Solver and of the port's Solver from
    the same weights, feeds and dropout masks."""
    jsolver = JaxSolver(JaxSP.from_text(solver_text()))
    port = Solver(SolverParameter.from_text(solver_text()), device="cpu")
    load_jax_params(port.net, _host(jsolver.params))
    feeds = _feeds(5)
    jlosses = [jsolver.step(1, lambda k: feeds[k]) for _ in range(5)]
    port.step(5, _torch_feeds(feeds), dropout_masks=_jax_masks(jsolver))
    return jsolver, port, jlosses


def test_five_sgd_iterations_match_the_jax_solver(five_steps):
    jsolver, port, jlosses = five_steps
    assert port.iter == jsolver.iter == 5
    np.testing.assert_allclose(port.losses, jlosses, rtol=1e-5)
    _assert_params_equal(jsolver.params, port.net, **STEP)
    for lname, blobs in jsolver.opt_state.items():
        for pname, slots in blobs.items():
            np.testing.assert_allclose(
                port.history[(lname, pname)][0].numpy(),
                np.asarray(slots[0]), err_msg=f"{lname}.{pname}", **STEP)
    # the LR stepped at iteration 3 (stepsize 3): the later updates are
    # 10x smaller, so a missed schedule would show in the params


def test_test_nets_share_the_train_params_and_score_like_jax(five_steps):
    jsolver, port, _ = five_steps
    tnet = port.test_nets[0]
    assert tnet.layer_by_name("fc8").weight is \
        port.net.layer_by_name("fc8").weight
    test_feeds = _feeds(2, seed=9)
    want = jsolver.test_all([lambda k: test_feeds[k]])
    got = port.test_all([_torch_feeds(test_feeds)])
    assert set(got[0]) == {"accuracy"}
    np.testing.assert_allclose(got[0]["accuracy"], want[0]["accuracy"],
                               rtol=1e-6)


def test_resume_from_a_jax_opt_state_continues_like_jax(five_steps):
    jsolver, _, _ = five_steps
    port = Solver(SolverParameter.from_text(solver_text()), device="cpu")
    load_jax_params(port.net, _host(jsolver.params))
    load_jax_opt_state(port, _host(jsolver.opt_state))
    port.iter = jsolver.iter
    feeds = _feeds(2, seed=7)
    masks = _jax_masks(jsolver)
    twin = JaxSolver(JaxSP.from_text(solver_text("max_iter: 7")))
    twin.params, twin.opt_state, twin.iter = (jsolver.params,
                                              jsolver.opt_state, 5)
    jl = [twin.step(1, lambda k: feeds[k - 5]) for _ in range(2)]
    port.step(2, lambda k: _torch_feeds(feeds)(k - 5), dropout_masks=masks)
    np.testing.assert_allclose(port.losses, jl, rtol=1e-5)
    _assert_params_equal(twin.params, port.net, **STEP)


def test_load_jax_opt_state_is_a_checked_copy(five_steps):
    jsolver, _, _ = five_steps
    port = Solver(SolverParameter.from_text(solver_text()), device="cpu")
    host = _host(jsolver.opt_state)
    bad = {k: dict(v) for k, v in host.items()}
    del bad["fc8"]
    with pytest.raises(KeyError, match="fc8"):
        load_jax_opt_state(port, bad)
    bad = {k: dict(v) for k, v in host.items()}
    bad["fc8"]["weight"] = bad["fc8"]["weight"] * 2
    with pytest.raises(ValueError, match="slots"):
        load_jax_opt_state(port, bad)
    bad = {k: dict(v) for k, v in host.items()}
    bad["fc8"]["bias"] = (bad["fc8"]["bias"][0][:3],)
    with pytest.raises(ValueError, match="shape"):
        load_jax_opt_state(port, bad)


# -- snapshots ----------------------------------------------------------------

def test_port_snapshot_loads_in_the_jax_readers_and_solver(five_steps,
                                                           tmp_path):
    _, port, _ = five_steps
    port.sp.snapshot_prefix = str(tmp_path / "port")
    state = port.snapshot()
    assert state == str(tmp_path / "port_iter_5.solverstate")
    weights = jax_io.load_caffemodel(str(tmp_path / "port_iter_5.caffemodel"))
    for lname, blobs in port.net.export_weights().items():
        for a, b in zip(blobs, weights[lname]):
            np.testing.assert_array_equal(a, b)
    it, learned, history, _ = jax_io.load_solverstate(state)
    assert it == 5 and learned.endswith("port_iter_5.caffemodel")
    keys = [(l, p) for l, p, _ in port.net.learnable_param_decls()]
    assert len(history) == len(keys)
    for (l, p), h in zip(keys, history):
        np.testing.assert_array_equal(h, port.history[(l, p)][0].numpy())
    # the JAX solver resumes it: same iteration, weights and history
    jsolver = JaxSolver(JaxSP.from_text(solver_text()))
    jsolver.restore(state)
    assert jsolver.iter == 5
    _assert_params_equal(jsolver.params, port.net, rtol=0, atol=0)
    for l, p in keys:
        np.testing.assert_array_equal(np.asarray(jsolver.opt_state[l][p][0]),
                                      port.history[(l, p)][0].numpy())


def test_jax_snapshot_restores_into_the_port(five_steps, tmp_path):
    jsolver, _, _ = five_steps
    jsolver.sp.snapshot_prefix = str(tmp_path / "jax")
    state = jsolver.snapshot()
    port = Solver(SolverParameter.from_text(solver_text()), device="cpu")
    port.restore(state)
    assert port.iter == 5
    _assert_params_equal(jsolver.params, port.net, rtol=0, atol=0)
    for lname, blobs in jsolver.opt_state.items():
        for pname, slots in blobs.items():
            np.testing.assert_array_equal(
                port.history[(lname, pname)][0].numpy(),
                np.asarray(slots[0]))
    # the test net still shares the restored weights
    assert port.test_nets[0].layer_by_name("conv1").weight is \
        port.net.layer_by_name("conv1").weight


def test_resumed_port_run_equals_the_uninterrupted_one(tmp_path):
    """Dropout draws from the port's own generator here: it is reseeded
    from (random_seed, iteration), so a resume draws the same masks."""
    feeds = _feeds(4, seed=5)
    whole = Solver(SolverParameter.from_text(solver_text()), device="cpu")
    whole.step(4, _torch_feeds(feeds))
    first = Solver(SolverParameter.from_text(solver_text()), device="cpu")
    first.step(2, _torch_feeds(feeds))
    first.sp.snapshot_prefix = str(tmp_path / "half")
    state = first.snapshot()
    resumed = Solver(SolverParameter.from_text(solver_text()), device="cpu")
    resumed.restore(state)
    resumed.step(2, _torch_feeds(feeds))
    assert resumed.losses == whole.losses[2:]
    for (_, _, _, a), (_, _, _, b) in zip(whole._decls, resumed._decls):
        assert torch.equal(a, b)


def test_blob_binaryproto_round_trips(tmp_path):
    a = np.random.RandomState(6).randn(2, 3, 4).astype(np.float32)
    path = str(tmp_path / "mean.binaryproto")
    port_io.save_blob_binaryproto(path, a)
    np.testing.assert_array_equal(jax_io.load_blob_binaryproto(path), a)
    np.testing.assert_array_equal(port_io.load_blob_binaryproto(path), a)
    assert os.listdir(tmp_path) == ["mean.binaryproto"]  # no temp left


# -- CLI train ----------------------------------------------------------------

def _write_solver(tmp_path, batch=B):
    net = tmp_path / "train_val.prototxt"
    net.write_text('name: "SmallAlexNet"\n' + train_val(batch))
    solver = tmp_path / "solver.prototxt"
    solver.write_text(
        f'net: "{net}"\ntest_iter: 1\ntest_interval: 1000\nbase_lr: 0.01\n'
        'lr_policy: "step"\ngamma: 0.1\nstepsize: 100000\ndisplay: 1\n'
        'max_iter: 450000\nmomentum: 0.9\nweight_decay: 0.0005\n'
        'snapshot: 10000\n')
    return solver


def test_synthetic_feed_draws_what_the_jax_cli_draws(tmp_path):
    solver = _write_solver(tmp_path)
    jsolver = JaxSolver(JaxSP.from_file(str(solver)))
    port = Solver(SolverParameter.from_file(str(solver)), device="cpu")
    for net, tnet, seed in ((jsolver.net, port.net, 0),
                            (jsolver.test_nets[0], port.test_nets[0], 1)):
        want = jax_synthetic_feed(net, seed=seed)
        got = cli.synthetic_feed(tnet, seed=seed)
        assert list(got) == list(want) == ["data", "label"]
        for key in want:
            np.testing.assert_array_equal(got[key].numpy(),
                                          np.asarray(want[key]))
        assert int(got["label"].max()) < 10


def test_cli_train_on_the_cpu_exits_zero_and_snapshots(tmp_path):
    solver = _write_solver(tmp_path)
    prefix = str(tmp_path / "snap" / "small")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(
        [sys.executable, "-m", "caffe_mpi_tpu_torch.tools.cli", "train",
         "-solver", str(solver), "-synthetic", "-max_iter", "2",
         "-snapshot_prefix", prefix, "-device", "cpu"],
        cwd=_ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    line = [l for l in proc.stdout.splitlines() if l.startswith('{"train"')]
    import json
    summary = json.loads(line[-1])["train"]
    assert summary["iters"] == 2 and len(summary["losses"]) == 2
    assert np.all(np.isfinite(summary["losses"]))
    assert summary["test_scores"][0].keys() == {"accuracy"}
    assert summary["snapshot"] == prefix + "_iter_2.solverstate"
    # resume it for one more iteration, in-process
    args = cli.parse_args(["train", "-solver", str(solver), "-synthetic",
                           "-max_iter", "3", "-snapshot", summary["snapshot"],
                           "-snapshot_prefix", prefix, "-device", "cpu"])
    solver_obj, again = cli.train(args)
    assert again["start_iter"] == 2 and again["iters"] == 1
    assert solver_obj.iter == 3
    assert os.path.exists(prefix + "_iter_3.caffemodel")


def test_cli_train_without_synthetic_or_solver_fails(tmp_path):
    solver = _write_solver(tmp_path)
    assert cli.main(["train", "-solver", str(solver), "-device",
                     "cpu"]) == 1
    assert cli.main(["train", "-device", "cpu"]) == 1
