"""Port parity: GPipe over heterogeneous stages (caffe_mpi_tpu_torch/
parallel/gpipe.py, `Net.forward_range`, `Solver(gpipe=)`, `cli train
-gpipe`) against the JAX package's parallel/gpipe.py and `Solver(gpipe=)`,
on the CPU (every stage on the CPU; the JAX stages on the virtual CPU
devices conftest.py makes).

- `boundary_blobs` at every cut and `auto_boundaries` for 2-4 stages equal
  JAX's on a small CNN, on GoogLeNet and on ResNet-18 (batch cut to 2);
- `GPipe.train_step` at S = 2, 3, 4 against JAX `GPipe.train_step` from
  the same weights and micro-batches (loss, gradients, BatchNorm state),
  and against the port's own sequential loop over the micro-batches;
- a param shared by name across a stage cut;
- five `Solver(gpipe=)` iterations against the JAX `Solver(gpipe=)`,
  plain, with clip_gradients and with global_grad_scale; a GPipe
  snapshot restored into a plain solver and the reverse; stage 0's
  evaluation; `_chunk_at`;
- `cli train -gpipe` on a narrowed GoogLeNet against the iter_size run
  of the same micro-batches, and the refusals, message for message.

Tolerances, float32 (the solver bars of test_torch_train.py): losses rtol
1e-5; params, history and statistics rtol 1e-5 / atol 1e-6; gradients
1e-5 of the largest element.
"""

import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caffe_mpi_tpu.net import Net as JaxNet
from caffe_mpi_tpu.parallel import MeshPlan as JaxMeshPlan
from caffe_mpi_tpu.parallel.gpipe import GPipe as JaxGPipe
from caffe_mpi_tpu.parallel.gpipe import auto_boundaries as jax_auto
from caffe_mpi_tpu.parallel.gpipe import boundary_blobs as jax_boundary
from caffe_mpi_tpu.proto import NetParameter as JaxNP
from caffe_mpi_tpu.proto import SolverParameter as JaxSP
from caffe_mpi_tpu.solver import Solver as JaxSolver
from caffe_mpi_tpu_torch.net import Net
from caffe_mpi_tpu_torch.parallel import mesh as mesh_mod
from caffe_mpi_tpu_torch.parallel.gpipe import (GPipe, auto_boundaries,
                                                boundary_blobs, lrn_launches)
from caffe_mpi_tpu_torch.proto import NetParameter, SolverParameter
from caffe_mpi_tpu_torch.solver import Solver
from caffe_mpi_tpu_torch.tools import cli
from caffe_mpi_tpu_torch.weights import load_jax_params

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS = dict(rtol=1e-5)
STEP = dict(rtol=1e-5, atol=1e-6)
GRAD = 1e-5  # of the largest element

SMALL_CNN = """
name: "gpipe_cnn"
layer { name: "in" type: "Input" top: "data" top: "label"
        input_param { shape { dim: 2 dim: 3 dim: 16 dim: 16 }
                      shape { dim: 2 } } }
layer { name: "conv1" type: "Convolution" bottom: "data" top: "conv1"
        convolution_param { num_output: 8 kernel_size: 3 pad: 1
          weight_filler { type: "msra" } } }
layer { name: "bn1" type: "BatchNorm" bottom: "conv1" top: "conv1"
        batch_norm_param { scale_bias: true } }
layer { name: "relu1" type: "ReLU" bottom: "conv1" top: "conv1" }
layer { name: "pool1" type: "Pooling" bottom: "conv1" top: "pool1"
        pooling_param { pool: MAX kernel_size: 2 stride: 2 } }
layer { name: "norm1" type: "LRN" bottom: "pool1" top: "norm1"
        lrn_param { local_size: 5 alpha: 0.0001 beta: 0.75 } }
layer { name: "conv2" type: "Convolution" bottom: "norm1" top: "conv2"
        convolution_param { num_output: 16 kernel_size: 3 pad: 1 stride: 2
          weight_filler { type: "msra" } } }
layer { name: "relu2" type: "ReLU" bottom: "conv2" top: "conv2" }
layer { name: "aux" type: "InnerProduct" bottom: "pool1" top: "aux"
        inner_product_param { num_output: 10
          weight_filler { type: "xavier" } } }
layer { name: "aux_loss" type: "SoftmaxWithLoss" bottom: "aux"
        bottom: "label" top: "aux_loss" loss_weight: 0.3 }
layer { name: "ip" type: "InnerProduct" bottom: "conv2" top: "logits"
        inner_product_param { num_output: 10
          weight_filler { type: "xavier" } } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "logits"
        bottom: "label" top: "loss" }
layer { name: "acc" type: "Accuracy" bottom: "logits" bottom: "label"
        top: "acc" }
"""

SHARED_NET = """
name: "gpipe_shared"
layer { name: "in" type: "Input" top: "x" top: "label"
        input_param { shape { dim: 2 dim: 12 } shape { dim: 2 } } }
layer { name: "fc1" type: "InnerProduct" bottom: "x" top: "h1"
        param { name: "w_tied" } param { name: "b_tied" }
        inner_product_param { num_output: 12
          weight_filler { type: "xavier" } } }
layer { name: "relu1" type: "ReLU" bottom: "h1" top: "h1" }
layer { name: "fc2" type: "InnerProduct" bottom: "h1" top: "h2"
        param { name: "w_tied" } param { name: "b_tied" }
        inner_product_param { num_output: 12
          weight_filler { type: "xavier" } } }
layer { name: "relu2" type: "ReLU" bottom: "h2" top: "h2" }
layer { name: "out" type: "InnerProduct" bottom: "h2" top: "logits"
        inner_product_param { num_output: 4
          weight_filler { type: "xavier" } } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "logits"
        bottom: "label" top: "loss" }
"""

# the JAX test_gpipe_solver.py net and solver
SOLVER_NET = """
name: "gps_net"
layer { name: "in" type: "Input" top: "data" top: "label"
        input_param { shape { dim: 8 dim: 3 dim: 16 dim: 16 }
                      shape { dim: 8 } } }
layer { name: "conv1" type: "Convolution" bottom: "data" top: "c1"
        convolution_param { num_output: 8 kernel_size: 3 pad: 1
          weight_filler { type: "msra" } } }
layer { name: "r1" type: "ReLU" bottom: "c1" top: "c1" }
layer { name: "pool1" type: "Pooling" bottom: "c1" top: "p1"
        pooling_param { pool: MAX kernel_size: 2 stride: 2 } }
layer { name: "ip1" type: "InnerProduct" bottom: "p1" top: "h"
        inner_product_param { num_output: 32
          weight_filler { type: "xavier" } } }
layer { name: "r2" type: "ReLU" bottom: "h" top: "h" }
layer { name: "ip2" type: "InnerProduct" bottom: "h" top: "y"
        inner_product_param { num_output: 10
          weight_filler { type: "xavier" } } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "y" bottom: "label"
        top: "l" }
"""
SOLVER_TXT = ('base_lr: 0.05 momentum: 0.9 lr_policy: "fixed" max_iter: 40 '
              'type: "SGD" random_seed: 7 ')


def _zoo_param(cls, path, batch=2, narrow=1):
    """A zoo net with its Input batch set to `batch` and every
    num_output divided by `narrow` (at least 1)."""
    param = cls.from_file(os.path.join(_ROOT, path))
    for lp in param.layer:
        if lp.type == "Input" and lp.input_param:
            for shape in lp.input_param.shape:
                shape.dim[0] = batch
        if narrow > 1:
            for p in (lp.convolution_param, lp.inner_product_param):
                if p is not None and p.num_output and lp.name not in (
                        "loss3/classifier", "loss1/classifier",
                        "loss2/classifier"):
                    p.num_output = max(p.num_output // narrow, 1)
    return param


NETS = {"small_cnn": lambda cls: cls.from_text(SMALL_CNN),
        "googlenet": lambda cls: _zoo_param(
            cls, "models/googlenet/train_val.prototxt"),
        "resnet18": lambda cls: _zoo_param(
            cls, "models/resnet18/train_val.prototxt")}


def _nets(name):
    return (JaxNet(NETS[name](JaxNP), phase="TRAIN"),
            Net(NETS[name](NetParameter), "TRAIN", device="cpu"))


@pytest.mark.parametrize("name", sorted(NETS))
def test_boundaries_and_auto_cuts_equal_jax(name):
    jnet, net = _nets(name)
    n = len(net.layers)
    assert [l.name for l in net.layers] == [l.name for l in jnet.layers]
    for cut in range(1, n + 1):
        assert boundary_blobs(net, cut, n) == jax_boundary(jnet, cut, n)
        assert boundary_blobs(net, 0, cut) == jax_boundary(jnet, 0, cut)
    for s in (2, 3, 4):
        assert auto_boundaries(net, s) == jax_auto(jnet, s), s
    # the in-place tops resolve per consumer stage, as JAX resolves them
    gp, jgp = GPipe(net, 4), JaxGPipe(jnet, 4, devices=jax.devices()[:4])
    assert gp.in_blobs == jgp.in_blobs and gp.out_blobs == jgp.out_blobs
    assert gp._in_producer == jgp._in_producer
    assert gp.feed_keys == jgp.feed_keys
    assert gp.param_layers == jgp.param_layers


def _micro(net, n, seed=0, classes=10):
    r = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        f = {}
        for key, (shape, kind) in net.feed_specs.items():
            f[key] = (r.randint(0, classes, shape).astype(np.int32)
                      if key == "label"
                      else r.randn(*shape).astype(np.float32))
        out.append(f)
    return out


def _torch(feeds):
    return [{k: torch.from_numpy(v) for k, v in f.items()} for f in feeds]


def _sequential(net, feeds):
    """The port's iter_size loop: each micro-batch's forward and backward
    in order, the loss and gradients averaged."""
    decls = [(l, p, getattr(net.layer_by_name(l), p))
             for l, p, _ in net.learnable_param_decls()]
    for _, _, p in decls:
        p.grad = None
    total = 0.0
    for f in feeds:
        _, loss = net(f)
        loss.backward()
        total += float(loss.detach())
    n = len(feeds)
    return total / n, {(l, p): t.grad / n for l, p, t in decls
                       if t.grad is not None}


def _assert_grads(got, want, what):
    """Each gradient within GRAD of its largest element; one that is zero
    in exact arithmetic (a convolution's bias before a BatchNorm: its
    largest element under 1e-6 of the net's largest gradient) within
    GRAD of the net's largest gradient."""
    want = {k: np.asarray(w) for k, w in want.items()}
    top = max(float(np.abs(w).max()) for w in want.values())
    assert set(got) == set(want), (what, set(got) ^ set(want))
    for key, w in want.items():
        g = got[key].detach().numpy()
        scale = float(np.abs(w).max())
        if scale < 1e-6 * top:
            scale = top
        err = float(np.abs(g - w).max()) / scale
        assert err <= GRAD, (what, key, err)


def _state(net):
    return {(l, n): b.detach().numpy().copy()
            for l, n, b in net.state_buffers()}


def _init_pair(name, seed=0):
    jnet, net = _nets(name)
    params, state = jnet.init(jax.random.PRNGKey(seed))
    load_jax_params(net, jax.tree_util.tree_map(np.asarray, params),
                    jax.tree_util.tree_map(np.asarray, state))
    for lname, pname, decl in net.learnable_param_decls():
        getattr(net.layer_by_name(lname), pname).requires_grad_(
            decl.lr_mult != 0)
    return jnet, params, state, net


@pytest.mark.parametrize("n_stages", [2, 3, 4])
def test_train_step_matches_jax_gpipe_and_the_sequential_loop(n_stages):
    jnet, params, state, net = _init_pair("small_cnn")
    feeds = _micro(net, 4, seed=1)
    jgp = JaxGPipe(jnet, n_stages, devices=jax.devices()[:n_stages])
    jloss, jgrads, jstate = jgp.train_step(
        jgp.place_params(params), state,
        [jax.tree_util.tree_map(jnp.asarray, f) for f in feeds])
    gp = GPipe(net, n_stages, devices=["cpu"] * n_stages)
    assert gp.bounds == jgp.bounds
    state0 = _state(net)
    loss, grads = gp.train_step(_torch(feeds))
    np.testing.assert_allclose(float(loss), float(jloss), **LOSS)
    _assert_grads(grads, {(l, p): g for l, t in jgrads.items()
                          for p, g in t.items()}, "jax")
    for (l, n), v in _state(net).items():
        np.testing.assert_allclose(v, np.asarray(jstate[l][n]),
                                   err_msg=f"{l}.{n}", **STEP)
    # the port's iter_size loop from the same start
    gstate = _state(net)
    with torch.no_grad():
        for l, n, b in net.state_buffers():
            b.copy_(torch.from_numpy(state0[(l, n)]))
    sloss, sgrads = _sequential(net, _torch(feeds))
    np.testing.assert_allclose(float(loss), sloss, **LOSS)
    _assert_grads(grads, {k: v.numpy() for k, v in sgrads.items()}, "seq")
    for key, v in _state(net).items():
        np.testing.assert_allclose(gstate[key], v, err_msg=str(key), **STEP)


def test_loss_scale_seeds_the_backward_scaled():
    _, _, _, net = _init_pair("small_cnn")
    feeds = _torch(_micro(net, 2, seed=4))
    gp = GPipe(net, 3, devices=["cpu"] * 3)
    state0 = _state(net)
    loss, grads = gp.train_step(feeds)
    with torch.no_grad():
        for l, n, b in net.state_buffers():
            b.copy_(torch.from_numpy(state0[(l, n)]))
    loss2, grads2 = gp.train_step(feeds, loss_scale=1024.0)
    assert float(loss2) == float(loss)  # the loss is not scaled
    _assert_grads({k: v / 1024.0 for k, v in grads2.items()},
                  {k: v.numpy() for k, v in grads.items()}, "scale")


def test_shared_params_across_stages():
    """fc1 owns the tied weight, fc2 (another stage) reads a per-step copy
    and sends its gradient back to the owner's; both JAX's and the
    sequential loop's gradients result. Leaving the copy's gradient out
    (the planted fault) is far from them."""
    jnet = JaxNet(JaxNP.from_text(SHARED_NET), phase="TRAIN")
    net = Net(NetParameter.from_text(SHARED_NET), "TRAIN", device="cpu")
    assert net.owner_of("fc2", "weight") == ("fc1", "weight")
    params, state = jnet.init(jax.random.PRNGKey(2))
    load_jax_params(net, jax.tree_util.tree_map(np.asarray, params))
    for lname, pname, _ in net.learnable_param_decls():
        getattr(net.layer_by_name(lname), pname).requires_grad_(True)
    r = np.random.RandomState(5)
    feeds = [{"x": r.randn(2, 12).astype(np.float32),
              "label": r.randint(0, 4, 2).astype(np.int32)}
             for _ in range(3)]
    cut = [l.name for l in net.layers].index("fc2")
    bounds = [0, cut, len(net.layers)]
    jgp = JaxGPipe(jnet, boundaries=bounds, devices=jax.devices()[:2])
    jloss, jgrads, _ = jgp.train_step(
        jgp.place_params(params), state,
        [jax.tree_util.tree_map(jnp.asarray, f) for f in feeds])
    gp = GPipe(net, boundaries=bounds, devices=["cpu", "cpu"])
    assert "fc1" in gp.param_layers[1] and gp.param_layers == \
        jgp.param_layers
    loss, grads = gp.train_step(_torch(feeds))
    np.testing.assert_allclose(float(loss), float(jloss), **LOSS)
    _assert_grads(grads, {(l, p): g for l, t in jgrads.items()
                          for p, g in t.items()}, "jax")
    _, sgrads = _sequential(net, _torch(feeds))
    _assert_grads(grads, {k: v.numpy() for k, v in sgrads.items()}, "seq")
    # the fault: the referencing stage's gradient not sent back
    gp._stage_params = lambda s, f=gp._stage_params: (f(s)[0], [])
    _, bad = gp.train_step(_torch(feeds))
    w, g = sgrads[("fc1", "weight")], bad[("fc1", "weight")]
    assert float((g - w).abs().max()) / float(w.abs().max()) > 1e-2


# -- the Solver ---------------------------------------------------------------

def _halves(n, seed=3):
    r = np.random.RandomState(seed)
    return [{"data": r.randn(4, 3, 16, 16).astype(np.float32),
             "label": r.randint(0, 10, 4).astype(np.int32)}
            for _ in range(n)]


def _solvers(extra="", micro=2, stages=2):
    jsp = JaxSP.from_text(SOLVER_TXT + extra)
    jsp.net_param = JaxNP.from_text(SOLVER_NET)
    psp = SolverParameter.from_text(SOLVER_TXT + extra)
    psp.net_param = NetParameter.from_text(SOLVER_NET)
    js = JaxSolver(jsp, gpipe={"stages": stages, "micro": micro})
    port = Solver(psp, device="cpu",
                  gpipe={"stages": stages, "micro": micro})
    load_jax_params(port.net, jax.tree_util.tree_map(np.asarray, js.params))
    return js, port


def _assert_solver_equal(js, port):
    for lname, blobs in js.params.items():
        for pname, arr in blobs.items():
            np.testing.assert_allclose(
                getattr(port.net.layer_by_name(lname), pname).detach()
                .numpy(), np.asarray(arr), err_msg=f"{lname}.{pname}",
                **STEP)
            np.testing.assert_allclose(
                port.history[(lname, pname)][0].numpy(),
                np.asarray(js.opt_state[lname][pname][0]),
                err_msg=f"{lname}.{pname} history", **STEP)


@pytest.mark.parametrize("extra", ["", "clip_gradients: 0.8",
                                   "global_grad_scale: 1000"])
def test_five_iterations_match_the_jax_gpipe_solver(extra):
    halves = _halves(10)
    js, port = _solvers(extra)
    assert port._batch_images() == 4 and port.gpipe.bounds == \
        js.gpipe.bounds
    jl = [js.step(1, lambda it: {k: jnp.asarray(v) for k, v in
                                 halves[it].items()}) for _ in range(5)]
    port.step(5, lambda it: _torch([halves[it]])[0])
    np.testing.assert_allclose(port.losses, jl, **LOSS)
    _assert_solver_equal(js, port)
    assert port.dispatch_count == 5  # an iteration a dispatch


def _plain(extra="", iter_size=2):
    sp = SolverParameter.from_text(SOLVER_TXT + extra
                                   + f" iter_size: {iter_size}")
    sp.net_param = NetParameter.from_text(
        SOLVER_NET.replace("dim: 8 dim: 3", "dim: 4 dim: 3")
        .replace("shape { dim: 8 }", "shape { dim: 4 }"))
    return Solver(sp, device="cpu")


def _gp(extra=""):
    sp = SolverParameter.from_text(SOLVER_TXT + extra)
    sp.net_param = NetParameter.from_text(SOLVER_NET)
    return Solver(sp, device="cpu", gpipe={"stages": 2, "micro": 2})


def _params(solver):
    out = {f"{l}.{p}": t.detach().clone() for l, p, _, t in solver._decls}
    for (l, p), slots in solver.history.items():
        out[f"{l}.{p}.h"] = slots[0].clone()
    return out


def _assert_params_close(a, b):
    for k in a:
        np.testing.assert_allclose(b[k].numpy(), a[k].numpy(),
                                   err_msg=k, **STEP)


def test_gpipe_equals_the_iter_size_run_and_snapshots_cross_modes(tmp_path):
    """GPipe at M micro-batches is iter_size M's contract; a GPipe
    snapshot restores into a plain solver and the reverse (stage
    placement is not in the checkpoint), both continuing the
    uninterrupted run."""
    halves = _halves(16)
    feed = lambda it: _torch([halves[it]])[0]  # noqa: E731
    ref = _gp()
    ref.step(8, feed)
    seq = _plain()
    seq.step(8, feed)
    np.testing.assert_allclose(seq.losses, ref.losses, **LOSS)
    _assert_params_close(_params(seq), _params(ref))

    a = _gp()
    a.sp.snapshot_prefix = str(tmp_path / "gp")
    a.step(4, feed)
    path = a.snapshot()
    b = _plain()
    b.restore(path)
    assert b.iter == 4
    b.step(4, feed)
    _assert_params_close(_params(b), _params(ref))
    c = _plain()
    c.sp.snapshot_prefix = str(tmp_path / "seq")
    c.step(4, feed)
    d = _gp()
    d.restore(c.snapshot())
    d.step(4, feed)
    _assert_params_close(_params(d), _params(ref))


def test_stage_zero_evaluation_scores_as_the_plain_solver(tmp_path):
    """The test net evaluates whole on stage 0's device through the
    weights' copies, in training (test_interval) and by test_all: the
    scores equal a plain solver's on the same weights."""
    halves = _halves(8)
    feed = lambda it: _torch([halves[it]])[0]  # noqa: E731
    full = [{k: np.concatenate([halves[2 * i][k], halves[2 * i + 1][k]])
             for k in halves[0]} for i in range(2)]
    test = lambda k: _torch([full[k % 2]])[0]  # noqa: E731
    extra = ' test_iter: 2 test_interval: 2 snapshot_prefix: "%s"' % (
        tmp_path / "s")
    gp = _gp(extra)
    assert len(gp.test_nets) == 1
    gp.step(4, feed, [test])
    assert [e["iter"] for e in gp.eval_log] == [0, 2]
    scores = gp.test_all([test])
    path = gp.snapshot()
    sp = SolverParameter.from_text(SOLVER_TXT + extra)
    sp.net_param = NetParameter.from_text(SOLVER_NET)
    plain = Solver(sp, device="cpu")
    plain.restore(path)
    assert plain.test_all([test]) == scores
    assert np.isfinite(list(scores[0].values())).all()


def test_chunk_at_is_one_under_gpipe():
    gp = _gp(" step_chunk: 4 display: 100")
    assert gp._chunk_at(1, 10) == 1
    plain = _plain(" step_chunk: 4 display: 100")
    assert plain._chunk_at(1, 10) == 4


def test_stage_params_and_history_live_on_their_stage_device():
    """Each stage's params, state and history share one device (the
    stages' devices are all the CPU here; the owner map partitions the
    params as JAX's does)."""
    js, port = _solvers(stages=2)
    for lname in {l for l, _, _, _ in port._decls}:
        assert port.gpipe.owner_stage(lname) == js.gpipe.owner_stage(lname)
    owned = [port.gpipe.owned_param_layers(s) for s in range(2)]
    assert owned == [js.gpipe.owned_param_layers(s, js.params)
                     for s in range(2)]
    for (l, p), slots in port.history.items():
        dev = getattr(port.net.layer_by_name(l), p).device
        assert all(s.device == dev for s in slots)


# -- refusals -----------------------------------------------------------------

REFUSALS = {
    "bf16": ('precision: "bf16"', None, "precision: bf16 is unsupported"),
    "mesh": ("", "mesh", "mutually exclusive"),
    "zero_stage": ("zero_stage: 1", "mesh", None),
    "iter_size": ("iter_size: 2", None, "iter_size > 1 under gpipe"),
    "train_guard": ("train_guard: true", None, "train_guard is unsupported"),
}


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_gpipe_refusals_match_the_jax_solver(name):
    extra, mesh, match = REFUSALS[name]
    jsp = JaxSP.from_text(SOLVER_TXT + extra)
    jsp.net_param = JaxNP.from_text(SOLVER_NET)
    psp = SolverParameter.from_text(SOLVER_TXT + extra)
    psp.net_param = NetParameter.from_text(SOLVER_NET)
    with pytest.raises(ValueError) as jerr:
        JaxSolver(jsp, gpipe={"stages": 2},
                  mesh=JaxMeshPlan.data_parallel() if mesh else None)
    pmesh = None
    try:
        if mesh:
            pmesh = mesh_mod.MeshPlan.from_shape(1, devices=["cpu"])
        with pytest.raises(ValueError) as perr:
            Solver(psp, device=None if pmesh else "cpu", mesh=pmesh,
                   gpipe={"stages": 2})
    finally:
        mesh_mod.shutdown_distributed()
    if match is not None:
        assert match in str(jerr.value) and match in str(perr.value)
    # the same refusal: the port's message is one the JAX solver gives
    assert str(perr.value) in {str(jerr.value),
                               "zero_stage with gpipe is unsupported",
                               "gpipe and mesh are mutually exclusive "
                               "(pipeline stages own whole devices)"}


# -- the CLI on a narrowed GoogLeNet -----------------------------------------

def _googlenet_solver(tmp_path, batch, iter_size=1):
    param = _zoo_param(NetParameter, "models/googlenet/train_val.prototxt",
                       batch=batch, narrow=16)
    net = tmp_path / f"googlenet_b{batch}.prototxt"
    net.write_text(param.to_prototxt())
    solver = tmp_path / f"solver_b{batch}.prototxt"
    solver.write_text(f'net: "{net}"\nbase_lr: 0.01\nmomentum: 0.9\n'
                      'lr_policy: "fixed"\nmax_iter: 2\nrandom_seed: 5\n'
                      f'iter_size: {iter_size}\n')
    return str(solver)


def test_cli_gpipe_trains_googlenet_as_its_iter_size_run(tmp_path, capsys):
    """`train -gpipe 4 -gpipe_micro 2` on GoogLeNet (every num_output / 16,
    batch 4: two micro-batches of 2, three losses) against `iter_size 2`
    at batch 2 on the same micro-batches (the synthetic feed and the
    Dropout draws are the micro-batch's in both)."""
    rc = cli.main(["train", "-solver", _googlenet_solver(tmp_path, 4),
                   "-synthetic", "-device", "cpu", "-gpipe", "4",
                   "-gpipe_micro", "2"])
    assert rc == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    rc = cli.main(["train", "-solver", _googlenet_solver(tmp_path, 2, 2),
                   "-synthetic", "-device", "cpu"])
    assert rc == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    g, w = got["train"], want["train"]
    assert g["gpipe"]["stages"] == 4 and g["gpipe"]["micro"] == 2
    assert g["batch"] == w["batch"] == 4 and g["rank_batch"] == 2
    assert g["gpipe"]["bounds"] == auto_boundaries(
        Net(NetParameter.from_file(re.search(
            r'net: "(.*)"', open(_googlenet_solver(tmp_path, 2, 2))
            .read()).group(1)), "TRAIN", device="cpu"), 4)
    np.testing.assert_allclose(g["losses"], w["losses"], **LOSS)


def test_lrn_launch_predictor_on_googlenets_cut():
    """GoogLeNet's two across-channel LRNs at S = 4, M = 4: K1 16 an
    iteration (8 forward wavefront, 8 recompute), K2 8."""
    net = Net(NETS["googlenet"](NetParameter), "TRAIN", device="cpu")
    assert lrn_launches(GPipe(net, 4), 4) == (16, 8)
    assert lrn_launches(GPipe(net, 2), 1) == (4, 2)
