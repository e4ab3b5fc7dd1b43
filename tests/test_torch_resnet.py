"""Port parity: a narrow ResNet with BatchNorm, Scale and Concat trains,
tests, snapshots and serves like the JAX package, running statistics
included, on the CPU.

The net: Conv -> BatchNorm(scale_bias) -> ReLU, a residual block whose
second branch ends in the BVLC pair BatchNorm + Scale(bias_term), an
Eltwise SUM, a Concat of a 1x1 and a 3x3 branch, BatchNorm(scale_bias),
a global AVE pool, InnerProduct and SoftmaxWithLoss (TRAIN) or Accuracy
(TEST). moving_average_fraction 0.9 so the statistics move visibly in a
few steps.

Tolerances, float32 throughout: 5 SGD iterations against the JAX Solver,
losses rtol 1e-5, every parameter, history slot and running statistic
rtol 1e-5 / atol 1e-6 (as tests/test_torch_train.py: layers of f32 sums
in another order, forward and backward, five times over); test scores
rtol 1e-5; snapshots and restores bitwise (the same float32 blobs).
"""

import jax
import numpy as np
import pytest
import torch

from caffe_mpi_tpu import io as jax_io
from caffe_mpi_tpu.net import Net as JaxNet
from caffe_mpi_tpu.proto import NetParameter as JaxNP
from caffe_mpi_tpu.proto import SolverParameter as JaxSP
from caffe_mpi_tpu.solver import Solver as JaxSolver
from caffe_mpi_tpu_torch import io as port_io
from caffe_mpi_tpu_torch.net import Net
from caffe_mpi_tpu_torch.proto import NetParameter, SolverParameter
from caffe_mpi_tpu_torch.serving.engine import InferenceModel
from caffe_mpi_tpu_torch.solver import Solver
from caffe_mpi_tpu_torch.weights import load_jax_opt_state, load_jax_params

B = 4
SEED = 5
STEP = dict(rtol=1e-5, atol=1e-6)


def _conv(name, bottom, n, k=3, pad=1):
    return (f'layer {{ name: "{name}" type: "Convolution" bottom: "{bottom}" '
            f'top: "{name}" convolution_param {{ num_output: {n} '
            f'kernel_size: {k} pad: {pad} bias_term: false weight_filler '
            '{ type: "msra" } } }\n')


def _bn(name, bottom, top, scale_bias=True):
    sb = "scale_bias: true " if scale_bias else ""
    return (f'layer {{ name: "{name}" type: "BatchNorm" bottom: "{bottom}" '
            f'top: "{top}" batch_norm_param {{ {sb}eps: 0.0001 '
            'moving_average_fraction: 0.9 } }\n')


def _relu(name, blob):
    return (f'layer {{ name: "{name}" type: "ReLU" bottom: "{blob}" '
            f'top: "{blob}" }}\n')


def body():
    """The layers after the input."""
    return (
        _conv("conv1", "data", 8) + _bn("bn1", "conv1", "bn1")
        + _relu("relu1", "bn1")
        + _conv("res_a", "bn1", 8) + _bn("res_a_bn", "res_a", "res_a_bn")
        + _relu("res_a_relu", "res_a_bn")
        + _conv("res_b", "res_a_bn", 8)
        + _bn("res_b_bn", "res_b", "res_b_bn", scale_bias=False)
        + 'layer { name: "res_b_scale" type: "Scale" bottom: "res_b_bn" '
          'top: "res_b_bn" scale_param { bias_term: true } }\n'
        + 'layer { name: "res" type: "Eltwise" bottom: "bn1" '
          'bottom: "res_b_bn" top: "res" }\n'
        + _relu("res_relu", "res")
        + _conv("br1", "res", 4, k=1, pad=0) + _conv("br3", "res", 4)
        + 'layer { name: "cat" type: "Concat" bottom: "br1" bottom: "br3" '
          'top: "cat" }\n'
        + _bn("cat_bn", "cat", "cat_bn") + _relu("cat_relu", "cat_bn")
        + 'layer { name: "pool" type: "Pooling" bottom: "cat_bn" '
          'top: "pool" pooling_param { pool: AVE global_pooling: true } }\n'
        + 'layer { name: "fc" type: "InnerProduct" bottom: "pool" '
          'top: "fc" inner_product_param { num_output: 10 weight_filler '
          '{ type: "gaussian" std: 0.1 } } }\n')


def train_val(batch=B):
    return (
        f'layer {{ name: "data" type: "Input" top: "data" top: "label" '
        f'input_param {{ shape {{ dim: {batch} dim: 3 dim: 12 dim: 12 }} '
        f'shape {{ dim: {batch} }} }} }}\n' + body()
        + 'layer { name: "loss" type: "SoftmaxWithLoss" bottom: "fc" '
          'bottom: "label" top: "loss" include { phase: TRAIN } }\n'
        + 'layer { name: "accuracy" type: "Accuracy" bottom: "fc" '
          'bottom: "label" top: "accuracy" include { phase: TEST } }\n')


def deploy(batch=B):
    return (f'name: "NarrowResNet" layer {{ name: "data" type: "Input" '
            f'top: "data" input_param {{ shape {{ dim: {batch} dim: 3 '
            f'dim: 12 dim: 12 }} }} }}\n' + body()
            + 'layer { name: "prob" type: "Softmax" bottom: "fc" '
              'top: "prob" }\n')


def solver_text(extra=""):
    return ('net_param { name: "NarrowResNet" ' + train_val() + ' }\n'
            'base_lr: 0.05 lr_policy: "poly" power: 2.0 max_iter: 10 '
            'momentum: 0.9 weight_decay: 0.0001 '
            f'random_seed: {SEED} test_iter: 2 test_interval: 100\n' + extra)


def _feeds(n, seed=0):
    rs = np.random.RandomState(seed)
    return [{"data": (rs.randn(B, 3, 12, 12) * 2 + 0.5).astype(np.float32),
             "label": rs.randint(0, 10, B).astype(np.int32)}
            for _ in range(n)]


def _torch_feeds(feeds, offset=0):
    return lambda k: {key: torch.from_numpy(v) for key, v in
                      feeds[k - offset].items()}


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_tree(jtree, net, **tol):
    """Every array of a JAX params or state tree against the port's."""
    for lname, blobs in jtree.items():
        for name, arr in blobs.items():
            got = getattr(net.layer_by_name(lname), name).detach().numpy()
            np.testing.assert_allclose(got, np.asarray(arr),
                                       err_msg=f"{lname}.{name}", **tol)


def _state_tree(net):
    out = {}
    for lname, sname, buf in net.state_buffers():
        out.setdefault(lname, {})[sname] = buf.detach().numpy().copy()
    return out


def _port_solver(extra=""):
    return Solver(SolverParameter.from_text(solver_text(extra)),
                  device="cpu")


@pytest.fixture(scope="module")
def five_steps():
    """5 SGD iterations of the JAX Solver and of the port's from the same
    weights and feeds; the port's statistics start from the JAX zeros."""
    jsolver = JaxSolver(JaxSP.from_text(solver_text()))
    port = _port_solver()
    load_jax_params(port.net, _host(jsolver.params),
                    _host(jsolver.net_state))
    feeds = _feeds(5)
    jlosses = [jsolver.step(1, lambda k: feeds[k]) for _ in range(5)]
    port.step(5, _torch_feeds(feeds))
    return jsolver, port, jlosses


def test_narrow_resnet_has_the_jax_shapes_and_state():
    jnet = JaxNet(JaxNP.from_text(train_val()), "TRAIN")
    net = Net(NetParameter.from_text(train_val()), "TRAIN", device="cpu")
    assert net.blob_shapes == jnet.blob_shapes
    params, state = jnet.init(jax.random.PRNGKey(0))
    assert sorted(_state_tree(net)) == sorted(state) == [
        "bn1", "cat_bn", "res_a_bn", "res_b_bn"]
    for lname, blobs in state.items():
        for sname, arr in blobs.items():
            buf = getattr(net.layer_by_name(lname), sname)
            assert tuple(buf.shape) == arr.shape and buf.dtype == \
                torch.float32
    assert net.blob_shapes["cat"] == (B, 8, 12, 12)


def test_five_sgd_iterations_match_the_jax_solver(five_steps):
    """Losses, parameters, history and running statistics after 5
    iterations (poly LR, momentum, weight decay)."""
    jsolver, port, jlosses = five_steps
    assert port.iter == jsolver.iter == 5
    np.testing.assert_allclose(port.losses, jlosses, rtol=1e-5)
    _assert_tree(jsolver.params, port.net, **STEP)
    _assert_tree(jsolver.net_state, port.net, **STEP)
    for lname, blobs in jsolver.opt_state.items():
        for pname, slots in blobs.items():
            np.testing.assert_allclose(
                port.history[(lname, pname)][0].numpy(),
                np.asarray(slots[0]), err_msg=f"{lname}.{pname}", **STEP)
    # the statistics moved from zero, the variance to a positive value
    assert float(port.net.layer_by_name("cat_bn").var.min()) > 0


def test_test_nets_share_the_statistics_and_score_like_jax(five_steps):
    jsolver, port, _ = five_steps
    tnet = port.test_nets[0]
    for lname, sname, buf in port.net.state_buffers():
        assert getattr(tnet.layer_by_name(lname), sname) is buf
    assert tnet.layer_by_name("bn1").use_global
    test_feeds = _feeds(2, seed=9)
    want = jsolver.test_all([lambda k: test_feeds[k]])
    before = _state_tree(port.net)
    got = port.test_all([_torch_feeds(test_feeds)])
    np.testing.assert_allclose(got[0]["accuracy"], want[0]["accuracy"],
                               rtol=1e-5)
    # the test pass normalises with the running statistics, not its own
    # batch, and leaves them as they were
    after = _state_tree(port.net)
    for lname in before:
        for sname in before[lname]:
            np.testing.assert_array_equal(after[lname][sname],
                                          before[lname][sname])
    blobs, _ = tnet({k: torch.from_numpy(v)
                     for k, v in test_feeds[0].items()})
    jblobs, _, _ = jsolver.test_nets[0].apply(
        jsolver.params, jsolver.net_state,
        {k: np.asarray(v) for k, v in test_feeds[0].items()}, train=False)
    np.testing.assert_allclose(blobs["fc"].detach().numpy(),
                               np.asarray(jblobs["fc"]), **STEP)


def test_iter_size_updates_the_statistics_once_a_micro_batch():
    """iter_size 2: each micro-batch's forward updates the statistics,
    as the JAX solver threads its state through the micro-batch scan."""
    jsolver = JaxSolver(JaxSP.from_text(solver_text("iter_size: 2")))
    port = _port_solver("iter_size: 2")
    load_jax_params(port.net, _host(jsolver.params),
                    _host(jsolver.net_state))
    feeds = _feeds(4, seed=3)
    jl = [jsolver.step(1, lambda k: feeds[k]) for _ in range(2)]
    port.step(2, _torch_feeds(feeds))
    np.testing.assert_allclose(port.losses, jl, rtol=1e-5)
    _assert_tree(jsolver.net_state, port.net, **STEP)
    _assert_tree(jsolver.params, port.net, **STEP)


def test_resume_from_jax_params_state_and_history_continues_like_jax(
        five_steps):
    jsolver, _, _ = five_steps
    port = _port_solver()
    load_jax_params(port.net, _host(jsolver.params),
                    _host(jsolver.net_state))
    load_jax_opt_state(port, _host(jsolver.opt_state))
    port.iter = jsolver.iter
    feeds = _feeds(2, seed=7)
    twin = JaxSolver(JaxSP.from_text(solver_text()))
    twin.params, twin.net_state, twin.opt_state, twin.iter = (
        jsolver.params, jsolver.net_state, jsolver.opt_state, 5)
    jl = [twin.step(1, lambda k: feeds[k - 5]) for _ in range(2)]
    port.step(2, _torch_feeds(feeds, offset=5))
    np.testing.assert_allclose(port.losses, jl, rtol=1e-5)
    _assert_tree(twin.params, port.net, **STEP)
    _assert_tree(twin.net_state, port.net, **STEP)


# -- snapshots ----------------------------------------------------------------

def test_port_snapshot_loads_in_the_jax_reader_and_solver(five_steps,
                                                          tmp_path):
    _, port, _ = five_steps
    port.sp.snapshot_prefix = str(tmp_path / "port")
    state = port.snapshot()
    weights = jax_io.load_caffemodel(str(tmp_path / "port_iter_5.caffemodel"))
    bn = weights["bn1"]
    assert len(bn) == 5 and bn[2].tolist() == [1.0]
    np.testing.assert_array_equal(bn[0], port.net.layer_by_name(
        "bn1").mean.numpy())
    assert len(weights["res_b_bn"]) == 3
    jsolver = JaxSolver(JaxSP.from_text(solver_text()))
    jsolver.restore(state)
    assert jsolver.iter == 5
    _assert_tree(jsolver.params, port.net, rtol=0, atol=0)
    _assert_tree(jsolver.net_state, port.net, rtol=0, atol=0)


def test_jax_snapshot_restores_into_the_port(five_steps, tmp_path):
    jsolver, _, _ = five_steps
    jsolver.sp.snapshot_prefix = str(tmp_path / "jax")
    state = jsolver.snapshot()
    port = _port_solver()
    port.restore(state)
    assert port.iter == 5
    _assert_tree(jsolver.params, port.net, rtol=0, atol=0)
    _assert_tree(jsolver.net_state, port.net, rtol=0, atol=0)
    tnet = port.test_nets[0]
    assert tnet.layer_by_name("cat_bn").var is \
        port.net.layer_by_name("cat_bn").var


def test_resumed_port_run_equals_the_uninterrupted_one(tmp_path):
    feeds = _feeds(4, seed=5)
    whole = _port_solver()
    whole.step(4, _torch_feeds(feeds))
    first = _port_solver()
    first.step(2, _torch_feeds(feeds))
    first.sp.snapshot_prefix = str(tmp_path / "half")
    state = first.snapshot()
    resumed = _port_solver()
    resumed.restore(state)
    for lname, sname, buf in first.net.state_buffers():
        assert torch.equal(getattr(resumed.net.layer_by_name(lname), sname),
                           buf)
    resumed.step(2, _torch_feeds(feeds))
    assert resumed.losses == whole.losses[2:]
    for (_, _, _, a), (_, _, _, b) in zip(whole._decls, resumed._decls):
        assert torch.equal(a, b)
    for (_, _, a), (_, _, b) in zip(whole.net.state_buffers(),
                                    resumed.net.state_buffers()):
        assert torch.equal(a, b)


# -- BVLC caffemodels ---------------------------------------------------------

@pytest.mark.parametrize("correction", [2.5, 1.0, 0.0])
@pytest.mark.parametrize("n_blobs", [5, 3])
def test_bvlc_caffemodel_imports_like_jax(tmp_path, correction, n_blobs):
    """A BatchNorm blob list [mean x c, var x c, c, (scale, bias)] loads
    as the JAX Net loads it: the statistics times 1/c, zero for c = 0; a
    3-blob list into a scale_bias layer leaves scale and bias as they
    were."""
    rs = np.random.RandomState(int(correction * 10) + n_blobs)
    jnet = JaxNet(JaxNP.from_text(train_val()), "TRAIN")
    params, state = jnet.init(jax.random.PRNGKey(1))
    weights = jnet.export_weights(params, state)
    for lname in ("bn1", "cat_bn"):
        c = weights[lname][0].shape[0]
        mean, var = rs.randn(c).astype(np.float32), \
            (rs.rand(c) + 0.5).astype(np.float32)
        blobs = [mean * np.float32(correction), var * np.float32(correction),
                 np.array([correction], np.float32)]
        blobs += [rs.randn(c).astype(np.float32) for _ in range(2)]
        weights[lname] = blobs[:n_blobs]
    path = str(tmp_path / "bvlc.caffemodel")
    jax_io.save_caffemodel(path, weights, net_name="NarrowResNet")
    jp, js = jnet.import_weights(params, state, jax_io.load_caffemodel(path))
    net = Net(NetParameter.from_text(train_val()), "TRAIN", device="cpu")
    load_jax_params(net, _host(params), _host(state))
    net.import_weights(port_io.load_weights(path))
    _assert_tree(js, net, rtol=0, atol=0)
    _assert_tree(jp, net, rtol=0, atol=0)
    if correction == 0.0:
        assert float(net.layer_by_name("bn1").var.abs().max()) == 0.0


def test_load_jax_params_with_state_is_a_checked_copy():
    jnet = JaxNet(JaxNP.from_text(train_val()), "TRAIN")
    params, state = jnet.init(jax.random.PRNGKey(0))
    params, state = _host(params), _host(state)
    net = Net(NetParameter.from_text(train_val()), "TRAIN", device="cpu")
    state = {k: {n: a + 0.5 for n, a in v.items()} for k, v in state.items()}
    load_jax_params(net, params, state)
    _assert_tree(state, net, rtol=0, atol=0)
    bad = {k: dict(v) for k, v in state.items()}
    bad["bn1"]["mean"] = bad["bn1"]["mean"][:3]
    with pytest.raises(ValueError, match="shape"):
        load_jax_params(net, params, bad)
    missing = {k: dict(v) for k, v in state.items()}
    del missing["cat_bn"]
    with pytest.raises(KeyError, match="cat_bn"):
        load_jax_params(net, params, missing)
    extra = {k: dict(v) for k, v in state.items()}
    extra["bn1"]["count"] = extra["bn1"]["mean"]
    with pytest.raises(KeyError, match="count"):
        load_jax_params(net, params, extra)
    with pytest.raises(KeyError, match="conv1"):
        load_jax_params(net, params, {**state, "conv1": {"mean": 0}})
    with pytest.raises(KeyError, match="state"):
        load_jax_params(net, params)


# -- serving ------------------------------------------------------------------

def test_every_serving_bucket_normalises_with_the_loaded_statistics(
        five_steps, tmp_path):
    """The trained snapshot loaded by InferenceModel and served at buckets
    1, 2 and 4: each bucket net holds the first one's statistics, and
    every row equals the port's TEST-phase forward of the deploy net."""
    _, port, _ = five_steps
    port.sp.snapshot_prefix = str(tmp_path / "serve")
    port.snapshot()
    caffemodel = str(tmp_path / "serve_iter_5.caffemodel")
    model = InferenceModel("narrow", NetParameter.from_text(deploy()),
                           caffemodel, ladder=(1, 2, 4), device="cpu")
    fwd = model.fwd
    owner = fwd.net_for(1)
    for b in (2, 4):
        other = fwd.net_for(b)
        for lname, sname, buf in owner.state_buffers():
            assert getattr(other.layer_by_name(lname), sname) is buf
    ref = Net(NetParameter.from_text(deploy()), "TEST", device="cpu")
    ref.import_weights(port_io.load_weights(caffemodel))
    x = _feeds(1, seed=11)[0]["data"]
    with torch.inference_mode():
        want = ref({"data": torch.from_numpy(x)})[0]["prob"].numpy()
    rows = np.concatenate([fwd.to_host(fwd.run_bucket(x[:1])),
                           fwd.to_host(fwd.run_bucket(x[1:3])),
                           fwd.to_host(fwd.run_bucket(x))[3:]])
    np.testing.assert_allclose(rows, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(fwd.to_host(fwd.run_bucket(x)), want,
                               rtol=1e-5, atol=1e-6)
    # the statistics are the trained ones, not the zeros of a fresh net
    assert torch.equal(owner.layer_by_name("bn1").mean,
                       port.net.layer_by_name("bn1").mean)
