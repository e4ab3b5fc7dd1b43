"""Port parity: data-parallel training (caffe_mpi_tpu_torch/parallel/,
the Solver's `mesh`, the CLI's -hosts) against the JAX `Solver` on
`MeshPlan.from_shape(N)` over the virtual CPU devices, at N = 2 and 4.

The port's ranks are processes over gloo on the CPU
(tests/torch_dp_worker.py): each spawn runs a group of scenarios, every
collective bounded by a 90 s timeout and each spawn by its own deadline.
The same numpy feeds (global batches; each rank takes its slice), the
JAX solver's initial weights and its global Dropout masks go to both.

Tolerances, float32:
- params, history and running statistics after 5 SGD iterations: rtol
  1e-5 / atol 1e-6, losses rtol 1e-5 (the one-device parity tests' bar;
  the ranks sum in another order than XLA's sharded program);
- BatchNorm alone: output and statistics rtol 1e-5 / atol 1e-6,
  gradients 1e-5 of the largest element;
- ranks against each other: equal, element for element.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from caffe_mpi_tpu.core.types import DtypePolicy as JaxPolicy
from caffe_mpi_tpu.layers import create_layer as jax_create_layer
from caffe_mpi_tpu.parallel import MeshPlan as JaxMeshPlan
from caffe_mpi_tpu.proto import LayerParameter as JaxLP
from caffe_mpi_tpu.proto import SolverParameter as JaxSP
from caffe_mpi_tpu.solver import Solver as JaxSolver
from caffe_mpi_tpu_torch.parallel import MeshPlan
from caffe_mpi_tpu_torch.parallel import mesh as mesh_mod
from caffe_mpi_tpu_torch.utils.resilience import ClusterError
from test_torch_resnet import train_val as resnet_train_val
from test_torch_train import _jax_masks
from test_torch_train import train_val as alexnet_train_val
from torch_dp_worker import Ranks

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP = dict(rtol=1e-5, atol=1e-6)
ITERS = 5

# the dp_mlp of tests/test_parallel.py
MLP = """
name: "dp_mlp"
layer { name: "in" type: "Input" top: "x" top: "t"
        input_param { shape { dim: 16 dim: 8 } shape { dim: 16 } } }
layer { name: "ip1" type: "InnerProduct" bottom: "x" top: "h"
        inner_product_param { num_output: 32 weight_filler { type: "xavier" } } }
layer { name: "r" type: "ReLU" bottom: "h" top: "h" }
layer { name: "ip2" type: "InnerProduct" bottom: "h" top: "y"
        inner_product_param { num_output: 4 weight_filler { type: "xavier" } } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "y" bottom: "t" top: "l" }
"""
IGNORE = MLP.replace('top: "l" }', 'top: "l" loss_param { ignore_label: 2 } }')


def mlp_solver(extra="", net=MLP):
    return ("net_param { " + net + " }\n"
            'base_lr: 0.05 momentum: 0.9 lr_policy: "fixed" max_iter: 20 '
            'type: "SGD" random_seed: 7 ' + extra)


def mlp_feeds(n, seed=3):
    r = np.random.RandomState(seed)
    return [{"x": r.randn(16, 8).astype(np.float32),
             "t": r.randint(0, 4, 16).astype(np.int32)} for _ in range(n)]


def alexnet_solver(extra="", batch=8):
    """The narrowed AlexNet of test_torch_train.py: a TRAIN loss, a TEST
    accuracy (its test net shares the params)."""
    body = alexnet_train_val(batch)
    return ("net_param { " + body[body.index("layer"):] + " }\n"
            'base_lr: 0.01 lr_policy: "step" gamma: 0.1 stepsize: 3 '
            "momentum: 0.9 weight_decay: 0.0005 max_iter: 5 random_seed: 3 "
            "test_iter: 2 test_interval: 100 " + extra)


def alexnet_feeds(n, batch=8, seed=0):
    rs = np.random.RandomState(seed)
    return [{"data": rs.randn(batch, 3, 67, 67).astype(np.float32),
             "label": rs.randint(0, 10, batch).astype(np.int32)}
            for _ in range(n)]


def resnet_solver(extra="", batch=8):
    return ('net_param { name: "NarrowResNet" ' + resnet_train_val(batch)
            + " }\n"
            'base_lr: 0.05 lr_policy: "poly" power: 2.0 max_iter: 10 '
            "momentum: 0.9 weight_decay: 0.0001 random_seed: 5 " + extra)


def resnet_feeds(n, batch=8, seed=0):
    rs = np.random.RandomState(seed)
    return [{"data": (rs.randn(batch, 3, 12, 12) * 2 + 0.5).astype(
        np.float32), "label": rs.randint(0, 10, batch).astype(np.int32)}
        for _ in range(n)]


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_start(text, feeds, n, iters=ITERS, masks=False):
    """The JAX Solver on a mesh of n virtual devices, not stepped yet, and
    the scenario the port's ranks start from (its initial weights and
    global Dropout masks)."""
    js = JaxSolver(JaxSP.from_text(text),
                   mesh=JaxMeshPlan.from_shape(n, devices=jax.devices()[:n]))
    sc = {"solver": text, "feeds": feeds, "iters": iters,
          "weights": _host(js.params), "net_state": _host(js.net_state)}
    if masks:
        fn = _jax_masks(js, seed=js.sp.random_seed)
        iter_size = max(js.sp.iter_size, 1)
        sc["masks"] = {(it, m): {k: v.numpy() for k, v in fn(it, m).items()}
                       for it in range(iters) for m in range(iter_size)}
    if js.test_nets:
        sc["test_feeds"] = alexnet_feeds(2, seed=9)
    return js, sc


def jax_finish(js, sc):
    """Step the JAX Solver through the scenario: its losses (and its test
    scores on the test net's feeds)."""
    feeds = sc["feeds"]
    losses = [js.step(1, lambda k: feeds[k]) for _ in range(sc["iters"])]
    if "test_feeds" in sc:
        js.test_scores = js.test_all([lambda k: sc["test_feeds"][k]])
    return losses


def jax_reference(text, feeds, n, iters=ITERS, masks=False):
    """(stepped JAX Solver, its losses, the scenario)."""
    js, sc = jax_start(text, feeds, n, iters, masks)
    return js, jax_finish(js, sc), sc


def assert_like_jax(js, losses, res, **tol):
    tol = tol or STEP
    np.testing.assert_allclose(res["losses"], losses, rtol=1e-5)
    state = res["state"]
    for lname, blobs in js.params.items():
        for pname, arr in blobs.items():
            np.testing.assert_allclose(state[f"{lname}.{pname}"],
                                       np.asarray(arr),
                                       err_msg=f"{lname}.{pname}", **tol)
            for i, slot in enumerate(js.opt_state[lname][pname]):
                np.testing.assert_allclose(
                    state[f"{lname}.{pname}.h{i}"], np.asarray(slot),
                    err_msg=f"{lname}.{pname}.h{i}", **tol)
    for lname, blobs in js.net_state.items():
        for sname, arr in blobs.items():
            np.testing.assert_allclose(state[f"{lname}.{sname}"],
                                       np.asarray(arr),
                                       err_msg=f"{lname}.{sname}", **tol)


def assert_ranks_equal(results, name):
    first = results[0][name]
    for r, res in enumerate(results[1:], 1):
        assert np.array_equal(res[name]["losses"], first["losses"],
                              equal_nan=True), r
        for key, arr in first["state"].items():
            assert np.array_equal(res[name]["state"][key], arr), (r, key)


BN_LAYER = ('name: "bn" type: "BatchNorm" bottom: "x" top: "y" '
            "batch_norm_param { scale_bias: true eps: 0.0001 "
            "moving_average_fraction: 0.9 }")


def bn_case(n):
    rs = np.random.RandomState(11)
    x = (rs.randn(8, 4, 3, 3) * 2 + 0.5).astype(np.float32)
    return {"name": "bn", "kind": "bn", "layer": BN_LAYER, "x": x,
            "w": rs.randn(*x.shape).astype(np.float32),
            "scale": rs.rand(4).astype(np.float32) + 0.5,
            "bias": rs.randn(4).astype(np.float32)}


def jax_bn(case):
    jl = jax_create_layer(JaxLP.from_text(case["layer"]), JaxPolicy(),
                          "TRAIN")
    jl.in_shapes = [case["x"].shape]
    jl.out_shapes = jl.setup([case["x"].shape])
    state = {"mean": np.zeros(4, np.float32), "var": np.zeros(4, np.float32)}

    def loss(p, x):
        tops, new = jl.apply(p, state, [x], train=True,
                             rng=jax.random.PRNGKey(0))
        return (tops[0] * case["w"]).sum(), (tops[0], new)
    (_, (y, new)), (gp, gx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(
        {"scale": case["scale"], "bias": case["bias"]}, case["x"])
    return {"y": np.asarray(y), "dx": np.asarray(gx),
            "dscale": np.asarray(gp["scale"]),
            "dbias": np.asarray(gp["bias"]),
            "mean": np.asarray(new["mean"]), "var": np.asarray(new["var"])}


def _scenarios(n):
    """The spawn's scenarios, and the JAX solvers (not stepped) by name."""
    jaxes, scs = {}, []

    def add(name, text, feeds, masks=False, **extra):
        js, sc = jax_start(text, feeds, n, masks=masks)
        jaxes[name] = (js, sc)
        scs.append(dict(sc, name=name, **extra))

    add("mlp", mlp_solver(), mlp_feeds(ITERS))
    add("alexnet", alexnet_solver(), alexnet_feeds(ITERS), masks=True)
    add("resnet", resnet_solver(), resnet_feeds(ITERS))
    if n == 2:
        add("mlp_iter2", mlp_solver("iter_size: 2"), mlp_feeds(2 * ITERS))
        add("mlp_ignore", mlp_solver(net=IGNORE), mlp_feeds(ITERS))
        poisoned = mlp_feeds(ITERS)
        poisoned[2]["x"][8, 0] = np.nan  # rank 1's first row
        add("mlp_guard", mlp_solver("train_guard: true"), poisoned)
        scs[-1]["feeds"] = mlp_feeds(ITERS)
        scs[-1]["poison"] = (2, 1)
    scs.append(bn_case(n))
    return scs, jaxes


def _spawn(n, tmp_path_factory):
    """The ranks run while the JAX references step."""
    scs, jaxes = _scenarios(n)
    ranks = Ranks(scs, n, str(tmp_path_factory.mktemp(f"dp{n}")))
    refs = {name: (js, jax_finish(js, sc)) for name, (js, sc)
            in jaxes.items()}
    return n, ranks.results(), refs, {sc["name"]: sc for sc in scs}


@pytest.fixture(scope="module")
def spawn2(tmp_path_factory):
    return _spawn(2, tmp_path_factory)


@pytest.fixture(scope="module")
def spawn4(tmp_path_factory):
    return _spawn(4, tmp_path_factory)


@pytest.fixture(params=[2, 4], ids=["N2", "N4"])
def spawn(request):
    return request.getfixturevalue(f"spawn{request.param}")


# -- MeshPlan and the cluster helpers (in process) ----------------------------

def test_mesh_axes_and_layouts_are_validated():
    # a 1 x 2 mesh is two ranks: it needs the process group formed first
    # (a group of one that another test of this process formed goes)
    mesh_mod.shutdown_distributed()
    with pytest.raises(ClusterError, match="needs the process group"):
        MeshPlan.from_shape(1, model=2, devices=["cpu", "cpu"])
    # and a live group of one is the wrong size for it
    MeshPlan.from_shape(1, devices=["cpu"])
    with pytest.raises(ValueError, match="process group has 1 ranks"):
        MeshPlan.from_shape(1, model=2, devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="axes must be >= 1"):
        MeshPlan.from_shape(1, model=0, devices=[])
    with pytest.raises(ValueError, match="devices"):
        MeshPlan.from_shape(3, devices=["cpu"] * 2)
    assert mesh_mod.backend_for(["cpu", "cpu"]) == "gloo"
    assert mesh_mod.backend_for(["cuda:0", "cuda:0"]) == "gloo"
    assert mesh_mod.backend_for(["cuda:0", "cuda:1"]) == "nccl"
    # two hosts of one card each: a card a rank, so NCCL
    assert mesh_mod.backend_for(["cuda:0", "cuda:0"], hosts=2) == "nccl"


def test_world_one_plan_shards_and_refuses_tensor_parallelism():
    plan = MeshPlan.from_shape(1, devices=["cpu"])
    assert (plan.n_data, plan.rank, plan.backend) == (1, 0, "gloo")
    x = torch.arange(8.0).reshape(4, 2)
    assert torch.equal(plan.shard(x), x)
    assert plan.zero_slot_sharding((8, 3)) is None  # one rank: replicated
    # one model rank: the rules place nothing
    placement = plan.param_sharding_rules({"ip": ("model", None)})
    assert placement.spec("ip", "weight", 2) is None
    # rank 3 of a 2 x 2 mesh: data index 1, model index 1; "rows" splits
    # the weight's dim 0 and the bias, a (None, "model") spec dim 1 only
    mp = MeshPlan(n_data=2, rank=3, device=torch.device("cpu"),
                  backend="gloo", n_model=2)
    assert (mp.data_index, mp.model_index) == (1, 1)
    assert torch.equal(mp.shard(x), x[2:])
    rules = mp.param_sharding_rules({"a": "rows", "b": (None, "model")})
    w = torch.arange(12.0).reshape(4, 3)
    def local(pl, lname, pname, t):
        return pl.local_spec(pl.spec(lname, pname, t.dim()), t)

    assert torch.equal(local(rules, "a", "weight", w), w[2:])
    assert torch.equal(local(rules, "a", "bias", w[:, 0]), w[2:, 0])
    assert rules.model_dim(rules.spec("a", "bias", 1)) == 0
    assert rules.model_dim(rules.spec("b", "bias", 1)) is None
    assert torch.equal(local(rules, "b", "weight", w.t()), w.t()[:, 2:])
    # a ("data", "model") spec splits dim 0 over 'data' and dim 1 over
    # 'model' (gathered on use: no model-parallel forward takes it)
    both = mp.param_sharding_rules({"c": ("data", "model")})
    w4 = torch.arange(16.0).reshape(4, 4)
    assert torch.equal(local(both, "c", "weight", w4), w4[2:, 2:])
    assert both.spec("c", "weight", 2) == (("data",), ("model",))
    assert both.model_dim(both.spec("c", "weight", 2)) is None
    assert both.spec("c", "bias", 1) is None
    half = MeshPlan(n_data=2, rank=1, device=torch.device("cpu"),
                    backend="gloo")
    assert torch.equal(half.shard(x), x[2:])
    assert torch.equal(half.shard(x, batch_axis=1), x[:, 1:])
    assert half.zero_slot_sharding((8, 3)) == 4
    assert half.zero_slot_sharding((3,)) is None


def test_resolve_cluster_needs_a_coordinator_and_a_host_id(monkeypatch):
    for key in ("CAFFE_TPU_NUM_HOSTS", "CAFFE_TPU_COORDINATOR",
                "CAFFE_TPU_HOST_ID"):
        monkeypatch.delenv(key, raising=False)
    assert mesh_mod.resolve_cluster(None)[0] == 0
    from caffe_mpi_tpu_torch.proto import SolverParameter
    sp = SolverParameter.from_text("hosts: 2")
    with pytest.raises(ClusterError, match="coordinator"):
        mesh_mod.resolve_cluster(sp, host_id=0)
    sp.coordinator = "127.0.0.1:1"
    with pytest.raises(ClusterError, match="host id"):
        mesh_mod.resolve_cluster(sp)
    assert mesh_mod.resolve_cluster(sp, host_id=1) == (2, "127.0.0.1:1", 1)


def test_needs_collective_gather_reads_the_shards():
    assert not mesh_mod.needs_collective_gather({("a", "w"): None})
    assert mesh_mod.needs_collective_gather({("a", "w"): None,
                                             ("b", "w"): 4})


def test_an_indivisible_batch_has_its_own_error():
    """The solver evaluates a test net whole on every rank on this error
    alone; any other error building the net propagates."""
    from caffe_mpi_tpu_torch.net import IndivisibleBatch, Net
    from caffe_mpi_tpu_torch.proto import NetParameter
    with pytest.raises(IndivisibleBatch, match="not divisible by 3"):
        Net(NetParameter.from_text(MLP), "TRAIN", device="cpu",
            batch_divisor=3)
    bad = MLP.replace('bottom: "h" top: "y"', 'bottom: "nowhere" top: "y"')
    with pytest.raises(Exception) as e:
        Net(NetParameter.from_text(bad), "TRAIN", device="cpu",
            batch_divisor=2)
    assert not isinstance(e.value, IndivisibleBatch)


def test_collective_time_is_the_union_of_overlapping_pairs():
    # reduce_overlap's bucket pairs overlap each other: counted once
    assert mesh_mod.union_ms([(0.0, 4.0), (1.0, 5.0), (2.0, 3.0)]) == 5.0
    assert mesh_mod.union_ms([(6.0, 7.0), (-1.0, 1.0), (0.5, 2.0)]) == 4.0
    assert mesh_mod.union_ms([]) == 0.0


# -- training against the JAX mesh --------------------------------------------

@pytest.mark.parametrize("name", ["mlp", "alexnet", "resnet"])
def test_five_iterations_match_the_jax_mesh(spawn, name):
    n, results, refs, _ = spawn
    js, losses = refs[name]
    assert_like_jax(js, losses, results[0][name])
    assert_ranks_equal(results, name)
    stats = results[0][name]["stats"]
    assert stats["mode"] == "implicit" and stats["n_data"] == n


def test_test_pass_scores_the_global_batch_on_every_rank(spawn):
    """The test net's batch divides the ranks: each evaluates its slice
    and the scores are all-reduced (the accuracy of the whole batch)."""
    n, results, refs, _ = spawn
    js, _ = refs["alexnet"]
    for r in results:
        got = r["alexnet"]["test_scores"]
        assert set(got[0]) == {"accuracy"}
        np.testing.assert_allclose(got[0]["accuracy"],
                                   js.test_scores[0]["accuracy"], rtol=1e-6)


def test_resnet_statistics_are_the_global_batch(spawn):
    n, results, refs, _ = spawn
    js, _ = refs["resnet"]
    for r in results:
        for lname, blobs in js.net_state.items():
            for sname, arr in blobs.items():
                np.testing.assert_allclose(
                    r["resnet"]["state"][f"{lname}.{sname}"],
                    np.asarray(arr), **STEP)


def test_batch_norm_forward_state_and_gradients_match_jax(spawn):
    n, results, _, scs = spawn
    want = jax_bn(scs["bn"])
    b = scs["bn"]["x"].shape[0] // n
    for r, res in enumerate(results):
        got = res["bn"]
        sl = slice(r * b, (r + 1) * b)
        np.testing.assert_allclose(got["y"], want["y"][sl], **STEP)
        np.testing.assert_allclose(got["mean"], want["mean"], **STEP)
        np.testing.assert_allclose(got["var"], want["var"], **STEP)
        np.testing.assert_allclose(
            got["dx"], want["dx"][sl], rtol=1e-5,
            atol=1e-5 * float(np.abs(want["dx"]).max()))
    for key in ("dscale", "dbias"):
        total = sum(res["bn"][key] for res in results)
        np.testing.assert_allclose(
            total, want[key], rtol=1e-5,
            atol=1e-5 * float(np.abs(want[key]).max()))


def test_iter_size_two_matches_the_jax_mesh(spawn2):
    n, results, refs, _ = spawn2
    js, losses = refs["mlp_iter2"]
    assert_like_jax(js, losses, results[0]["mlp_iter2"])
    assert_ranks_equal(results, "mlp_iter2")


def test_valid_normalization_with_ignore_label_is_global(spawn2):
    n, results, refs, _ = spawn2
    js, losses = refs["mlp_ignore"]
    assert_like_jax(js, losses, results[0]["mlp_ignore"])
    assert_ranks_equal(results, "mlp_ignore")


def test_guard_skips_on_every_rank_when_one_rank_feeds_a_nan(spawn2):
    n, results, refs, _ = spawn2
    js, losses = refs["mlp_guard"]
    assert np.isnan(losses[2])
    for r in results:
        assert r["mlp_guard"]["skipped"] == [2]
        assert np.isnan(r["mlp_guard"]["losses"][2])
    good = [l for i, l in enumerate(losses) if i != 2]
    got = [l for i, l in enumerate(results[0]["mlp_guard"]["losses"])
           if i != 2]
    np.testing.assert_allclose(got, good, rtol=1e-5)
    state = results[0]["mlp_guard"]["state"]
    for lname, blobs in js.params.items():
        for pname, arr in blobs.items():
            np.testing.assert_allclose(state[f"{lname}.{pname}"],
                                       np.asarray(arr), **STEP)
    assert_ranks_equal(results, "mlp_guard")


# -- the CLI across processes -------------------------------------------------

def _cli_solver(tmp_path, batch=8):
    # 10 classes: the synthetic labels are class ids in [0, 10)
    body = MLP.replace("dim: 16 dim: 8 } shape { dim: 16",
                       f"dim: {batch} dim: 8 }} shape {{ dim: {batch}"
                       ).replace("num_output: 4", "num_output: 10")
    path = tmp_path / "solver.prototxt"
    path.write_text("net_param { " + body + " }\n"
                    'base_lr: 0.05 momentum: 0.9 lr_policy: "fixed" '
                    "max_iter: 4 random_seed: 7 snapshot: 2\n"
                    f'snapshot_prefix: "{tmp_path}/snap/m"\n')
    return str(path)


def _cli(args, env=None, timeout=120):
    return subprocess.Popen(
        [sys.executable, "-m", "caffe_mpi_tpu_torch.tools.cli", "train",
         *args], cwd=_ROOT, env=dict(os.environ, OMP_NUM_THREADS="1",
                                     **(env or {})),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _summary(out):
    import json
    lines = [l for l in out.splitlines() if l.startswith('{"train"')]
    return json.loads(lines[-1])["train"] if lines else None


def test_cli_hosts_two_matches_one_process_and_resumes_together(tmp_path):
    """`train -hosts 2` as two CLI processes (one rank each, gloo) against
    one process at the global batch; then both resume with -resume auto
    from the snapshot rank 0 chose."""
    from caffe_mpi_tpu_torch import io as port_io
    solver = _cli_solver(tmp_path)
    one = tmp_path / "one"
    p = _cli(["-solver", solver, "-synthetic", "-device", "cpu",
              "-snapshot_prefix", str(one / "m")])
    out1, err1 = p.communicate(timeout=120)
    assert p.returncode == 0, err1[-3000:]

    def hosts(extra):
        port = mesh_mod.free_port()
        procs = [_cli(["-solver", solver, "-synthetic", "-device", "cpu",
                       "-hosts", "2", "-host_id", str(h), "-coordinator",
                       f"127.0.0.1:{port}", *extra]) for h in range(2)]
        outs = [pr.communicate(timeout=120) for pr in procs]
        for pr, (o, e) in zip(procs, outs):
            assert pr.returncode == 0, e[-3000:]
        assert _summary(outs[1][0]) is None  # rank 0 prints the summary
        return _summary(outs[0][0])

    first = hosts(["-max_iter", "2"])
    assert first["world"] == 2 and first["rank_batch"] == 4
    assert first["batch"] == 8
    again = hosts(["-resume", "auto"])
    assert again["resumed_from"].endswith("m_iter_2.solverstate")
    assert again["start_iter"] == 2 and again["iters"] == 2
    s1 = _summary(out1)
    np.testing.assert_allclose(first["losses"] + again["losses"],
                               s1["losses"], rtol=1e-5)
    w_one = port_io.load_weights(str(one / "m_iter_4.caffemodel"))
    w_dp = port_io.load_weights(str(tmp_path / "snap" /
                                    "m_iter_4.caffemodel"))
    for name, blobs in w_one.items():
        for a, b in zip(blobs, w_dp[name]):
            np.testing.assert_allclose(b, a, **STEP)


def test_cli_missing_coordinator_journals_and_exits_87(tmp_path):
    solver = _cli_solver(tmp_path)
    p = _cli(["-solver", solver, "-synthetic", "-device", "cpu", "-hosts",
              "2", "-host_id", "1", "-coordinator",
              f"127.0.0.1:{mesh_mod.free_port()}"],
             env={"CAFFE_TPU_INIT_TIMEOUT": "0.2"})
    _, err = p.communicate(timeout=120)
    assert p.returncode == 87, err[-3000:]
    import json
    with open(tmp_path / "snap" / "m.r1.run.json") as f:
        journal = json.load(f)
    assert journal["reason"] == "cluster_init_failed"
    assert journal["exit_code"] == 87


def _lmdb_solver(tmp_path):
    """A Data-layer net over a 32-record LMDB (batch 8): the feeders stripe
    the records by rank."""
    from caffe_mpi_tpu_torch.data.datasets import encode_datum
    from caffe_mpi_tpu_torch.data.lmdb_io import write_lmdb
    rs = np.random.RandomState(4)
    write_lmdb(str(tmp_path / "db"), [
        (b"%08d" % i, encode_datum(rs.randint(0, 256, (1, 8, 8)).astype(
            np.uint8), int(rs.randint(0, 10)))) for i in range(32)])
    path = tmp_path / "solver.prototxt"
    path.write_text(
        'net_param { name: "dbnet" layer { name: "d" type: "Data" '
        'top: "data" top: "label" transform_param { scale: 0.00390625 } '
        f'data_param {{ source: "{tmp_path}/db" backend: LMDB '
        "batch_size: 8 } } "
        'layer { name: "ip" type: "InnerProduct" bottom: "data" top: "ip" '
        'inner_product_param { num_output: 10 weight_filler { type: '
        '"xavier" } } } layer { name: "loss" type: "SoftmaxWithLoss" '
        'bottom: "ip" bottom: "label" top: "loss" } }\n'
        'base_lr: 0.1 momentum: 0.9 lr_policy: "fixed" max_iter: 6 '
        "random_seed: 7 reduce_buckets: 4\n")
    return str(path)


def test_cli_mesh_data_two_on_an_lmdb_matches_one_process(tmp_path):
    """`train -mesh data=2 -device cpu` spawns two workers (gloo); each
    Feeder reads its stripe of every global batch, so the run is the
    one-process run at batch 8. -reduce_overlap with the prototxt's
    reduce_buckets 4 and -grad_bucket_mb, which overrides it."""
    from caffe_mpi_tpu_torch import io as port_io
    solver = _lmdb_solver(tmp_path)
    runs = {}
    for name, extra in (("one", []),
                        ("mesh", ["-mesh", "data=2", "-reduce_overlap",
                                  "-grad_bucket_mb", "0.0001"])):
        p = _cli(["-solver", solver, "-device", "cpu", "-snapshot_prefix",
                  str(tmp_path / name / "s"), *extra])
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err[-3000:]
        runs[name] = _summary(out)
        assert out.count('{"train"') == 1  # rank 0's summary only
    mesh = runs["mesh"]
    assert mesh["data"] == "dataset" and mesh["world"] == 2
    assert mesh["rank_batch"] == 4 and mesh["batch"] == 8
    red = mesh["reduction"]
    assert red["mode"] == "bucketed" and red["reduce_buckets"] == 2
    np.testing.assert_allclose(mesh["losses"], runs["one"]["losses"],
                               rtol=1e-5)
    a = port_io.load_weights(str(tmp_path / "one" / "s_iter_6.caffemodel"))
    b = port_io.load_weights(str(tmp_path / "mesh" / "s_iter_6.caffemodel"))
    for name, blobs in a.items():
        for x, y in zip(blobs, b[name]):
            np.testing.assert_allclose(y, x, **STEP)


def test_mesh_with_more_ranks_than_cards_raises(monkeypatch):
    from caffe_mpi_tpu_torch.proto import SolverParameter
    from caffe_mpi_tpu_torch.tools import cli
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    sp = SolverParameter.from_text("base_lr: 0.1")
    args = cli.parse_args(["train", "-mesh", "data=2"])
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        cli._layout(args, sp)
    args = cli.parse_args(["train", "-gpu", "all"])
    assert cli._layout(args, sp)["local"] == ["cuda:0"]


def test_cli_mesh_refusals_exit_one_and_gpu_without_a_card_raises(
        tmp_path, monkeypatch):
    from caffe_mpi_tpu_torch.tools import cli
    solver = _cli_solver(tmp_path)
    base = ["train", "-solver", solver, "-synthetic", "-device", "cpu"]
    assert cli.main(base + ["-mesh", "data=1,model=2,stage=2"]) == 1
    assert cli.main(base + ["-gpu", "all"]) == 1      # -gpu names cards
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        cli.main(["train", "-solver", solver, "-synthetic", "-gpu", "all"])
