"""Port parity: the bucketed gradient reduction
(caffe_mpi_tpu_torch/parallel/reduction.py) against the JAX package's
caffe_mpi_tpu/parallel/reduction.py and its Solver.

- the bucket plans and the fallback reasons equal the JAX module's, on
  the JAX test's cases and the zoo nets;
- the Reducer's hooks start a bucket's all-reduce during the last
  micro-batch's backward, never an earlier one's, and `finish` starts the
  rest in bucket order (a recording mesh, in process);
- the knob validation raises where the JAX Solver raises;
- `reduce_overlap` trains to the flat path's params and history exactly
  at N = 2 (two gloo ranks; a sum of two is the same in any order), and
  within rtol 1e-5 / atol 1e-6 at N = 4, where gloo's ring adds four
  values in an order that depends on the bucketing.
"""

import numpy as np
import pytest
import torch

from caffe_mpi_tpu.net import Net as JaxNet
from caffe_mpi_tpu.parallel import MeshPlan as JaxMeshPlan
from caffe_mpi_tpu.parallel import reduction as jax_reduction
from caffe_mpi_tpu.proto import NetParameter as JaxNP
from caffe_mpi_tpu.proto import SolverParameter as JaxSP
from caffe_mpi_tpu.solver import Solver as JaxSolver
from caffe_mpi_tpu_torch.net import Net
from caffe_mpi_tpu_torch.parallel import MeshPlan, reduction
from caffe_mpi_tpu_torch.proto import NetParameter, SolverParameter
from caffe_mpi_tpu_torch.solver import Solver
from test_torch_parallel import (IGNORE, MLP, STEP, alexnet_feeds,
                                 alexnet_solver, mlp_feeds, mlp_solver,
                                 resnet_feeds, resnet_solver)
from torch_dp_worker import run_ranks

# tests/test_reduction.py TestPlanner.ENTRIES, reverse-topo already
ENTRIES = [("ip2", "weight", (4, 32), np.float32),
           ("ip2", "bias", (4,), np.float32),
           ("ip1", "weight", (32, 6), np.float32),
           ("ip1", "bias", (32,), np.float32)]
MIXED = [("a", "w", (8,), np.float32), ("b", "w", (8,), np.float16),
         ("c", "w", (8,), np.float16)]


def _same_plan(got, want):
    assert len(got.buckets) == len(want.buckets)
    for g, w in zip(got.buckets, want.buckets):
        assert (g.entries, g.sizes, g.dtype, g.nbytes) == \
            (w.entries, w.sizes, w.dtype, w.nbytes)
    assert (got.n_data, got.wire_dtype) == (want.n_data, want.wire_dtype)
    assert got.stats() == want.stats()


@pytest.mark.parametrize("entries,kw", [
    (ENTRIES, dict(n_buckets=3, n_data=8)),
    (ENTRIES, dict(n_buckets=64)),
    (ENTRIES, dict(n_buckets=1)),
    (ENTRIES, dict(bucket_bytes=600)),
    (ENTRIES, dict(bucket_bytes=256)),
    (ENTRIES, dict(n_buckets=2, wire_dtype="bfloat16", n_data=4)),
    (MIXED, dict(n_buckets=1)),
    (MIXED, dict(bucket_bytes=40)),
], ids=["count3", "count64", "count1", "bytes600", "bytes256", "bf16wire",
        "dtype_split", "dtype_bytes"])
def test_plan_buckets_equals_jax(entries, kw):
    _same_plan(reduction.plan_buckets(entries, **kw),
               jax_reduction.plan_buckets(entries, **kw))


def test_plan_buckets_refuses_no_sizing_mode_as_jax_does():
    with pytest.raises(ValueError, match="n_buckets"):
        reduction.plan_buckets(ENTRIES)


def _nets(text):
    port = Net(NetParameter.from_text(text), "TRAIN", device="cpu")
    jnet = JaxNet(JaxNP.from_text(text), "TRAIN")
    params = {}
    for lname, pname, decl in jnet.learnable_param_decls():
        params.setdefault(lname, {})[pname] = np.broadcast_to(
            np.float32(0), decl.shape)
    return port, jnet, params


def _zoo(name):
    with open(f"models/{name}/train_val.prototxt") as f:
        return f.read()


@pytest.mark.parametrize("name", ["alexnet", "resnet50", "googlenet",
                                  "transformer_lm"])
@pytest.mark.parametrize("kw", [dict(n_buckets=6, n_data=4),
                                dict(bucket_bytes=4 << 20, n_data=2),
                                dict(n_buckets=3, wire_dtype="bfloat16")],
                         ids=["count6", "budget4MiB", "bf16wire"])
def test_plan_for_net_equals_jax_on_the_zoo(name, kw):
    port, jnet, params = _nets(_zoo(name))
    _same_plan(reduction.plan_for_net(port, **kw),
               jax_reduction.plan_for_net(jnet, params, **kw))


BN_NET = MLP.replace(
    'layer { name: "r"',
    'layer { name: "bn" type: "BatchNorm" bottom: "h" top: "h" }\n'
    'layer { name: "r"')
NONE_NET = MLP.replace('top: "l" }',
                       'top: "l" loss_param { normalization: NONE } }')
EUCLID = MLP.replace('type: "SoftmaxWithLoss" bottom: "y" bottom: "t"',
                     'type: "EuclideanLoss" bottom: "y" bottom: "y2"'
                     ).replace('top: "x" top: "t"',
                               'top: "x" top: "y2"').replace(
    "shape { dim: 16 } }", "shape { dim: 16 dim: 4 } }")


@pytest.mark.parametrize("text", [MLP, BN_NET, IGNORE, NONE_NET, EUCLID,
                                  "alexnet", "resnet50", "googlenet"],
                         ids=["mlp", "bn", "ignore", "none", "euclid",
                              "alexnet", "resnet50", "googlenet"])
def test_unsupported_reason_equals_jax(text):
    if "layer" not in text:
        text = _zoo(text)
    port, jnet, _ = _nets(text)
    assert reduction.unsupported_reason(port) == \
        jax_reduction.unsupported_reason(jnet)


# -- the Reducer's schedule, on a recording mesh ------------------------------

class _Recorder:
    """A mesh of n ranks that records when each bucket's sum starts and
    sums nothing (every rank would hold the same values)."""

    def __init__(self, n):
        self.n_data, self.started = n, []

    def _staged(self, t):
        return False

    def all_reduce_start(self, t, host=None):
        self.started.append((t.data_ptr(), self.phase))

        class Done:
            def wait(self):
                pass
        return Done()


def test_hooks_start_buckets_in_the_last_micro_batchs_backward():
    torch.manual_seed(0)
    layers = torch.nn.ModuleList(torch.nn.Linear(4, 4) for _ in range(3))
    params = {(f"l{i}", n): getattr(m, n) for i, m in enumerate(layers)
              for n in ("weight", "bias")}
    entries = [(l, n, tuple(p.shape), p.dtype)
               for (l, n), p in reversed(list(params.items()))]
    plan = reduction.plan_buckets(entries, n_buckets=3, n_data=2)
    mesh = _Recorder(2)
    red = reduction.Reducer(plan, params, mesh, hooks=True)
    x = torch.randn(5, 4)
    red.zero()
    want = []
    for m in range(2):
        red.arm(m == 1)
        mesh.phase = f"backward {m}"
        y = x
        for layer in layers:
            y = layer(y)
        y.square().sum().backward()
        want.append(torch.cat([p.grad.reshape(-1).clone()
                               for p in params.values()]))
    mesh.phase = "finish"
    red.finish()
    # every bucket started once, in the last micro-batch's backward, in
    # bucket (reverse layer) order
    assert [p for _, p in mesh.started] == ["backward 1"] * 3
    assert [ptr for ptr, _ in mesh.started] == \
        [f.data_ptr() for f in red.flats]
    # the grads accumulated over both micro-batches in the flat buffers,
    # then the 1/n scale
    got = torch.cat([p.grad.reshape(-1) for p in params.values()])
    torch.testing.assert_close(got, want[-1] / 2, rtol=0, atol=0)


def test_finish_starts_the_buckets_no_hook_started_in_order():
    params = {("a", "w"): torch.nn.Parameter(torch.ones(3)),
              ("b", "w"): torch.nn.Parameter(torch.ones(2))}
    entries = [("b", "w", (2,), torch.float32), ("a", "w", (3,),
                                                  torch.float32)]
    plan = reduction.plan_buckets(entries, n_buckets=2, n_data=1)
    mesh = _Recorder(1)
    red = reduction.Reducer(plan, params, mesh, hooks=False)
    red.zero()
    red.arm(True)
    mesh.phase = "backward"
    (params[("a", "w")].sum() * 2).backward()
    mesh.phase = "finish"
    red.finish()
    assert [p for _, p in mesh.started] == ["finish", "finish"]
    assert torch.equal(params[("a", "w")].grad, torch.full((3,), 2.0))


# -- the Solver's validation --------------------------------------------------

def _both(extra, mesh=False):
    """The JAX Solver's and the port's construction on `extra`: each
    raises the same error type, or neither does."""
    import jax
    text = mlp_solver(extra)
    jmesh = JaxMeshPlan.from_shape(1, devices=jax.devices()[:1]) \
        if mesh else None
    pmesh = MeshPlan.from_shape(1, devices=["cpu"]) if mesh else None
    out = []
    for build in (lambda: JaxSolver(JaxSP.from_text(text), mesh=jmesh),
                  lambda: Solver(SolverParameter.from_text(text), mesh=pmesh,
                                 device=None if mesh else "cpu")):
        try:
            out.append(build())
        except (ValueError, NotImplementedError) as e:
            out.append(type(e))
    return out


@pytest.mark.parametrize("extra", ["reduce_overlap: true",
                                   "reduce_buckets: 0",
                                   "reduce_buckets: -1",
                                   "grad_bucket_mb: 0",
                                   "reduce_buckets: 2 grad_bucket_mb: 1",
                                   "zero_stage: 2", "zero_stage: 1"])
def test_knob_validation_raises_where_jax_raises(extra):
    jax_out, port_out = _both(extra)
    assert jax_out is ValueError and port_out is ValueError


def test_net_level_zero_reduce_buckets_raises_as_jax_does():
    net = MLP.replace('name: "dp_mlp"', 'name: "dp_mlp" reduce_buckets: 0')
    text = mlp_solver(net=net)
    with pytest.raises(ValueError, match="reduce_buckets"):
        JaxSolver(JaxSP.from_text(text))
    with pytest.raises(ValueError, match="reduce_buckets"):
        Solver(SolverParameter.from_text(text), device="cpu")


def test_one_rank_falls_back_with_the_jax_reason_and_stats_keys():
    jax_s, port_s = _both("reduce_overlap: true reduce_buckets: 2",
                          mesh=True)
    want, got = jax_s.reduction_stats(), port_s.reduction_stats()
    assert got["mode"] == want["mode"] == "implicit"
    assert got["fallback_reason"] == want["fallback_reason"]
    assert set(want) - {"generation", "generation_hosts",
                        "world_full"} <= set(got)
    port_s.close()


# -- bucketed against flat, across ranks --------------------------------------

def _scenarios(n):
    mlp = {"feeds": mlp_feeds(5), "iters": 5}
    scs = [dict(mlp, name="flat", solver=mlp_solver()),
           dict(mlp, name="overlap",
                solver=mlp_solver("reduce_overlap: true reduce_buckets: 2")),
           dict(mlp, name="overlap_mb",
                solver=mlp_solver("reduce_overlap: true grad_bucket_mb: "
                                  "0.001")),
           dict(mlp, name="overlap_iter2", feeds=mlp_feeds(10),
                solver=mlp_solver("reduce_overlap: true reduce_buckets: 3 "
                                  "iter_size: 2")),
           dict(mlp, name="flat_iter2", feeds=mlp_feeds(10),
                solver=mlp_solver("iter_size: 2"))]
    if n == 2:
        scs.append(dict(mlp, name="overlap_bf16", solver=mlp_solver(
            'precision: "bf16" reduce_overlap: true reduce_buckets: 2')))
        alex = {"feeds": alexnet_feeds(3), "iters": 3}
        scs += [dict(alex, name="alexnet", solver=alexnet_solver(
                     "clip_gradients: 1.0")),
                dict(alex, name="alexnet_overlap", solver=alexnet_solver(
                    "clip_gradients: 1.0 reduce_overlap: true")),
                dict(name="resnet_overlap", feeds=resnet_feeds(1), iters=1,
                     solver=resnet_solver("reduce_overlap: true"))]
    return scs


def _spawn(n, tmp_path_factory):
    return n, run_ranks(_scenarios(n), n,
                        str(tmp_path_factory.mktemp(f"red{n}")))


@pytest.fixture(scope="module")
def spawn2(tmp_path_factory):
    return _spawn(2, tmp_path_factory)


@pytest.fixture(scope="module")
def spawn4(tmp_path_factory):
    return _spawn(4, tmp_path_factory)


@pytest.fixture(params=[2, 4], ids=["N2", "N4"])
def spawn(request):
    return request.getfixturevalue(f"spawn{request.param}")


def _compare(a, b, exact):
    assert set(a["state"]) == set(b["state"])
    for key, arr in a["state"].items():
        if exact:
            assert np.array_equal(b["state"][key], arr), key
        else:
            np.testing.assert_allclose(b["state"][key], arr,
                                       err_msg=key, **STEP)


@pytest.mark.parametrize("flat,bucketed", [
    ("flat", "overlap"), ("flat", "overlap_mb"),
    ("flat_iter2", "overlap_iter2")])
def test_bucketed_matches_flat(spawn, flat, bucketed):
    n, results = spawn
    res = results[0]
    _compare(res[flat], res[bucketed], exact=n == 2)
    stats = res[bucketed]["stats"]
    assert stats["mode"] == "bucketed" and stats["n_data"] == n
    assert stats["reduce_buckets"] >= 2
    # every bucket and the loss, a step
    assert stats["collectives_issued_per_step"] == \
        stats["reduce_buckets"] + 1
    for r in results[1:]:
        _compare(res[bucketed], r[bucketed], exact=True)


def test_alexnet_overlap_with_clipping_equals_flat_at_two_ranks(spawn2):
    _, results = spawn2
    res = results[0]
    _compare(res["alexnet"], res["alexnet_overlap"], exact=True)
    stats = res["alexnet_overlap"]["stats"]
    assert stats["reduce_buckets"] == 6  # the net-level default
    assert sum(stats["bucket_bytes"]) == stats["reduced_bytes_per_step"]


def test_batchnorm_net_falls_back_to_the_flat_reduce(spawn2):
    _, results = spawn2
    stats = results[0]["resnet_overlap"]["stats"]
    assert stats["mode"] == "implicit" and stats["buckets"] == 1
    assert "BatchNorm" in stats["fallback_reason"]


def test_bf16_buckets_travel_at_half_the_bytes(spawn2):
    """precision bf16: the buckets are cast to bfloat16 for the all-reduce
    (the JAX plan's wire_dtype), half the f32 plan's bytes, and cast back
    before the 1/n scale; the ranks stay equal."""
    _, results = spawn2
    res = results[0]
    wire, f32 = res["overlap_bf16"]["stats"], res["overlap"]["stats"]
    assert wire["wire_dtype"] == "bfloat16" and "wire_dtype" not in f32
    assert 2 * sum(wire["bucket_bytes"]) == sum(f32["bucket_bytes"])
    assert wire["reduced_bytes_per_step"] == sum(wire["bucket_bytes"])
    assert np.all(np.isfinite(res["overlap_bf16"]["losses"]))
    for r in results[1:]:
        _compare(res["overlap_bf16"], r["overlap_bf16"], exact=True)
