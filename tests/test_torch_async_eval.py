"""Port parity: the asynchronous evaluation that overlaps training
(caffe_mpi_tpu_torch/solver/solver.py `_start_eval`, `_continue_eval`,
`_harvest_eval`), after the JAX package's tests/test_fused_eval.py
(TestAsyncInTraining, test_gpipe_stage0_eval, TestFeedQueuePrefetch).

At a test_interval boundary the port harvests the previous pass, copies
the live params and state into the test nets' persistent copies, launches
the first test chunk and trains on; the rest follow the next training
chunk and the pass is harvested at the next boundary or at the end of
`step`. On the CPU it is the same code, run in that order.

- the passes fire at the JAX solver's iterations (test_initialization
  included), logged with the iteration they evaluate, and score as the
  JAX solver's from the same weights (rtol 1e-5, the solver bar);
- each boundary's scores are bitwise the synchronous `test_all`'s on the
  same weights, and training is bitwise unperturbed by the evaluation;
- the planted fault, a pass that reads the live params instead of the
  copy, is caught: its later chunks see updated weights;
- the boundary launches only the first chunk, the rest follow the next
  training chunk; each test batch is asked for once, in order;
- eval_stall_ms is tracked; a resume across a test boundary continues
  the uninterrupted run and its passes; GPipe's pass runs on stage 0.
"""

import logging

import jax
import numpy as np
import pytest
import torch

from caffe_mpi_tpu.proto import NetParameter as JaxNP
from caffe_mpi_tpu.proto import SolverParameter as JaxSP
from caffe_mpi_tpu.solver import Solver as JaxSolver
from caffe_mpi_tpu_torch.proto import NetParameter, SolverParameter
from caffe_mpi_tpu_torch.solver import Solver
from caffe_mpi_tpu_torch.tools import cli
from caffe_mpi_tpu_torch.weights import load_jax_params

CLS_NET = """
name: "cls"
layer { name: "in" type: "Input" top: "x" top: "t"
        input_param { shape { dim: 8 dim: 6 } shape { dim: 8 } } }
layer { name: "ip" type: "InnerProduct" bottom: "x" top: "y"
        inner_product_param { num_output: 3
          weight_filler { type: "xavier" } } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "y" bottom: "t"
        top: "l" }
layer { name: "acc" type: "Accuracy" bottom: "y" bottom: "t"
        top: "acc" include { phase: TEST } }
"""
BASE = ('base_lr: 0.2 lr_policy: "fixed" max_iter: 1000 type: "SGD" '
        'momentum: 0.9 display: 0 random_seed: 11 ')


def cls_feed(seed_base=0, batch=8, calls=None):
    """Separable clusters, a pure function of the index (the JAX test's
    feed); `calls` collects the indices asked for."""
    templates = np.random.RandomState(99).randn(3, 6).astype(np.float32)

    def feed(it):
        if calls is not None:
            calls.append(it)
        r = np.random.RandomState(seed_base + it)
        t = r.randint(0, 3, batch)
        x = templates[t] + 0.1 * r.randn(batch, 6).astype(np.float32)
        return {"x": torch.from_numpy(np.asarray(x, np.float32)),
                "t": torch.from_numpy(t.astype(np.int32))}
    return feed


def make_solver(extra="", **kw):
    sp = SolverParameter.from_text(BASE + extra)
    sp.net_param = NetParameter.from_text(CLS_NET)
    return Solver(sp, device="cpu", **kw)


def _params(solver):
    return {f"{l}.{p}": t.detach().clone()
            for l, p, _, t in solver._decls}


def test_boundary_passes_fire_and_score_as_the_jax_solver(caplog):
    cfg = "test_iter: 2 test_interval: 4 test_initialization: true "
    jsp = JaxSP.from_text(BASE + cfg)
    jsp.net_param = JaxNP.from_text(CLS_NET)
    js = JaxSolver(jsp)
    port = make_solver(cfg)
    load_jax_params(port.net, jax.tree_util.tree_map(np.asarray, js.params))
    train, test = cls_feed(0), cls_feed(5000)
    np_feed = lambda f: lambda it: {k: v.numpy()  # noqa: E731
                                    for k, v in f(it).items()}
    with caplog.at_level(logging.INFO, "caffe_mpi_tpu.solver"):
        js.step(8, np_feed(train), test_feed_fns=[np_feed(test)])
    jax_tags = [r.args for r in caplog.records
                if r.name == "caffe_mpi_tpu.solver"
                and r.msg.startswith("Test net #%d, iteration")]
    jax_scores = [r.args[1:] for r in caplog.records
                  if r.name == "caffe_mpi_tpu.solver"
                  and r.msg.startswith("    Test net")]
    caplog.clear()
    with caplog.at_level(logging.INFO, "caffe_mpi_tpu_torch.solver"):
        port.step(8, train, test_feed_fns=[test])
    tags = [r.args for r in caplog.records
            if r.name == "caffe_mpi_tpu_torch.solver"
            and r.msg.startswith("Test net #%d, iteration")]
    assert tags == jax_tags == [(0, 0), (0, 4)]
    assert [e["iter"] for e in port.eval_log] == [0, 4]
    got = [kv for e in port.eval_log for kv in e["scores"][0].items()]
    assert [k for k, _ in got] == [k for k, _ in jax_scores]
    np.testing.assert_allclose([v for _, v in got],
                               [v for _, v in jax_scores], rtol=1e-5)
    assert port._pending_eval is None and port.test_pass_count == 2


def test_boundary_scores_are_bitwise_the_synchronous_pass():
    """A twin without test feeds trains the same trajectory; its
    synchronous test_all at each boundary gives the very floats the
    asynchronous pass logged."""
    cfg = "test_iter: 5 test_chunk: 2 test_interval: 3 "
    a, b = make_solver(cfg), make_solver(cfg)
    train, test = cls_feed(0), cls_feed(5000)
    a.step(9, train, test_feed_fns=[test])
    want = []
    for _ in range(3):
        want.append(b.test_all([test]))
        b.step(3, train)
    assert [e["iter"] for e in a.eval_log] == [0, 3, 6]
    assert [e["scores"] for e in a.eval_log] == want


def test_evaluation_does_not_perturb_training():
    cfg = "test_iter: 3 test_interval: 4 step_chunk: 2 " \
          "test_initialization: false "
    a, b = make_solver(cfg), make_solver(cfg)
    train, test = cls_feed(0), cls_feed(5000)
    a.step(8, train, test_feed_fns=[test])
    b.step(8, train)
    assert a.iter == b.iter == 8 and a.losses == b.losses
    pa, pb = _params(a), _params(b)
    for k in pa:
        assert torch.equal(pa[k], pb[k]), k
    assert a.test_pass_count == 1 and a._pending_eval is None


def test_a_pass_on_the_live_params_is_caught():
    """The planted fault: no copy, the pass reads the live params; its
    chunks after the boundary's first see the next iterations' weights,
    so its scores leave the synchronous pass's."""
    cfg = "test_iter: 6 test_chunk: 2 test_interval: 4 " \
          "test_initialization: false "
    a, b = make_solver(cfg), make_solver(cfg)
    train, test = cls_feed(0), cls_feed(5000)

    def live(ti, tnet):
        # the view's entries (a module's dict, a name, the tensor read),
        # each the live tensor itself
        return [(d, name, t) for m in tnet.modules()
                for d in (m._parameters, m._buffers)
                for name, t in d.items() if t is not None]
    a._eval_view = live
    a.step(8, train, test_feed_fns=[test])
    b.step(4, train)
    want = b.test_all([test])[0]
    (entry,) = a.eval_log
    got = entry["scores"][0]
    assert entry["iter"] == 4
    assert abs(got["l"] - want["l"]) > 0
    # the sound pass on the same schedule holds
    c = make_solver(cfg)
    c.step(8, train, test_feed_fns=[test])
    assert c.eval_log[0]["scores"][0] == want


def test_boundary_launches_only_the_first_chunk():
    s = make_solver("test_iter: 6 test_chunk: 2")
    calls = []
    test = cls_feed(5000, calls=calls)
    d0 = s.test_dispatch_count
    s._start_eval([test])
    entry = s._pending_eval["entries"][0]
    assert entry["next"] == 2 and calls == [0, 1]
    assert s.test_dispatch_count - d0 == 1
    s._continue_eval()
    assert entry["next"] == 6 and s.test_dispatch_count - d0 == 3
    scores = s._harvest_eval()
    assert s.test_dispatch_count - d0 == 3 and calls == list(range(6))
    assert scores == s.test_all([cls_feed(5000)])


def test_later_chunks_interleave_with_training():
    """Each test batch is asked for once, in order; the boundary launches
    the first chunk before the boundary's training chunk, the rest
    follow it."""
    s = make_solver("test_iter: 6 test_chunk: 2 test_interval: 4 "
                    "test_initialization: false")
    seen = []
    calls = []
    base = cls_feed(5000, calls=calls)

    def test(k):
        seen.append((s.dispatch_count, k))
        return base(k)
    s.step(8, cls_feed(0), test_feed_fns=[test])
    assert calls == list(range(6))
    assert seen == [(4, 0), (4, 1), (5, 2), (5, 3), (5, 4), (5, 5)]


def test_eval_stall_is_tracked():
    s = make_solver("test_iter: 2 test_interval: 2 "
                    "test_initialization: false")
    s.step(4, cls_feed(0), test_feed_fns=[cls_feed(5000)])
    assert s.test_pass_count == 1 and s.eval_stall_ms > 0.0


def test_resume_across_a_test_boundary(tmp_path):
    """A snapshot at 6 with a test boundary at 4 and step_chunk 4: the
    resumed run continues the uninterrupted one bitwise, and its pass at
    8 scores as the uninterrupted run's."""
    cfg = ('type: "Adam" test_iter: 2 test_interval: 4 snapshot: 6 '
           'test_initialization: false step_chunk: 4 ')
    train, test = cls_feed(0), cls_feed(5000)
    a = make_solver(cfg)
    a.sp.snapshot_prefix = str(tmp_path / "fe")
    a.step(10, train, test_feed_fns=[test])
    a.wait_snapshots()
    c = make_solver(cfg)
    c.restore(str(tmp_path / "fe_iter_6.solverstate"))
    assert c.iter == 6
    c.step(4, train, test_feed_fns=[test])
    pa, pc = _params(a), _params(c)
    for k in pa:
        assert torch.equal(pa[k], pc[k]), k
    assert [e["iter"] for e in a.eval_log] == [4, 8]
    assert c.eval_log == a.eval_log[1:]


def test_gpipe_pass_runs_on_stage_zero():
    """Under GPipe the pass evaluates the whole test net on stage 0's
    device through the copies: deterministic, bitwise a plain solver's
    pass on the same weights, and the in-training pass scores as the
    iter_size run's on the same micro-batches (rtol 1e-5)."""
    full = cls_feed(0)

    def half(it):
        f = full(it // 2)
        lo = 4 * (it % 2)
        return {k: v[lo:lo + 4] for k, v in f.items()}
    test = cls_feed(5000)
    cfg = "test_iter: 3 test_interval: 2 test_initialization: false "
    gp = make_solver(cfg, gpipe={"stages": 2, "micro": 2})
    gp.step(4, half, test_feed_fns=[test])
    assert gp._eval_device() == gp.gpipe.devices[0]
    assert [e["iter"] for e in gp.eval_log] == [2]
    s1, s2 = gp.test_all([test]), gp.test_all([test])
    assert s1 == s2
    plain = make_solver(cfg)
    plain.net.import_weights(gp.net.export_weights())
    assert plain.test_all([test]) == s1
    # the iter_size run, its test net at the GPipe run's test batch
    sp = SolverParameter.from_text(BASE + cfg + "iter_size: 2")
    sp.net_param = NetParameter.from_text(
        CLS_NET.replace("dim: 8 dim: 6", "dim: 4 dim: 6")
        .replace("shape { dim: 8 }", "shape { dim: 4 }"))
    sp.test_net_param = [NetParameter.from_text(CLS_NET)]
    seq = Solver(sp, device="cpu")
    seq.step(4, half, test_feed_fns=[test])
    assert [e["iter"] for e in seq.eval_log] == [2]
    for a, b in zip(gp.eval_log[0]["scores"][0].items(),
                    seq.eval_log[0]["scores"][0].items()):
        assert a[0] == b[0]
        np.testing.assert_allclose(a[1], b[1], rtol=1e-5)


def test_close_drops_an_unharvested_pass(caplog):
    s = make_solver("test_iter: 4 test_chunk: 1")
    s._start_eval([cls_feed(5000)])
    with caplog.at_level(logging.WARNING, "caffe_mpi_tpu_torch.solver"):
        s.close()
    assert s._pending_eval is None
    assert "unharvested evaluation pass" in caplog.text


def test_cli_summary_reports_the_passes_and_the_stall(tmp_path):
    net = tmp_path / "net.prototxt"
    net.write_text(CLS_NET.replace("num_output: 3", "num_output: 10"))
    solver = tmp_path / "solver.prototxt"
    solver.write_text(f'net: "{net}"\n' + BASE.replace("max_iter: 1000",
                                                       "max_iter: 4")
                      + "test_iter: 3 test_interval: 2\n")
    _, summary = cli.train(cli.parse_args(
        ["train", "-solver", str(solver), "-synthetic", "-device", "cpu"]))
    assert [e["iter"] for e in summary["eval_log"]] == [0, 2, 4]
    assert summary["eval_stall_ms"] > 0
    assert summary["test_scores"] == summary["eval_log"][-1]["scores"]
