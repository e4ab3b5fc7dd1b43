"""Port serving resilience on the CPU, each scenario run on the port's
engine and on the JAX package's (caffe_mpi_tpu/serving) with the same
narrow LRN deploy net, weights and fault sites: admission control (429),
deadlines under the `serve_dispatch_stall` fault site (504), the stall
breaker (in-flight futures fail typed, new submits shed 503, the journal's
reasons, `probe_recovery`), a contained dispatcher crash, hot swap (rows
follow the new weights within 1e-6 of the port's Net; a `swap_canary_bad`
candidate is rejected and the old rows come back bitwise; no build
counted), graceful drain, LRU residency under `serve_hbm_mb` (spill and
reload counts equal to the JAX engine's on the same trace, rows after a
reload bitwise the rows before), the static plan, and `serve_dtype: bf16`
(rows within twice the JAX bf16 engine's own distance from its f32 rows,
the rule of test_torch_precision.py).
"""

import json
import os
import time

import numpy as np
import pytest
import torch

from caffe_mpi_tpu.proto.config import ServingParameter as JaxServing
from caffe_mpi_tpu.serving import ServingEngine as JaxEngine
from caffe_mpi_tpu.serving import plan as jplan
from caffe_mpi_tpu.utils import resilience as jres
from caffe_mpi_tpu_torch import io as port_io
from caffe_mpi_tpu_torch.net import Net
from caffe_mpi_tpu_torch.proto import NetParameter
from caffe_mpi_tpu_torch.proto.config import ServingParameter
from caffe_mpi_tpu_torch.serving import (DeadlineError, EngineClosedError,
                                         EngineUnhealthyError,
                                         ServingEngine, ShedError,
                                         SwapError, plan)
from caffe_mpi_tpu_torch.serving.engine import InferenceModel
from caffe_mpi_tpu_torch.utils import resilience as pres
from test_torch_serving_ingest import BUCKETS, write_deploy

ENGINES = {"port": lambda **kw: ServingEngine(device="cpu", buckets=BUCKETS,
                                              **kw),
           "jax": lambda **kw: JaxEngine(buckets=BUCKETS, **kw)}
PLANES = {"port": pres.FAULTS, "jax": jres.FAULTS}


@pytest.fixture(scope="module")
def deploy(tmp_path_factory):
    return write_deploy(tmp_path_factory.mktemp("serve_res"))


@pytest.fixture
def faults():
    """Configure both fault planes for one test, and always clear them."""
    def configure(spec):
        for plane in PLANES.values():
            plane.configure(spec)
    yield configure
    for plane in PLANES.values():
        plane.configure("")


def rows(n, seed=0):
    return np.random.RandomState(seed).rand(n, 3, 16, 16).astype(
        np.float32) * 255.0


def submit(eng, n, seed=0):
    return [eng.submit("m", r, preprocess=False) for r in rows(n, seed)]


def wait_taken(eng, timeout=10.0):
    """Until the dispatcher has taken every pending request."""
    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        with eng._batcher._cv:
            if not eng._batcher._pending:
                return
        time.sleep(0.005)
    raise TimeoutError("the dispatcher never took the pending request")


def journal(prefix, timeout=5.0):
    path = prefix + ".serve.run.json"
    deadline = time.perf_counter() + timeout
    while not os.path.exists(path) and time.perf_counter() < deadline:
        time.sleep(0.01)
    with open(path) as f:
        return json.load(f)


def outcome(fut, timeout=30):
    try:
        fut.result(timeout=timeout)
        return "ok"
    except Exception as e:  # noqa: BLE001 — the kind is the outcome
        return getattr(e, "kind", type(e).__name__)


# -- admission ----------------------------------------------------------------

@pytest.mark.parametrize("kind", ["port", "jax"])
def test_admission_sheds_429_at_the_queue_limit(deploy, kind):
    model, weights = deploy
    with ENGINES[kind](window_ms=600_000, queue_limit=3) as eng:
        eng.load_model("m", model, weights)
        accepted = shed = 0
        for r in rows(12):
            try:
                eng.submit("m", r, preprocess=False)
                accepted += 1
            except ShedError if kind == "port" else Exception as e:
                assert e.kind == "shed" and e.http_status == 429
                shed += 1
        st = eng.stats()
    assert (accepted, shed) == (3, 9)
    assert st["shed_requests"] == 9 and st["max_queue_depth"] == 3


def test_negative_knobs_are_refused_as_jax_refuses_them():
    for knob in ("queue_limit", "deadline_ms", "stall_s", "hbm_mb",
                 "decoded_cache_mb", "window_ms"):
        with pytest.raises(ValueError, match="must be >= 0"):
            ServingEngine(device="cpu", start=False, **{knob: -1})
        with pytest.raises(ValueError, match="must be >= 0"):
            JaxEngine(start=False, **{knob: -1})


# -- deadlines ----------------------------------------------------------------

def _deadline_run(kind, deploy, faults):
    model, weights = deploy
    faults("serve_dispatch_stall:1:0:0.8")
    with ENGINES[kind](window_ms=0, deadline_ms=150) as eng:
        eng.load_model("m", model, weights)
        first = submit(eng, 1)
        wait_taken(eng)  # A is inside its stall, alone
        later = submit(eng, 3, seed=1)
        got = [outcome(f) for f in first + later]
        late = submit(eng, 2, seed=2)  # after the stall: in time
        got += [outcome(f) for f in late]
        return got, eng.stats()["deadline_failures"]


def test_the_same_requests_expire_as_in_the_jax_engine(deploy, faults):
    port = _deadline_run("port", deploy, faults)
    jax = _deadline_run("jax", deploy, faults)
    assert port == jax
    assert port[0] == ["ok", "deadline", "deadline", "deadline", "ok", "ok"]
    assert port[1] == 3


def test_the_window_is_clamped_to_half_the_deadline(deploy):
    model, weights = deploy
    with ServingEngine(device="cpu", buckets=BUCKETS, window_ms=600_000,
                       deadline_ms=200) as eng:
        eng.load_model("m", model, weights)
        t0 = time.perf_counter()
        assert eng.submit("m", rows(1)[0], preprocess=False).result(
            30).shape == (7,)
        assert time.perf_counter() - t0 < 10.0
        assert eng.stats()["deadline_failures"] == 0


# -- the stall breaker --------------------------------------------------------

def _breaker_run(kind, deploy, faults, tmp_path):
    model, weights = deploy
    prefix = str(tmp_path / kind)
    faults("serve_dispatch_stall:1:0:1.5")
    reasons = []
    with ENGINES[kind](window_ms=0, stall_s=0.3, journal=prefix) as eng:
        eng.load_model("m", model, weights)
        fut = submit(eng, 1)[0]
        with pytest.raises(Exception) as ei:
            fut.result(timeout=10)
        assert ei.value.kind == "deadline" and ei.value.http_status == 504
        assert not eng.healthy
        h = eng.health()
        assert h["healthy"] is False and h["breaker"]["state"] == "open"
        assert h["breaker"]["section"] == "dispatch:m"
        reasons.append(journal(prefix)["reason"])
        t0 = time.perf_counter()
        with pytest.raises(Exception) as ei:
            submit(eng, 1)
        assert time.perf_counter() - t0 < 0.3
        assert ei.value.kind == "unhealthy" and ei.value.http_status == 503
        # the stalled call is still open: the probe is refused
        assert eng.probe_recovery(timeout=1) is False
        eng.drain(timeout=10)
        assert eng.probe_recovery(timeout=10) is True
        reasons.append(journal(prefix)["reason"])
        assert eng.healthy
        assert np.stack([f.result(30) for f in submit(eng, 2)]).shape \
            == (2, 7)
        st = eng.stats()
    assert st["stall_trips"] == 1 and st["healthy"] is True
    assert st["compile_count"] == st["warmed_buckets"]
    return reasons, st["unhealthy_sheds"]


def test_the_breaker_trips_sheds_journals_and_recovers_as_jax(
        deploy, faults, tmp_path):
    port = _breaker_run("port", deploy, faults, tmp_path)
    jax = _breaker_run("jax", deploy, faults, tmp_path)
    assert port == jax
    assert port[0] == ["serve_stall:dispatch:m", "serve_recovered"]


def test_a_trip_fails_the_parked_backlog_too(deploy, faults):
    model, weights = deploy
    faults("serve_dispatch_stall:1:0:1.2")
    with ServingEngine(device="cpu", buckets=BUCKETS, window_ms=0,
                       stall_s=0.3) as eng:
        eng.load_model("m", model, weights)
        first = submit(eng, 1)[0]
        wait_taken(eng)
        parked = submit(eng, 1, seed=1)[0]
        with pytest.raises(DeadlineError):
            first.result(timeout=10)
        with pytest.raises(DeadlineError):
            parked.result(timeout=10)
        eng.drain(timeout=10)


def test_close_stops_the_breaker_and_a_late_probe_does_not_rearm(deploy):
    model, weights = deploy
    eng = ServingEngine(device="cpu", buckets=BUCKETS, window_ms=0,
                        stall_s=5.0)
    eng.load_model("m", model, weights)
    wd = eng._watchdog
    assert wd is not None and wd._thread.is_alive()
    eng._on_stall("dispatch:m", 9.9)  # breaker open
    assert not eng.healthy and eng.health()["breaker"]["state"] == "open"
    eng.close()
    wd._thread.join(timeout=5)
    assert not wd._thread.is_alive() and eng._watchdog is None
    assert eng.probe_recovery(timeout=5) is False
    assert not eng.healthy


def test_a_dispatcher_crash_is_contained_typed_and_journaled(deploy,
                                                             tmp_path):
    model, weights = deploy
    prefix = str(tmp_path / "crash")
    with ServingEngine(device="cpu", buckets=BUCKETS, window_ms=0,
                       journal=prefix) as eng:
        eng.load_model("m", model, weights)
        real = eng._batcher._take_group
        armed = [True]

        def boom(*a, **kw):
            if armed[0]:
                armed[0] = False
                raise RuntimeError("injected dispatcher crash")
            return real(*a, **kw)

        eng._batcher._take_group = boom
        with pytest.raises(EngineUnhealthyError, match="dispatcher crashed"):
            submit(eng, 1)[0].result(timeout=10)
        doc = journal(prefix)
        assert doc["reason"] == "serve_dispatcher_crash"
        assert "injected dispatcher crash" in doc["error"]
        assert submit(eng, 1)[0].result(timeout=10).shape == (7,)


# -- hot swap -----------------------------------------------------------------

def _net_rows(model, weights, x):
    net = Net(NetParameter.from_file(model), device="cpu")
    net.import_weights(port_io.load_weights(weights), strict=True)
    want = []
    for chunk in (x[:4], x[4:]):
        pad = np.zeros((4 - len(chunk), 3, 16, 16), np.float32)
        with torch.inference_mode():
            out = net({"data": torch.from_numpy(
                np.concatenate([chunk, pad]))})[0]["prob"].numpy()
        want.append(out[:len(chunk)])
    return np.concatenate(want)


def _swap_run(kind, deploy, faults, tmp_path):
    model, weights = deploy
    _, new = write_deploy(tmp_path, seed=9)
    prefix = str(tmp_path / f"swap_{kind}")
    faults("")  # the other engine's run armed both planes
    x = rows(6)
    with ENGINES[kind](window_ms=0, journal=prefix) as eng:
        eng.load_model("m", model, weights)
        before = eng.classify("m", x, preprocess=False)
        builds = eng.compile_count
        eng.swap_weights("m", new)
        reasons = [journal(prefix)["reason"]]
        after = eng.classify("m", x, preprocess=False)
        faults("swap_canary_bad:1")
        with pytest.raises(Exception) as ei:
            eng.swap_weights("m", weights)
        assert ei.value.kind == "swap"
        assert kind == "jax" or isinstance(ei.value, SwapError)
        doc = journal(prefix)
        reasons.append((doc["reason"], doc["swap_reason"]))
        kept = eng.classify("m", x, preprocess=False)
        with pytest.raises(Exception) as ei:
            eng.swap_weights("m", str(tmp_path / "missing.caffemodel"))
        assert ei.value.kind == "swap"
        st = eng.stats()
        assert eng.compile_count == builds == st["warmed_buckets"]
    assert (st["swaps"], st["swap_rejections"]) == (1, 2)
    return before, after, kept, reasons, new


def test_swap_follows_the_new_weights_and_the_canary_rolls_back(
        deploy, faults, tmp_path):
    model, weights = deploy
    before, after, kept, reasons, new = _swap_run("port", deploy, faults,
                                                  tmp_path)
    x = rows(6)
    np.testing.assert_allclose(before, _net_rows(model, weights, x),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(after, _net_rows(model, new, x), rtol=0,
                               atol=1e-6)
    assert np.abs(after - before).max() > 1e-4
    np.testing.assert_array_equal(kept, after)  # the rejection left them
    jbefore, jafter, jkept, jreasons, _ = _swap_run("jax", deploy, faults,
                                                    tmp_path)
    assert reasons == jreasons == [
        "swap", ("swap_rejected", "canary scores are non-finite")]
    np.testing.assert_allclose(after, jafter, rtol=0, atol=1e-4)
    np.testing.assert_allclose(kept, jkept, rtol=0, atol=1e-4)


# -- graceful drain ------------------------------------------------------------

@pytest.mark.parametrize("kind", ["port", "jax"])
def test_shutdown_resolves_every_accepted_request(deploy, tmp_path, kind):
    model, weights = deploy
    prefix = str(tmp_path / kind)
    eng = ENGINES[kind](window_ms=600_000, journal=prefix)
    eng.load_model("m", model, weights)
    futs = submit(eng, 6)
    eng.shutdown(timeout=60)
    assert all(f.result(timeout=1).shape == (7,) for f in futs)
    assert journal(prefix)["reason"] == "serve_shutdown"
    with pytest.raises(Exception) as ei:
        submit(eng, 1)
    assert ei.value.kind == "closed" and ei.value.http_status == 503
    if kind == "port":
        assert isinstance(ei.value, EngineClosedError)


# -- residency ------------------------------------------------------------------

TRACE = ["a", "b", "a", "a", "b", "b", "a"]


def _residency_run(kind, deploy, tmp_path):
    model, weights = deploy
    _, other = write_deploy(tmp_path, seed=5)
    probe = ENGINES[kind](start=False)
    size = probe.load_model("p", model, weights).param_bytes
    probe.close()
    budget = 1.5 * size / 2**20  # one model fits, not two
    x = rows(3)
    out = []
    with ENGINES[kind](window_ms=0, hbm_mb=budget) as eng:
        eng.load_model("a", model, weights)
        eng.load_model("b", model, other)
        counts = [(eng.spills, eng.reloads)]
        for name in TRACE:
            out.append(eng.classify(name, x, preprocess=False))
            counts.append((eng.spills, eng.reloads))
        st = eng.stats()
    return out, counts, st


def test_lru_residency_spills_and_reloads_as_jax(deploy, tmp_path):
    out, counts, st = _residency_run("port", deploy, tmp_path)
    jout, jcounts, jst = _residency_run("jax", deploy, tmp_path)
    assert counts == jcounts
    assert st["spills"] > 0 and st["reloads"] > 0
    # rows after a reload are bitwise the rows before
    by = {}
    for name, r in zip(TRACE, out):
        by.setdefault(name, []).append(r)
    for name, seen in by.items():
        for r in seen[1:]:
            np.testing.assert_array_equal(r, seen[0])
    np.testing.assert_allclose(np.stack(out), np.stack(jout), rtol=0,
                               atol=1e-4)
    # no graphs on the CPU: nothing to recapture, every bucket built once
    assert st["compile_count"] == st["warmed_buckets"] + st["recaptures"]
    # the JAX plan spills "a" in load order; the trace ends on "a", so
    # the engine's residency holds "a" alone
    assert jst["bank"]["plan"]["admission"]["planned_spills"] == ["a"]
    assert st["plan"]["admission"]["resident"] == ["a"]
    assert st["plan"]["admission"]["resident_bytes"] == \
        st["plan"]["models"]["a"]["param_bytes"]


@pytest.mark.parametrize("busy,spilled", [
    ((), ["a"]), (("a",), ["b"]), (("a", "b"), []),
])
def test_lru_spills_the_least_recent_idle_model(deploy, busy, spilled):
    """A model with a dispatch in flight is never a victim: the next idle
    one spills in its place, and with none idle the budget is
    over-committed until their next LRU pass."""
    model, weights = deploy
    with ServingEngine(device="cpu", buckets=BUCKETS, window_ms=0,
                       start=False) as probe:
        size = probe.load_model("p", model, weights).param_bytes
    with ServingEngine(device="cpu", buckets=BUCKETS, window_ms=0,
                       hbm_mb=2.5 * size / 2**20) as eng:
        for name in ("a", "b"):
            eng.load_model(name, model, weights)
        for name in busy:
            eng.model(name).in_flight += 1
        eng.load_model("c", model, weights)
        assert [n for n in ("a", "b") if not eng.model(n).resident] \
            == spilled
        assert eng.spills == len(spilled) and eng.model("c").resident
        adm = eng.stats()["plan"]["admission"]
        assert adm["resident"] == [n for n in ("a", "b", "c")
                                   if n not in spilled]
        assert adm["resident_bytes"] == len(adm["resident"]) * size
        for name in busy:
            eng.model(name).in_flight -= 1


def test_a_spill_frees_the_device_storage_and_a_reload_restores_it(deploy):
    model, weights = deploy
    with ServingEngine(device="cpu", buckets=BUCKETS, window_ms=0) as eng:
        m = eng.load_model("a", model, weights)
        want = eng.classify("a", rows(2), preprocess=False)
        m.spill()
        assert not m.resident
        assert all(t.untyped_storage().nbytes() == 0
                   for t in m._tensors.values())
        eng._make_resident(m)
        assert m.resident
        np.testing.assert_array_equal(
            eng.classify("a", rows(2), preprocess=False), want)


# -- the plan -------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("ladder", [None, "1,2"])
def test_plan_model_equals_the_jax_plan(deploy, dtype, ladder):
    param = NetParameter.from_file(deploy[0])
    from caffe_mpi_tpu.proto import NetParameter as JaxNetParameter
    jparam = JaxNetParameter.from_file(deploy[0])
    assert plan.declared_batch(param) == jplan.declared_batch(jparam) == 4
    model = InferenceModel("m", param, deploy[1], ladder=ladder,
                           dtype=dtype, device="cpu")
    got = plan.plan_model(model.fwd, model.param_bytes)
    assert got == jplan.plan_model(jparam, ladder=ladder, dtype=dtype)
    assert got["param_bytes"] == sum(
        b.size * 4 for w in port_io.load_weights(deploy[1]).values()
        for b in w)


@pytest.mark.parametrize("models,budget", [
    ([("a", 10), ("b", 10), ("c", 5)], 0),
    ([("a", 10), ("b", 10), ("c", 5)], 16),
    ([("a", 10), ("b", 30)], 20),
])
def test_plan_admission_equals_the_jax_plan(models, budget):
    assert plan.plan_admission(models, budget) == \
        jplan.plan_admission(models, budget)


# -- bf16 -----------------------------------------------------------------------

def test_bf16_rows_within_twice_the_jax_bf16_distance(deploy):
    model, weights = deploy
    x = rows(6)
    got = {}
    for kind, make, sp_cls in (
            ("port", lambda sp: ServingEngine(sp, device="cpu",
                                              buckets=BUCKETS),
             ServingParameter),
            ("jax", lambda sp: JaxEngine(sp, buckets=BUCKETS), JaxServing)):
        for dtype in ("f32", "bf16"):
            with make(sp_cls(serve_dtype=dtype)) as eng:
                eng.load_model("m", model, weights)
                r = eng.classify("m", x, preprocess=False)
                assert r.dtype == np.float32 and r.shape == (6, 7)
                got[kind, dtype] = r
                st = eng.stats()
                assert st["compile_count"] == st["warmed_buckets"] == 2
    band = np.abs(got["jax", "bf16"] - got["jax", "f32"]).max()
    assert band > 0
    assert np.abs(got["port", "bf16"] - got["jax", "bf16"]).max() \
        <= 2 * band
    np.testing.assert_allclose(got["port", "f32"], got["jax", "f32"],
                               rtol=0, atol=1e-4)
    assert np.abs(got["port", "bf16"] - got["port", "f32"]).max() > 0


def test_serving_param_fields_reach_the_engine():
    sp = ServingParameter(serve_dtype="bf16", serve_hbm_mb=2.0,
                          serve_deadline_ms=40.0, serve_stall_s=3.0,
                          serve_decoded_cache_mb=1.5)
    eng = ServingEngine(sp, device="cpu", start=False)
    try:
        assert eng.serve_dtype == "bf16" and eng.hbm_budget == 2 * 2**20
        assert eng.deadline_ms == 40.0 and eng.stall_s == 3.0
        assert eng._watchdog is not None
        assert eng.ingest.cache_budget == int(1.5 * 2**20)
    finally:
        eng.close()
