"""The port's fleet router and heartbeat revive on the CPU:
caffe_mpi_tpu_torch.serving.fleet against the JAX package's
caffe_mpi_tpu/serving/fleet.py.

Every scenario of tests/test_serving_fleet.py runs through both packages'
`FleetRouter` with the same scripted fake replica clients: least-loaded
picks, the typed-retry policy (429 and 503 retried on a sibling within
`serve_retry_budget`, 504 and 400 never, a connection error typed
`replica_lost`), the fleet-wide stats / healthz / readyz documents, the
rolling canary swap, the rollback to the previous weights file, the
`fleet_swap_canary_bad` site and the snapshot watcher driving the router.
Each scenario returns what it observed (statuses, kinds, the calls each
client received, the counters, the documents, the journal's reasons and
counters, the rollbacks) with paths made relative to the scenario's
directory: each package's test holds the JAX test's expectations, and one
test more holds the two packages' observations equal. `HostHeartbeat.revive`
is held against the JAX heartbeat, and `serving/fleet.py` imports with
torch and jax blocked.
"""

import os
import subprocess
import sys
import time

import pytest

import caffe_mpi_tpu.serving.errors as jax_errors
import caffe_mpi_tpu.serving.fleet as jax_fleet
import caffe_mpi_tpu.serving.watch as jax_watch
import caffe_mpi_tpu.utils.resilience as jax_res
import caffe_mpi_tpu_torch.serving.errors as port_errors
import caffe_mpi_tpu_torch.serving.fleet as port_fleet
import caffe_mpi_tpu_torch.serving.watch as port_watch
import caffe_mpi_tpu_torch.utils.resilience as port_res

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PKGS = {
    "jax": (jax_fleet, jax_errors, jax_watch, jax_res),
    "port": (port_fleet, port_errors, port_watch, port_res),
}

OK = (200, {"predictions": [{"label": 0, "score": 1.0}]})
SHED = (429, {"error": "shed", "kind": "shed"})
UNHEALTHY = (503, {"error": "breaker open", "kind": "unhealthy"})
DEADLINE = (504, {"error": "deadline", "kind": "deadline"})
BAD = (400, {"error": "bad bytes", "kind": "bad_request"})
SWAP_OK = (200, {"swapped": True})
SWAP_REJECT = (500, {"error": "canary scores are non-finite",
                     "kind": "swap"})
DOWN = "down"  # a scripted ConnectionRefusedError


class FakeClient:
    """Scripted replica (tests/test_serving_fleet.py's): `responses` is
    consumed one per classify call (the last entry repeats); DOWN raises
    a connection-level error. Swap calls are recorded with their
    payloads."""

    def __init__(self, responses=(OK,), swap=(SWAP_OK,), ready=True,
                 stats=None):
        self._responses = list(responses)
        self._swap = list(swap)
        self.ready = ready
        self.stats_doc = stats if stats is not None else {"requests": 0}
        self.classify_calls = 0
        self.swap_calls = []

    def _next(self, script):
        r = script.pop(0) if len(script) > 1 else script[0]
        if r == DOWN:
            raise ConnectionRefusedError("down")
        return r

    def classify(self, body, content_type=""):
        self.classify_calls += 1
        return self._next(self._responses)

    def get(self, path):
        if path == "/readyz":
            return (200, {"ready": True}) if self.ready \
                else (503, {"ready": False})
        if path == "/stats":
            return 200, self.stats_doc
        return 404, {"kind": "not_found"}

    def swap(self, payload):
        self.swap_calls.append(dict(payload))
        return self._next(self._swap)


class Run:
    """One scenario in one package: its router, its clients, its directory,
    and what it observed."""

    def __init__(self, pkg, tmp, clients, **kw):
        self.fleet, self.errors, self.watch, self.res = PKGS[pkg]
        self.tmp = str(tmp)
        self.clients = clients
        handles = [self.fleet.ReplicaHandle(i, client=c)
                   for i, c in enumerate(clients)]
        self.router = self.fleet.FleetRouter(handles, **kw)
        self.seen = {}

    def rel(self, obj):
        """`obj` with this scenario's directory made `<tmp>`: the two
        packages' runs compare equal across their directories."""
        if isinstance(obj, str):
            return obj.replace(self.tmp, "<tmp>")
        if isinstance(obj, dict):
            return {k: self.rel(v) for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            return [self.rel(v) for v in obj]
        return obj

    def classify(self, n=1):
        out = [self.router.classify(b"img") for _ in range(n)]
        self.seen.setdefault("answers", []).extend(
            (s, d.get("kind", "")) for s, d in out)
        return out[-1]

    def swap(self, weights, **kw):
        try:
            self.router.swap_weights("default", weights, **kw)
            self.seen.setdefault("swaps", []).append("ok")
        except self.errors.SwapError as e:
            self.seen.setdefault("swaps", []).append(
                ("SwapError", self.rel(str(e))))

    def weights(self, name, payload):
        path = os.path.join(self.tmp, name)
        with open(path, "wb") as f:
            f.write(payload)
        return path

    def journal(self):
        doc = self.res.read_run_manifest(
            os.path.join(self.tmp, "fleet") + ".serve") or {}
        return {k: self.rel(v) for k, v in doc.items()
                if k not in ("time", "pid", "schema")}

    def observed(self):
        r = self.router
        return self.rel({
            **self.seen,
            "classify_calls": [c.classify_calls for c in self.clients],
            "swap_calls": [c.swap_calls for c in self.clients],
            "counters": {k: getattr(r, k) for k in (
                "routed", "retries", "sheds_absorbed", "conn_errors",
                "replica_deaths", "respawns", "swaps", "swap_rejections",
                "rollbacks")},
            "rotation": [h.in_rotation for h in r._handles],
            "in_flight": [h.in_flight for h in r._handles],
            "health": r.health(), "ready": list(r.ready()),
            "stats": r.stats(), "current_weights": r.current_weights,
            "previous_weights": r.previous_weights,
            "journal": self.journal()})


# ---------------------------------------------------------------------------
# the scenarios: each returns its Run after driving it

def sc_least_loaded_pick(pkg, tmp):
    run = Run(pkg, tmp, [FakeClient(), FakeClient(), FakeClient()])
    for rid, n in ((0, 2), (1, 0), (2, 1)):
        run.router.handle(rid).in_flight = n
    h = run.router._pick(set())
    run.seen["pick"] = (h.rid, h.in_flight)
    return run


def sc_idle_fleet_still_spreads(pkg, tmp):
    run = Run(pkg, tmp, [FakeClient(), FakeClient()])
    run.classify(4)
    return run


def sc_shed_retried_on_sibling(pkg, tmp):
    run = Run(pkg, tmp, [FakeClient(), FakeClient(responses=[SHED])],
              retry_budget=1)
    run.classify()
    return run


def sc_unhealthy_retried_on_sibling(pkg, tmp):
    run = Run(pkg, tmp, [FakeClient(), FakeClient(responses=[UNHEALTHY])],
              retry_budget=1)
    run.classify()
    return run


def sc_retry_budget_exhausted(pkg, tmp):
    run = Run(pkg, tmp, [FakeClient(responses=[SHED]) for _ in range(3)],
              retry_budget=1)
    run.classify()
    return run


def sc_deadline_never_retried(pkg, tmp):
    run = Run(pkg, tmp, [FakeClient(), FakeClient(responses=[DEADLINE])],
              retry_budget=3)
    run.classify()
    return run


def sc_bad_request_never_retried(pkg, tmp):
    run = Run(pkg, tmp, [FakeClient(), FakeClient(responses=[BAD])],
              retry_budget=3)
    run.classify()
    return run


def sc_conn_error_retried_and_drained(pkg, tmp):
    run = Run(pkg, tmp, [FakeClient(), FakeClient(responses=[DOWN])],
              retry_budget=1)
    run.classify()
    return run


def sc_conn_error_without_budget(pkg, tmp):
    run = Run(pkg, tmp, [FakeClient(responses=[DOWN])], retry_budget=0)
    run.classify()
    return run


def sc_empty_rotation(pkg, tmp):
    run = Run(pkg, tmp, [FakeClient(), FakeClient()])
    run.router.mark_down(0)
    run.router.mark_down(1)
    run.classify()
    return run


def sc_stats_aggregation(pkg, tmp):
    run = Run(pkg, tmp, [
        FakeClient(stats={"requests": 7, "compile_count": 2}),
        FakeClient(responses=[DOWN], stats={"requests": 3})],
        retry_budget=1)
    run.classify(2)
    return run


def sc_healthz_aggregation(pkg, tmp):
    run = Run(pkg, tmp, [FakeClient(), FakeClient()])
    docs = [run.router.health()]
    run.router.mark_down(0)
    docs.append(run.router.health())
    run.router.mark_down(1)
    docs.append(run.router.health())
    run.router.mark_up(0)
    docs.append(run.router.health())
    run.seen["healthz"] = docs
    return run


def sc_readyz_aggregation(pkg, tmp):
    b = FakeClient(ready=False)
    run = Run(pkg, tmp, [FakeClient(), b])
    docs = [run.router.ready()]
    b.ready = True
    docs.append(run.router.ready())
    run.router.mark_down(0)
    docs.append(run.router.ready())
    run.seen["readyz"] = [list(d) for d in docs]
    return run


def sc_rolling_swap_propagates(pkg, tmp):
    run = Run(pkg, tmp, [FakeClient() for _ in range(3)],
              stage_dir=os.path.join(str(tmp), "stage"))
    run.swap(run.weights("v2.caffemodel", b"weights-v2-bytes"),
             source="iter_10")
    with open(run.router.current_weights, "rb") as f:
        run.seen["staged_bytes"] = f.read().decode()
    return run


def sc_canary_rejection(pkg, tmp):
    run = Run(pkg, tmp, [FakeClient(swap=[SWAP_REJECT]), FakeClient(),
                         FakeClient()],
              stage_dir=os.path.join(str(tmp), "stage"))
    run.swap(run.weights("bad.caffemodel", b"poison"), source="iter_20")
    return run


def sc_midrollout_rollback(pkg, tmp):
    prev = os.path.join(str(tmp), "v1.caffemodel")
    with open(prev, "wb") as f:
        f.write(b"previous-bytes")
    run = Run(pkg, tmp, [FakeClient(), FakeClient(swap=[SWAP_REJECT]),
                         FakeClient()],
              current_weights=prev, stage_dir=os.path.join(str(tmp),
                                                           "stage"),
              journal=os.path.join(str(tmp), "fleet"))
    run.swap(run.weights("v2.caffemodel", b"candidate-bytes"),
             source="iter_30")
    with open(run.clients[0].swap_calls[1]["weights"], "rb") as f:
        run.seen["rollback_bytes"] = f.read().decode()
    return run


def sc_canary_bad_site(pkg, tmp):
    run = Run(pkg, tmp, [FakeClient()],
              stage_dir=os.path.join(str(tmp), "stage"))
    src = run.weights("v3.caffemodel", b"A" * 64)
    run.res.FAULTS.configure("fleet_swap_canary_bad:1")
    try:
        run.swap(src)
    finally:
        run.res.FAULTS.configure("")
    with open(run.clients[0].swap_calls[0]["weights"], "rb") as f:
        run.seen["staged_bytes"] = f.read().hex()
    with open(src, "rb") as f:
        run.seen["source_bytes"] = f.read().hex()
    return run


def _snapshot(run, it, model_bytes):
    prefix = os.path.join(run.tmp, "snap")
    mpath = run.weights(f"snap_iter_{it}.caffemodel", model_bytes)
    spath = run.weights(f"snap_iter_{it}.solverstate", b"state")
    run.res.write_snapshot_manifest(spath, it,
                                    {"model": mpath, "state": spath})
    return prefix


def sc_watcher_drives_router(pkg, tmp):
    run = Run(pkg, tmp, [FakeClient(), FakeClient()],
              stage_dir=os.path.join(str(tmp), "stage"))
    prefix = _snapshot(run, 10, b"model-bytes")
    watcher = run.watch.SnapshotWatcher(run.router, "default", prefix,
                                        poll_s=0.05)
    run.seen["check"] = [watcher.check_once()]
    return run


def sc_watcher_rejection_counted(pkg, tmp):
    run = Run(pkg, tmp, [FakeClient(swap=[SWAP_REJECT]), FakeClient()],
              stage_dir=os.path.join(str(tmp), "stage"))
    prefix = _snapshot(run, 5, b"bad-model")
    watcher = run.watch.SnapshotWatcher(run.router, "default", prefix,
                                        poll_s=0.05)
    run.seen["check"] = [watcher.check_once(), watcher.check_once()]
    return run


def sc_journal_reasons(pkg, tmp):
    run = Run(pkg, tmp, [FakeClient()],
              journal=os.path.join(str(tmp), "fleet"),
              stage_dir=os.path.join(str(tmp), "stage"))
    with run.router._lock:
        run.router.replica_deaths += 1
    run.router._journal("replica_dead", replica=0, elapsed_s=1.0)
    run.seen["after_death"] = run.journal()
    run.swap(run.weights("v9.caffemodel", b"w"))
    return run


SCENARIOS = {name[3:]: fn for name, fn in globals().items()
             if name.startswith("sc_")}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return request.param


def _obs(name, pkg, tmp_path):
    return SCENARIOS[name](pkg, tmp_path).observed()


# ---------------------------------------------------------------------------
# the JAX test's expectations, held in each package

def test_least_loaded_pick(pkg, tmp_path):
    o = _obs("least_loaded_pick", pkg, tmp_path)
    assert o["pick"] == [1, 1]  # the pick claims a slot


def test_idle_fleet_still_spreads(pkg, tmp_path):
    o = _obs("idle_fleet_still_spreads", pkg, tmp_path)
    assert o["answers"] == [[200, ""]] * 4
    assert o["classify_calls"] == [2, 2]


def test_shed_retried_on_sibling_and_absorbed(pkg, tmp_path):
    o = _obs("shed_retried_on_sibling", pkg, tmp_path)
    assert o["answers"] == [[200, ""]] and o["classify_calls"] == [1, 1]
    assert o["counters"]["retries"] == 1
    assert o["counters"]["sheds_absorbed"] == 1


def test_unhealthy_retried_on_sibling(pkg, tmp_path):
    o = _obs("unhealthy_retried_on_sibling", pkg, tmp_path)
    assert o["answers"] == [[200, ""]] and o["counters"]["retries"] == 1


def test_retry_budget_exhausted_goes_typed(pkg, tmp_path):
    o = _obs("retry_budget_exhausted", pkg, tmp_path)
    assert o["answers"] == [[429, "shed"]]
    assert sum(o["classify_calls"]) == 2 and o["counters"]["retries"] == 1


@pytest.mark.parametrize("name,want", [
    ("deadline_never_retried", [504, "deadline"]),
    ("bad_request_never_retried", [400, "bad_request"])])
def test_terminal_kinds_never_retried(pkg, tmp_path, name, want):
    assert want[1] not in PKGS[pkg][0].RETRYABLE_KINDS
    o = _obs(name, pkg, tmp_path)
    assert o["answers"] == [want]
    assert o["classify_calls"][0] == 0  # the sibling never saw it
    assert o["counters"]["retries"] == 0


def test_conn_error_typed_retried_and_drained(pkg, tmp_path):
    o = _obs("conn_error_retried_and_drained", pkg, tmp_path)
    assert o["answers"] == [[200, ""]] and o["counters"]["conn_errors"] == 1
    assert o["health"]["in_rotation"] == 1 and o["rotation"] == [True,
                                                                 False]


def test_conn_error_with_no_budget_is_replica_lost(pkg, tmp_path):
    o = _obs("conn_error_without_budget", pkg, tmp_path)
    assert o["answers"] == [[503, "replica_lost"]]


def test_empty_rotation_is_typed_unhealthy(pkg, tmp_path):
    o = _obs("empty_rotation", pkg, tmp_path)
    assert o["answers"] == [[503, "unhealthy"]]


def test_stats_aggregation(pkg, tmp_path):
    o = _obs("stats_aggregation", pkg, tmp_path)
    assert o["stats"]["fleet"]["replicas"] == 2
    assert o["stats"]["fleet"]["routed"] == 2
    assert o["stats"]["replicas"]["0"]["requests"] == 7
    assert o["stats"]["replicas"]["1"]["requests"] == 3


def test_healthz_aggregation(pkg, tmp_path):
    o = _obs("healthz_aggregation", pkg, tmp_path)
    assert [d["healthy"] for d in o["healthz"]] == [True, True, False, True]
    assert o["healthz"][2]["in_rotation"] == 0


def test_readyz_aggregation(pkg, tmp_path):
    o = _obs("readyz_aggregation", pkg, tmp_path)
    (ok0, d0), (ok1, _), (ok2, d2) = o["readyz"]
    assert not ok0 and d0["replicas"]["1"]["ready"] is False
    assert ok1
    assert not ok2 and d2["replicas"]["0"]["in_rotation"] is False


def test_rolling_swap_propagates(pkg, tmp_path):
    o = _obs("rolling_swap_propagates", pkg, tmp_path)
    assert o["counters"]["swaps"] == 1 and o["swaps"] == ["ok"]
    calls = o["swap_calls"]
    assert [len(c) for c in calls] == [1, 1, 1]
    # the canary flag on exactly one replica, the canary
    assert [c[0]["canary"] for c in calls] == [True, False, False]
    assert {c[0]["source"] for c in calls} == {"iter_10"}
    # every replica read one staged copy, bitwise the source
    assert len({c[0]["weights"] for c in calls}) == 1
    assert o["staged_bytes"] == "weights-v2-bytes"
    assert o["current_weights"] == calls[0][0]["weights"]


def test_canary_rejection_touches_no_sibling(pkg, tmp_path):
    o = _obs("canary_rejection", pkg, tmp_path)
    assert o["swaps"][0][0] == "SwapError"
    assert o["counters"]["swaps"] == 0
    assert o["counters"]["swap_rejections"] == 1
    assert [len(c) for c in o["swap_calls"]] == [1, 0, 0]


def test_midrollout_rejection_rolls_back_bitwise(pkg, tmp_path):
    o = _obs("midrollout_rollback", pkg, tmp_path)
    ok1, rejector, ok2 = o["swap_calls"]
    assert len(ok1) == 2 and len(rejector) == 1 and not ok2
    assert ok1[1]["weights"] == "<tmp>/v1.caffemodel"
    assert ok1[1]["canary"] is False
    assert o["rollback_bytes"] == "previous-bytes"
    assert o["counters"]["rollbacks"] == 1 and o["counters"]["swaps"] == 0
    assert o["current_weights"] == "<tmp>/v1.caffemodel"
    assert o["journal"]["reason"] == "fleet_swap_rejected"
    assert o["journal"]["rollbacks"] == 1


def test_fleet_swap_canary_bad_site_rots_the_staged_copy(pkg, tmp_path):
    o = _obs("canary_bad_site", pkg, tmp_path)
    assert o["staged_bytes"] != o["source_bytes"]
    assert o["source_bytes"] == (b"A" * 64).hex()
    assert "fleet_swap_canary_bad" in PKGS[pkg][3].FAULT_SITES
    assert "replica_dead" in PKGS[pkg][3].FAULT_SITES


def test_snapshot_watcher_drives_the_router_unmodified(pkg, tmp_path):
    o = _obs("watcher_drives_router", pkg, tmp_path)
    assert o["check"] == [True] and o["counters"]["swaps"] == 1
    assert [len(c) for c in o["swap_calls"]] == [1, 1]
    assert o["swap_calls"][0][0]["source"] == "iter_10"


def test_watcher_rejection_via_router_is_counted(pkg, tmp_path):
    o = _obs("watcher_rejection_counted", pkg, tmp_path)
    assert o["check"] == [False, False]  # rejected iterations stay so
    assert o["counters"]["swap_rejections"] == 1
    assert o["counters"]["swaps"] == 0
    assert [len(c) for c in o["swap_calls"]] == [1, 0]


def test_replica_journal_reasons(pkg, tmp_path):
    o = _obs("journal_reasons", pkg, tmp_path)
    assert o["after_death"]["reason"] == "replica_dead"
    assert o["after_death"]["replica_deaths"] == 1
    assert o["journal"]["reason"] == "fleet_swap"
    assert o["journal"]["fleet_swaps"] == 1
    assert o["journal"]["replica_deaths"] == 1  # cumulative counters


# ---------------------------------------------------------------------------
# the two packages observe the same

@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_port_router_observes_what_the_jax_router_does(tmp_path, name):
    jax = _obs(name, "jax", tmp_path / "jax")
    port = _obs(name, "port", tmp_path / "port")
    assert port == jax


@pytest.fixture(autouse=True)
def _scenario_dirs(tmp_path):
    for d in ("jax", "port"):
        (tmp_path / d).mkdir(exist_ok=True)


# ---------------------------------------------------------------------------
# the heartbeat's revive (the supervisor's re-arm after a respawn)

def _revive_run(res, hb_dir):
    """tests/test_serving_fleet.py's revive scenario; returns what the
    monitor saw at each step."""
    replica = res.DirBeatTransport(hb_dir)
    hb = res.HostHeartbeat(res.DirBeatTransport(hb_dir), host_id=1,
                           n_hosts=2, deadline=0.15, grace=0.15,
                           interval=0.05, hard_exit=False)
    seen = []
    replica.publish(0, 0)
    hb.tick()
    seen.append(("first", hb.lost, hb.beats_seen(0) >= 1))
    time.sleep(0.4)  # silent past the deadline: mourned
    hb.tick()
    seen.append(("silent", hb.lost[0] if hb.lost else None,
                 hb.lost_event.is_set()))
    hb.revive(0)
    seen.append(("revived", hb.lost, hb.lost_event.is_set()))
    # a respawned incarnation (a new transport, a new token) restarts at
    # seq 0, which reads as an advance
    respawned = res.DirBeatTransport(hb_dir)
    respawned.publish(0, 0)
    hb.tick()
    before = hb.beats_seen(0)
    respawned.publish(0, 1)
    hb.tick()
    seen.append(("respawned", hb.lost, hb.beats_seen(0) > before))
    # a peer that said farewell and is then revived is monitored again
    respawned.farewell(0)
    hb.tick()
    done = 0 in hb._done
    hb.revive(0)
    seen.append(("farewell", done, 0 in hb._done))
    return seen


def test_heartbeat_revive_rearms_monitoring_as_jax_does(tmp_path):
    port = _revive_run(port_res, str(tmp_path / "port"))
    jax = _revive_run(jax_res, str(tmp_path / "jax"))
    assert port == jax
    assert port == [("first", None, True), ("silent", 0, True),
                    ("revived", None, False), ("respawned", None, True),
                    ("farewell", True, False)]


def test_revive_gives_a_fresh_first_contact_grace(tmp_path):
    for res in (port_res, jax_res):
        hb = res.HostHeartbeat(res.DirBeatTransport(str(tmp_path / "hb")),
                               host_id=1, n_hosts=2, deadline=0.1,
                               grace=5.0, interval=0.05, hard_exit=False)
        hb._first[0] = False
        hb.revive(0)
        assert hb._first[0] is True
        hb.tick()  # no beat yet, but within the grace: not mourned
        assert hb.lost is None


def test_fleet_fault_sites_carry_the_jax_text():
    for site in ("replica_dead", "fleet_swap_canary_bad"):
        assert port_res.FAULT_SITES[site] == jax_res.FAULT_SITES[site]


# ---------------------------------------------------------------------------
# the module's imports

@pytest.mark.parametrize("module", [
    "caffe_mpi_tpu_torch.serving.fleet",
    "caffe_mpi_tpu_torch.tools.lint.concurrency",
    "caffe_mpi_tpu_torch.serving.locks"])
def test_imports_with_torch_and_jax_blocked(module):
    code = ("import sys\n"
            "sys.modules['torch'] = sys.modules['jax'] = None\n"
            f"import {module}\n"
            "from caffe_mpi_tpu_torch.serving import FleetRouter, "
            "FleetSupervisor, SnapshotWatcher\n"
            "assert 'torch' not in [m for m, v in sys.modules.items() "
            "if v is not None]\n"
            "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=_ROOT,
                          capture_output=True, text=True, timeout=120,
                          env=dict(os.environ, PYTHONPATH=_ROOT))
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", \
        proc.stderr


def test_the_replica_command_is_the_ports_cli(tmp_path):
    from caffe_mpi_tpu_torch.proto.config import ServingParameter
    sp = ServingParameter(serve_window_ms=2.0, serve_buckets="1,4")
    sup = port_fleet.FleetSupervisor("deploy.prototxt", "w.caffemodel", 2,
                                     str(tmp_path / "fleet"),
                                     serving_param=sp, device="cpu",
                                     replica_deadline=1.5)
    cmd = sup._replica_cmd(1, 4321, "w.caffemodel")
    assert cmd[1:4] == ["-m", "caffe_mpi_tpu_torch.tools.cli", "serve"]
    flags = dict(zip(cmd[4::2], cmd[5::2]))
    assert flags["-device"] == "cpu" and flags["-replica_id"] == "1"
    assert flags["-port"] == "4321" and flags["-weights"] == "w.caffemodel"
    assert flags["-replica_deadline"] == "1.5"
    assert flags["-serve_window_ms"] == "2.0"
    assert flags["-serve_buckets"] == "1,4"
    assert "-serve_program_bank" not in cmd
    # the same flags as the JAX supervisor's, bar the bank and the device
    jax_sup = jax_fleet.FleetSupervisor(
        "deploy.prototxt", "w.caffemodel", 2, str(tmp_path / "fleet"),
        serving_param=sp, replica_deadline=1.5)
    jcmd = jax_sup._replica_cmd(1, 4321, "w.caffemodel")
    jflags = dict(zip(jcmd[4::2], jcmd[5::2]))
    jflags.pop("-serve_program_bank")
    assert {k: v for k, v in flags.items() if k != "-device"} == jflags


def test_a_fleet_needs_a_replica_and_a_directory(tmp_path):
    with pytest.raises(ValueError, match="at least 1 replica"):
        port_fleet.FleetSupervisor("m", "", 0, str(tmp_path))
    with pytest.raises(ValueError, match="fleet_dir"):
        port_fleet.FleetSupervisor("m", "", 2, "")
