"""Port parity: multi-host elasticity (caffe_mpi_tpu_torch/utils/
resilience.py's multi-host half, parallel/mesh.py's heartbeat transport
and generation records, the solver's heartbeat and grow-back hooks, the
CLI's elastic supervisor), after the JAX package's tests/test_multihost.py
(TestHeartbeat, TestQuarantineMerge) and tests/test_degraded.py.

- the heartbeat: a silent peer trips within the deadline, a farewell is
  not mourned, first contact has its grace, a restarted publisher
  advances; over the shared directory and over the group's store; the
  watchdog's thread ticks it as its pulse;
- the files both packages write read the same either way: beat files
  and farewells, generation records (and the done marker), per-host
  quarantine journals and their merge;
- membership rounds over supervisor beats, rejoin-wait, the generation
  environment, the solver's snapshot-boundary grow-back trigger, a
  failed collective handed to the heartbeat, and only a collective: a
  guard trip over two hosts under the heartbeat still exits 88;
- restore across world sizes on the port's own snapshots: 2 gloo ranks
  (ZeRO-1) -> 1 process -> 2 ranks, against the uninterrupted 2 ranks;
- one bounded end-to-end run over gloo: two supervised "hosts" on the
  CPU, host 1 lost for good (worker and supervisor) -> the survivor's
  `host_lost` exit 87 -> generation 2 at world 1 -> the revived host
  parked in rejoin-wait -> re-admitted at a snapshot boundary ->
  generation 3 at world 2 -> final weights and history against an
  uninterrupted run.

Tolerances: the files bytes- or value-equal; weights and history rtol
1e-5 / atol 1e-6 (the solver bar: the degraded generation sums one
process's batch where the ranks sum two halves). The end-to-end net is a
TanH MLP: a ReLU kink can turn a one-ulp difference into a different
gradient, which no tolerance of a reordered sum should have to absorb.
No process group is left live in the test process: every group runs in
a subprocess.
"""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from caffe_mpi_tpu.utils import resilience as jax_res
from caffe_mpi_tpu_torch import io as port_io
from caffe_mpi_tpu_torch.parallel import mesh as mesh_mod
from caffe_mpi_tpu_torch.proto import NetParameter, SolverParameter
from caffe_mpi_tpu_torch.solver import Solver
from caffe_mpi_tpu_torch.utils import resilience
from torch_dp_worker import Ranks

_HERE = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_HERE)
STEP = dict(rtol=1e-5, atol=1e-6)
PACKAGES = {"jax": jax_res, "port": resilience}


# -- the heartbeat ------------------------------------------------------------

def _pair(path, deadline=0.3, transport=None):
    t = transport or resilience.DirBeatTransport(str(path))
    mk = lambda host: resilience.HostHeartbeat(  # noqa: E731
        t, host, 2, deadline, interval=0.05, grace=0.5, hard_exit=False)
    return mk(0), mk(1)


def test_silent_peer_trips_within_the_deadline(tmp_path):
    lost = []
    a, b = _pair(tmp_path)
    a.on_lost = lambda p, e: lost.append((p, e))
    for _ in range(6):
        a.tick()
        b.tick()
        time.sleep(0.05)
    assert a.beats_seen(1) > 0 and a.lost is None
    t0 = time.monotonic()
    while a.lost is None and time.monotonic() - t0 < 3:
        a.tick()  # b stopped beating
        time.sleep(0.03)
    assert a.lost is not None and a.lost[0] == 1
    assert lost and lost[0][0] == 1 and a.lost_event.is_set()
    assert time.monotonic() - t0 < 1.5


def test_farewell_is_not_mourned_and_first_contact_has_grace(tmp_path):
    a, b = _pair(tmp_path / "f", deadline=0.2)
    a.tick()
    b.tick()
    time.sleep(0.06)
    a.tick()
    b.farewell()
    t0 = time.monotonic()
    while time.monotonic() - t0 < 1.0:
        a.tick()
        time.sleep(0.03)
    assert a.lost is None
    # a peer that never beat gets deadline + grace, not the deadline
    c, _ = _pair(tmp_path / "g", deadline=0.1)
    t0 = time.monotonic()
    while time.monotonic() - t0 < 0.4:
        c.tick()
        time.sleep(0.03)
    assert c.lost is None


def test_a_restarted_publisher_advances_and_an_old_bye_does_not_count(
        tmp_path):
    reader = resilience.DirBeatTransport(str(tmp_path))
    old = resilience.DirBeatTransport(str(tmp_path))
    for s in range(40):
        old.publish(1, s)
    assert reader.latest_seq(1) == 39
    old.farewell(1)
    new = resilience.DirBeatTransport(str(tmp_path))
    new.publish(1, 0)
    assert reader.latest_seq(1) > 39
    assert not reader.is_bye(1)
    new.farewell(1)
    assert reader.is_bye(1)


@pytest.mark.parametrize("writer,reader", [("jax", "port"),
                                           ("port", "jax")])
def test_beat_files_read_across_the_packages(tmp_path, writer, reader):
    w = PACKAGES[writer].DirBeatTransport(str(tmp_path))
    r = PACKAGES[reader].DirBeatTransport(str(tmp_path))
    assert r.latest_seq(3) == -1
    for s in range(5):
        w.publish(3, s)
    assert r.latest_seq(3) == 4 and not r.is_bye(3)
    w.farewell(3)
    assert r.is_bye(3)
    with open(tmp_path / "hb_3") as f:
        token, _, seq = f.read().rpartition(":")
    assert token and seq == "4"


def test_the_store_transport_carries_the_heartbeat(monkeypatch):
    """KVBeatTransport over a TCPStore (the group's store), with no group
    formed: beats, the newest of them, farewells; a heartbeat pair over
    it trips on silence."""
    from datetime import timedelta
    # port 0: the store binds a port of the system's choosing, so no
    # other process can take it between a probe and the bind
    store = torch.distributed.TCPStore(
        "127.0.0.1", 0, 1, True,
        timeout=timedelta(seconds=10), wait_for_workers=False)
    assert store.port > 0
    t = mesh_mod.KVBeatTransport(store)
    assert t.latest_seq(5) == -1 and not t.is_bye(5)
    for s in range(3):
        t.publish(5, s)
    assert t.latest_seq(5) == 2
    t.farewell(5)
    assert t.is_bye(5)
    a, b = _pair(None, deadline=0.2, transport=t)
    for _ in range(4):
        a.tick()
        b.tick()
        time.sleep(0.05)
    t0 = time.monotonic()
    while a.lost is None and time.monotonic() - t0 < 3:
        a.tick()
        time.sleep(0.03)
    assert a.lost is not None and a.lost[0] == 1
    # no group: no store. Another test of this worker process may have
    # formed a group of one and left its store in the module
    monkeypatch.setattr(mesh_mod, "_STORE", None)
    with pytest.raises(resilience.ClusterError):
        mesh_mod.KVBeatTransport()
    del store


def test_the_watchdog_thread_ticks_the_pulse_and_survives_its_failure():
    calls = []

    def pulse():
        calls.append(time.monotonic())
        if len(calls) == 2:
            raise RuntimeError("a failing pulse")
    wd = resilience.DispatchWatchdog(float("inf"), poll=0.02, pulse=pulse)
    try:
        time.sleep(0.3)
    finally:
        wd.stop()
    assert len(calls) > 4  # ticked on past the failure
    with wd.section("never trips"):
        pass


def test_a_failed_collective_waits_for_the_heartbeat():
    """gloo raises at once when a peer process dies: the solver lets the
    heartbeat name the peer (it exits 87 from its thread); without a trip
    in time it raises ClusterError, reason cluster_collective_failed."""
    sp = SolverParameter.from_text(
        'base_lr: 0.1 max_iter: 5 lr_policy: "fixed"')
    sp.net_param = NetParameter.from_text(REJOIN_NET)
    s = Solver(sp, device="cpu")
    s.await_host_loss(RuntimeError("no heartbeat: nothing to wait for"))
    hb = resilience.HostHeartbeat(_NullTransport(), 0, 2, 0.05,
                                  hard_exit=False)
    s._heartbeat = hb
    t0 = time.monotonic()
    with pytest.raises(resilience.ClusterError) as err:
        s.await_host_loss(RuntimeError("Connection closed by peer"))
    assert err.value.reason == "cluster_collective_failed"
    assert time.monotonic() - t0 < 5
    # a trip during the wait ends it at once
    hb.lost_event.set()
    t0 = time.monotonic()
    with pytest.raises(resilience.ClusterError):
        s.await_host_loss(RuntimeError("x"))
    assert time.monotonic() - t0 < 0.5
    s.close()


def test_a_collective_failure_is_named_where_it_is_raised():
    """The mesh's collectives raise CollectiveError, the one error the CLI
    hands to the heartbeat; other errors pass through as they are."""
    def closed(*a, **kw):
        raise RuntimeError("Connection closed by peer")

    with pytest.raises(resilience.CollectiveError) as err:
        mesh_mod._collective(closed, torch.zeros(2))
    assert "Connection closed by peer" in str(err.value)
    assert not isinstance(err.value, resilience.ClusterError)

    def misuse(*a, **kw):
        raise ValueError("wrong shape")

    with pytest.raises(ValueError):
        mesh_mod._collective(misuse)


GUARD_SOLVER = """net_param { name: "g"
layer { name: "in" type: "Input" top: "x" top: "t"
        input_param { shape { dim: 8 dim: 6 } shape { dim: 8 } } }
layer { name: "ip" type: "InnerProduct" bottom: "x" top: "y"
        inner_product_param { num_output: 10
          weight_filler { type: "xavier" } } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "y" bottom: "t"
        top: "l" } }
base_lr: 0.05 momentum: 0.9 lr_policy: "fixed" max_iter: 12
random_seed: 3 display: 0
"""


def test_a_guard_trip_under_the_heartbeat_exits_88_not_87(tmp_path):
    """Only a failed collective waits for the heartbeat: a guard trip
    over two hosts with host_deadline set exits 88 at once, journaled
    numeric_anomaly, so a supervisor routes it through anomaly_action."""
    solver = tmp_path / "solver.prototxt"
    solver.write_text(GUARD_SOLVER)
    prefix = str(tmp_path / "s")
    port = mesh_mod.free_port()
    env = {k: v for k, v in os.environ.items() if not k.startswith("CAFFE_")}
    env.update(PYTHONPATH=_ROOT, CAFFE_TPU_INIT_TIMEOUT="30",
               OMP_NUM_THREADS="1", CAFFE_TPU_FAULTS="nan_grad:2:0:5")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "caffe_mpi_tpu_torch.tools.cli", "train",
         "-solver", str(solver), "-synthetic", "-device", "cpu",
         "-snapshot_prefix", prefix, "-hosts", "2", "-host_id", str(h),
         "-coordinator", f"127.0.0.1:{port}", "-host_deadline", "5",
         "-train_guard", "-guard_max_skips", "2"], env=env, cwd=_ROOT,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
        start_new_session=True) for h in range(2)]
    exited = _exit_times(procs, 60)
    rcs = [p.returncode for p in procs]
    errs = [p.stderr.read()[-3000:] for p in procs]
    assert rcs == [resilience.EXIT_NUMERIC] * 2, errs
    runs = [resilience.read_run_manifest(prefix),
            resilience.read_run_manifest(f"{prefix}.r1")]
    for run in runs:
        assert run["reason"] == "numeric_anomaly" and run["exit_code"] == 88
    # no wait of two host deadlines for a peer that never went silent:
    # each process exits within 10 s of its own journaled trip (timed
    # from the trip, not the spawn, so the imports of a loaded machine
    # do not count)
    for run, at in zip(runs, exited):
        assert at - run["time"] < 10, (at - run["time"], errs)


class _NullTransport:
    def publish(self, host, seq):
        pass

    def latest_seq(self, host):
        return -1

    def farewell(self, host):
        pass

    def is_bye(self, host):
        return False


# -- generation records, membership, rejoin ----------------------------------

@pytest.mark.parametrize("writer,reader", [("jax", "port"),
                                           ("port", "jax")])
def test_generation_records_read_across_the_packages(tmp_path, writer,
                                                     reader):
    w, r = PACKAGES[writer], PACKAGES[reader]
    cdir = w.cluster_dir(str(tmp_path / "s"))
    assert cdir == r.cluster_dir(str(tmp_path / "s"))
    assert r.read_generation(cdir) is None
    assert w.initial_generation(3, "h:9") == r.initial_generation(3, "h:9")
    os.makedirs(cdir, exist_ok=True)
    with open(os.path.join(cdir, "done"), "w") as f:
        f.write("1\n")
    gen = {"generation": 2, "hosts": [0, 2], "world": 2, "world_full": 3,
           "coordinator": "127.0.0.1:5", "reason": "cluster_degraded",
           "prev_hosts": [0, 1, 2]}
    path = w.write_generation(cdir, gen)
    assert path == r.generation_path(cdir)
    got = r.read_generation(cdir)
    assert {k: got[k] for k in gen} == gen
    with open(os.path.join(cdir, "gen_2.json")) as f:
        assert json.load(f)["reason"] == "cluster_degraded"
    assert not os.path.exists(os.path.join(cdir, "done"))
    with open(r.generation_path(cdir), "w") as f:
        f.write('{"generation": 3, "hos')  # torn
    assert w.read_generation(cdir) is None and r.read_generation(cdir) \
        is None


def test_membership_round_and_paused_beats(tmp_path):
    cdir = str(tmp_path / "c")
    beat = resilience.SupervisorBeat(cdir, 1, 0.05)
    tr = resilience.DirBeatTransport(os.path.join(cdir, "hb"))
    tr.publish(2, 41)  # a dead incarnation's frozen beat
    beat.start()
    try:
        assert resilience.observe_live_hosts(cdir, 3, 0, 0.6) == [0, 1]
        beat.pause()
        time.sleep(0.15)
        assert resilience.observe_live_hosts(cdir, 3, 0, 0.5) == [0]
        beat.resume()
        # the JAX reader sees the port's supervisor beats alike
        assert jax_res.observe_live_hosts(cdir, 3, 0, 0.5) == [0, 1]
    finally:
        beat.stop()


def test_rejoin_wait_readmission_and_done(tmp_path):
    cdir = str(tmp_path / "c")
    os.makedirs(cdir)
    resilience.write_generation(cdir, {
        "generation": 3, "hosts": [0, 1], "world": 2, "world_full": 2,
        "coordinator": "x:1", "reason": "cluster_regrown"})
    assert resilience._rejoin_wait(cdir, 1, 2, 5.0)["generation"] == 3
    assert resilience._rejoin_wait(cdir, 5, 3, 0.6) is None
    with open(os.path.join(cdir, "done"), "w") as f:
        f.write("1\n")
    assert resilience._rejoin_wait(cdir, 5, 3, 5.0) == "done"


def test_cluster_generation_environment(monkeypatch):
    from caffe_mpi_tpu.parallel import mesh as jax_mesh
    for var in ("CAFFE_TPU_CLUSTER_GEN", "CAFFE_TPU_CLUSTER_HOSTS",
                "CAFFE_TPU_WORLD_FULL", "CAFFE_TPU_CLUSTER_SELF"):
        monkeypatch.delenv(var, raising=False)
    assert mesh_mod.cluster_generation() is None
    assert mesh_mod.publish_generation() is False
    monkeypatch.setenv("CAFFE_TPU_CLUSTER_GEN", "2")
    monkeypatch.setenv("CAFFE_TPU_CLUSTER_HOSTS", "0,2")
    monkeypatch.setenv("CAFFE_TPU_WORLD_FULL", "3")
    monkeypatch.setenv("CAFFE_TPU_CLUSTER_SELF", "2")
    assert mesh_mod.cluster_generation() == jax_mesh.cluster_generation() \
        == {"generation": 2, "hosts": [0, 2], "world_full": 3, "self": 2}
    monkeypatch.setenv("CAFFE_TPU_CLUSTER_HOSTS", "0,x")
    assert mesh_mod.cluster_generation() is None


REJOIN_NET = """
name: "lsq"
layer { name: "in" type: "Input" top: "x" top: "t"
        input_param { shape { dim: 4 dim: 3 } shape { dim: 4 dim: 1 } } }
layer { name: "ip" type: "InnerProduct" bottom: "x" top: "pred"
        inner_product_param { num_output: 1
          weight_filler { type: "gaussian" std: 1 } } }
layer { name: "loss" type: "EuclideanLoss" bottom: "pred"
        bottom: "t" top: "l" }
"""


def _rejoin_solver(min_hosts=1):
    sp = SolverParameter.from_text(
        'base_lr: 0.1 max_iter: 50 lr_policy: "fixed" display: 0 '
        f'random_seed: 3 min_hosts: {min_hosts}')
    sp.net_param = NetParameter.from_text(REJOIN_NET)
    return Solver(sp, device="cpu")


@pytest.mark.parametrize("case", ["unset", "full"])
def test_the_grow_back_check_is_inert_without_missing_hosts(
        tmp_path, monkeypatch, case):
    monkeypatch.setenv("CAFFE_TPU_CLUSTER_DIR", str(tmp_path / "c"))
    monkeypatch.setenv("CAFFE_TPU_CLUSTER_GEN", "1")
    monkeypatch.setenv("CAFFE_TPU_CLUSTER_HOSTS",
                       "0" if case == "unset" else "0,1")
    monkeypatch.setenv("CAFFE_TPU_WORLD_FULL", "2")
    s = _rejoin_solver(min_hosts=0 if case == "unset" else 1)
    s._maybe_admit_rejoin()
    assert s._rejoin is (None if case == "unset" else False)
    s.close()


def test_a_revival_raises_cluster_rejoin_at_the_boundary(tmp_path,
                                                          monkeypatch):
    """The first boundary primes the missing host's frozen beat; a later
    one that sees an advance (the JAX supervisor's new incarnation here)
    journals cluster_rejoin and raises."""
    cdir = str(tmp_path / "c")
    monkeypatch.setenv("CAFFE_TPU_CLUSTER_DIR", cdir)
    monkeypatch.setenv("CAFFE_TPU_CLUSTER_GEN", "2")
    monkeypatch.setenv("CAFFE_TPU_CLUSTER_HOSTS", "0")
    monkeypatch.setenv("CAFFE_TPU_WORLD_FULL", "2")
    resilience.DirBeatTransport(os.path.join(cdir, "hb")).publish(1, 17)
    s = _rejoin_solver()
    s.sp.snapshot_prefix = str(tmp_path / "s")
    s._maybe_admit_rejoin()
    assert isinstance(s._rejoin, tuple)
    s._maybe_admit_rejoin()  # frozen: no advance
    jax_res.DirBeatTransport(os.path.join(cdir, "hb")).publish(1, 0)
    with pytest.raises(resilience.ClusterError) as err:
        s._maybe_admit_rejoin()
    assert err.value.reason == "cluster_rejoin"
    assert "snapshot boundary" in str(err.value)
    run = resilience.read_run_manifest(str(tmp_path / "s"))
    assert run["reason"] == "cluster_rejoin"
    assert run["rejoining_hosts"] == [1] and run["boundary_iter"] == 0
    s.close()


# -- quarantine journals ------------------------------------------------------

@pytest.mark.parametrize("args", [(), (0, 1), (1, 2), (3, 4), (1, 2, 7),
                                  (0, 1, 7)])
def test_quarantine_journal_paths_equal_jax(tmp_path, args):
    prefix = str(tmp_path / "s")
    kw = dict(zip(("rank", "world", "host"), args))
    assert resilience.quarantine_journal_path(prefix, **kw) == \
        jax_res.quarantine_journal_path(prefix, **kw)


@pytest.mark.parametrize("writer,merger", [("port", "jax"),
                                           ("jax", "port")])
def test_quarantine_journals_merge_across_the_packages(tmp_path, writer,
                                                       merger):
    prefix = str(tmp_path / "s")
    ent = lambda i: {"source": "db", "index": i, "key": "",  # noqa: E731
                     "substitute": i + 1, "reason": "crc", "time": 0}
    w = PACKAGES[writer]
    for path, idxs in ((w.quarantine_journal_path(prefix, 0, 2), [3, 7]),
                       (w.quarantine_journal_path(prefix, 1, 2), [7, 12]),
                       (w.quarantine_journal_path(prefix, 1, 2, 5), [1])):
        with open(path, "w") as f:
            json.dump({"schema": 1, "records": [ent(i) for i in idxs]}, f)
    assert PACKAGES[merger].merge_quarantine_journals(prefix) == 4
    with open(prefix + ".quarantine.json") as f:
        merged = json.load(f)
    assert [e["index"] for e in merged["records"]] == [1, 3, 7, 12]
    assert len(merged["merged_from"]) == 3
    # the other package's merge writes the same file
    PACKAGES[writer].merge_quarantine_journals(prefix)
    with open(prefix + ".quarantine.json") as f:
        assert json.load(f) == merged
    assert resilience.merge_quarantine_journals(str(tmp_path / "n")) == 0


# -- restore across world sizes -----------------------------------------------

MLP = """
name: "mh"
layer { name: "in" type: "Input" top: "x" top: "t"
        input_param { shape { dim: 8 dim: 6 } shape { dim: 8 } } }
layer { name: "ip1" type: "InnerProduct" bottom: "x" top: "h"
        inner_product_param { num_output: 8
          weight_filler { type: "xavier" } } }
layer { name: "r" type: "TanH" bottom: "h" top: "h" }
layer { name: "ip2" type: "InnerProduct" bottom: "h" top: "y"
        inner_product_param { num_output: 4
          weight_filler { type: "xavier" } } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "y" bottom: "t"
        top: "l" }
"""


def _mlp_solver(extra=""):
    return ('net_param { ' + MLP[MLP.index("layer"):] + ' }\n'
            'base_lr: 0.1 momentum: 0.9 lr_policy: "fixed" max_iter: 100 '
            'random_seed: 5 display: 0 ' + extra)


def _mlp_feeds(n=4):
    r = np.random.RandomState(8)
    return [{"x": r.randn(8, 6).astype(np.float32),
             "t": r.randint(0, 4, 8).astype(np.int32)} for _ in range(n)]


def test_restore_across_world_sizes(tmp_path):
    """The degraded resume on the port's whole snapshots: 2 ranks (each
    ZeRO-1 rank keeping its slot shards) snapshot at 3; one process
    restores it and trains to 5; 2 ranks restore that and train to 7,
    against 2 ranks trained to 7 without a stop."""
    feeds = _mlp_feeds()
    prefix = str(tmp_path / "s")
    zero = _mlp_solver("zero_stage: 1")
    ref = Ranks([{"name": "ref", "kind": "resume", "solver": zero,
                  "prefix": str(tmp_path / "ref"), "iters": 7,
                  "feeds": feeds}], 2, str(tmp_path / "r0"))
    first = Ranks([{"name": "a", "kind": "resume", "solver": zero,
                    "prefix": prefix, "iters": 3, "feeds": feeds}], 2,
                  str(tmp_path / "r1")).results()
    assert first[0]["a"]["iter"] == 3
    assert first[1]["a"]["shards"]["ip1.weight"] == (4, 6)  # ZeRO-1
    one = Solver(SolverParameter.from_text(_mlp_solver()), device="cpu")
    one.sp.snapshot_prefix = prefix
    assert one.restore_auto() == prefix + "_iter_3.solverstate"
    for l, p, _, t in one._decls:  # the whole params, bitwise
        np.testing.assert_array_equal(t.detach().numpy(),
                                      first[0]["a"]["state"][f"{l}.{p}"])
    one.step(2, lambda k: {key: torch.from_numpy(v)
                           for key, v in feeds[k % len(feeds)].items()})
    one.snapshot()
    one.close()
    back = Ranks([{"name": "b", "kind": "resume", "solver": zero,
                   "prefix": prefix, "iters": 2, "feeds": feeds,
                   "restore": True}], 2, str(tmp_path / "r2")).results()
    want = ref.results()[0]["ref"]["state"]
    assert back[0]["b"]["restored"] == prefix + "_iter_5.solverstate"
    assert back[0]["b"]["iter"] == 7
    got = back[0]["b"]["state"]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **STEP)
        np.testing.assert_array_equal(got[k], back[1]["b"]["state"][k])


# -- the end-to-end run -------------------------------------------------------

E2E_NET = """
name: "mh"
layer { name: "in" type: "Input" top: "x" top: "t"
        input_param { shape { dim: 32 dim: 16 } shape { dim: 32 } } }
layer { name: "ip1" type: "InnerProduct" bottom: "x" top: "h"
        inner_product_param { num_output: 64
          weight_filler { type: "xavier" } } }
layer { name: "r" type: "TanH" bottom: "h" top: "h" }
layer { name: "ip2" type: "InnerProduct" bottom: "h" top: "y"
        inner_product_param { num_output: 10
          weight_filler { type: "xavier" } } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "y" bottom: "t"
        top: "l" }
"""
E2E_ITERS = 800
E2E_EVERY = 40       # snapshot interval: the boundaries a host rejoins at
E2E_DEADLINE = 3.0   # -host_deadline
E2E_KILL_BEAT = 8    # host 1's worker dies at this beat (~6 s after arming)
E2E_DARK_S = 12.0    # then its supervisor goes dark: past the survivor's
#                      detection (~3 s) and membership round (~6 s)
E2E_STALL_S = 0.02   # each iteration's sleep: the degraded generation is
#                      still training when host 1 revives


def _pair_run(root, tag, solver, faults: bool, timeout=200.0):
    """Two supervised CLI "hosts" on the CPU over gloo, each in its own
    session; returns (exit codes, logs, snapshot prefix)."""
    prefix = os.path.join(root, tag, "s")
    os.makedirs(os.path.dirname(prefix), exist_ok=True)
    port = mesh_mod.free_port()
    procs, logs = [], []
    for host in range(2):
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("CAFFE_")}
        env.update(PYTHONPATH=_ROOT, CAFFE_TPU_INIT_TIMEOUT="30",
                   OMP_NUM_THREADS="1")
        if faults:
            spec = f"dispatch_stall:0:0:{E2E_STALL_S}"
            if host == 1:
                spec += (f",host_loss:1:0:{E2E_KILL_BEAT}"
                         f",host_perma_loss:1:0:{E2E_DARK_S}")
                env["CAFFE_TPU_FAULTS_DIR"] = os.path.join(root, tag + "_f")
                os.makedirs(env["CAFFE_TPU_FAULTS_DIR"], exist_ok=True)
            env["CAFFE_TPU_FAULTS"] = spec
        log = os.path.join(root, f"{tag}_h{host}.log")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "caffe_mpi_tpu_torch.tools.cli", "train",
             "-solver", solver, "-synthetic", "-device", "cpu",
             "-snapshot_prefix", prefix, "-hosts", "2", "-host_id",
             str(host), "-coordinator", f"127.0.0.1:{port}",
             "-host_deadline", str(E2E_DEADLINE), "-max_restarts", "3",
             "-min_hosts", "1"], env=env, cwd=_ROOT,
            stdout=open(log, "w"), stderr=subprocess.STDOUT,
            start_new_session=True))
    return procs, logs, prefix


def _exit_times(procs, timeout):
    """Wait for every process (killed past `timeout`); the wall time at
    which each was seen to exit, polled every 20 ms."""
    t_end = time.monotonic() + timeout
    exited = [None] * len(procs)
    try:
        while None in exited and time.monotonic() < t_end:
            for i, p in enumerate(procs):
                if exited[i] is None and p.poll() is not None:
                    exited[i] = time.time()
            time.sleep(0.02)
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    return [t if t is not None else float("inf") for t in exited]


def _wait(procs, timeout):
    t_end = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(t_end - time.monotonic(), 1))
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    return [p.returncode for p in procs]


def _snapshot_state(prefix, it):
    weights = port_io.load_caffemodel(f"{prefix}_iter_{it}.caffemodel")
    _, _, history, _ = port_io.load_solverstate(
        f"{prefix}_iter_{it}.solverstate")
    return weights, history


def _gen(prefix, g):
    try:
        with open(os.path.join(prefix + ".cluster", f"gen_{g}.json")) as f:
            return json.load(f)
    except OSError:
        return {}


def test_degrade_and_grow_back_end_to_end(tmp_path):
    import re
    net = tmp_path / "net.prototxt"
    net.write_text(E2E_NET)
    solver = tmp_path / "solver.prototxt"
    solver.write_text(f'net: "{net}"\nbase_lr: 0.05 momentum: 0.9\n'
                      f'lr_policy: "fixed" max_iter: {E2E_ITERS} '
                      f'random_seed: 5\ndisplay: 0 snapshot: {E2E_EVERY}\n')
    root = str(tmp_path)
    base = _pair_run(root, "base", str(solver), faults=False)
    deg = _pair_run(root, "degrade", str(solver), faults=True)
    rcs_base = _wait(base[0], 200)
    rcs = _wait(deg[0], 200)
    base_logs = [open(p).read() for p in base[1]]
    surv, lost = (open(p).read() for p in deg[1])
    assert rcs_base == [0, 0], base_logs[0][-3000:]
    assert rcs == [0, 0], (surv[-3000:], lost[-3000:])
    assert not _gen(base[2], 2)  # a run without a loss stays generation 1
    # the survivor's worker: host 1 silent, journaled, exit 87
    assert "heartbeat: host 1 silent" in surv
    with open(deg[2] + ".failures.log") as f:
        assert "gen 1 attempt 1: fault/cluster" in f.read()
    g2, g3 = _gen(deg[2], 2), _gen(deg[2], 3)
    assert (g2["reason"], g2["hosts"], g2["world"]) == \
        ("cluster_degraded", [0], 1)
    assert (g3["reason"], g3["hosts"], g3["world"]) == \
        ("cluster_regrown", [0, 1], 2)
    assert "rejoin-wait" in lost
    m = re.search(r"snapshot boundary iteration (\d+)", surv)
    assert m and int(m.group(1)) % E2E_EVERY == 0
    assert os.path.exists(os.path.join(deg[2] + ".cluster", "done"))
    want_w, want_h = _snapshot_state(base[2], E2E_ITERS)
    got_w, got_h = _snapshot_state(deg[2], E2E_ITERS)
    assert set(got_w) == set(want_w)
    for name in want_w:
        for a, b in zip(got_w[name], want_w[name]):
            np.testing.assert_allclose(a, b, err_msg=name, **STEP)
    for a, b in zip(got_h, want_h):
        np.testing.assert_allclose(a, b, **STEP)
