"""Port parity: supervised recovery end to end, on the CPU.

Counterparts of the JAX tests/test_fault_tolerance.py TestEndToEndRecovery
and tests/test_train_guard.py TestSuperviseAnomalyRouting and
TestEndToEndSelfHealing. Each scenario drives the port's CLI (`train
-device cpu`) in a subprocess, under the supervisor (`-max_restarts N`)
where it has one, with fault sites set through CAFFE_TPU_FAULTS and
CAFFE_TPU_FAULTS_DIR (a site that has fired stays off in the restarted
child): an abort at a chunk's start, a kill between a snapshot's two
files, bitrot after a manifest, a dispatch stall past the watchdog's
deadline, NaN feeds under the skip-step guard with each anomaly_action,
and a crash loop. A recovered run's final caffemodel is bitwise the
uninterrupted run's (the CPU replays the same float32 operations).

The scenarios are independent processes, so the module runs them three
at a time up front (each supervisor and child imports torch, ~3 s here)
and the tests read their results. Also here: `supervise` alone over
scripted children (the failure log's reason words equal the JAX
supervisor's; the rewind_lr / rewind / abort routing), run_contained's
process-group kill and deadline, and SIGHUP / SIGINT acted on at a chunk
boundary of an in-process `cli.train`.
"""

import json
import os
import re
import signal
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from caffe_mpi_tpu.utils import resilience as jres
from caffe_mpi_tpu_torch.io import load_caffemodel
from caffe_mpi_tpu_torch.solver import solver as solver_mod
from caffe_mpi_tpu_torch.tools import cli
from caffe_mpi_tpu_torch.utils import resilience as pres
from caffe_mpi_tpu_torch.utils.subproc import run_contained

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NET = ('net_param { name: "tiny" '
       'layer { name: "data" type: "Input" top: "data" top: "label" '
       'input_param { shape { dim: 4 dim: 6 } shape { dim: 4 } } } '
       'layer { name: "ip" type: "InnerProduct" bottom: "data" top: "ip" '
       'inner_product_param { num_output: 10 '
       'weight_filler { type: "xavier" } } } '
       'layer { name: "loss" type: "SoftmaxWithLoss" bottom: "ip" '
       'bottom: "label" top: "loss" } }\n')
SOLVER = NET + ('base_lr: 0.05 momentum: 0.9 lr_policy: "fixed" '
                'max_iter: 12 random_seed: 3 display: 0 snapshot: 4\n')
GUARD = ("-train_guard", "-guard_max_skips", "2")
SUPERVISED = ("-max_restarts", "2")

# name -> (faults, with a once-dir, extra flags)
SCENARIOS = {
    "baseline": ("", False, ()),
    "abort_corrupt": ("snapshot_sync:-1,snapshot_corrupt:1:1,"
                      "train_abort:1:0:10", True, SUPERVISED),
    "kill": ("snapshot_sync:-1,snapshot_kill:1:1", True, SUPERVISED),
    "stall": ("dispatch_stall:1:3:8", True,
              SUPERVISED + ("-watchdog_deadline", "1.5")),
    "stall_alone": ("dispatch_stall:1:3:8", False,
                    ("-watchdog_deadline", "1.5")),
    "rewind_lr": ("nan_grad:2:0:5", True,
                  GUARD + SUPERVISED + ("-anomaly_action", "rewind_lr")),
    "rewind": ("nan_grad:2:0:5", True,
               GUARD + SUPERVISED + ("-anomaly_action", "rewind")),
    "abort": ("nan_grad:2:0:5", False,
              GUARD + SUPERVISED + ("-anomaly_action", "abort")),
    "crashloop": ("train_abort:99:0:2", False, ("-max_restarts", "1")),
}


def _run(root, solver, name):
    faults, once, extra = SCENARIOS[name]
    prefix = os.path.join(root, name, "s")
    fdir = os.path.join(root, name + "_faults")
    os.makedirs(fdir, exist_ok=True)
    env = dict(os.environ, CAFFE_TPU_FAULTS=faults,
               CAFFE_TPU_FAULTS_DIR=fdir if once else "")
    env.pop("CAFFE_SUPERVISED_CHILD", None)
    env.pop("PYTHONPATH", None)
    cmd = [sys.executable, "-m", "caffe_mpi_tpu_torch.tools.cli", "train",
           "-solver", solver, "-synthetic", "-snapshot_prefix", prefix,
           "-step_chunk", "2", "-device", "cpu", *extra]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=_ROOT, env=env, capture_output=True,
                       text=True, timeout=240)
    summaries = [json.loads(l)["train"] for l in r.stdout.splitlines()
                 if l.startswith('{"train"')]
    log_path = prefix + ".failures.log"
    return {"rc": r.returncode, "out": r.stdout, "err": r.stderr,
            "summaries": summaries, "prefix": prefix,
            "seconds": time.perf_counter() - t0,
            "failures": open(log_path).read()
            if os.path.exists(log_path) else ""}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("recovery"))
    solver = os.path.join(root, "solver.prototxt")
    with open(solver, "w") as f:
        f.write(SOLVER)
    with ThreadPoolExecutor(max_workers=3) as ex:
        futs = {name: ex.submit(_run, root, solver, name)
                for name in SCENARIOS}
        return {name: f.result() for name, f in futs.items()}


def _final(res, it=12):
    path = f"{res['prefix']}_iter_{it}.caffemodel"
    assert os.path.exists(path), (res["err"][-3000:], path)
    return load_caffemodel(path)


def _bitwise(got, want):
    assert set(got) == set(want)
    for lname in want:
        for a, b in zip(got[lname], want[lname]):
            assert np.array_equal(a, b), f"{lname}: weight bits differ"


def _ok(res):
    assert res["rc"] == 0, (res["rc"], res["err"][-3000:])


def test_baseline_runs_unsupervised(runs):
    res = runs["baseline"]
    _ok(res)
    (summary,) = res["summaries"]
    assert summary["resumed_from"] is None and summary["iters"] == 12
    assert summary["snapshots"] == [f"{res['prefix']}_iter_{i}.solverstate"
                                    for i in (4, 8, 12)]
    assert summary["kernel_launches"] == {f"K{i}": 0 for i in range(1, 6)}
    assert "supervisor" not in res["err"]


def test_train_abort_restarts_and_the_corrupt_snapshot_falls_back(runs):
    """Snapshot 8 rots after its manifest (snapshot_sync pins the write
    to the boundary); the child dies at the chunk starting at 10; the
    restart skips 8 (crc), resumes from 4 and ends bitwise."""
    res = runs["abort_corrupt"]
    _ok(res)
    assert "failed crc verification" in res["err"]
    assert "child failed (fault/cluster)" in res["err"]
    (summary,) = res["summaries"]  # the first child printed none
    assert summary["resumed_from"].endswith("s_iter_4.solverstate")
    assert summary["start_iter"] == 4
    lines = [l for l in res["failures"].splitlines()
             if not l.startswith("    ")]
    assert len(lines) == 1 and "attempt 1: fault/cluster" in lines[0]
    _bitwise(_final(res), _final(runs["baseline"]))


def test_kill_mid_snapshot_leaves_the_previous_one_verifiable(runs):
    res = runs["kill"]
    _ok(res)
    assert "hard exit at site 'snapshot_kill'" in res["err"]
    (summary,) = res["summaries"]
    assert summary["resumed_from"].endswith("s_iter_4.solverstate")
    _bitwise(_final(res), _final(runs["baseline"]))
    for _it, m in pres.iter_snapshot_manifests(res["prefix"]):
        assert pres.verify_snapshot(m) is not None


def test_dispatch_stall_trips_the_watchdog_and_the_run_resumes(runs):
    res = runs["stall"]
    _ok(res)
    assert "exceeded 1.5s deadline" in res["err"]
    assert "child failed (watchdog)" in res["err"]
    assert "attempt 1: watchdog" in res["failures"]
    _bitwise(_final(res), _final(runs["baseline"]))


def test_watchdog_exits_86_and_journals_its_section(runs):
    res = runs["stall_alone"]
    assert res["rc"] == pres.EXIT_WATCHDOG, res["err"][-3000:]
    run = pres.read_run_manifest(res["prefix"])
    assert run["reason"] == "watchdog:train dispatch"
    assert run["deadline_s"] == 1.5 and run["stalled_s"] >= 1.5
    assert run["last_snapshot_iter"] == 4  # the chunks [0, 6): 3 ran
    assert res["summaries"] == []


def test_rewind_lr_restarts_with_lr_scale(runs):
    res = runs["rewind_lr"]
    _ok(res)
    assert "exiting 88" in res["err"]
    assert "attempt 1: numeric divergence" in res["failures"]
    assert "rewinding to the newest verified snapshot" in res["err"]
    attempt2 = [l for l in res["err"].splitlines()
                if "supervisor: attempt 2/3" in l]
    assert attempt2 and attempt2[0].endswith("-resume auto -lr_scale 0.1")
    assert "base_lr scaled by 0.1" in res["err"]
    (summary,) = res["summaries"]
    assert summary["resumed_from"].endswith("s_iter_4.solverstate")
    journal = pres.read_run_manifest(res["prefix"])
    assert journal["reason"] == "snapshot"


def test_rewind_restarts_without_lr_scale_and_replays_bitwise(runs):
    res = runs["rewind"]
    _ok(res)
    assert "-lr_scale" not in res["err"]
    assert "attempt 1: numeric divergence" in res["failures"]
    _bitwise(_final(res), _final(runs["baseline"]))


def test_anomaly_action_abort_returns_88_without_a_restart(runs):
    res = runs["abort"]
    assert res["rc"] == pres.EXIT_NUMERIC, res["err"][-3000:]
    assert "anomaly_action 'abort'" in res["err"]
    assert "rewinding" not in res["err"]
    assert "supervisor: attempt 2/3" not in res["err"]
    run = pres.read_run_manifest(res["prefix"])
    assert run["reason"] == "numeric_anomaly" and run["exit_code"] == 88
    assert run["consec_skips"] == 2 and run["last_bad_iter"] == 6


def test_crash_loop_guard_gives_up_after_max_restarts(runs):
    res = runs["crashloop"]
    assert res["rc"] == pres.EXIT_FAULT
    assert "crash-loop guard" in res["err"]
    lines = [l for l in res["failures"].splitlines()
             if not l.startswith("    ")]
    assert len(lines) == 2
    assert all("fault/cluster" in l for l in lines)


# -- supervise alone over scripted children ---------------------------------------

def _script(tmp_path, codes):
    """A child that exits with codes[k] on its k-th run (0 after)."""
    count = tmp_path / "count"
    script = tmp_path / "child.sh"
    script.write_text(
        "#!/bin/sh\n"
        f'n=$(cat "{count}" 2>/dev/null || echo 0)\n'
        f'echo $((n + 1)) > "{count}"\n'
        f'set -- {" ".join(str(c) for c in codes)} 0 0 0 0 0 0 0 0\n'
        'shift "$n"\nexit "$1"\n')
    script.chmod(0o755)
    return str(script)


def _reasons(path):
    return [re.sub(r" after [0-9.]+s:.*", "", l.split("] ", 1)[1])
            for l in open(path).read().splitlines()
            if not l.startswith("    ")]


@pytest.fixture
def signals_kept():
    """run_contained hooks SIGTERM/SIGINT/SIGHUP in the calling process:
    give them back after an in-process supervisor."""
    from caffe_mpi_tpu_torch.utils import subproc
    sigs = (signal.SIGTERM, signal.SIGINT, signal.SIGHUP)
    prev = {s: signal.getsignal(s) for s in sigs}
    yield
    for s, h in prev.items():
        signal.signal(s, h)
    subproc._HOOKED = False
    import caffe_mpi_tpu.utils.subproc as jsub
    jsub._HOOKED = False


def test_failure_log_reason_words_equal_the_jax_supervisors(
        tmp_path, signals_kept):
    out = {}
    for name, pkg in (("port", pres), ("jax", jres)):
        d = tmp_path / name
        d.mkdir()
        child = _script(d, [86, 87, 88, 3])
        rc = pkg.supervise([child], [child, "-resume", "auto"], 5,
                           failure_log=str(d / "f.log"),
                           backoff_base=0.01)
        out[name] = (rc, _reasons(str(d / "f.log")))
    assert out["port"] == out["jax"]
    assert out["port"][1] == [
        "attempt 1: watchdog", "attempt 2: fault/cluster",
        "attempt 3: numeric divergence", "attempt 4: exit 3"]


@pytest.mark.parametrize("action,max_restarts,want_rc", [
    ("rewind_lr", 2, 0), ("rewind", 1, 88), ("abort", 2, 88)])
def test_anomaly_routing_equals_the_jax_supervisors(
        tmp_path, signals_kept, action, max_restarts, want_rc):
    """A child that exits 88 until it is given -lr_scale."""
    script = tmp_path / "child.sh"
    script.write_text('#!/bin/sh\nfor a in "$@"; do\n'
                      '  [ "$a" = "-lr_scale" ] && exit 0\ndone\nexit 88\n')
    script.chmod(0o755)
    got = {}
    for name, pkg in (("port", pres), ("jax", jres)):
        log_path = str(tmp_path / f"{name}.log")
        rc = pkg.supervise([str(script)], [str(script), "-resume", "auto"],
                           max_restarts, failure_log=log_path,
                           anomaly_action=action, anomaly_lr_mult=0.1,
                           backoff_base=0.01)
        got[name] = (rc, _reasons(log_path))
    assert got["port"] == got["jax"]
    assert got["port"][0] == want_rc
    # abort: one attempt; rewind: every attempt fails; rewind_lr: the
    # restart carried -lr_scale and succeeded
    assert len(got["port"][1]) == {"abort": 1, "rewind": 2,
                                   "rewind_lr": 1}[action]


def _state(pid):
    try:
        with open(f"/proc/{pid}/status") as f:
            return next(l.split()[1] for l in f if l.startswith("State:"))
    except (OSError, StopIteration):
        return "gone"


def test_run_contained_kills_the_whole_group_and_keeps_its_deadline(
        tmp_path, signals_kept):
    pidfile = tmp_path / "grandchild.pid"
    script = tmp_path / "spawn.sh"
    script.write_text(f"#!/bin/sh\nsleep 60 >/dev/null 2>&1 &\necho $! > {pidfile}\n"
                      "echo spawned\nexit 3\n")
    script.chmod(0o755)
    rc, out, _err = run_contained([str(script)], timeout=30)
    assert rc == 3 and "spawned" in out
    pid = int(pidfile.read_text())
    deadline = time.time() + 5
    while _state(pid) not in ("gone", "Z") and time.time() < deadline:
        time.sleep(0.05)
    assert _state(pid) in ("gone", "Z")  # killed with the group
    t0 = time.perf_counter()
    rc, _out, _err = run_contained(["sleep", "30"], timeout=0.5)
    assert rc is None and time.perf_counter() - t0 < 10


# -- signals at a chunk boundary --------------------------------------------------

def _signal_at(monkeypatch, sig, at_iter):
    """Deliver `sig` to this process when the chunk starting at
    `at_iter` begins (the handler only sets a flag)."""
    real = solver_mod.Solver._run_chunk

    def run_chunk(self, feed_fn, c, masks):
        if self.iter == at_iter:
            os.kill(os.getpid(), sig)
        return real(self, feed_fn, c, masks)
    monkeypatch.setattr(solver_mod.Solver, "_run_chunk", run_chunk)


def _train_in_process(tmp_path, *extra):
    path = tmp_path / "solver.prototxt"
    path.write_text(NET + 'base_lr: 0.05 momentum: 0.9 lr_policy: "fixed" '
                    'max_iter: 12 random_seed: 3 display: 0\n')
    return cli.train(cli.parse_args(
        ["train", "-solver", str(path), "-synthetic", "-snapshot_prefix",
         str(tmp_path / "s"), "-step_chunk", "2", "-device", "cpu",
         *extra]))


def test_sighup_snapshots_at_the_next_chunk_boundary(tmp_path,
                                                     monkeypatch):
    before = signal.getsignal(signal.SIGHUP)
    _signal_at(monkeypatch, signal.SIGHUP, 4)
    solver, summary = _train_in_process(tmp_path)
    assert summary["iters"] == 12 and not summary["stopped"]
    # the chunk [4, 6) ran to its end, then the snapshot; then the
    # after-train one
    assert summary["snapshots"] == [str(tmp_path / "s_iter_6.solverstate"),
                                    str(tmp_path / "s_iter_12.solverstate")]
    assert pres.verify_snapshot(str(tmp_path / "s_iter_6.manifest.json"))
    assert signal.getsignal(signal.SIGHUP) is before  # given back


def test_sigint_stops_and_snapshots_at_the_next_chunk_boundary(
        tmp_path, monkeypatch):
    before = signal.getsignal(signal.SIGINT)
    _signal_at(monkeypatch, signal.SIGINT, 4)
    solver, summary = _train_in_process(tmp_path)
    assert summary["stopped"] and solver.iter == 6
    assert summary["iters"] == 6 and summary["test_scores"] is None
    assert summary["snapshot"] == str(tmp_path / "s_iter_6.solverstate")
    assert signal.getsignal(signal.SIGINT) is before
    # -resume auto picks it up and finishes the run
    monkeypatch.undo()
    _, again = _train_in_process(tmp_path, "-resume", "auto")
    assert again["resumed_from"] == str(tmp_path / "s_iter_6.solverstate")
    assert again["start_iter"] == 6 and again["iters"] == 6


def test_sigint_effect_none_ignores_the_signal(tmp_path, monkeypatch):
    _signal_at(monkeypatch, signal.SIGINT, 4)
    _, summary = _train_in_process(tmp_path, "-sigint_effect", "none")
    assert summary["iters"] == 12 and not summary["stopped"]
