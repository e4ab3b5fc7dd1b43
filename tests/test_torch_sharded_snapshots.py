"""Port parity: sharded snapshots (`snapshot_format: ORBAX`; the JAX
`snapshot_native` / `restore_native`, caffe_mpi_tpu/solver/solver.py).

A run on a 2 x 2 mesh of four gloo ranks (tests/torch_dp_worker.py) with
fc1 split ("data", "model"), fc2 by cols and ZeRO-1 on fc3 writes its
sets at iterations 3 and 5: each rank writes the shards it owns, rank 0
commits the crc32c manifest after the write barrier. Beside the set at
5 it writes the gathered (BINARYPROTO) snapshot of the same state. The
set restores element for element at (2, 2), at (1, 2) and in one
process, each equal to the gathered snapshot; the one-process restore
is held against the JAX package's own round trip of the same run (its
snapshot_native into orbax, its restore_native) at the bars of test_torch_model_parallel.py
(rtol 1e-5 / atol 1e-6). Each package reads the other's manifests; GC
takes whole sets; a flipped shard byte makes restore_auto fall back; a
directory the JAX package wrote (orbax's own files) is refused.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from caffe_mpi_tpu.utils import resilience as jax_res
from caffe_mpi_tpu_torch import io as port_io
from caffe_mpi_tpu_torch.proto import SolverParameter
from caffe_mpi_tpu_torch.solver import Solver
from caffe_mpi_tpu_torch.utils import resilience as port_res
from test_torch_model_parallel import (ITERS, MESH, STEP, TP_MLP, jax_start,
                                       solver_text)
from torch_dp_worker import Ranks

BASE = solver_text(TP_MLP, kind="Adam", extra="base_lr: 0.01 "
                   "momentum2: 0.999 delta: 1e-8")
SHARDINGS = {"fc1": ("data", "model"), "fc2": (None, "model")}
ORBAX = ' snapshot_format: ORBAX'


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded")
    js, sc = jax_start(BASE + " zero_stage: 1", 31, SHARDINGS)
    prefix, gathered = str(tmp / "port" / "s"), str(tmp / "flat" / "g")
    os.makedirs(os.path.dirname(prefix))
    os.makedirs(os.path.dirname(gathered))
    sc = dict(sc, name="write", solver=BASE + " zero_stage: 1 snapshot: 3"
              + ORBAX + f' snapshot_prefix: "{prefix}"', snapshot=prefix,
              gathered=gathered)
    ranks = Ranks({"mesh": MESH, "scenarios": [sc]}, 4, str(tmp / "r22"),
                  timeout=240)
    for _ in range(ITERS):
        js.step(1, lambda k: sc["feeds"][k])
    jprefix = str(tmp / "jax" / "j")
    os.makedirs(os.path.dirname(jprefix))
    js.sp.snapshot_prefix = jprefix
    jpath = js.snapshot_native()
    back, _ = jax_start(BASE + " zero_stage: 1", 31, SHARDINGS)
    back.restore_native(jpath)
    written = ranks.results()
    path = written[0]["write"]["snapshot"]
    half = Ranks({"mesh": (1, 2), "scenarios": [dict(
        name="restore", kind="restore", solver=BASE + ORBAX, path=path,
        param_shardings=SHARDINGS)]}, 2, str(tmp / "r12"), timeout=120)
    one = Solver(SolverParameter.from_text(BASE + ORBAX), device="cpu")
    one.restore(path)
    return {"tmp": tmp, "written": written, "path": path, "prefix": prefix,
            "jax": back, "jpath": jpath, "jprefix": jprefix,
            "half": half.results(), "one": one, "feeds": sc["feeds"]}


def _one_state(solver) -> dict:
    out = {}
    for lname, pname, _, p in solver._decls:
        out[f"{lname}.{pname}"] = p.detach().numpy()
    for (lname, pname), slots in solver.history.items():
        for i, h in enumerate(slots):
            out[f"{lname}.{pname}.h{i}"] = h.numpy()
    return out


def _gathered(run) -> dict:
    """The BINARYPROTO snapshot of the same iteration, as arrays."""
    res = run["written"][0]["write"]
    state = res["gathered"]
    model = port_io.load_weights(state.replace(".solverstate", ".caffemodel"))
    _, _, history, _ = port_io.load_solverstate(state)
    keys = [(l, p) for l, p, _, _ in run["one"]._decls]
    out = {}
    for i, (lname, pname) in enumerate(keys):
        out[f"{lname}.{pname}"] = model[lname][("weight", "bias").index(
            pname)]
        for s in range(2):
            out[f"{lname}.{pname}.h{s}"] = history[i + s * len(keys)]
    return out


def test_the_set_holds_each_shard_once_and_commits(run):
    """Sets at 3 and 5, each a directory of one file a distinct shard and
    the index, under a kind-"orbax" manifest that verifies."""
    path = run["path"]
    assert path.endswith("s_iter_5.orbax") and os.path.isdir(path)
    files = sorted(os.listdir(path))
    assert "port_index.json" in files
    # fc1's weight over 4 ranks (4 files a slot), fc2's over the model
    # ranks (2), fc3's slots over the data ranks (2), the rest whole (1)
    assert len([f for f in files if f.startswith("0.")]) == 4
    doc = port_res.verify_snapshot(port_res.manifest_for_state(path))
    assert doc is not None and doc["kind"] == "orbax"
    assert doc["iteration"] == 5 and set(doc["files"]) == set(files)
    assert [it for it, _ in port_res.iter_snapshot_manifests(
        run["prefix"])] == [5, 3]


def test_restores_at_2x2_1x2_and_in_one_process_as_the_gathered_set(run):
    want = _gathered(run)
    for r in run["written"]:
        res = r["write"]
        assert res["restored_iter"] == ITERS
        assert res["restored_auto"] == run["path"]
        for key, arr in res["state"].items():
            np.testing.assert_array_equal(res["restored"][key], arr, key)
            if key in want:
                np.testing.assert_array_equal(arr, want[key], key)
    for r in run["half"]:
        assert r["restore"]["iter"] == ITERS
        for key, arr in want.items():
            np.testing.assert_array_equal(r["restore"]["state"][key], arr,
                                          key)
    assert run["one"].iter == ITERS
    for key, arr in _one_state(run["one"]).items():
        np.testing.assert_array_equal(arr, want[key], key)


def test_the_round_trip_matches_the_jax_one(run):
    js, got = run["jax"], _one_state(run["one"])
    assert int(js.iter) == ITERS
    for lname, blobs in js.params.items():
        for pname, arr in blobs.items():
            np.testing.assert_allclose(got[f"{lname}.{pname}"],
                                       np.asarray(arr), **STEP)
            for i, slot in enumerate(js.opt_state[lname][pname]):
                np.testing.assert_allclose(got[f"{lname}.{pname}.h{i}"],
                                           np.asarray(slot), **STEP)


@pytest.mark.parametrize("reader", [jax_res, port_res])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_manifests_read_under_both_packages(run, reader, writer):
    prefix = run["prefix"] if writer == "port" else run["jprefix"]
    found = reader.iter_snapshot_manifests(prefix)
    assert found and found[0][0] == ITERS
    doc = reader.verify_snapshot(found[0][1])
    assert doc is not None and doc["kind"] == "orbax"
    assert os.path.isdir(doc["state"])


def test_gc_keeps_whole_sets(run, tmp_path):
    copy = tmp_path / "gc"
    shutil.copytree(os.path.dirname(run["prefix"]), copy)
    prefix = str(copy / "s")
    port_res.gc_snapshots(prefix, 1)
    left = sorted(os.listdir(copy))
    assert "s_iter_5.orbax" in left and "s_iter_3.orbax" not in left
    assert not any("iter_3" in name for name in left)
    assert port_res.verify_snapshot(
        port_res.manifest_for_state(str(copy / "s_iter_5.orbax")))


def test_a_flipped_shard_falls_back_to_the_older_set(run, tmp_path):
    copy = tmp_path / "bad"
    shutil.copytree(os.path.dirname(run["prefix"]), copy)
    victim = port_res.sharded_snapshot_files(str(copy / "s_iter_5.orbax"))[0]
    with open(victim, "r+b") as f:
        f.seek(os.path.getsize(victim) // 2)
        b = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([b[0] ^ 0xFF]))
    solver = Solver(SolverParameter.from_text(BASE + ORBAX), device="cpu")
    with pytest.raises(port_res.SnapshotCorruptError):
        solver.restore(str(copy / "s_iter_5.orbax"))
    assert solver.restore_auto(str(copy / "s")) == str(copy / "s_iter_3.orbax")
    assert solver.iter == 3


def test_the_shard_fault_site_corrupts_after_the_commit(run, tmp_path):
    """`snapshot_shard_corrupt` flips a byte of the biggest shard after
    the manifest: restore_auto falls back past that set."""
    solver = Solver(SolverParameter.from_text(BASE + ORBAX), device="cpu")
    solver.sp.snapshot_prefix = str(tmp_path / "f")
    solver.restore(run["path"])
    solver.snapshot()
    feeds = run["feeds"]
    solver.step(1, lambda k: {key: torch.from_numpy(v)
                              for key, v in feeds[k % len(feeds)].items()})
    port_res.FAULTS.configure("snapshot_shard_corrupt")
    try:
        bad = solver.snapshot()
    finally:
        port_res.FAULTS.configure("")
    assert bad.endswith("f_iter_6.orbax")
    again = Solver(SolverParameter.from_text(BASE + ORBAX), device="cpu")
    assert again.restore_auto(str(tmp_path / "f")).endswith("f_iter_5.orbax")


def test_a_jax_written_directory_is_refused(run):
    solver = Solver(SolverParameter.from_text(BASE + ORBAX), device="cpu")
    with pytest.raises(NotImplementedError, match="need orbax"):
        solver.restore(run["jpath"])


def test_sharded_write_and_gathered_write_are_timed(run):
    res = run["written"][0]["write"]
    log = [e for e in res["snapshot_log"] if e.get("format") == "ORBAX"]
    assert [e["iter"] for e in log] == [3, 5]
    assert all(e["write_ms"] > 0 for e in log) and res["gathered_ms"] > 0


def test_the_serving_watcher_skips_a_sharded_set(run, tmp_path):
    """A prefix that publishes the port's sharded sets: the watcher
    verifies the newest, sees kind "orbax", swaps nothing and rejects
    nothing (it serves flat .caffemodel snapshots only)."""
    from caffe_mpi_tpu_torch.serving import ServingEngine, SnapshotWatcher
    from test_torch_serving_ingest import BUCKETS, write_deploy
    model, weights = write_deploy(tmp_path)
    with ServingEngine(device="cpu", buckets=BUCKETS, window_ms=0) as eng:
        eng.load_model("m", model, weights)
        watcher = SnapshotWatcher(eng, "m", run["prefix"])
        assert watcher.check_once() is False
        assert eng.swaps == 0 and eng.swap_rejections == 0
        assert watcher._last_iter == ITERS and not watcher._rejected
