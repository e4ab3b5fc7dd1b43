"""Port parity: verified snapshots against the JAX package, on the CPU.

Counterparts of the JAX tests/test_fault_tolerance.py TestAtomicManifests
and TestSolverSnapshots: crc32c_file, snapshot manifests written and
verified across the two packages both ways, the GC's choice of files,
the manifest scan's order, restore's refusal of a corrupt snapshot,
restore_auto's pick over one directory of mixed snapshots (verified,
corrupt, manifest-less, none), the fault plane's firing rules, and the
run journal's fields.

The resume check trains the narrowed AlexNet of test_torch_train.py:
5 SGD iterations, a snapshot, restore_auto in a fresh Solver and 5 more
are bitwise 10 uninterrupted iterations (the CPU runs the same float32
operations in the same order; Dropout masks come from the JAX draws),
and within test_torch_train.py's tolerances of the JAX Solver's 10
(losses rtol 1e-5; params and history rtol 1e-5 / atol 1e-6). An
interval snapshot written by the writer thread is byte for byte the
blocking snapshot at the same iteration.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from caffe_mpi_tpu.proto import SolverParameter as JaxSP
from caffe_mpi_tpu.solver import Solver as JaxSolver
from caffe_mpi_tpu.utils import resilience as jres
from caffe_mpi_tpu_torch.proto import SolverParameter
from caffe_mpi_tpu_torch.solver import Solver
from caffe_mpi_tpu_torch.solver import solver as solver_mod
from caffe_mpi_tpu_torch.utils import resilience as pres
from caffe_mpi_tpu_torch.weights import load_jax_params
from test_torch_train import (STEP, _assert_params_equal, _feeds, _host,
                              _jax_masks, _torch_feeds, solver_text)

PKGS = {"port": pres, "jax": jres}
# one inner product over an Input feed (test_torch_refusals.py's NET)
TINY = ('net_param { name: "tiny" '
        'layer { name: "data" type: "Input" top: "data" top: "label" '
        'input_param { shape { dim: 2 dim: 3 } shape { dim: 2 } } } '
        'layer { name: "ip" type: "InnerProduct" bottom: "data" top: "ip" '
        'inner_product_param { num_output: 4 '
        'weight_filler { type: "xavier" } } } '
        'layer { name: "loss" type: "SoftmaxWithLoss" bottom: "ip" '
        'bottom: "label" top: "loss" } }\n'
        'base_lr: 0.05 momentum: 0.9 lr_policy: "fixed" max_iter: 100 '
        'random_seed: 3 display: 0\n')


def tiny_feed(it):
    r = np.random.RandomState(100 + it)
    return {"data": r.randn(2, 3).astype(np.float32),
            "label": r.randint(0, 4, 2).astype(np.int32)}


def port_feed(it):
    return {k: torch.from_numpy(v) for k, v in tiny_feed(it).items()}


def tiny_solver(extra="", prefix=None):
    s = Solver(SolverParameter.from_text(TINY + extra), device="cpu")
    if prefix:
        s.sp.snapshot_prefix = prefix
    return s


def jax_tiny_solver(extra="", prefix=None):
    s = JaxSolver(JaxSP.from_text(TINY + extra))
    if prefix:
        s.sp.snapshot_prefix = prefix
    return s


def flip_byte(path):
    b = bytearray(open(path, "rb").read())
    b[len(b) // 2] ^= 0xFF
    open(path, "wb").write(bytes(b))


def fake_snapshot(pkg, prefix, it, payload=b"weights"):
    model = f"{prefix}_iter_{it}.caffemodel"
    state = f"{prefix}_iter_{it}.solverstate"
    open(model, "wb").write(payload + str(it).encode() * 50)
    open(state, "wb").write(b"state" + str(it).encode())
    pkg.write_snapshot_manifest(state, it, {"model": model, "state": state})
    return model, state


# -- crc32c and manifests -------------------------------------------------------

@pytest.mark.parametrize("size", [0, 1, 7, 4096, (1 << 20) + 13])
def test_crc32c_file_gives_the_jax_value(tmp_path, size):
    path = str(tmp_path / "f.bin")
    open(path, "wb").write(np.random.RandomState(size).bytes(size))
    want = jres.crc32c_file(path)
    assert pres.crc32c_file(path) == want
    # chunked: the chunks' crcs chained through the native extend
    assert pres.crc32c_file(path, chunk=1000) == want


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port"),
                                           ("port", "port")])
def test_snapshot_manifest_verifies_across_packages(tmp_path, writer,
                                                    reader):
    prefix = str(tmp_path / "s")
    model, state = fake_snapshot(PKGS[writer], prefix, 4)
    (it, mpath), = PKGS[reader].iter_snapshot_manifests(prefix)
    doc = PKGS[reader].verify_snapshot(mpath)
    assert it == 4 and doc is not None
    assert doc["state"] == os.path.abspath(state)
    assert doc["iteration"] == 4 and set(doc["files"]) == {"model", "state"}
    # a flipped byte fails under both packages
    flip_byte(model)
    assert pres.verify_snapshot(mpath) is None
    assert jres.verify_snapshot(mpath) is None
    # a truncation too
    model2, _ = fake_snapshot(PKGS[writer], prefix, 8)
    open(model2, "wb").write(b"w")
    (_, m8), _ = pres.iter_snapshot_manifests(prefix)
    assert pres.verify_snapshot(m8) is None and jres.verify_snapshot(m8) \
        is None


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_file_manifest_verifies_across_packages(tmp_path, writer):
    path = str(tmp_path / "artifact.bin")
    open(path, "wb").write(b"x" * 1000)
    PKGS[writer].write_file_manifest(path, fingerprint="abc")
    for pkg in PKGS.values():
        doc = pkg.verify_file_manifest(path)
        assert doc is not None and doc["fingerprint"] == "abc"
    flip_byte(path)
    assert all(pkg.verify_file_manifest(path) is None
               for pkg in PKGS.values())


def test_manifest_scan_order_equals_the_jax_scan(tmp_path):
    prefix = str(tmp_path / "s")
    for it in (3, 12, 7, 100):
        fake_snapshot(pres, prefix, it)
    # a sharded set's name, and names the scan must pass over
    open(f"{prefix}_iter_50.orbax.manifest.json", "w").write("{}")
    for junk in ("s_iter_x.manifest.json", "s_iter_9.caffemodel",
                 "other_iter_5.manifest.json", "s_iter_.manifest.json"):
        open(tmp_path / junk, "w").write("{}")
    got = pres.iter_snapshot_manifests(prefix)
    assert got == jres.iter_snapshot_manifests(prefix)
    assert [it for it, _ in got] == [100, 50, 12, 7, 3]
    assert pres.iter_snapshot_manifests(str(tmp_path / "none" / "s")) == []


@pytest.mark.parametrize("rot,keep", [((6, 8), 2), ((8,), 1), ((), 3),
                                      ((2, 4, 6, 8), 1)])
def test_gc_keeps_the_files_the_jax_gc_keeps(tmp_path, rot, keep):
    left = {}
    for name, pkg in PKGS.items():
        d = tmp_path / name
        d.mkdir()
        prefix = str(d / "s")
        for it in (2, 4, 6, 8):
            fake_snapshot(pres, prefix, it)
        for it in rot:
            open(f"{prefix}_iter_{it}.caffemodel", "ab").write(b"rot")
        pkg.gc_snapshots(prefix, keep)
        left[name] = sorted(os.listdir(d))
    assert left["port"] == left["jax"]
    remaining = {it for it, _ in pres.iter_snapshot_manifests(
        str(tmp_path / "port" / "s"))}
    good = [it for it in (8, 6, 4, 2) if it not in rot]
    if good:  # the newest verified snapshot survives every sweep
        assert good[0] in remaining
    assert len(remaining) >= min(keep, 4)


def test_gc_assume_verified_skips_the_read(tmp_path, monkeypatch):
    prefix = str(tmp_path / "s")
    for it in (2, 4, 6):
        fake_snapshot(pres, prefix, it)
    reads = []
    real = pres.verify_snapshot
    monkeypatch.setattr(pres, "verify_snapshot",
                        lambda m: reads.append(m) or real(m))
    removed = pres.gc_snapshots(prefix, 1,
                                assume_verified=f"{prefix}_iter_6"
                                ".manifest.json")
    assert reads == [] and len(removed) == 6
    assert [it for it, _ in pres.iter_snapshot_manifests(prefix)] == [6]


def test_latest_verified_snapshot_skips_corrupt_and_bounds(tmp_path):
    prefix = str(tmp_path / "s")
    for it in (2, 4, 6):
        fake_snapshot(pres, prefix, it)
    flip_byte(f"{prefix}_iter_6.caffemodel")
    for pkg in PKGS.values():
        assert pkg.latest_verified_snapshot(prefix)["iteration"] == 4
    assert [d["iteration"] for d in pres.verified_snapshots(prefix)] == [4, 2]
    # every manifest corrupt, or none at all: nothing to resume from
    for it in (2, 4):
        flip_byte(f"{prefix}_iter_{it}.solverstate")
    for pkg in PKGS.values():
        assert pkg.latest_verified_snapshot(prefix) is None
        assert pkg.latest_verified_snapshot(str(tmp_path / "none")) is None


def test_atomic_output_publishes_whole_or_nothing(tmp_path):
    path = str(tmp_path / "f.bin")
    open(f"{path}.tmp99999", "wb").write(b"orphan of a killed writer")
    with pres.atomic_output(path) as tmp:
        open(tmp, "wb").write(b"payload")
    with pytest.raises(ValueError):
        with pres.atomic_output(path) as tmp:
            open(tmp, "wb").write(b"half-")
            raise ValueError("the writer died")
    assert open(path, "rb").read() == b"payload"
    assert os.listdir(tmp_path) == ["f.bin"]


# -- the fault plane ----------------------------------------------------------

# (spec, keys): fire(site, key=k) for each key, or 5 calls without a key
SEQUENCES = [
    ("site:2:1:arg", []),
    ("site:-1", []),
    ("site:1:0:5", [3, 4, 5, 6]),
    ("site:2:1:5", [4, 5, 6, 7, 8]),
]


@pytest.mark.parametrize("spec,keys", SEQUENCES)
def test_fault_plane_fires_as_the_jax_plane(tmp_path, spec, keys):
    out = {}
    for name, pkg in PKGS.items():
        once = tmp_path / name
        once.mkdir()
        plane = pkg.FaultPlane()
        plane.configure(spec, once_dir=str(once))
        calls = [plane.fire("site", key=k) for k in keys] if keys else \
            [plane.fire("site") for _ in range(5)]
        calls.append(plane.fire("other"))
        # a restarted process loads a site that has fired disabled
        again = pkg.FaultPlane()
        again.configure(spec, once_dir=str(once))
        out[name] = (calls, sorted(os.listdir(once)), again.active("site"))
    assert out["port"] == out["jax"]


def test_fault_plane_feed_poisoning_matches_the_jax_plane():
    port, jax = pres.FaultPlane(), jres.FaultPlane()
    for plane in (port, jax):
        plane.configure("nan_grad:2:0:3,loss_spike:1:0:6")
    pf = port.wrap_feeds(port_feed)
    jf = jax.wrap_feeds(tiny_feed)
    for it in range(8):
        got, want = pf(it), jf(it)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    off = pres.FaultPlane()
    assert off.wrap_feeds(port_feed) is port_feed  # free when off


# -- the Solver -----------------------------------------------------------------

def test_snapshot_keep_gc_and_the_run_journal(tmp_path):
    s = tiny_solver("snapshot: 2 snapshot_keep: 2", str(tmp_path / "s"))
    s.step(8, port_feed)
    s.close()
    its = [it for it, _ in pres.iter_snapshot_manifests(str(tmp_path / "s"))]
    assert its == [8, 6]
    for _it, m in pres.iter_snapshot_manifests(str(tmp_path / "s")):
        assert pres.verify_snapshot(m) is not None
        assert jres.verify_snapshot(m) is not None
    assert not os.path.exists(tmp_path / "s_iter_2.caffemodel")
    run = pres.read_run_manifest(str(tmp_path / "s"))
    assert run["iter"] == 8 and run["reason"] == "snapshot"
    assert run["last_snapshot_state"].endswith("s_iter_8.solverstate")
    assert s.snapshots == [str(tmp_path / f"s_iter_{i}.solverstate")
                           for i in (2, 4, 6, 8)]


def test_run_journal_fields_match_the_jax_journal(tmp_path):
    keys = {}
    for name, make in (("port", tiny_solver), ("jax", jax_tiny_solver)):
        prefix = str(tmp_path / name / "s")
        s = make("", prefix)
        s.step(2, port_feed if name == "port" else tiny_feed)
        s.snapshot()
        doc = PKGS[name].read_run_manifest(prefix)
        assert doc["reason"] == "snapshot" and doc["iter"] == 2
        assert doc["last_snapshot_iter"] == 2
        keys[name] = set(doc)
        s._watchdog_journal("train dispatch", 12.34)
        doc = PKGS[name].read_run_manifest(prefix)
        assert doc["reason"] == "watchdog:train dispatch"
        assert doc["stalled_s"] == 12.3
        keys[name + "_watchdog"] = set(doc)
        s.close()
    assert keys["port"] == keys["jax"]
    assert keys["port_watchdog"] == keys["jax_watchdog"]


def test_numeric_anomaly_journal_matches_the_jax_journal(tmp_path):
    docs = {}
    extra = "train_guard: true guard_max_skips: 2 "

    def nan_feed(base):
        def feed(it):
            f = base(it)
            if it >= 1:
                f["data"] = f["data"] * float("nan")
            return f
        return feed

    for name, make in (("port", tiny_solver), ("jax", jax_tiny_solver)):
        prefix = str(tmp_path / name / "s")
        s = make(extra, prefix)
        with pytest.raises(PKGS[name].NumericAnomalyError):
            for _ in range(6):
                s.step(1, nan_feed(port_feed if name == "port"
                                   else tiny_feed))
        docs[name] = PKGS[name].read_run_manifest(prefix)
        s.close()
    assert docs["port"]["reason"] == docs["jax"]["reason"] == \
        "numeric_anomaly"
    assert set(docs["port"]) == set(docs["jax"])
    for key in ("consec_skips", "skipped_steps", "last_bad_iter",
                "exit_code"):
        assert docs["port"][key] == docs["jax"][key], key


def test_restore_rejects_a_corrupt_snapshot(tmp_path):
    s = tiny_solver("snapshot: 2", str(tmp_path / "s"))
    s.step(4, port_feed)
    s.close()
    flip_byte(str(tmp_path / "s_iter_4.caffemodel"))
    fresh = tiny_solver()
    with pytest.raises(pres.SnapshotCorruptError, match="crc32c"):
        fresh.restore(str(tmp_path / "s_iter_4.solverstate"))
    assert fresh.iter == 0
    fresh.restore(str(tmp_path / "s_iter_4.solverstate"), verify=False)
    assert fresh.iter == 4  # unverified, the rotten bytes load


def _mixed_dir(root, layout):
    """Port snapshots at 2, 4, 6 and 8 of one run, then per `layout`
    (iteration -> "ok", "corrupt", "legacy" (manifest removed), "gone"
    (files removed))."""
    prefix = os.path.join(root, "s")
    s = tiny_solver("snapshot: 2", prefix)
    s.step(8, port_feed)
    s.close()
    for it, kind in layout.items():
        if kind == "corrupt":
            flip_byte(f"{prefix}_iter_{it}.caffemodel")
        elif kind == "legacy":
            os.unlink(f"{prefix}_iter_{it}.manifest.json")
        elif kind == "gone":
            for ext in ("caffemodel", "solverstate", "manifest.json"):
                os.unlink(f"{prefix}_iter_{it}.{ext}")
    return prefix


@pytest.mark.parametrize("layout,want", [
    ({8: "corrupt"}, 6),
    ({8: "corrupt", 6: "legacy"}, 4),
    ({8: "corrupt", 6: "corrupt", 4: "corrupt", 2: "legacy"}, 2),
    ({8: "corrupt", 6: "corrupt", 4: "corrupt", 2: "corrupt"}, None),
    ({8: "gone", 6: "gone", 4: "gone", 2: "gone"}, None),
])
def test_restore_auto_picks_what_the_jax_solver_picks(tmp_path, layout,
                                                      want):
    prefix = _mixed_dir(str(tmp_path), layout)
    port = tiny_solver("", prefix)
    jax = jax_tiny_solver("", prefix)
    got, jgot = port.restore_auto(), jax.restore_auto()
    assert got == jgot
    if want is None:
        assert got is None and port.iter == 0 and jax.iter == 0
    else:
        assert got.endswith(f"s_iter_{want}.solverstate")
        assert port.iter == jax.iter == want
        _assert_params_equal(_host(jax.params), port.net, rtol=0, atol=0)


def test_restore_auto_resume_is_bitwise_the_uninterrupted_run(tmp_path):
    whole = tiny_solver()
    whole.step(6, port_feed)
    first = tiny_solver("snapshot: 2", str(tmp_path / "s"))
    first.step(6, port_feed)
    first.close()
    flip_byte(str(tmp_path / "s_iter_6.caffemodel"))
    fresh = tiny_solver("", str(tmp_path / "s"))
    assert fresh.restore_auto().endswith("s_iter_4.solverstate")
    fresh.step(2, port_feed)
    for (_, _, _, a), (_, _, _, b) in zip(whole._decls, fresh._decls):
        assert torch.equal(a, b)


# -- 5 + 5 iterations of the narrowed AlexNet -----------------------------------

@pytest.fixture(scope="module")
def alexnet_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("alexnet_snap")
    text = solver_text("max_iter: 10")
    jsolver = JaxSolver(JaxSP.from_text(text))
    feeds = _feeds(10, seed=4)
    jlosses = [jsolver.step(1, lambda k: feeds[k]) for _ in range(10)]
    masks = _jax_masks(jsolver)
    start = _host(JaxSolver(JaxSP.from_text(text)).params)
    whole = Solver(SolverParameter.from_text(text), device="cpu")
    load_jax_params(whole.net, start)
    whole.step(10, _torch_feeds(feeds), dropout_masks=masks)
    first = Solver(SolverParameter.from_text(text), device="cpu")
    load_jax_params(first.net, start)
    first.sp.snapshot_prefix = str(tmp / "half")
    first.step(5, _torch_feeds(feeds), dropout_masks=masks)
    first.snapshot(block=False)
    first.close()
    resumed = Solver(SolverParameter.from_text(text), device="cpu")
    resumed.sp.snapshot_prefix = str(tmp / "half")
    assert resumed.restore_auto().endswith("half_iter_5.solverstate")
    resumed.step(5, _torch_feeds(feeds), dropout_masks=masks)
    return jsolver, jlosses, whole, first, resumed


def test_five_plus_five_iterations_are_bitwise_ten(alexnet_runs):
    _, _, whole, first, resumed = alexnet_runs
    assert resumed.iter == whole.iter == 10
    assert first.losses + resumed.losses == whole.losses
    for (_, _, _, a), (_, _, _, b) in zip(whole._decls, resumed._decls):
        assert torch.equal(a, b)
    for key in whole.history:
        for a, b in zip(whole.history[key], resumed.history[key]):
            assert torch.equal(a, b)


def test_resumed_run_matches_the_jax_solvers_ten(alexnet_runs):
    jsolver, jlosses, _, first, resumed = alexnet_runs
    np.testing.assert_allclose(first.losses + resumed.losses, jlosses,
                               rtol=1e-5)
    _assert_params_equal(jsolver.params, resumed.net, **STEP)
    for lname, blobs in jsolver.opt_state.items():
        for pname, slots in blobs.items():
            np.testing.assert_allclose(
                resumed.history[(lname, pname)][0].numpy(),
                np.asarray(slots[0]), err_msg=f"{lname}.{pname}", **STEP)


# -- the writer thread ----------------------------------------------------------

def test_async_snapshot_is_byte_equal_to_a_blocking_one(tmp_path,
                                                        monkeypatch):
    """The interval snapshot at 4 is written by the writer thread while
    the solver runs on to 8; a second solver stopped at 4 writes a
    blocking one. Relative prefixes, so the state files name the same
    caffemodel."""
    for d in ("async", "block"):
        (tmp_path / d).mkdir()
    monkeypatch.chdir(tmp_path / "async")
    a = tiny_solver("snapshot: 4", "s")
    a.step(8, port_feed)
    a.close()
    monkeypatch.chdir(tmp_path / "block")
    b = tiny_solver("", "s")
    b.step(4, port_feed)
    assert b.snapshot(block=True) == "s_iter_4.solverstate"
    assert [e["block"] for e in a.snapshot_log] == [False, False]
    for ext in ("caffemodel", "solverstate"):
        got = open(tmp_path / "async" / f"s_iter_4.{ext}", "rb").read()
        want = open(tmp_path / "block" / f"s_iter_4.{ext}", "rb").read()
        assert got == want, ext
    assert pres.verify_snapshot(str(tmp_path / "async" /
                                    "s_iter_4.manifest.json"))


def test_snapshot_sync_site_makes_interval_snapshots_block(tmp_path):
    pres.FAULTS.configure("snapshot_sync:-1")
    try:
        s = tiny_solver("snapshot: 2", str(tmp_path / "s"))
        s.step(4, port_feed)
        s.close()
    finally:
        pres.FAULTS.configure("")
    assert [e["block"] for e in s.snapshot_log] == [True, True]


def test_wait_snapshots_reraises_a_failed_write_with_its_iteration(
        tmp_path, monkeypatch):
    def broken(*a, **k):
        raise OSError("disk full")
    monkeypatch.setattr(solver_mod.caffe_io, "save_solverstate", broken)
    s = tiny_solver("snapshot: 3", str(tmp_path / "s"))
    s.step(3, port_feed)  # the writer fails in its thread
    with pytest.raises(RuntimeError, match="async snapshot failed at "
                       "iteration 3") as ei:
        s.wait_snapshots()
    assert isinstance(ei.value.__cause__, OSError)
    s.wait_snapshots()  # raised once
    # no manifest was written: the failed snapshot is invisible to resume
    assert pres.iter_snapshot_manifests(str(tmp_path / "s")) == []
    s.close()


def test_solve_waits_for_the_writer_and_cleans_no_temp(tmp_path):
    s = tiny_solver("snapshot: 5 max_iter: 10", str(tmp_path / "s"))
    s.solve(port_feed)
    assert s._snapshot_thread is None
    assert sorted(os.listdir(tmp_path)) == sorted(
        ["s.run.json"] + [f"s_iter_{i}.{e}" for i in (5, 10)
                          for e in ("caffemodel", "solverstate",
                                    "manifest.json")])
    shutil.rmtree(tmp_path)


def test_streamed_snapshot_files_are_the_jax_writers_bytes(tmp_path):
    """The port writes each blob's data straight from its array; the
    files are byte for byte the JAX package's (0-d, empty, Fortran-order
    and float64 blobs included)."""
    from caffe_mpi_tpu import io as jax_io
    from caffe_mpi_tpu_torch import io as port_io
    rs = np.random.RandomState(0)
    weights = {"ip": [rs.rand(40, 30).astype(np.float32),
                      np.zeros(40, np.float32)],
               "odd": [np.float32(3.0) * np.ones(()),
                       np.zeros((0, 3), np.float32),
                       np.asfortranarray(rs.rand(5, 7).astype(np.float32)),
                       rs.rand(2, 3, 4)]}
    history = [w for blobs in weights.values() for w in blobs]
    for name, port_save, jax_save, args in (
            ("m.caffemodel", port_io.save_caffemodel,
             jax_io.save_caffemodel, (weights, "n", {"ip": "InnerProduct"})),
            ("s.solverstate", port_io.save_solverstate,
             jax_io.save_solverstate, (7, "m.caffemodel", history, 2))):
        port_save(str(tmp_path / ("port_" + name)), *args)
        jax_save(str(tmp_path / ("jax_" + name)), *args)
        assert (tmp_path / ("port_" + name)).read_bytes() == \
            (tmp_path / ("jax_" + name)).read_bytes(), name
    assert port_io.encode_caffemodel(weights, "n") == \
        jax_io.encode_caffemodel(weights, "n")
    assert sorted(os.listdir(tmp_path)) == sorted(
        p + n for p in ("port_", "jax_")
        for n in ("m.caffemodel", "s.solverstate"))
