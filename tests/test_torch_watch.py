"""Port parity: the snapshot watcher (serving/watch.py) against the JAX
package's, on the CPU.

Counterparts of the JAX tests/test_serving_resilience.py TestHotSwap. The
deploy net is the narrow LRN net of test_torch_serving_ingest.py (ladder
1, 4); a training run's snapshots are published into a prefix (a
.caffemodel of seeded weights, a .solverstate, the crc32c manifest last),
and the port's watcher over the port's engine and the JAX watcher over
the JAX engine each poll the same sequence of publications: none, a good
one, one rotted by the `swap_corrupt` site, one whose canary fails
(`swap_canary_bad`), one torn (its model file gone), a good one, nothing
new. Held: the same swap and reject decisions and journal reasons; rows
after each swap within 1e-4 of the JAX engine's (the serving tolerance
of test_torch_serving.py) and within 1e-6 of the port's Net on the
swapped weights; after a rejection the previous rows bitwise; no bucket
built by any swap (`compile_count` equal before and after). `cli serve
-watch` with `-smoke` swaps once.
"""

import json
import os
import time

import numpy as np
import pytest
import torch

from caffe_mpi_tpu.serving import ServingEngine as JaxEngine
from caffe_mpi_tpu.serving.watch import SnapshotWatcher as JaxWatcher
from caffe_mpi_tpu.utils import resilience as jres
from caffe_mpi_tpu_torch import io as port_io
from caffe_mpi_tpu_torch.net import Net
from caffe_mpi_tpu_torch.proto import NetParameter
from caffe_mpi_tpu_torch.serving import ServingEngine, SnapshotWatcher
from caffe_mpi_tpu_torch.tools import cli
from caffe_mpi_tpu_torch.utils import resilience as pres
from test_torch_serving_ingest import BUCKETS, write_deploy

KINDS = {
    "port": (lambda **kw: ServingEngine(device="cpu", buckets=BUCKETS, **kw),
             SnapshotWatcher, pres),
    "jax": (lambda **kw: JaxEngine(buckets=BUCKETS, **kw), JaxWatcher,
            jres),
}
# (iteration or None, weights seed, fault site armed for the poll)
SEQUENCE = [(None, 0, ""), (10, 5, ""), (20, 6, "swap_corrupt:1"),
            (30, 8, "swap_canary_bad:1"), (40, 9, "torn"), (50, 7, ""),
            (None, 0, "")]


def rows(n=6, seed=0):
    return np.random.RandomState(seed).rand(n, 3, 16, 16).astype(
        np.float32) * 255.0


def publish(model, prefix, it, seed):
    """A training run's snapshot of the deploy net's weights at `it`."""
    net = Net(NetParameter.from_file(model), device="cpu")
    net.init(seed)
    weights = f"{prefix}_iter_{it}.caffemodel"
    state = f"{prefix}_iter_{it}.solverstate"
    port_io.save_caffemodel(weights, net.export_weights(), net.name)
    port_io.save_solverstate(state, it, weights, [])
    pres.write_snapshot_manifest(state, it, {"model": weights,
                                             "state": state})
    return weights


def net_rows(model, weights, x):
    net = Net(NetParameter.from_file(model), device="cpu")
    net.import_weights(port_io.load_weights(weights), strict=True)
    out = []
    for chunk in (x[:4], x[4:]):
        pad = np.zeros((4 - len(chunk), 3, 16, 16), np.float32)
        with torch.inference_mode():
            out.append(net({"data": torch.from_numpy(np.concatenate(
                [chunk, pad]))})[0]["prob"].numpy()[:len(chunk)])
    return np.concatenate(out)


def _watch_run(kind, tmp_path, model, weights):
    make, watcher_cls, pkg = KINDS[kind]
    d = tmp_path / kind
    d.mkdir()
    prefix = str(d / "train" / "s")
    os.makedirs(os.path.dirname(prefix))
    journal = str(d / "m")
    x = rows()
    out = {"decisions": [], "reasons": [], "rows": [], "builds": [],
           "weights": []}
    with make(window_ms=0, journal=journal) as eng:
        eng.load_model("m", model, weights)
        watcher = watcher_cls(eng, "m", prefix, poll_s=0.1)
        builds = eng.compile_count
        last = eng.classify("m", x, preprocess=False)
        for it, seed, site in SEQUENCE:
            new = None
            if it is not None:
                new = publish(model, prefix, it, seed)
                if site == "torn":
                    os.unlink(new)
            pkg.FAULTS.configure("" if site == "torn" else site)
            try:
                swapped = watcher.check_once()
            finally:
                pkg.FAULTS.configure("")
            got = eng.classify("m", x, preprocess=False)
            out["decisions"].append(swapped)
            out["rows"].append(got)
            out["weights"].append(new if swapped else None)
            if not swapped and it is not None:
                np.testing.assert_array_equal(got, last)  # kept bitwise
            if it is not None:
                with open(journal + ".serve.run.json") as f:
                    doc = json.load(f)
                out["reasons"].append((doc["reason"], doc.get("source")))
            out["builds"].append(eng.compile_count - builds)
            last = got
        stats = eng.stats()
    out["swaps"], out["rejections"] = stats["swaps"], stats["swap_rejections"]
    return out


@pytest.fixture(scope="module")
def watched(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("watch")
    model, weights = write_deploy(tmp)
    return {kind: _watch_run(kind, tmp, model, weights) for kind in KINDS}, \
        model


def test_port_and_jax_watchers_make_the_same_decisions(watched):
    runs, _ = watched
    port, jax = runs["port"], runs["jax"]
    assert port["decisions"] == jax["decisions"] == [
        False, True, False, False, False, True, False]
    assert port["reasons"] == jax["reasons"] == [
        ("swap", "iter_10"), ("swap_rejected", "iter_20"),
        ("swap_rejected", "iter_30"), ("swap_rejected", "iter_40"),
        ("swap", "iter_50")]
    assert (port["swaps"], port["rejections"]) == \
        (jax["swaps"], jax["rejections"]) == (2, 3)


def test_rows_after_each_swap_follow_the_new_weights(watched):
    runs, model = watched
    port, jax = runs["port"], runs["jax"]
    x = rows()
    for got, want, weights in zip(port["rows"], jax["rows"],
                                  port["weights"]):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
        if weights is not None:
            np.testing.assert_allclose(got, net_rows(model, weights, x),
                                       rtol=0, atol=1e-6)
    assert np.abs(port["rows"][1] - port["rows"][0]).max() > 1e-4


def test_no_swap_builds_a_bucket(watched):
    runs, _ = watched
    assert runs["port"]["builds"] == [0] * len(SEQUENCE)
    assert runs["jax"]["builds"] == [0] * len(SEQUENCE)


def test_rejected_iterations_are_remembered_and_min_iter_skips(tmp_path):
    model, weights = write_deploy(tmp_path)
    prefix = str(tmp_path / "s")
    publish(model, prefix, 5, 4)
    with ServingEngine(device="cpu", buckets=BUCKETS, window_ms=0) as eng:
        eng.load_model("m", model, weights)
        skipping = SnapshotWatcher(eng, "m", prefix, min_iter=5)
        assert skipping.check_once() is False and eng.swaps == 0
        pres.FAULTS.configure("swap_corrupt:1")
        try:
            watcher = SnapshotWatcher(eng, "m", prefix)
            assert watcher.check_once() is False
        finally:
            pres.FAULTS.configure("")
        assert watcher._rejected == {5}
        assert watcher.check_once() is False  # rot does not heal
        assert eng.swap_rejections == 1
        publish(model, prefix, 6, 9)
        assert watcher.check_once() is True and eng.swaps == 1


def test_watcher_thread_swaps_and_stops(tmp_path):
    model, weights = write_deploy(tmp_path)
    prefix = str(tmp_path / "s")
    with ServingEngine(device="cpu", buckets=BUCKETS, window_ms=0) as eng:
        eng.load_model("m", model, weights)
        watcher = SnapshotWatcher(eng, "m", prefix, poll_s=0.05)
        watcher.start()
        publish(model, prefix, 3, 4)
        deadline = time.time() + 30
        while eng.swaps == 0 and time.time() < deadline:
            time.sleep(0.05)
        watcher.stop()
        assert eng.swaps == 1 and watcher._thread is None


def test_cli_serve_watch_smoke_swaps_once(tmp_path, capsys):
    model, weights = write_deploy(tmp_path)
    prefix = str(tmp_path / "train" / "s")
    os.makedirs(os.path.dirname(prefix))
    publish(model, prefix, 10, 5)
    assert cli.main(["serve", "-model", model, "-weights", weights,
                     "-smoke", "4", "-watch", prefix, "-serve_buckets",
                     BUCKETS, "-device", "cpu"]) == 0
    line = [l for l in capsys.readouterr().out.splitlines()
            if l.startswith('{"serve_smoke"')]
    stats = json.loads(line[-1])["serve_smoke"]
    assert stats["swaps"] == 1 and stats["swap_rejections"] == 0
    assert stats["post_warmup_compiles"] == 0
    doc = json.load(open(os.path.splitext(model)[0] + ".serve.run.json"))
    assert (doc["reason"], doc["source"]) == ("swap", "iter_10")
