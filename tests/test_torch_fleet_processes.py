"""The port's serving fleet with real replica processes on the CPU, the
admin route `POST /swap`, and the CLI's fleet flags.

- The JAX package's fleet smoke (tools/fleet_smoke.py) on its toy deploy
  net, through the port: `FleetSupervisor` spawns two `cli serve
  -device cpu` replicas behind the router; replica 1 dies at a heartbeat
  boundary (`replica_dead`, a deadline of 1 s) while requests flow; every
  request resolves typed, the journal records the death and the respawn,
  the respawn passes its readyz gate; a rolling swap lands on both
  replicas with no build, and a NaN candidate is rejected with a typed
  SwapError while both replicas answer bitwise as before. Each replica
  journals its swaps to `<model>.rK.serve.run.json`.
- `POST /swap` on a CPU engine answers the JAX front's codes and kinds
  for the same request bytes; `swap_weights(canary=False)` skips the gate
  in both packages; a rejected swap is journaled with the run lock free.
- `cli serve -replicas 2 -smoke 8 -device cpu` exits 0; the fleet's flags
  land on the serving parameter; the program bank stays refused.
"""

import json
import math
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from caffe_mpi_tpu import io as jax_io
from caffe_mpi_tpu.serving import ServingEngine as JaxEngine
from caffe_mpi_tpu.serving.http_front import make_server as jax_server
from caffe_mpi_tpu_torch import io as port_io
from caffe_mpi_tpu_torch.net import Net
from caffe_mpi_tpu_torch.proto import NetParameter
from caffe_mpi_tpu_torch.proto.config import ServingParameter
from caffe_mpi_tpu_torch.serving import ServingEngine
from caffe_mpi_tpu_torch.serving.errors import SwapError
from caffe_mpi_tpu_torch.serving.fleet import FleetSupervisor
from caffe_mpi_tpu_torch.serving.http_front import make_server
from caffe_mpi_tpu_torch.tools import cli
from caffe_mpi_tpu_torch.utils import resilience

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tools/fleet_smoke.py's toy deploy net
DEPLOY = """
name: "fleet_toy"
layer { name: "data" type: "Input" top: "data"
        input_param { shape { dim: 8 dim: 3 dim: 12 dim: 12 } } }
layer { name: "conv" type: "Convolution" bottom: "data" top: "c"
        convolution_param { num_output: 4 kernel_size: 3 stride: 2
          weight_filler { type: "xavier" } } }
layer { name: "ip" type: "InnerProduct" bottom: "c" top: "score"
        inner_product_param { num_output: 6
          weight_filler { type: "xavier" } } }
layer { name: "prob" type: "Softmax" bottom: "score" top: "prob" }
"""
VICTIM = 1
DEADLINE = 1.0       # a beat each 0.25 s
KILL_MARGIN_S = 4.0  # the victim dies this long past replica 0's readyz


def _png(seed, hw=(12, 12)):
    import io

    from PIL import Image
    rng = np.random.RandomState(seed)
    buf = io.BytesIO()
    Image.fromarray(rng.randint(0, 255, (*hw, 3), np.uint8)).save(
        buf, format="PNG")
    return buf.getvalue()


def _toy(tmp_path):
    model = tmp_path / "deploy.prototxt"
    model.write_text(DEPLOY)
    net = Net(NetParameter.from_file(str(model)), device="cpu")
    net.init(0)
    weights = net.export_weights()
    w1 = str(tmp_path / "w1.caffemodel")
    port_io.save_caffemodel(w1, weights)
    return str(model), w1, weights


class _KillFleet(FleetSupervisor):
    """The supervisor with the victim's first spawn given the
    `replica_dead` fault at the beat KILL_MARGIN_S past replica 0's
    measured time to readyz (a loaded machine starts replicas slowly)."""

    ready_s: list = []

    def _spawn(self, rid, weights):
        first = rid == VICTIM and not hasattr(self, "_killed")
        if first:
            self._killed = True
            interval = min(max(self.deadline / 4.0, 0.05), 1.0)
            beat = math.ceil((self.ready_s[0] + KILL_MARGIN_S) / interval)
            self.replica_env[rid] = {
                "CAFFE_TPU_FAULTS": f"replica_dead:1:0:{beat}"}
        self._t_spawn = time.monotonic()
        try:
            return super()._spawn(rid, weights)
        finally:
            if first:
                self.replica_env.pop(rid)

    def _await_ready(self, client, proc, rid):
        ok = super()._await_ready(client, proc, rid)
        self.ready_s = self.ready_s + [time.monotonic() - self._t_spawn]
        return ok


def _send(router, data):
    return router.classify(data, "image/png")


def _bodies(router, data):
    out = {}
    for h in list(router._handles):
        status, doc = h.client.classify(data, "image/png")
        out[h.rid] = (status, json.dumps(doc, sort_keys=True))
    return out


def test_fleet_smoke_scenario_with_real_replica_processes(tmp_path,
                                                         monkeypatch):
    monkeypatch.setenv("PYTHONPATH", _ROOT)
    model, w1, weights = _toy(tmp_path)
    fleet_dir = str(tmp_path / "fleet")
    sp = ServingParameter(serve_window_ms=2.0)
    sup = _KillFleet(model, w1, 2, fleet_dir, serving_param=sp,
                     replica_deadline=DEADLINE, device="cpu",
                     spawn_timeout=120.0)
    png = _png(7)
    t0 = time.monotonic()
    try:
        sup.start()
        router = sup.router
        for _ in range(10):
            status, doc = _send(router, png)
            assert status == 200, doc
        # traffic until the heartbeat mourns, then until re-admission
        untyped, answered = 0, 0
        t_end = time.monotonic() + 60
        while time.monotonic() < t_end:
            status, doc = _send(router, png)
            answered += 1
            untyped += status != 200 and not doc.get("kind")
            if router.health()["replica_deaths"] >= 1:
                break
        assert router.health()["replica_deaths"] == 1
        t_end = time.monotonic() + 60
        while time.monotonic() < t_end:
            status, doc = _send(router, png)
            answered += 1
            untyped += status != 200 and not doc.get("kind")
            if router.health()["respawns"] >= 1 and router.ready()[0]:
                break
            time.sleep(0.02)
        assert untyped == 0 and answered > 0
        assert router.ready()[0] and router.respawns == 1
        jdoc = resilience.read_run_manifest(
            os.path.join(fleet_dir, "fleet") + ".serve")
        assert jdoc["reason"] == "replica_respawned"
        assert jdoc["replica_deaths"] == 1 and jdoc["respawns"] == 1
        victim = router.stats()["replicas"][str(VICTIM)]
        assert victim["compile_count"] == victim["warmed_buckets"] \
            + victim["recaptures"]
        # the rolling swap: both replicas, no build, the scores moved
        before = _bodies(router, png)
        builds = {r: d["compile_count"]
                  for r, d in router.stats()["replicas"].items()}
        w2 = str(tmp_path / "w2.caffemodel")
        port_io.save_caffemodel(w2, {**weights, "ip": [
            weights["ip"][0] * 3.0, weights["ip"][1]]})
        router.swap_weights("default", w2, source="smoke_v2")
        after = _bodies(router, png)
        docs = router.stats()["replicas"]
        assert {r: d["swaps"] for r, d in docs.items()} == {"0": 1, "1": 1}
        assert {r: d["compile_count"] for r, d in docs.items()} == builds
        assert all(after[r][0] == 200 and after[r] != before[r]
                   for r in before)
        # a NaN candidate: typed, and every replica bitwise as before
        w_bad = str(tmp_path / "w_bad.caffemodel")
        port_io.save_caffemodel(w_bad, {**weights, "ip": [
            np.full_like(weights["ip"][0], np.nan), weights["ip"][1]]})
        with pytest.raises(SwapError, match="canary replica 0 rejected"):
            router.swap_weights("default", w_bad, source="smoke_bad")
        assert _bodies(router, png) == after
        assert router.swap_rejections == 1 and router.swaps == 1
    finally:
        sup.stop()
    # each replica journals its own swaps beside the deploy prototxt
    stem = os.path.splitext(model)[0]
    for rid in (0, 1):
        doc = resilience.read_run_manifest(f"{stem}.r{rid}.serve")
        assert doc is not None, rid
        assert doc["reason"] in ("swap", "swap_rejected")
    assert os.path.isfile(os.path.join(fleet_dir, "hb", "hb_0"))
    assert time.monotonic() - t0 < 120


# ---------------------------------------------------------------------------
# POST /swap against the JAX front

TINY = ('name: "tiny" layer { name: "data" type: "Input" top: "data" '
        'input_param { shape { dim: 2 dim: 3 } } } '
        'layer { name: "ip" type: "InnerProduct" bottom: "data" top: "ip" '
        'inner_product_param { num_output: 4 weight_filler { '
        'type: "gaussian" std: 1 } } } '
        'layer { name: "prob" type: "Softmax" bottom: "ip" top: "prob" }')


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    d = tmp_path_factory.mktemp("swap_route")
    model = d / "tiny.prototxt"
    model.write_text(TINY)
    net = Net(NetParameter.from_file(str(model)), device="cpu")
    net.init(1)
    weights = net.export_weights()
    paths = {}
    for tag, w in (("w1", weights),
                   ("w2", {**weights, "ip": [weights["ip"][0] * 2.0,
                                             weights["ip"][1]]}),
                   ("nan", {**weights, "ip": [
                       np.full_like(weights["ip"][0], np.nan),
                       weights["ip"][1]]})):
        paths[tag] = str(d / f"{tag}.caffemodel")
        jax_io.save_caffemodel(paths[tag], w)
    return str(model), paths


def _engine(kind, model, weights):
    if kind == "port":
        eng = ServingEngine(device="cpu", buckets="1,2")
        mk = make_server
    else:
        eng = JaxEngine(buckets="1,2")
        mk = jax_server
    eng.load_model("m", model, weights)
    return eng, mk


def _post(url, path, body, ctype="application/json"):
    req = urllib.request.Request(url + path, data=body,
                                 headers={"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _swap_run(kind, tiny):
    model, paths = tiny
    eng, mk = _engine(kind, model, paths["w1"])
    x = np.linspace(-1, 1, 6, dtype=np.float32).reshape(2, 3)
    answers = []
    try:
        public = mk(eng, "m", port=0)
        threading.Thread(target=public.serve_forever, daemon=True).start()
        url = f"http://127.0.0.1:{public.server_address[1]}"
        code, doc = _post(url, "/swap", json.dumps(
            {"weights": paths["w2"]}).encode())
        answers.append((code, doc.get("kind"), doc.get("error")))
        public.shutdown()
        public.server_close()
        admin = mk(eng, "m", port=0, admin=True)
        threading.Thread(target=admin.serve_forever, daemon=True).start()
        url = f"http://127.0.0.1:{admin.server_address[1]}"
        rows0 = eng.classify("m", list(x), preprocess=False)
        for body in (b"not json", json.dumps({"model": "m"}).encode(),
                     json.dumps(["w"]).encode(),
                     json.dumps({"model": "nope",
                                 "weights": paths["w2"]}).encode(),
                     json.dumps({"weights": paths["nan"],
                                 "source": "bad"}).encode(),
                     json.dumps({"weights": str(paths["w1"]) + ".gone"}
                                ).encode()):
            code, doc = _post(url, "/swap", body)
            answers.append((code, doc.get("kind")))
        rows_kept = eng.classify("m", list(x), preprocess=False)
        code, doc = _post(url, "/swap", json.dumps(
            {"model": "m", "weights": paths["w2"], "canary": True,
             "source": "iter_5"}).encode())
        answers.append((code, doc.get("swapped"), doc.get("model"),
                        doc.get("swaps")))
        rows2 = eng.classify("m", list(x), preprocess=False)
        admin.shutdown()
        admin.server_close()
    finally:
        eng.close()
    return answers, rows0, rows_kept, rows2


def test_swap_route_answers_as_the_jax_front(tiny):
    port, p0, pkept, p2 = _swap_run("port", tiny)
    jax, j0, jkept, j2 = _swap_run("jax", tiny)
    assert port == jax
    assert port == [
        (404, "not_found", "no route /swap"),
        (400, "bad_request"), (400, "bad_request"), (400, "bad_request"),
        (404, "not_found"), (500, "swap"), (500, "swap"),
        (200, True, "m", 1)]
    # a rejected candidate leaves the previous weights serving, bitwise
    assert np.array_equal(pkept, p0)
    assert not np.allclose(p2, p0)
    np.testing.assert_allclose(p2, j2, atol=1e-5)
    np.testing.assert_allclose(p0, j0, atol=1e-5)


@pytest.mark.parametrize("kind", ["port", "jax"])
def test_canary_false_skips_the_gate(tiny, kind):
    """The propagation leg of a rolling swap: `canary=False` commits what
    the canary replica already held, so even a NaN candidate lands; with
    the gate it is rejected."""
    model, paths = tiny
    eng, _ = _engine(kind, model, paths["w1"])
    try:
        with pytest.raises(Exception) as info:
            eng.swap_weights("m", paths["nan"])
        assert getattr(info.value, "kind", "") == "swap"
        assert eng.swap_rejections == 1 and eng.swaps == 0
        eng.swap_weights("m", paths["nan"], canary=False, source="fleet")
        assert eng.swaps == 1 and eng.swap_rejections == 1
        rows = eng.classify("m", [np.ones(3, np.float32)],
                            preprocess=False)
        assert not np.all(np.isfinite(rows))
    finally:
        eng.close()


def test_a_rejected_swap_is_journaled_with_the_run_lock_free(tiny):
    """The canary's rejection is journaled after the run lock is released:
    a dispatch waits for the weight copies, never for a file write."""
    model, paths = tiny
    eng = ServingEngine(device="cpu", buckets="1,2")
    try:
        m = eng.load_model("m", model, paths["w1"])
        held = []
        eng._journal = lambda reason, **kw: held.append(
            (reason, m.fwd._run_lock._is_owned()))
        with pytest.raises(SwapError):
            eng.swap_weights("m", paths["nan"])
        eng.swap_weights("m", paths["w2"])
        assert held == [("swap_rejected", False), ("swap", False)]
    finally:
        eng.close()


# ---------------------------------------------------------------------------
# the CLI

def test_cli_serve_replicas_smoke_on_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("PYTHONPATH", _ROOT)
    model, w1, _ = _toy(tmp_path)
    rc = cli.main(["serve", "-model", model, "-weights", w1,
                   "-replicas", "2", "-smoke", "8", "-device", "cpu",
                   "-fleet_dir", str(tmp_path / "fleet"),
                   "-replica_deadline", "2"])
    out = capsys.readouterr().out
    assert rc == 0, out
    doc = json.loads(out.strip().splitlines()[-1])["serve_fleet_smoke"]
    assert doc["fleet"]["replicas"] == 2 and doc["fleet"]["routed"] == 8
    assert not doc["router_cuda_initialized"]
    assert all(d["requests"] > 0 for d in doc["replicas"].values())
    assert all(d["compile_count"] == d["warmed_buckets"]
               for d in doc["replicas"].values())


def test_cli_fleet_flags_land_on_the_serving_parameter():
    args = cli.parse_args(["serve", "-model", "m.prototxt", "-replicas", "3",
                           "-serve_retry_budget", "2", "-replica_deadline",
                           "1.5", "-fleet_dir", "/f", "-replica_id", "1"])
    assert (args.serve_replicas, args.serve_retry_budget,
            args.replica_deadline, args.fleet_dir, args.replica_id) == (
        3, 2, 1.5, "/f", 1)
    defaults = cli.parse_args(["serve"])
    assert (defaults.serve_replicas, defaults.serve_retry_budget,
            defaults.replica_deadline, defaults.fleet_dir,
            defaults.replica_id) == (-1, -1, -1.0, "", -1)
    assert [f for f, _, _ in cli.UNPORTED_FLAGS] == ["require_bank_warm"]


@pytest.mark.parametrize("flags", [
    ["-serve_program_bank", "bank"],
    ["-serve_program_bank", "bank", "-replicas", "2"],
    ["-require_bank_warm"], ["-require_bank_warm", "-replicas", "2"]])
def test_cli_the_program_bank_stays_refused(tmp_path, caplog, flags):
    """The bank is refused before any replica spawns or engine builds,
    naming ROADMAP §1 item 5, with or without -replicas."""
    model, _, _ = _toy(tmp_path)
    rc = cli.main(["serve", "-model", model, "-smoke", "1", "-device",
                   "cpu", "-fleet_dir", str(tmp_path / "fleet"), *flags])
    assert rc == 1
    assert "ROADMAP.md §1 item 5" in caplog.text
    assert not os.path.exists(tmp_path / "fleet" / "replica_0.log")


@pytest.mark.parametrize("flags", [["-replicas", "2"],
                                   ["-fleet_dir", "/nowhere"],
                                   ["-replica_id", "0"],
                                   ["-serve_retry_budget", "3"]])
def test_cli_train_takes_the_fleet_flags_as_jax_does(tmp_path, flags):
    """The fleet's flags are the serve command's: train parses and ignores
    them, as the JAX CLI does."""
    from test_torch_model_parallel import _cli_solver
    assert cli.main(["train", "-solver", _cli_solver(tmp_path),
                     "-synthetic", "-device", "cpu", *flags]) == 0
