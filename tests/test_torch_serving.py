"""Port serving plane on the CPU: caffe_mpi_tpu_torch.serving against its
own Net and against the JAX package's ServingEngine.

The deploy net is the narrowed AlexNet of test_torch_net.py at a declared
batch of 10, so its ladder is (1, 4, 10) as the full AlexNet's is. Rows
served through padded buckets equal the port's Net forward at 1e-6 (rows
are batch-independent at inference; only the batch size of the
convolution and product calls differs), and equal the JAX engine's rows
on the same .caffemodel at 1e-4 (float32 sums in another order through
eight layers, then softmax).
"""

import sys

import numpy as np
import pytest
import torch

from caffe_mpi_tpu.serving import ServingEngine as JaxEngine
from caffe_mpi_tpu.serving import plan_ladder as jax_plan_ladder
from caffe_mpi_tpu_torch.net import Net
from caffe_mpi_tpu_torch.proto import NetParameter
from caffe_mpi_tpu_torch.serving import (EngineClosedError, ServingEngine,
                                         ShedError, bucket_for, plan_ladder)
from caffe_mpi_tpu_torch.tools import cli
from test_torch_net import small_alexnet

BURSTS = (1, 3, 11)


@pytest.fixture(scope="module")
def deploy(tmp_path_factory):
    d = tmp_path_factory.mktemp("serve")
    model = d / "deploy.prototxt"
    model.write_text(small_alexnet(batch=10))
    net = Net(NetParameter.from_file(str(model)), device="cpu")
    net.init(3)
    from caffe_mpi_tpu import io as jax_io
    weights = str(d / "small.caffemodel")
    jax_io.save_caffemodel(weights, net.export_weights())
    return str(model), weights


def _rows(n, seed):
    return np.random.RandomState(seed).randn(n, 3, 67, 67).astype(np.float32)


@pytest.mark.parametrize("max_batch,spec", [(10, None), (1, None),
                                            (256, None), (10, "1,4,16"),
                                            (10, [4, 2])])
def test_ladder_equals_jax_plan_ladder(max_batch, spec):
    assert plan_ladder(max_batch, spec) == jax_plan_ladder(max_batch, spec)
    for n in (1, 2, 4, 5, max_batch):
        ladder = plan_ladder(max_batch, spec)
        assert bucket_for(n, ladder) in ladder


def test_mixed_bursts_match_net_and_jax_engine(deploy):
    model, weights = deploy
    with ServingEngine(device="cpu", window_ms=2) as eng:
        m = eng.load_model("a", model, weights)
        assert m.fwd.ladder == jax_plan_ladder(10) == (1, 4, 10)
        served = [eng.classify("a", _rows(n, n), preprocess=False)
                  for n in BURSTS]
        eng.drain()
        st = eng.stats()
    assert st["requests"] == sum(BURSTS)
    assert st["warmed_buckets"] == 3
    assert [w["bucket"] for w in st["warm"]["a"]] == [1, 4, 10]

    # the port's own Net, one declared batch of 10 at a time, zero-padded
    net = Net(NetParameter.from_file(model), device="cpu")
    from caffe_mpi_tpu_torch import io as port_io
    net.import_weights(port_io.load_weights(weights), strict=True)
    for n, rows in zip(BURSTS, served):
        x = _rows(n, n)
        want = []
        for i in range(0, n, 10):
            chunk = x[i:i + 10]
            pad = np.zeros((10 - len(chunk), 3, 67, 67), np.float32)
            with torch.inference_mode():
                out = net({"data": torch.from_numpy(
                    np.concatenate([chunk, pad]))})[0]["prob"].numpy()
            want.append(out[:len(chunk)])
        np.testing.assert_allclose(rows, np.concatenate(want), rtol=0,
                                   atol=1e-6)

    with JaxEngine(window_ms=2) as jeng:
        jeng.load_model("a", model, weights)
        for n, rows in zip(BURSTS, served):
            want = jeng.classify("a", list(_rows(n, n)), preprocess=False)
            np.testing.assert_allclose(rows, want, rtol=0, atol=1e-4)


def test_typed_errors_and_stats(deploy):
    model, weights = deploy
    eng = ServingEngine(device="cpu", window_ms=0)
    try:
        eng.load_model("a", model, weights)
        with pytest.raises(ValueError, match="row shape"):
            eng.submit("a", np.zeros((3, 66, 67), np.float32),
                       preprocess=False)
        with pytest.raises(KeyError):
            eng.submit("nope", _rows(1, 0)[0], preprocess=False)
        row = eng.submit("a", _rows(1, 0)[0], preprocess=False).result(60)
        assert row.shape == (10,) and abs(row.sum() - 1) < 1e-5
        st = eng.stats()
        assert st["warmed_buckets"] == 3 and st["requests"] == 1
        assert st["device"] == "cpu" and st["p99_ms"] >= st["p50_ms"] > 0
    finally:
        eng.shutdown()
    with pytest.raises(EngineClosedError):
        eng.submit("a", _rows(1, 0)[0], preprocess=False)


def test_queue_limit_sheds_typed(deploy):
    model, weights = deploy
    # a window far longer than the test holds the backlog undispatched
    eng = ServingEngine(device="cpu", queue_limit=2, window_ms=600_000)
    try:
        eng.load_model("a", model, weights)
        futs = [eng.submit("a", r, preprocess=False) for r in _rows(2, 1)]
        with pytest.raises(ShedError):
            eng.submit("a", _rows(1, 2)[0], preprocess=False)
        assert eng.stats()["shed_requests"] == 1
    finally:
        eng.close()
    # close() cancels what never dispatched
    assert all(f.cancelled() for f in futs)


def test_preprocess_hwc_images(deploy):
    model, weights = deploy
    with ServingEngine(device="cpu") as eng:
        m = eng.load_model("a", model, weights, raw_scale=255.0,
                           mean=np.array([104.0, 117.0, 123.0]),
                           channel_swap=(2, 1, 0))
        img = np.random.RandomState(0).rand(67, 67, 3).astype(np.float32)
        row = m.preprocess(img)
        want = img.transpose(2, 0, 1)[::-1] * 255.0 - \
            np.array([104.0, 117.0, 123.0], np.float32)[:, None, None]
        np.testing.assert_allclose(row, want, rtol=1e-6, atol=1e-4)
        scores = eng.classify("a", [img, img])
        assert scores.shape == (2, 10)
        np.testing.assert_array_equal(scores[0], scores[1])


def test_engine_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        ServingEngine()


def test_cli_serve_smoke_on_cpu(deploy, capsys):
    model, weights = deploy
    rc = cli.main(["serve", "-model", model, "-weights", weights,
                   "-smoke", "8", "-device", "cpu"])
    assert rc == 0
    out = capsys.readouterr().out
    # every request went over HTTP: decoded and preprocessed by the ingest
    assert '"serve_smoke"' in out and '"requests": 8' in out
    assert '"deferred_rows": 8' in out
    assert cli.main(["serve", "-device", "cpu"]) == 1  # no -model


def test_preprocess_touches_pil_only_to_resize(monkeypatch):
    from caffe_mpi_tpu_torch import caffe_io
    monkeypatch.setitem(sys.modules, "PIL", None)  # PIL absent
    img = np.random.RandomState(0).rand(8, 8, 3).astype(np.float32)
    same = caffe_io.resize_center_crop(img, (8, 8), (8, 8))
    np.testing.assert_array_equal(same, img)
    with pytest.raises(RuntimeError, match="needs PIL"):
        caffe_io.resize_center_crop(img, (6, 6), (6, 6))
