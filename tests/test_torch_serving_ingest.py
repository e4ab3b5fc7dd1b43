"""Port serving ingest on the CPU: request decode, the window-fused
preprocess, the decoded-request cache and the declines, each held against
the JAX package's serving ingest (caffe_mpi_tpu/serving/ingest.py) on the
same bytes.

The deploy net is a narrow one with an LRN (3x16x16 in, ladder 1, 4),
served from the same .caffemodel by both engines. Limits: PNG decode
bitwise (both PIL's and the JAX library's); JPEG within 1 LSB of the JAX
library's; fused rows bitwise the JAX package's fused rows and the port's
own per-request chain (caffe_io.resize_center_crop + Transformer); cache
and decode counters equal to the JAX engine's under the same trace; scores
of the same uploads within 1e-4 of the JAX engine's (the tolerance of
test_torch_serving.py).
"""

import io

import numpy as np
import pytest

from caffe_mpi_tpu.data import decode as jdecode
from caffe_mpi_tpu.serving import ServingEngine as JaxEngine
from caffe_mpi_tpu.serving import ingest as jingest
from caffe_mpi_tpu_torch.data import decode as pdecode
from caffe_mpi_tpu_torch.net import Net
from caffe_mpi_tpu_torch.proto import NetParameter
from caffe_mpi_tpu_torch.serving import ServingEngine
from caffe_mpi_tpu_torch.serving import ingest as pingest
from test_torch_native import jax_native  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("jax_native")

DEPLOY = """
name: "narrow_lrn"
layer { name: "data" type: "Input" top: "data"
        input_param { shape { dim: 4 dim: 3 dim: 16 dim: 16 } } }
layer { name: "conv1" type: "Convolution" bottom: "data" top: "conv1"
        convolution_param { num_output: 6 kernel_size: 3
          weight_filler { type: "gaussian" std: 0.05 }
          bias_filler { type: "constant" value: 0.1 } } }
layer { name: "relu1" type: "ReLU" bottom: "conv1" top: "conv1" }
layer { name: "norm1" type: "LRN" bottom: "conv1" top: "norm1"
        lrn_param { local_size: 5 alpha: 0.0001 beta: 0.75 } }
layer { name: "pool1" type: "Pooling" bottom: "norm1" top: "pool1"
        pooling_param { pool: MAX kernel_size: 2 stride: 2 } }
layer { name: "fc" type: "InnerProduct" bottom: "pool1" top: "fc"
        inner_product_param { num_output: 7
          weight_filler { type: "gaussian" std: 0.05 } } }
layer { name: "prob" type: "Softmax" bottom: "fc" top: "prob" }
"""
BUCKETS = "1,4"
# the Classifier recipe of chip_smoke.py: BGR, 0..255, mean-subtracted
PRE = dict(mean=np.array([104.0, 117.0, 123.0], np.float32),
           raw_scale=255.0, channel_swap=(2, 1, 0))


def write_deploy(d, seed=3, text=DEPLOY, name="deploy"):
    """The deploy prototxt and a .caffemodel of seeded weights (the port's
    Net init, written by the JAX package's writer)."""
    from caffe_mpi_tpu import io as jax_io
    model = d / f"{name}.prototxt"
    model.write_text(text)
    net = Net(NetParameter.from_file(str(model)), device="cpu")
    net.init(seed)
    weights = str(d / f"{name}_{seed}.caffemodel")
    jax_io.save_caffemodel(weights, net.export_weights())
    return str(model), weights


def encode(img, fmt, **kw):
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, fmt, **kw)
    return buf.getvalue()


def png(seed, hw=(20, 24)):
    rng = np.random.RandomState(seed)
    return encode(rng.randint(0, 256, (*hw, 3), np.uint8), "PNG")


def jpeg(seed, hw=(20, 24), quality=90):
    rng = np.random.RandomState(seed)
    return encode(rng.randint(0, 256, (*hw, 3), np.uint8), "JPEG",
                  quality=quality)


def pil_chw(data):
    from PIL import Image
    img = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    return img[:, :, ::-1].transpose(2, 0, 1)


@pytest.fixture(autouse=True)
def clean_decode(monkeypatch):
    monkeypatch.delenv("CAFFE_NATIVE_DECODE", raising=False)
    pdecode.STATS.reset()
    jdecode.STATS.reset()


@pytest.fixture(scope="module")
def deploy(tmp_path_factory):
    return write_deploy(tmp_path_factory.mktemp("serve_ingest"))


def engines(deploy, pre=PRE, start=True, **kw):
    model, weights = deploy
    peng = ServingEngine(device="cpu", buckets=BUCKETS, start=start, **kw)
    jeng = JaxEngine(buckets=BUCKETS, start=start, **kw)
    pm = peng.load_model("m", model, weights, **pre)
    jm = jeng.load_model("m", model, weights, **pre)
    return peng, jeng, pm, jm


# -- decode -------------------------------------------------------------------

@pytest.mark.parametrize("hw", [(19, 23), (67, 80)])
def test_png_decode_is_bitwise_pil_and_the_jax_ingest(hw):
    data = png(1, hw)
    peng = ServingEngine(device="cpu", start=False)
    jeng = JaxEngine(start=False)
    try:
        got = peng.decode_request(data)
        np.testing.assert_array_equal(got, jeng.decode_request(data))
        np.testing.assert_array_equal(got, pil_chw(data))
        assert pdecode.STATS.snapshot()["native_records"] == 1
        assert jdecode.STATS.snapshot()["native_records"] == 1
    finally:
        peng.close()
        jeng.close()


@pytest.mark.parametrize("quality", [90, 60])
def test_jpeg_decode_within_one_lsb_of_the_jax_ingest(quality):
    data = jpeg(2, (21, 17), quality)
    peng = ServingEngine(device="cpu", start=False)
    jeng = JaxEngine(start=False)
    try:
        got = peng.decode_request(data).astype(np.int16)
        want = jeng.decode_request(data).astype(np.int16)
        assert got.shape == want.shape == (3, 21, 17)
        assert np.abs(got - want).max() <= 1
        assert np.abs(got - pil_chw(data).astype(np.int16)).max() <= 1
    finally:
        peng.close()
        jeng.close()


# -- window-fused preprocess ---------------------------------------------------

@pytest.mark.parametrize("pre", [
    PRE, dict(PRE, image_dims=(20, 22)), dict(input_scale=0.5),
    dict(PRE, raw_scale=1.0, channel_swap=None)],
    ids=["classifier", "image_dims", "input_scale", "no_swap"])
def test_fused_rows_are_bitwise_the_jax_rows_and_the_classic_chain(
        deploy, pre):
    pre = {k: v for k, v in pre.items() if v is not None}
    peng, jeng, pm, jm = engines(deploy, pre, start=False)
    try:
        assert pingest.fused_engaged(pm) and jingest.fused_engaged(jm)
        raws = [peng.decode_request(png(s, hw)) for s, hw in
                enumerate([(16, 16), (20, 24), (40, 31), (9, 12)])]
        rows, errs = pingest.preprocess_rows(pm, raws, peng.ingest)
        jrows, jerrs = jingest.preprocess_rows(jm, raws, jeng.ingest)
        assert errs == jerrs == [None] * 4
        for r, j, raw in zip(rows, jrows, raws):
            assert r.shape == (3, 16, 16) and r.dtype == np.float32
            np.testing.assert_array_equal(r, j)
            np.testing.assert_array_equal(
                r, pm.preprocess(pdecode.to_float_image(raw)))
        for key in ("fused_batches", "fused_rows", "fused_fallback_rows"):
            assert peng.ingest.stats()[key] == jeng.ingest.stats()[key], key
        assert peng.ingest.stats()["fused_rows"] == 4
    finally:
        peng.close()
        jeng.close()


def test_full_image_mean_declines_the_fused_plan_as_jax(deploy):
    mean = np.full((3, 16, 16), 100.0, np.float32)
    peng, jeng, pm, jm = engines(deploy, dict(mean=mean), start=False)
    try:
        assert pm.ingest_plan is None and jm.ingest_plan is None
        raws = [peng.decode_request(png(0, (16, 16)))]
        rows, _ = pingest.preprocess_rows(pm, raws, peng.ingest)
        jrows, _ = jingest.preprocess_rows(jm, raws, jeng.ingest)
        np.testing.assert_array_equal(rows[0], jrows[0])
        assert peng.ingest.stats()["fused_fallback_rows"] == \
            jeng.ingest.stats()["fused_fallback_rows"] == 1
    finally:
        peng.close()
        jeng.close()


# -- the decoded cache ---------------------------------------------------------

@pytest.mark.parametrize("cache_mb", [1.0, 0.006])
def test_cache_hits_and_decode_calls_equal_the_jax_engine(cache_mb):
    a, b, c = png(10, (24, 24)), png(11, (24, 24)), jpeg(12, (24, 24))
    trace = [a, b, a, a, c, b, a, c, c, b]
    peng = ServingEngine(device="cpu", start=False, decoded_cache_mb=cache_mb)
    jeng = JaxEngine(start=False, decoded_cache_mb=cache_mb)
    try:
        for data in trace:
            got = peng.decode_request(data)
            want = jeng.decode_request(data)
            assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
        ps, js = peng.ingest.stats(), jeng.ingest.stats()
        for key in ("requests", "cache_hits", "cache_misses",
                    "cache_inserts", "cache_evictions", "cache_bytes"):
            assert ps[key] == js[key], key
        assert ps["decode_plane"]["decode_calls"] == \
            js["decode_plane"]["decode_calls"]
        if cache_mb == 1.0:
            assert ps["cache_hits"] == 7 and ps["cache_evictions"] == 0
            assert ps["decode_plane"]["decode_calls"] == 3
        else:
            assert ps["cache_evictions"] > 0
    finally:
        peng.close()
        jeng.close()


# -- declines ------------------------------------------------------------------

def _declined(kind):
    from PIL import Image
    rng = np.random.RandomState(5)
    buf = io.BytesIO()
    if kind == "cmyk_jpeg":
        Image.fromarray(rng.randint(0, 256, (18, 14, 4), np.uint8),
                        "CMYK").save(buf, "JPEG")
    elif kind == "alpha_png":
        Image.fromarray(rng.randint(0, 256, (18, 14, 4), np.uint8),
                        "RGBA").save(buf, "PNG")
    else:
        return png(5)[:40] + b"\x00" * 64  # a truncated PNG
    return buf.getvalue()


_PLANE_KEYS = ("native_records", "pil_records", "native_fallbacks",
               "decode_calls")


@pytest.mark.parametrize("kind", ["cmyk_jpeg", "alpha_png", "corrupt"])
def test_declines_take_the_jax_route_with_the_same_counters(kind):
    data = _declined(kind)
    peng = ServingEngine(device="cpu", start=False)
    jeng = JaxEngine(start=False)
    try:
        if kind == "corrupt":
            with pytest.raises(Exception):
                jeng.decode_request(data)
            with pytest.raises(Exception):
                peng.decode_request(data)
        else:
            got = peng.decode_request(data)
            np.testing.assert_array_equal(got, jeng.decode_request(data))
            np.testing.assert_array_equal(got, pil_chw(data))
        ps, js = pdecode.STATS.snapshot(), jdecode.STATS.snapshot()
        assert {k: ps[k] for k in _PLANE_KEYS} == \
            {k: js[k] for k in _PLANE_KEYS}
        assert ps["native_fallbacks"] == 1
    finally:
        peng.close()
        jeng.close()


# -- the request path ---------------------------------------------------------

UPLOADS = [png(20, (16, 16)), png(21, (30, 25)), png(22, (16, 16)),
           png(23, (50, 40)), png(24, (16, 20)), png(25, (64, 64))]


def _serve(eng, uploads):
    futs = [eng.submit_bytes("m", data) for data in uploads]
    rows = np.stack([f.result(timeout=120) for f in futs])
    eng.drain()
    return rows


@pytest.mark.parametrize("native", ["auto", "0"])
def test_uploads_score_as_the_jax_engine_on_the_same_ingest_route(
        deploy, monkeypatch, native):
    if native == "0":
        monkeypatch.setenv("CAFFE_NATIVE_DECODE", "0")
    peng, jeng, pm, jm = engines(deploy, window_ms=20)
    try:
        rows = _serve(peng, UPLOADS)
        want = _serve(jeng, UPLOADS)
        np.testing.assert_allclose(rows, want, rtol=0, atol=1e-4)
        ps, js = peng.stats()["ingest"], jeng.stats()["ingest"]
        for key in ("requests", "deferred_rows", "immediate_rows",
                    "fused_rows", "fused_fallback_rows"):
            assert ps[key] == js[key], key
        if native == "0":
            assert ps["immediate_rows"] == len(UPLOADS)
            assert ps["decode_plane"]["pil_records"] == len(UPLOADS)
        else:
            assert ps["deferred_rows"] == ps["fused_rows"] == len(UPLOADS)
        # the port's own per-request chain gives the same rows
        classic = peng.classify("m", [
            pdecode.to_float_image(pil_chw(d)) for d in UPLOADS])
        np.testing.assert_allclose(rows, classic, rtol=0, atol=1e-6)
        st = peng.stats()
        assert st["compile_count"] == st["warmed_buckets"] == 2
    finally:
        peng.close()
        jeng.close()


def test_a_bad_record_fails_only_its_own_future(deploy):
    peng, jeng, pm, _ = engines(deploy, window_ms=50)
    jeng.close()
    try:
        good = peng.decode_request(png(30))
        bad = np.zeros((4, 10, 10), np.uint8)  # not a 3-plane image
        futs = [peng.submit_raw("m", good), peng.submit_raw("m", bad),
                peng.submit_raw("m", good)]
        assert futs[0].result(60).shape == (7,)
        with pytest.raises(Exception):
            futs[1].result(60)
        np.testing.assert_array_equal(futs[0].result(), futs[2].result())
    finally:
        peng.close()
