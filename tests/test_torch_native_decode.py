"""Port parity: the native decode plane (csrc/native/decode.cc,
data/decode.py) and fused ingestion against the JAX package's, on the CPU.

The contract of the JAX package's tests/test_native_decode.py holds: PNG
decode is bitwise PIL's (a lossless format), JPEG within 1 LSB of PIL's
(IDCTs may differ between libjpeg builds); and the port is bitwise the
JAX native library on the same system libjpeg/libpng. The fused
decode-and-transform call, the fused Feeder in both staging modes, the
decode counters and the two dataset caches are held against the JAX
package's, bitwise. Records are tiny (3x16x16 to 3x32x32).
"""

import io
import json

import numpy as np
import pytest

from caffe_mpi_tpu.data import datasets as jds
from caffe_mpi_tpu.data import decode as jdecode
from caffe_mpi_tpu.data import feeder as jfeeder
from caffe_mpi_tpu.data.transformer import DataTransformer as JaxTF
from caffe_mpi_tpu_torch import native
from caffe_mpi_tpu_torch.data import datasets as pds
from caffe_mpi_tpu_torch.data import decode as pdecode
from caffe_mpi_tpu_torch.data import feeder as pfeeder
from caffe_mpi_tpu_torch.data import lmdb_io as plmdb
from caffe_mpi_tpu_torch.data.transformer import DataTransformer
from test_torch_data import TRANSFORMS, _items, _records, _tp, close_jax
from test_torch_native import jax_native  # noqa: F401 (a fixture)

# the JAX Feeder decodes natively only with its library loaded
pytestmark = pytest.mark.usefixtures("jax_native")


@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    monkeypatch.delenv("CAFFE_NATIVE_DECODE", raising=False)
    pdecode.STATS.reset()
    jdecode.STATS.reset()


def _pil_chw(data):
    from PIL import Image
    img = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    return img[:, :, ::-1].transpose(2, 0, 1)


def _encode(arr, fmt, mode=None, **kw):
    from PIL import Image
    img = Image.fromarray(arr) if mode is None else Image.fromarray(arr,
                                                                    mode)
    b = io.BytesIO()
    img.save(b, fmt, **kw)
    return b.getvalue()


def _rgb(shape, seed=0):
    return np.random.RandomState(seed).randint(0, 256, shape).astype(
        np.uint8)


# -- decode -------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["rgb", "gray", "palette"])
@pytest.mark.parametrize("hw", [(16, 16), (33, 47)])
def test_png_is_bitwise_pil_and_the_jax_librarys(jax_native, kind, hw):
    from PIL import Image
    if kind == "rgb":
        data = _encode(_rgb((*hw, 3)), "PNG")
    elif kind == "gray":
        data = _encode(_rgb(hw), "PNG")
    else:
        img = Image.fromarray(_rgb((*hw, 3))).convert("P")
        b = io.BytesIO()
        img.save(b, "PNG")
        data = b.getvalue()
    assert native.decode_probe(data) == jax_native.decode_probe(data) == hw
    got = native.decode_image_native(data)
    np.testing.assert_array_equal(got, _pil_chw(data))
    np.testing.assert_array_equal(got, jax_native.decode_image_native(data))


@pytest.mark.parametrize("quality", [75, 95])
@pytest.mark.parametrize("gray", [False, True])
def test_jpeg_is_within_one_lsb_of_pil_and_bitwise_the_jax_librarys(
        jax_native, quality, gray):
    arr = _rgb((24, 40) if gray else (24, 40, 3), seed=quality)
    data = _encode(arr, "JPEG", quality=quality)
    got = native.decode_image_native(data)
    assert got.shape == (3, 24, 40)
    diff = np.abs(got.astype(np.int16) - _pil_chw(data).astype(np.int16))
    assert diff.max() <= 1
    np.testing.assert_array_equal(got, jax_native.decode_image_native(data))


@pytest.mark.parametrize("kind", ["cmyk", "rgba", "png16", "gif", "junk"])
def test_what_the_decoder_declines_goes_to_pil_as_in_jax(jax_native, kind):
    """CMYK JPEGs, alpha and 16-bit PNGs and other formats are declined
    (None) and decode_image gives PIL's pixels, counted as a fallback;
    junk bytes raise PIL's error."""
    from PIL import Image
    if kind == "cmyk":
        data = _encode(_rgb((12, 12, 4)), "JPEG", mode="CMYK")
    elif kind == "rgba":
        data = _encode(_rgb((12, 12, 4)), "PNG", mode="RGBA")
    elif kind == "png16":
        img = Image.fromarray(
            np.random.RandomState(1).randint(0, 65535, (12, 12)).astype(
                np.uint16))
        b = io.BytesIO()
        img.save(b, "PNG")
        data = b.getvalue()
    elif kind == "gif":
        data = _encode(_rgb((12, 12, 3)), "GIF")
    else:
        data = b"\xff\xd8\xff" + bytes(64)
    assert native.decode_image_native(data) is None
    assert jax_native.decode_image_native(data) is None
    if kind == "junk":
        with pytest.raises(Exception):
            pdecode.decode_image(data)
        return
    np.testing.assert_array_equal(pdecode.decode_image(data),
                                  jdecode.decode_image(data))
    snap = pdecode.STATS.snapshot()
    assert snap["native_fallbacks"] == 1 and snap["pil_records"] == 1
    assert snap == jdecode.STATS.snapshot()


def test_the_policy_follows_caffe_native_decode(monkeypatch):
    data = _encode(_rgb((16, 16, 3)), "PNG")
    assert pdecode.native_mode() == 0 and pdecode.native_enabled()
    pdecode.decode_image(data)
    assert pdecode.STATS.snapshot()["native_records"] == 1
    monkeypatch.setenv("CAFFE_NATIVE_DECODE", "0")
    assert pdecode.native_mode() == -1 and not pdecode.native_enabled()
    pdecode.decode_image(data)
    assert pdecode.STATS.snapshot()["pil_records"] == 1
    monkeypatch.setenv("CAFFE_NATIVE_DECODE", "1")
    assert pdecode.native_mode() == 1 and pdecode.native_enabled()
    monkeypatch.setattr(native, "decode_available", lambda: False)
    with pytest.raises(RuntimeError, match="without libjpeg/libpng"):
        pdecode.native_enabled()
    monkeypatch.delenv("CAFFE_NATIVE_DECODE")
    assert not pdecode.native_enabled()  # auto: PIL where no codecs


def test_decode_resize_is_the_jax_librarys(jax_native):
    data = _encode(_rgb((20, 30, 3)), "PNG")
    for oh, ow in ((20, 30), (10, 12), (41, 33)):
        np.testing.assert_array_equal(
            native.decode_resize_native(data, oh, ow),
            jax_native.decode_resize_native(data, oh, ow))


# -- fused decode and transform -----------------------------------------------

@pytest.mark.parametrize("phase", ["TRAIN", "TEST"])
@pytest.mark.parametrize("spec", [TRANSFORMS[2], TRANSFORMS[6],
                                  TRANSFORMS[8]])
def test_decode_transform_batch_is_bitwise_the_jax_librarys(jax_native,
                                                            spec, phase):
    imgs, _ = _records(6, (3, 32, 32), seed=5)
    bufs = [_encode(np.ascontiguousarray(i[::-1].transpose(1, 2, 0)),
                    "JPEG" if k % 2 else "PNG") for k, i in enumerate(imgs)]
    tp, _ = _tp(spec, "")
    tf = DataTransformer(tp, phase)
    crop = tp.crop_size
    mean = None if tf.mean is None else np.resize(tf.mean.reshape(-1), 3)
    kw = dict(crop=crop, mean=mean, scale=tp.scale, train=phase == "TRAIN",
              mirror=tp.mirror, seed=tf.seed or 0, out_h=crop, out_w=crop)
    ids = np.arange(50, 56)
    outs, decs, sts = [], [], []
    for lib, threads in ((native, 3), (jax_native, 1)):
        out = np.full((6, 3, crop, crop), -1.0, np.float32)
        dec = [np.zeros((3, 32, 32), np.uint8) for _ in range(6)]
        sts.append(lib.decode_transform_batch(
            bufs, ids, out=out, decoded_out=dec, num_threads=threads, **kw))
        outs.append(out)
        decs.append(dec)
    assert sts[0].tolist() == sts[1].tolist() == [native.DECODE_OK] * 6
    np.testing.assert_array_equal(outs[0], outs[1])
    for a, b in zip(*decs):
        np.testing.assert_array_equal(a, b)
    # fused = decode, then the batch transform of the same pixels
    again = native.transform_batch(np.stack(decs[0]), ids, crop=crop,
                                   mean=mean, scale=tp.scale,
                                   train=phase == "TRAIN", mirror=tp.mirror,
                                   seed=tf.seed or 0)
    np.testing.assert_array_equal(outs[0], again)


def _jpeg_db(tmp_path, n=20, shape=(3, 32, 32), codec="jpeg", bad=()):
    imgs, labels = _records(n, shape, seed=8)
    items = _items(imgs, labels, lambda a, l: pds.encode_datum_image(
        a, l, codec))
    for i in bad:  # an undecodable payload under a valid crc32c
        items[i] = (items[i][0], pds.encode_datum_image(
            imgs[i], int(labels[i]), codec)[:-60] + bytes(60))
    path = str(tmp_path / f"{codec}_db")
    plmdb.write_lmdb(path, items)
    return path


@pytest.mark.parametrize("device", [False, True])
@pytest.mark.parametrize("codec", ["jpeg", "png"])
def test_fused_feeder_is_bitwise_the_jax_fused_feeder(tmp_path, jax_native,
                                                      device, codec):
    """A JPEG or PNG LMDB through both Feeders' fused native ingestion:
    decode and transform in one call (host transform, mean values), or
    decode into the staging stack (device transform): iterations 0..4 of
    batch 6, shuffle on, and the same decode counts."""
    db = _jpeg_db(tmp_path, codec=codec)
    spec = TRANSFORMS[2] if device else TRANSFORMS[6]
    tp, jtp = _tp(spec, "")
    kw = dict(shuffle=True, seed=3, threads=2, device_transform=device)
    port = pfeeder.Feeder(pds.open_dataset("LMDB", db),
                          DataTransformer(tp, "TRAIN"), 6, **kw)
    jax = jfeeder.Feeder(jds.open_dataset("LMDB", db),
                         JaxTF(jtp, "TRAIN"), 6, **kw)
    try:
        for it in range(5):  # no prefetch: the decode counts are exact
            got = port._build_batch_inner(it)
            want = jax._build_batch_inner(it)
            assert list(got) == list(want)
            for key in want:
                np.testing.assert_array_equal(got[key], want[key],
                                              err_msg=f"{key} it {it}")
        assert port._fused_ok and jax._fused_ok
    finally:
        port.close()
        close_jax(jax)
    snap = pdecode.STATS.snapshot()
    assert snap["fused_records"] >= 30 and snap["pil_records"] == 0
    assert snap == jdecode.STATS.snapshot()


def test_fused_feeder_falls_back_to_pil_and_quarantine_as_jax(tmp_path,
                                                               jax_native):
    """Records the fused call cannot decode go through the classic read:
    the undecodable ones quarantine, as the JAX Feeder's do."""
    db = _jpeg_db(tmp_path, bad=(3, 11))
    tp, jtp = _tp(TRANSFORMS[6], "")
    port = pfeeder.Feeder(pds.open_dataset("LMDB", db),
                          DataTransformer(tp, "TRAIN"), 5, threads=1)
    jax = jfeeder.Feeder(jds.open_dataset("LMDB", db), JaxTF(jtp, "TRAIN"),
                         5, threads=1)
    for it in range(4):
        got, want = port(it), jax(it)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key])
    assert port._sub_cache == jax._sub_cache
    port.close()
    close_jax(jax)


def test_pil_forced_feeder_is_the_jax_pil_feeder(tmp_path, monkeypatch):
    monkeypatch.setenv("CAFFE_NATIVE_DECODE", "0")
    db = _jpeg_db(tmp_path)
    tp, jtp = _tp(TRANSFORMS[6], "")
    port = pfeeder.Feeder(pds.open_dataset("LMDB", db),
                          DataTransformer(tp, "TRAIN"), 4, threads=1)
    jax = jfeeder.Feeder(jds.open_dataset("LMDB", db), JaxTF(jtp, "TRAIN"),
                         4, threads=1)
    for it in range(3):
        np.testing.assert_array_equal(port._build_batch_inner(it)["data"],
                                      jax._build_batch_inner(it)["data"])
    port.close()
    close_jax(jax)
    snap = pdecode.STATS.snapshot()
    assert snap["pil_records"] == 12 and snap["fused_records"] == 0
    assert snap == jdecode.STATS.snapshot()


# -- the caches -----------------------------------------------------------------

@pytest.mark.parametrize("device", [False, True])
def test_decoded_cache_hits_the_second_epoch_as_jax(tmp_path, device):
    """A 20-record JPEG LMDB at batch 5: epoch 1 (iterations 0-3) decodes
    and fills the cache, epoch 2 decodes nothing; batches and counts are
    the JAX Feeder's over its DecodedCacheDataset."""
    db = _jpeg_db(tmp_path)
    tp, jtp = _tp(TRANSFORMS[2], "")
    kw = dict(threads=1, device_transform=device)
    port = pfeeder.Feeder(pds.DecodedCacheDataset(
        pds.open_dataset("LMDB", db), 64.0), DataTransformer(tp, "TRAIN"),
        5, **kw)
    jax = jfeeder.Feeder(jds.DecodedCacheDataset(
        jds.open_dataset("LMDB", db), 64.0), JaxTF(jtp, "TRAIN"), 5, **kw)
    for it in range(4):  # no prefetch: the counts are exact
        got = port._build_batch_inner(it)
        for key, v in jax._build_batch_inner(it).items():
            np.testing.assert_array_equal(got[key], v)
    first = pdecode.STATS.snapshot()
    assert first == jdecode.STATS.snapshot()
    assert first["cache_inserts"] == 20
    pdecode.STATS.reset()
    jdecode.STATS.reset()
    for it in range(4, 8):
        got = port._build_batch_inner(it)
        for key, v in jax._build_batch_inner(it).items():
            np.testing.assert_array_equal(got[key], v)
    second = pdecode.STATS.snapshot()
    assert second["cache_hits"] == 20 and second["decode_calls"] == 0
    assert second == jdecode.STATS.snapshot()
    port.close()
    close_jax(jax)


def test_decoded_cache_budget_admits_first_fit(tmp_path):
    db = _jpeg_db(tmp_path)
    per = 3 * 32 * 32
    ds = pds.DecodedCacheDataset(pds.open_dataset("LMDB", db),
                                 (2.5 * per) / 2**20)
    jd = jds.DecodedCacheDataset(jds.open_dataset("LMDB", db),
                                 (2.5 * per) / 2**20)
    for i in range(5):
        np.testing.assert_array_equal(ds.get(i)[0], jd.get(i)[0])
    assert sorted(ds._cache) == sorted(jd._cache) == [0, 1]
    assert not ds.admitting() and not jd.admitting()
    assert ds.lookup(1) is not None and ds.lookup(2) is None
    with pytest.raises(ValueError):
        ds.get(0)[0][0, 0, 0] = 1  # cached arrays are read-only


def test_cached_dataset_is_the_jax_one(tmp_path):
    imgs, labels = _records(12, (3, 16, 16))
    path = str(tmp_path / "db")
    plmdb.write_lmdb(path, _items(imgs, labels))
    ds = pds.CachedDataset(pds.open_dataset("LMDB", path))
    jd = jds.CachedDataset(jds.open_dataset("LMDB", path))
    assert len(ds) == len(jd) == 12
    for i in range(12):
        (a, la), (b, lb) = ds.get(i), jd.get(i)
        np.testing.assert_array_equal(a, b)
        assert la == lb
    tp, jtp = _tp(TRANSFORMS[3], "")
    port = pfeeder.Feeder(ds, DataTransformer(tp, "TEST"), 4, threads=1)
    jax = jfeeder.Feeder(jd, JaxTF(jtp, "TEST"), 4, threads=1)
    for it in range(4):
        np.testing.assert_array_equal(port(it)["data"], jax(it)["data"])
    port.close()
    close_jax(jax)


# -- tools/bench_data -------------------------------------------------------------

def test_bench_data_measures_both_backends_and_the_ingest(capsys):
    from caffe_mpi_tpu_torch.tools import bench_data
    assert bench_data.main(["-n", "32", "-batch", "8", "-shape", "3x20x20",
                            "-crop", "16", "-threads", "0,1", "--json",
                            "--ingest-n", "16"]) == 0
    doc = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [(r["backend"], r["auto"]) for r in doc["backends"]] == [
        ("lmdb", True), ("lmdb", False), ("datumfile", True),
        ("datumfile", False)]
    assert all(r["img_s"] > 0 and r["gather_ms_per_batch"] > 0
               for r in doc["backends"])
    ing = doc["ingest"]
    assert set(ing["stages_ms_per_batch"]) == {
        "read", "crc", "decode_pil", "decode_native", "transform",
        "assemble"}
    assert ing["native_decode_available"] and ing["fused_records"] > 0
    assert ing["cache_epoch2_decodes"] == 0 and ing["cached_img_s"] > 0
    with pytest.raises(NotImplementedError, match=r"ROADMAP\.md §1 item 3"):
        bench_data.main(["-backends", "hdf5", "--no-ingest"])
    # leveldb (ported): the pure-Python reader, no native gather
    assert bench_data.main(["-n", "16", "-batch", "8", "-shape", "3x12x12",
                            "-crop", "8", "-threads", "1", "-backends",
                            "leveldb", "--json", "--no-ingest"]) == 0
    doc = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    (row,) = doc["backends"]
    assert row["backend"] == "leveldb" and row["img_s"] > 0
    assert row["gather_ms_per_batch"] is None
