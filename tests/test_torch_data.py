"""Port parity: the data plane (caffe_mpi_tpu_torch/data/) against the JAX
package's (caffe_mpi_tpu/data/), on the CPU, at small sizes (24-64 records
of 3x32x32 or 1x28x28, in tmp_path).

Every comparison is exact: the Datum codec and the LMDB files byte for
byte (the JAX writer is deterministic), the crc32c values as integers,
the host transform, the device transform (the port's torch version on
the CPU against JAX's and against the host's: float32 subtract and scale
in the same order, a mirror that only permutes) and the feeders' batches
bitwise.
"""

import filecmp
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caffe_mpi_tpu.data import datasets as jds
from caffe_mpi_tpu.data import device_transform as jdt
from caffe_mpi_tpu.data import feeder as jfeeder
from caffe_mpi_tpu.data import lmdb_io as jlmdb
from caffe_mpi_tpu.data.decode import _pil_decode as jax_pil_decode
from caffe_mpi_tpu.data.decode import to_float_image as jax_to_float
from caffe_mpi_tpu.data.leveldb_io import crc32c as jax_crc32c
from caffe_mpi_tpu.data.transformer import DataTransformer as JaxTF
from caffe_mpi_tpu.io import save_blob_binaryproto as jax_save_blob
from caffe_mpi_tpu.proto import LayerParameter as JaxLP
from caffe_mpi_tpu.proto.config import TransformationParameter as JaxTP
from caffe_mpi_tpu_torch.data import datasets as pds
from caffe_mpi_tpu_torch.data import decode as pdecode
from caffe_mpi_tpu_torch.data import device_transform as pdt
from caffe_mpi_tpu_torch.data import feeder as pfeeder
from caffe_mpi_tpu_torch.data import lmdb_io as plmdb
from caffe_mpi_tpu_torch.data.transformer import DataTransformer
from caffe_mpi_tpu_torch.proto import LayerParameter
from caffe_mpi_tpu_torch.proto.config import TransformationParameter

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _records(n, shape, seed=0):
    r = np.random.RandomState(seed)
    return (r.randint(0, 256, (n, *shape)).astype(np.uint8),
            r.randint(0, 10, n))


def _items(imgs, labels, encode=pds.encode_datum):
    return [(f"{i:08d}".encode(), encode(imgs[i], int(labels[i])))
            for i in range(len(imgs))]


# -- the Datum codec ----------------------------------------------------------

@pytest.mark.parametrize("kind", ["raw", "float", "jpeg", "png"])
def test_datum_codec_is_bytes_equal_both_ways(kind):
    imgs, labels = _records(4, (3, 8, 6))
    for img, label in zip(imgs, list(labels) + [-3]):
        if kind == "raw":
            got, want = pds.encode_datum(img, label), jds.encode_datum(
                img, label)
        elif kind == "float":
            f = img.astype(np.float32) / 7
            got, want = (pds.encode_datum_float(f, label),
                         jds.encode_datum_float(f, label))
        else:
            got = pds.encode_datum_image(img, label, kind)
            want = jds.encode_datum_image(img, label, kind)
        assert got == want
        assert pds.parse_datum_fields(want) == jds.parse_datum_fields(want)
        parr, plabel = pds.parse_datum(got)
        jarr, jlabel = jds.parse_datum(want)
        assert plabel == jlabel == label
        np.testing.assert_array_equal(parr, jarr)
        assert parr.dtype == jarr.dtype


def test_decode_matches_the_jax_pil_path():
    imgs, _ = _records(2, (3, 16, 12))
    for img in imgs:
        for codec in ("jpeg", "png"):
            data = pds.parse_datum_fields(
                pds.encode_datum_image(img, 0, codec)).data
            np.testing.assert_array_equal(pdecode.decode_image(data),
                                          jax_pil_decode(data))
        np.testing.assert_array_equal(pdecode.to_float_image(img),
                                      jax_to_float(img))


# -- crc32c -------------------------------------------------------------------

@pytest.mark.parametrize("n", [0, 1, 7, 1023, 1024, 1025, 3100, 196623])
def test_crc32c_equals_the_jax_crc32c(n):
    data = np.random.RandomState(n).bytes(n)
    assert plmdb.crc32c(data) == jax_crc32c(data)
    assert plmdb.crc32c(memoryview(data)) == jax_crc32c(data)


def test_crc32c_source_is_built_by_the_host_compiler():
    """csrc/crc32c.cc is host code: the host C++ compiler builds it (no
    nvcc here), into the hashed library that crc32c loads."""
    from caffe_mpi_tpu_torch.ops import build
    assert build._flags("crc32c.cc") == build.CXX_FLAGS
    data = np.random.RandomState(9).bytes(70001)
    assert plmdb.crc32c(data[1:]) == jax_crc32c(data[1:])  # unaligned
    assert os.path.isfile(build._lib_path("crc32c.cc"))


# -- LMDB ---------------------------------------------------------------------

@pytest.mark.parametrize("shape,encode", [((3, 32, 32), "raw"),
                                          ((1, 28, 28), "raw"),
                                          ((3, 32, 32), "jpeg")])
def test_lmdb_files_are_bytes_equal_and_read_both_ways(tmp_path, shape,
                                                       encode):
    imgs, labels = _records(40, shape)
    enc = pds.encode_datum if encode == "raw" else pds.encode_datum_image
    items = _items(imgs, labels, enc)
    port = plmdb.write_lmdb(str(tmp_path / "port"), items)
    jax = jlmdb.write_lmdb(str(tmp_path / "jax"), items)
    assert filecmp.cmp(port, jax, shallow=False)
    assert filecmp.cmp(port + ".crc32c", jax + ".crc32c", shallow=False)
    # streamed (ascending keys) as well as a sorted list
    streamed = plmdb.write_lmdb(str(tmp_path / "streamed"), iter(items))
    assert filecmp.cmp(streamed, jax, shallow=False)
    for writer, reader in ((port, jlmdb.LMDBReader),
                           (jax, plmdb.LMDBReader)):
        with reader(writer) as r:
            assert list(r.items()) == items
            assert r.get(items[17][0]) == items[17][1]
            assert r.get(b"missing") is None
    np.testing.assert_array_equal(
        plmdb.read_crc_sidecar(jax, expect_count=len(items)),
        jlmdb.read_crc_sidecar(port, expect_count=len(items)))
    ds, jd = pds.LMDBDataset(str(tmp_path / "jax")), \
        jds.LMDBDataset(str(tmp_path / "port"))
    assert len(ds) == len(jd) == len(items)
    for i in (0, 23, 39):
        (a, la), (b, lb) = ds.get(i), jd.get(i)
        assert la == lb == labels[i]
        np.testing.assert_array_equal(a, b)


def test_a_corrupt_record_raises_loudly(tmp_path):
    imgs, labels = _records(24, (3, 32, 32))
    path = plmdb.write_lmdb(str(tmp_path / "db"), _items(imgs, labels))
    raw = bytearray(open(path, "rb").read())
    needle = imgs[5].tobytes()[:64]
    at = bytes(raw).index(needle)
    raw[at + 10] ^= 0xFF  # one pixel of record 5
    with open(path, "wb") as f:
        f.write(raw)
    ds = pds.LMDBDataset(str(tmp_path / "db"))
    ds.get(4)
    with pytest.raises(pds.RecordIntegrityError, match="record 5: crc32c"):
        ds.get(5)


def test_datumfile_round_trips_against_jax(tmp_path):
    imgs, labels = _records(24, (1, 28, 28))
    bufs = [pds.encode_datum(i, int(l)) for i, l in zip(imgs, labels)]
    pds.DatumFileDataset.write(str(tmp_path / "p.df"), bufs)
    jds.DatumFileDataset.write(str(tmp_path / "j.df"), bufs)
    assert filecmp.cmp(tmp_path / "p.df", tmp_path / "j.df", shallow=False)
    ds = pds.DatumFileDataset(str(tmp_path / "j.df"))
    for i in (0, 11, 23):
        np.testing.assert_array_equal(ds.get(i)[0], imgs[i])


def test_synthetic_dataset_draws_what_jax_draws():
    a, b = pds.SyntheticDataset(12, seed=3), jds.SyntheticDataset(12, seed=3)
    for i in range(12):
        np.testing.assert_array_equal(a.get(i)[0], b.get(i)[0])
        assert a.get(i)[1] == b.get(i)[1]


# -- the host transform -------------------------------------------------------

def _mean_file(tmp_path, shape, seed=9):
    mean = (np.random.RandomState(seed).rand(1, *shape) * 255).astype(
        np.float32)
    path = str(tmp_path / "mean.binaryproto")
    jax_save_blob(path, mean)
    return path


TRANSFORMS = [
    "",
    "crop_size: 24",
    "crop_size: 24 mirror: true",
    "mirror: true scale: 0.00390625",
    "crop_size: 20 mirror: true mean_file: MEAN",
    "mean_file: MEAN scale: 0.5",
    "crop_size: 24 mirror: true mean_value: 104 mean_value: 117 "
    "mean_value: 123 scale: 0.017",
    "crop_size: 28 mean_value: 33",
    "crop_size: 16 mirror: true random_seed: 5 scale: 0.25",
]


def _tp(spec, mean):
    text = spec.replace("MEAN", f'"{mean}"')
    return TransformationParameter.from_text(text), JaxTP.from_text(text)


@pytest.mark.parametrize("phase", ["TRAIN", "TEST"])
@pytest.mark.parametrize("spec", TRANSFORMS)
def test_host_transform_is_bitwise_the_jax_one(tmp_path, spec, phase):
    shape = (1, 28, 28) if "mean_value: 33" in spec else (3, 32, 32)
    imgs, _ = _records(6, shape)
    tp, jtp = _tp(spec, _mean_file(tmp_path, shape))
    tf, jtf = DataTransformer(tp, phase), JaxTF(jtp, phase)
    for i, img in enumerate(imgs):
        got = tf(img, rng=tf.record_rng(100 + i))
        want = jtf(img, rng=jtf.record_rng(100 + i))
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    assert tf.output_shape(shape) == jtf.output_shape(shape)


@pytest.mark.parametrize("phase", ["TRAIN", "TEST"])
@pytest.mark.parametrize("spec", TRANSFORMS)
def test_device_transform_is_bitwise_jax_and_the_host(tmp_path, spec, phase):
    shape = (1, 28, 28) if "mean_value: 33" in spec else (3, 32, 32)
    imgs, _ = _records(8, shape, seed=2)
    tp, jtp = _tp(spec, _mean_file(tmp_path, shape))
    tf, jtf = DataTransformer(tp, phase), JaxTF(jtp, phase)
    flats = list(range(40, 48))
    aug = pdt.compute_aug(tf, flats, shape[-2:], len(imgs))
    np.testing.assert_array_equal(
        aug, jdt.compute_aug(jtf, flats, shape[-2:], len(imgs)))
    kw = dict(crop=tp.crop_size, scale=tp.scale)
    got = pdt.device_transform(
        torch.from_numpy(imgs), torch.from_numpy(aug),
        mean=None if tf.mean is None else torch.from_numpy(tf.mean), **kw)
    want = jdt.device_transform(jnp.asarray(imgs), jnp.asarray(aug),
                                mean=jtf.mean, **kw)
    host = np.stack([tf(img, rng=tf.record_rng(f))
                     for img, f in zip(imgs, flats)])
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), host)


@pytest.mark.parametrize("text,want", [
    ("", True), ("transform_param { use_gpu_transform: false }", False),
    ("transform_param { use_gpu_transform: true crop_size: 3 }", True),
    ("transform_param { force_gray: true }", False),
    ("transform_param { force_color: true use_gpu_transform: true }", False),
])
def test_wants_device_transform_as_jax(text, want):
    body = f'name: "d" type: "Data" top: "data" {text}'
    assert pdt.wants_device_transform(LayerParameter.from_text(body)) is want
    assert jdt.wants_device_transform(JaxLP.from_text(body)) is want


# -- the feeder ---------------------------------------------------------------

def _db(tmp_path, n, shape, name="db"):
    imgs, labels = _records(n, shape, seed=len(name))
    plmdb.write_lmdb(str(tmp_path / name), _items(imgs, labels))
    return str(tmp_path / name)


@pytest.mark.parametrize("device", [False, True])
@pytest.mark.parametrize("rank", [0, 1])
@pytest.mark.parametrize("spec", [TRANSFORMS[4], TRANSFORMS[3]])
def test_feeder_batches_are_bitwise_the_jax_feeders(tmp_path, spec, rank,
                                                    device):
    """Iterations 0..5 of batch 5 at world 2 over 24 records, shuffle on:
    the epoch boundary falls inside iteration 2. The JAX Feeder runs its
    classic path: where its native library is built it would transform on
    the host in C++, whose TRAIN crops and mirrors are drawn otherwise
    than its Python path's per-record Philox streams (which its device
    transform and the port both use)."""
    shape = (3, 32, 32)
    db = _db(tmp_path, 24, shape)
    tp, jtp = _tp(spec, _mean_file(tmp_path, shape))
    kw = dict(rank=rank, world=2, shuffle=True, seed=4, threads=2,
              device_transform=device)
    port = pfeeder.Feeder(pds.open_dataset("LMDB", db),
                          DataTransformer(tp, "TRAIN"), 5, **kw)
    jax = jfeeder.Feeder(jds.open_dataset("LMDB", db),
                         JaxTF(jtp, "TRAIN"), 5, **kw)
    jax._native = False  # the classic path
    try:
        for it in range(6):
            got, want = port(it), jax(it)
            assert list(got) == list(want)
            for key in want:
                assert got[key].dtype == want[key].dtype, key
                np.testing.assert_array_equal(got[key], want[key],
                                              err_msg=f"{key} it {it}")
        # a resumed feeder (a fresh one, asked for iteration 4 first)
        again = pfeeder.Feeder(pds.open_dataset("LMDB", db),
                               DataTransformer(tp, "TRAIN"), 5, **kw)
        for key, v in jax(4).items():
            np.testing.assert_array_equal(again(4)[key], v)
        again.close()
    finally:
        port.close()
        jax.close()
    assert port.feed_ms_per_batch() > 0


def test_default_threads_follow_the_kind_of_record(tmp_path):
    imgs, labels = _records(8, (3, 16, 16))
    for name, enc in (("raw", pds.encode_datum),
                      ("jpeg", pds.encode_datum_image)):
        plmdb.write_lmdb(str(tmp_path / name), _items(imgs, labels, enc))
    raw = pds.open_dataset("LMDB", str(tmp_path / "raw"))
    jpeg = pds.open_dataset("LMDB", str(tmp_path / "jpeg"))
    assert not raw.encoded and jpeg.encoded
    for ds, want in ((raw, pfeeder.DEFAULT_THREADS),
                     (jpeg, pfeeder.ENCODED_THREADS)):
        feeder = pfeeder.Feeder(ds, None, 4)
        assert feeder.threads == want
        feeder.close()
        feeder = pfeeder.Feeder(ds, None, 4, threads=3)
        assert feeder.threads == 3
        feeder.close()


def test_device_feed_on_the_cpu_gives_the_feeders_batches(tmp_path):
    db = _db(tmp_path, 24, (1, 28, 28))
    tp = TransformationParameter.from_text("scale: 0.00390625")
    feeder = pfeeder.Feeder(pds.open_dataset("LMDB", db),
                            DataTransformer(tp, "TEST"), 6,
                            device_transform=True, threads=1)
    ref = pfeeder.Feeder(pds.open_dataset("LMDB", db),
                         DataTransformer(tp, "TEST"), 6,
                         device_transform=True, threads=1)
    feed = pfeeder.DeviceFeed(feeder, torch.device("cpu"))
    try:
        for it in (0, 1, 2, 0, 5):  # a restart at 0 drops the prefetch
            got = feed(it)
            for key, v in ref(it).items():
                assert got[key].device.type == "cpu"
                np.testing.assert_array_equal(got[key].numpy(), v)
    finally:
        feed.close()
        ref.close()


# -- the Data layer and the probe ---------------------------------------------

def _data_layer_text(db, spec, batch=4, extra=""):
    return (f'name: "data" type: "Data" top: "data" top: "label" '
            f'transform_param {{ {spec} }} data_param {{ source: "{db}" '
            f'batch_size: {batch} backend: LMDB }} {extra}')


@pytest.mark.parametrize("spec", TRANSFORMS[:6])
@pytest.mark.parametrize("gpu", ["", "use_gpu_transform: false"])
def test_probe_and_feed_specs_match_jax(tmp_path, spec, gpu):
    from caffe_mpi_tpu.core.types import DtypePolicy as JaxPolicy
    from caffe_mpi_tpu.layers import create_layer as jax_create_layer
    from caffe_mpi_tpu_torch.core.types import DtypePolicy
    from caffe_mpi_tpu_torch.layers import create_layer
    db = _db(tmp_path, 24, (3, 32, 32))
    text = _data_layer_text(db, spec.replace(
        "MEAN", f'"{_mean_file(tmp_path, (3, 32, 32))}"') + " " + gpu)
    lp, jlp = LayerParameter.from_text(text), JaxLP.from_text(text)
    probe, jprobe = pfeeder.data_shape_probe(lp), \
        jfeeder.data_shape_probe(jlp)
    assert tuple(probe) == tuple(jprobe) and probe.raw == jprobe.raw
    layer = create_layer(lp, DtypePolicy(), "TRAIN", torch.device("cpu"))
    jl = jax_create_layer(jlp, JaxPolicy(), "TRAIN")
    layer.bound_shape, jl.bound_shape = probe, jprobe
    jl.model_dir = ""  # the JAX Net sets it on every layer
    layer.out_shapes = layer.setup([])
    jl.out_shapes = jl.setup([])
    assert layer.out_shapes == jl.out_shapes
    assert layer.dev_transform == jl.dev_transform == (gpu == "")
    assert layer.feed_specs() == [(k, tuple(s), kind) for k, s, kind
                                  in jl.feed_specs()]


def test_dummy_data_with_constant_fillers_matches_jax():
    from caffe_mpi_tpu.core.types import DtypePolicy as JaxPolicy
    from caffe_mpi_tpu.layers import create_layer as jax_create_layer
    from caffe_mpi_tpu_torch.core.types import DtypePolicy
    from caffe_mpi_tpu_torch.layers import create_layer
    text = ('name: "d" type: "DummyData" top: "a" top: "b" '
            'dummy_data_param { shape { dim: 2 dim: 3 dim: 4 } '
            'shape { dim: 2 } data_filler { type: "constant" value: 0.5 } '
            'data_filler { type: "constant" value: -2 } }')
    jl = jax_create_layer(JaxLP.from_text(text), JaxPolicy(), "TEST")
    jl.out_shapes = jl.setup([])
    layer = create_layer(LayerParameter.from_text(text), DtypePolicy(),
                         "TEST", torch.device("cpu"))
    layer.out_shapes = layer.setup([])
    assert layer.out_shapes == jl.out_shapes
    want, _ = jl.apply({}, {}, [], train=False, rng=None)
    got = layer([])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_dummy_data_legacy_shape_and_random_filler_shapes():
    from caffe_mpi_tpu_torch.core.types import DtypePolicy
    from caffe_mpi_tpu_torch.layers import create_layer
    text = ('name: "d" type: "DummyData" top: "a" dummy_data_param { '
            'num: 3 channels: 2 height: 4 width: 5 '
            'data_filler { type: "gaussian" std: 2 } }')
    layer = create_layer(LayerParameter.from_text(text), DtypePolicy(),
                         "TRAIN", torch.device("cpu"))
    layer.out_shapes = layer.setup([])
    (a,) = layer([])
    (b,) = layer([])
    assert a.shape == (3, 2, 4, 5) and not torch.equal(a, b)


def test_memory_data_matches_jax():
    from caffe_mpi_tpu.core.types import DtypePolicy as JaxPolicy
    from caffe_mpi_tpu.layers import create_layer as jax_create_layer
    from caffe_mpi_tpu_torch.core.types import DtypePolicy
    from caffe_mpi_tpu_torch.layers import create_layer
    text = ('name: "m" type: "MemoryData" top: "data" top: "label" '
            'memory_data_param { batch_size: 4 channels: 3 height: 5 '
            'width: 6 }')
    jl = jax_create_layer(JaxLP.from_text(text), JaxPolicy(), "TEST")
    jl.out_shapes = jl.setup([])
    layer = create_layer(LayerParameter.from_text(text), DtypePolicy(),
                         "TEST", torch.device("cpu"))
    layer.out_shapes = layer.setup([])
    assert layer.out_shapes == jl.out_shapes
    x = np.random.RandomState(0).randn(4, 3, 5, 6).astype(np.float32)
    y = np.arange(4, dtype=np.int32)
    feeds = {"data": x, "label": y}
    (wx, wy), _ = jl.apply({}, {}, jl.gather_feeds(
        {k: jnp.asarray(v) for k, v in feeds.items()}), train=False,
        rng=None)
    gx, gy = layer(layer.gather_feeds(
        {k: torch.from_numpy(v) for k, v in feeds.items()}))
    np.testing.assert_array_equal(gx.numpy(), np.asarray(wx))
    np.testing.assert_array_equal(gy.numpy(), np.asarray(wy))
