"""Port parity: the native data plane (caffe_mpi_tpu_torch/native, built from
csrc/native/ by ops/build.py) against the JAX package's native library
(caffe_mpi_tpu/native, built by its build.sh) and against the plain
versions, on the CPU, on tiny records (a few dozen, 3x16x16 to 3x32x32).

Every comparison is exact: the LMDB cursor's keys, values and crc32c, the
datumfile reader, the threaded batch transform (over test_torch_data's
TRANSFORMS, TRAIN and TEST, and a numpy splitmix64 oracle of its draws),
the raw-batch gather against the per-record Python build, the device
transform's Philox draws against numpy's, the Feeders' batches on their
native paths, and the lookahead retune's decisions. A failed build of the
library raises.
"""

import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

import numpy as np
import pytest

from caffe_mpi_tpu import native as jnative
from caffe_mpi_tpu.data import datasets as jds
from caffe_mpi_tpu.data import feeder as jfeeder
from caffe_mpi_tpu.data.transformer import DataTransformer as JaxTF
from caffe_mpi_tpu_torch import native
from caffe_mpi_tpu_torch.data import datasets as pds
from caffe_mpi_tpu_torch.data import feeder as pfeeder
from caffe_mpi_tpu_torch.data import lmdb_io as plmdb
from caffe_mpi_tpu_torch.data.transformer import DataTransformer
from caffe_mpi_tpu_torch.ops import build
from test_torch_data import (TRANSFORMS, _items, _mean_file, _records, _tp,
                             close_jax)

M64 = (1 << 64) - 1


@pytest.fixture(scope="session")
def jax_native():
    """The JAX package's native library, built by its own build.sh from
    its own sources, as tests/test_native.py builds it, but in a private
    copy of that directory under the temp dir (keyed by the sources'
    hash, built once under a file lock for every worker): the JAX tests'
    fixtures build in place, unlocked, and two builds in one directory
    race. It is loaded through the JAX binding's own loader, so every
    JAX module of this process uses it."""
    src = os.path.dirname(jnative.__file__)
    names = sorted(n for n in os.listdir(src)
                   if n.endswith((".cc", ".h", ".sh", ".txt")))
    digest = hashlib.sha256()
    for n in names:
        with open(os.path.join(src, n), "rb") as f:
            digest.update(n.encode() + f.read())
    root = os.path.join(tempfile.gettempdir(),
                        f"caffe_tpu_jax_native-{digest.hexdigest()[:16]}")
    with open(root + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.isfile(os.path.join(root, "libcaffe_tpu_native.so")):
            tmp = root + f".tmp{os.getpid()}"
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            for n in names:
                shutil.copy(os.path.join(src, n), tmp)
            subprocess.run(["sh", os.path.join(tmp, "build.sh")],
                           check=True, capture_output=True, timeout=600)
            shutil.rmtree(root, ignore_errors=True)
            os.replace(tmp, root)
    saved = jnative.__file__
    jnative.__file__ = os.path.join(root, "__init__.py")
    jnative._TRIED, jnative._LIB = False, None
    try:
        assert jnative.available() and jnative.decode_available()
    finally:
        jnative.__file__ = saved
    return jnative


pytestmark = pytest.mark.usefixtures("jax_native")


def _sm64(x):
    """splitmix64 (csrc/native/transform_core.h), the draws' oracle."""
    x = (x + 0x9E3779B97F4A7C15) & M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & M64
    return x ^ (x >> 31)


def _db(tmp_path, n, shape, name="db", encode=pds.encode_datum, seed=0):
    imgs, labels = _records(n, shape, seed=seed)
    plmdb.write_lmdb(str(tmp_path / name), _items(imgs, labels, encode))
    return str(tmp_path / name), imgs, labels


# -- the build ----------------------------------------------------------------

def test_the_library_is_built_from_the_checkout_with_the_host_compiler():
    assert build.NATIVE in build.SOURCES
    flags = build._flags(build.NATIVE)
    assert flags[:len(build.CXX_FLAGS)] == build.CXX_FLAGS
    assert "-pthread" in flags
    # this host has libjpeg's and libpng's headers: the codecs are built
    assert build.codec_probe() == {"jpeglib.h": True, "png.h": True}
    assert build._link(build.NATIVE) == build.CODEC_LIBS
    assert native.decode_available()
    assert native.lib().caffe_tpu_native_abi_version() == native.ABI_VERSION
    path = build._lib_path(build.NATIVE)
    assert os.path.isfile(path)
    assert path.startswith(os.path.join(build.PKG_DIR, "_build") + os.sep)


def test_a_failed_build_raises(tmp_path, monkeypatch):
    """A source that does not compile raises with the compiler's output;
    nothing falls back to a Python reader."""
    src = tmp_path / "csrc"
    (src / "native").mkdir(parents=True)
    for name in build.NATIVE_SOURCES + build.NATIVE_HEADERS:
        text = open(os.path.join(build.CSRC_DIR, name)).read()
        if name.endswith("transform.cc"):
            text += "\nthis is not C++;\n"
        (src / name).write_text(text)
    monkeypatch.setattr(build, "CSRC_DIR", str(src))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(build, "_LIBS", {})
    with pytest.raises(RuntimeError, match="failed on native"):
        build.load(build.NATIVE)
    monkeypatch.setattr(native, "_LIB", None)
    with pytest.raises(RuntimeError, match="failed on native"):
        native.lib()
    with pytest.raises(RuntimeError, match="failed on native"):
        pds.LMDBDataset(str(tmp_path / "any"))


def test_codec_less_build_stubs_the_decoder(tmp_path, monkeypatch):
    """Where the compiler finds no codec headers the library is built with
    -DCAFFE_TPU_NO_CODEC: it loads, reads and transforms, and its decode
    entry points say "unavailable"."""
    monkeypatch.setattr(build, "_CODEC", {"jpeglib.h": False,
                                          "png.h": True})
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(build, "_LIBS", {})
    assert "-DCAFFE_TPU_NO_CODEC" in build._flags(build.NATIVE)
    assert build._link(build.NATIVE) == ()
    monkeypatch.setattr(native, "_LIB", None)
    assert not native.decode_available()
    assert native.decode_probe(b"\xff\xd8\xff" + bytes(20)) is None
    db, imgs, _ = _db(tmp_path, 4, (3, 8, 8))
    np.testing.assert_array_equal(pds.LMDBDataset(db).get(2)[0], imgs[2])


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 63, 1025, 70001])
def test_crc32c_hardware_and_table_equal_the_sidecars(n):
    data = np.random.RandomState(n).bytes(n + 1)[1:]  # unaligned
    want = plmdb.crc32c(data)
    assert native.crc32c(data, hw=True) == native.crc32c(data, hw=False) \
        == want


# -- the LMDB cursor and the datumfile reader ---------------------------------

@pytest.mark.parametrize("big", [False, True])
def test_native_lmdb_equals_the_jax_librarys_and_the_python_reader(
        tmp_path, jax_native, big):
    """Keys, values (overflow pages too when `big`) and value_crc32c."""
    shape = (3, 32, 32) if big else (3, 4, 4)
    db, _, _ = _db(tmp_path, 40, shape)
    port, jax = native.NativeLMDB(db), jax_native.NativeLMDB(db)
    with plmdb.LMDBReader(db) as py:
        items = list(py.items())
    crcs = plmdb.read_crc_sidecar(db, expect_count=40)
    assert len(port) == len(jax) == len(items) == 40
    for i, (k, v) in enumerate(items):
        assert port.record(i) == jax.record(i) == (k, v)
        assert port.key(i) == k and port.value(i) == v
        assert port.value_crc32c(i) == jax.value_crc32c(i) == crcs[i]
    with pytest.raises(IndexError):
        port.value(40)
    port.close()
    jax.close()


def test_native_datumdb_equals_the_jax_librarys(tmp_path, jax_native):
    imgs, labels = _records(24, (3, 16, 16))
    bufs = [pds.encode_datum(i, int(l) - 4) for i, l in zip(imgs, labels)]
    path = str(tmp_path / "d.df")
    pds.DatumFileDataset.write(path, bufs)
    port, jax = native.NativeDatumDB(path), jax_native.NativeDatumDB(path)
    assert len(port) == len(jax) == 24
    for i in range(24):
        (a, la), (b, lb) = port.get(i), jax.get(i)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, imgs[i])
        assert la == lb == labels[i] - 4
    ds, jd = pds.open_dataset("DATUMFILE", path), jds.open_dataset(
        "DATUMFILE", path)
    for i in (0, 13, 23):
        np.testing.assert_array_equal(ds.get(i)[0], jd.get(i)[0])


def test_lmdb_dataset_reads_alike_on_both_readers(tmp_path):
    db, imgs, labels = _db(tmp_path, 24, (3, 16, 16))
    nat, py = pds.LMDBDataset(db), pds.LMDBDataset(db, reader="python")
    assert nat._native is not None and py._native is None
    assert nat.keys == py.keys and not nat.encoded and not py.encoded
    for i in range(24):
        (a, la), (b, lb) = nat.get(i), py.get(i)
        np.testing.assert_array_equal(a, b)
        assert la == lb == labels[i]
        assert nat.get_datum(i) == py.get_datum(i)
    with pytest.raises(ValueError, match="unknown LMDB reader"):
        pds.LMDBDataset(db, reader="lmdb")


def test_a_structurally_broken_lmdb_raises_at_open(tmp_path):
    db, _, _ = _db(tmp_path, 24, (3, 16, 16))
    path = os.path.join(db, "data.mdb")
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) // 2)
    with pytest.raises(pds.RecordIntegrityError, match="structural"):
        pds.LMDBDataset(db)


# -- the raw-batch gather -----------------------------------------------------

def test_gather_raw_equals_the_per_record_reads(tmp_path):
    db, imgs, labels = _db(tmp_path, 30, (3, 16, 16))
    ds = pds.LMDBDataset(db)
    idx = [29, 0, 7, 7, 15, 3]
    for threads in (1, 4):
        out = np.zeros((6, 3, 16, 16), np.uint8)
        got_labels, status = ds.gather_raw(idx, (3, 16, 16), out, threads)
        assert status.tolist() == [native.GATHER_OK] * 6
        np.testing.assert_array_equal(out, imgs[idx])
        assert got_labels.tolist() == [int(labels[i]) for i in idx]
    # another shape, an index past the end
    out = np.zeros((2, 3, 8, 8), np.uint8)
    _, status = ds.gather_raw([1, 2], (3, 8, 8), out)
    assert status.tolist() == [native.GATHER_NOT_RAW] * 2
    out = np.zeros((1, 3, 16, 16), np.uint8)
    _, status = ds._native.gather_raw([30], (3, 16, 16), out)
    assert status.tolist() == [native.GATHER_INDEX]
    with pytest.raises(ValueError, match="contiguous uint8"):
        ds.gather_raw([1], (3, 16, 16), np.zeros((1, 3, 16, 16), np.int16))


@pytest.mark.parametrize("kind", ["jpeg", "float", "negative_label",
                                  "crc", "truncated"])
def test_gather_declines_what_python_must_read(tmp_path, kind):
    """Encoded and float Datums are not raw; a record whose crc32c fails
    is declined before its walk; a negative label reads as Python reads
    it. A declined row is left as it was."""
    imgs, labels = _records(6, (3, 16, 16))
    items = _items(imgs, labels)
    if kind == "jpeg":
        items[2] = (items[2][0], pds.encode_datum_image(imgs[2], 1))
    elif kind == "float":
        items[2] = (items[2][0], pds.encode_datum_float(
            imgs[2].astype(np.float32), 1))
    elif kind == "negative_label":
        items[2] = (items[2][0], pds.encode_datum(imgs[2], -7))
    elif kind == "truncated":
        items[2] = (items[2][0], items[2][1][:-10])
    path = str(tmp_path / "db")
    plmdb.write_lmdb(path, items)
    ds = pds.LMDBDataset(path)
    if kind == "crc":
        ds._crcs = ds._crcs.copy()
        ds._crcs[2] ^= 1
    out = np.full((6, 3, 16, 16), 9, np.uint8)
    got_labels, status = ds.gather_raw(range(6), (3, 16, 16), out)
    want = {"jpeg": native.GATHER_NOT_RAW, "float": native.GATHER_NOT_RAW,
            "negative_label": native.GATHER_OK, "crc": native.GATHER_CRC,
            "truncated": native.GATHER_WIRE}[kind]
    assert status[2] == want
    assert (status[[0, 1, 3, 4, 5]] == native.GATHER_OK).all()
    if want == native.GATHER_OK:
        assert got_labels[2] == ds.get(2)[1] == -7
        np.testing.assert_array_equal(out[2], imgs[2])
    else:
        assert (out[2] == 9).all()


def test_gather_raw_of_a_datumfile(tmp_path):
    imgs, labels = _records(12, (3, 16, 16))
    path = str(tmp_path / "d.df")
    pds.DatumFileDataset.write(path, [pds.encode_datum(i, int(l))
                                      for i, l in zip(imgs, labels)])
    ds = pds.open_dataset("DATUMFILE", path)
    out = np.zeros((4, 3, 16, 16), np.uint8)
    got_labels, status = ds.gather_raw([11, 2, 5, 0], (3, 16, 16), out, 2)
    assert (status == native.GATHER_OK).all()
    np.testing.assert_array_equal(out, imgs[[11, 2, 5, 0]])
    assert got_labels.tolist() == labels[[11, 2, 5, 0]].tolist()


# -- the batch transform ------------------------------------------------------

def _native_mean(tf):
    mean = tf.mean
    if mean is not None and mean.ndim == 3 and mean.shape[1] == 1:
        mean = mean.reshape(-1)
    return mean


@pytest.mark.parametrize("phase", ["TRAIN", "TEST"])
@pytest.mark.parametrize("spec", TRANSFORMS)
def test_transform_batch_is_bitwise_the_jax_librarys(tmp_path, jax_native,
                                                     spec, phase):
    shape = (1, 28, 28) if "mean_value: 33" in spec else (3, 32, 32)
    imgs, _ = _records(7, shape, seed=3)
    tp, _ = _tp(spec, _mean_file(tmp_path, shape))
    tf = DataTransformer(tp, phase)
    ids = np.arange(100, 107)
    kw = dict(crop=tp.crop_size, mean=_native_mean(tf), scale=tp.scale,
              train=phase == "TRAIN", mirror=tp.mirror, seed=tf.seed or 0)
    got = native.transform_batch(imgs, ids, num_threads=3, **kw)
    want = jax_native.transform_batch(imgs, ids, num_threads=1, **kw)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 5, 1 << 40])
def test_transform_batch_draws_are_splitmix64(seed):
    """The crop offsets and mirrors of a TRAIN batch are the splitmix64
    draws keyed on seed ^ record id (transform_core.h), as a numpy
    oracle computes them."""
    imgs, _ = _records(9, (3, 16, 12), seed=4)
    ids = np.arange(9) * 37 + 5
    crop = 8
    got = native.transform_batch(imgs, ids, crop=crop, train=True,
                                 mirror=True, seed=seed)
    for i, rid in enumerate(ids):
        r = _sm64(seed ^ int(rid))
        oh = r % (16 - crop + 1)
        r = _sm64(r)
        ow = r % (12 - crop + 1)
        r = _sm64(r)
        want = imgs[i, :, oh:oh + crop, ow:ow + crop].astype(np.float32)
        if r & 1:
            want = want[:, :, ::-1]
        np.testing.assert_array_equal(got[i], want)


# -- the device transform's draws ---------------------------------------------

@pytest.mark.parametrize("spec,hw", [
    ("crop_size: 227 mirror: true", (256, 256)),
    ("crop_size: 5 mirror: true random_seed: 7", (9, 12)),
    ("mirror: true random_seed: 4294967297", (8, 8)),  # a 128-bit key
    ("crop_size: 8", (8, 8)),                          # nothing drawn
    ("crop_size: 3 random_seed: 123456789012", (200, 77)),
    # ranges near 2^31: Lemire's rejection draws again
    ("crop_size: 1 mirror: true", (2**31 - 1, 1_500_000_001)),
])
def test_native_philox_draws_are_numpys(spec, hw):
    """compute_aug's TRAIN draws in C (native.philox_aug) against the
    numpy Generator a record (compute_aug_plain, the JAX package's
    draws), over 3,000 records."""
    from caffe_mpi_tpu_torch.data import device_transform as pdt
    from caffe_mpi_tpu_torch.proto.config import TransformationParameter
    tf = DataTransformer(TransformationParameter.from_text(spec), "TRAIN")
    flats = np.arange(3000) * 7919 + 3
    got = pdt.compute_aug(tf, flats, hw, len(flats))
    want = pdt.compute_aug_plain(tf, flats, hw, len(flats))
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="exceeds"):
        native.philox_aug(flats[:2], 0, 4, 4, 5, True)


# -- the Feeder's native paths against the JAX Feeder's -----------------------

@pytest.mark.parametrize("device", [False, True])
@pytest.mark.parametrize("spec", [TRANSFORMS[4], TRANSFORMS[6],
                                  TRANSFORMS[3]])
def test_native_feeder_is_bitwise_the_jax_native_feeder(tmp_path, jax_native,
                                                        spec, device):
    """With both native libraries the port's Feeder (the raw gather, the
    native host transform) gives the JAX Feeder's batches (its per-record
    reads, its native host transform): iterations 0..5 of batch 5 at
    world 2, shuffle on, over 24 records."""
    shape = (3, 32, 32)
    db, _, _ = _db(tmp_path, 24, shape)
    tp, jtp = _tp(spec, _mean_file(tmp_path, shape))
    kw = dict(rank=1, world=2, shuffle=True, seed=4, threads=2,
              device_transform=device)
    port = pfeeder.Feeder(pds.open_dataset("LMDB", db),
                          DataTransformer(tp, "TRAIN"), 5, **kw)
    jax = jfeeder.Feeder(jds.open_dataset("LMDB", db),
                         JaxTF(jtp, "TRAIN"), 5, **kw)
    assert port._native and jax._native
    try:
        for it in range(6):
            got, want = port(it), jax(it)
            assert list(got) == list(want)
            for key in want:
                assert got[key].dtype == want[key].dtype, key
                np.testing.assert_array_equal(got[key], want[key],
                                              err_msg=f"{key} it {it}")
        assert port._raw_shape == shape and port._gather_ok
    finally:
        port.close()
        close_jax(jax)


def test_gathered_batches_equal_the_classic_build(tmp_path):
    """The raw gather against the per-record Python build of the same
    batches (the plain LMDB reader, no gather), host transform and device
    transform."""
    db, _, _ = _db(tmp_path, 20, (3, 32, 32))
    tp, _ = _tp(TRANSFORMS[6], "")
    for device in (False, True):
        fast = pfeeder.Feeder(pds.LMDBDataset(db),
                              DataTransformer(tp, "TRAIN"), 6, threads=1,
                              device_transform=device, shuffle=True)
        plain = pfeeder.Feeder(pds.LMDBDataset(db, reader="python"),
                               DataTransformer(tp, "TRAIN"), 6, threads=1,
                               device_transform=device, shuffle=True)
        plain._gather_ok = False
        for it in range(5):
            a, b = fast._build_batch_inner(it), plain._build_batch_inner(it)
            for key in b:
                np.testing.assert_array_equal(a[key], b[key])
        assert fast._raw_shape == (3, 32, 32)
        fast.close()
        plain.close()


def test_a_feeder_of_float_records_stays_classic(tmp_path):
    imgs, labels = _records(8, (3, 8, 8))
    path = str(tmp_path / "f")
    plmdb.write_lmdb(path, _items(imgs.astype(np.float32) / 3, labels,
                                  pds.encode_datum_float))
    port = pfeeder.Feeder(pds.open_dataset("LMDB", path), None, 4,
                          threads=1)
    jax = jfeeder.Feeder(jds.open_dataset("LMDB", path), None, 4,
                         threads=1)
    for it in range(3):
        np.testing.assert_array_equal(port(it)["data"], jax(it)["data"])
    assert port._gather_ok is False
    port.close()
    close_jax(jax)


# -- auto threads and the lookahead retune ------------------------------------

@pytest.mark.parametrize("builds,gaps,nbytes,budget,start", [
    ([0.05] * 8, [0.01] * 8, 1000, 1 << 30, 1),     # slow builds: grow
    ([0.001] * 8, [0.02] * 8, 1000, 1 << 30, 12),   # fast builds: shrink
    ([0.05] * 8, [0.001] * 8, 1000, 1 << 30, 1),    # the hard cap
    ([0.05] * 8, [0.01] * 8, 1000, 3500, 1),        # the memory budget
    ([0.05] * 4, [0.01] * 8, 1000, 1 << 30, 3),     # too little telemetry
    ([0.02, 0.5, 0.01, 0.03, 0.02, 0.04], [0.01] * 6, 10, 1 << 30, 2),
])
def test_retune_decides_as_jax(builds, gaps, nbytes, budget, start):
    ds = pds.SyntheticDataset(64, shape=(3, 4, 4))
    jd = jds.SyntheticDataset(64, shape=(3, 4, 4))
    port = pfeeder.Feeder(ds, None, 4, lookahead=start, mem_budget=budget)
    jax = jfeeder.Feeder(jd, None, 4, lookahead=start, mem_budget=budget)
    for f in (port, jax):
        f._build_times.extend(builds)
        f._gaps.extend(gaps)
        f._batch_bytes = nbytes
        f._maybe_retune()
    assert port.lookahead == jax.lookahead
    assert pfeeder._LOOKAHEAD_HARD_CAP == jfeeder._LOOKAHEAD_HARD_CAP
    assert pfeeder._default_mem_budget() == jfeeder._default_mem_budget()
    port.close()
    close_jax(jax)


def test_auto_mode_retunes_while_it_feeds():
    """threads 0: the workers of JAX's auto mode, and a lookahead that
    grows when builds outlast the consumer's steps."""

    class Slow(pds.SyntheticDataset):
        def get(self, index):
            time.sleep(0.002)
            return super().get(index)

    f = pfeeder.Feeder(Slow(256, shape=(3, 4, 4)), None, 4, lookahead=1)
    assert f.auto and f.threads == pfeeder.auto_threads() == min(
        os.cpu_count() or 2, 8)
    for it in range(16):
        f(it)
    f.close()
    assert f.lookahead > 1
    pinned = pfeeder.Feeder(Slow(64, shape=(3, 4, 4)), None, 4, threads=2,
                            lookahead=1)
    for it in range(10):
        pinned(it)
    pinned.close()
    assert pinned.lookahead == 1 and not pinned.auto
