"""Port parity: the LevelDB reader and writer (data/leveldb_io.py), the
LevelDB dataset and a Feeder over it, against the JAX package's, on the
CPU.

Files are compared byte for byte (the port's writer against the JAX
writer), reads key for key and value for value (the port's reader and
the JAX reader over the same directory), and Feeder batches bitwise.
Datasets are tiny (8-60 records of 3x12x12 at most).
"""

import filecmp
import os
import shutil
import struct

import numpy as np
import pytest

from caffe_mpi_tpu.data import datasets as jds
from caffe_mpi_tpu.data import feeder as jfeeder
from caffe_mpi_tpu.data import leveldb_io as jldb
from caffe_mpi_tpu.data.transformer import DataTransformer as JaxTF
from caffe_mpi_tpu.utils import resilience as jres
from caffe_mpi_tpu_torch.data import datasets as pds
from caffe_mpi_tpu_torch.data import feeder as pfeeder
from caffe_mpi_tpu_torch.data import leveldb_io as pldb
from caffe_mpi_tpu_torch.data.transformer import DataTransformer
from caffe_mpi_tpu_torch.utils import resilience as pres
from test_torch_data import (TRANSFORMS, _items, _mean_file, _records, _tp,
                             close_jax)


def _kv(n, seed=0, size=40):
    r = np.random.RandomState(seed)
    return [(b"k%05d" % int(i), r.bytes(int(size + r.randint(0, size))))
            for i in r.permutation(n)]


def _same_dirs(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    for name in names:
        assert filecmp.cmp(os.path.join(a, name), os.path.join(b, name),
                           shallow=False), name


# -- the writer ---------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(), dict(compress=True), dict(block_size=256),
    dict(block_size=256, compress=True, wal_tail=7), dict(wal_tail=60)])
def test_written_dbs_are_byte_equal_to_the_jax_writers(tmp_path, kw):
    items = _kv(60)
    pldb.write_leveldb(str(tmp_path / "port"), items, **kw)
    jldb.write_leveldb(str(tmp_path / "jax"), items, **kw)
    _same_dirs(tmp_path / "port", tmp_path / "jax")


def test_wal_is_byte_equal_across_block_boundaries(tmp_path):
    """Records of 20-50 KB cross the log's 32 KiB blocks (FIRST, MIDDLE,
    LAST records and the trailer padding)."""
    items = _kv(6, seed=3, size=25000)
    pldb.write_wal(str(tmp_path / "p.log"), items, start_seq=5)
    jldb.write_wal(str(tmp_path / "j.log"), items, start_seq=5)
    assert filecmp.cmp(tmp_path / "p.log", tmp_path / "j.log",
                       shallow=False)


def test_masked_crc32c_and_snappy_literals_equal_jax():
    for n in (0, 1, 59, 60, 61, 255, 256, 70000):
        data = np.random.RandomState(n).bytes(n)
        assert pldb.masked_crc32c(data) == jldb.masked_crc32c(data)
        enc = pldb.snappy_compress_literal(data)
        assert enc == jldb.snappy_compress_literal(data)
        assert pldb.snappy_decompress(enc) == data


# -- the reader ---------------------------------------------------------------

def _snappy_with_copies(buf: bytes) -> bytes:
    """A valid snappy stream that uses every copy element: 8 literal
    bytes, then copies of 1-, 2- and 4-byte offsets (overlapping runs
    among them) while the data repeats, literals elsewhere."""
    out = bytearray(pldb._put_uvarint(len(buf)))
    pos, kind = 0, 0
    while pos < len(buf):
        n = min(8, len(buf) - pos)
        if pos >= 8 and buf[pos:pos + 4] == buf[pos - 1:pos + 3]:
            # an overlapping copy at offset 1, by each tag form in turn
            run = 4
            while pos + run < len(buf) and run < 11 and \
                    buf[pos + run] == buf[pos - 1]:
                run += 1
            if kind % 3 == 0:
                out.append(1 | ((run - 4) << 2))
                out.append(1)
            elif kind % 3 == 1:
                out.append(2 | ((run - 1) << 2))
                out += (1).to_bytes(2, "little")
            else:
                out.append(3 | ((run - 1) << 2))
                out += (1).to_bytes(4, "little")
            kind += 1
            pos += run
            continue
        if pos >= 8 and buf[pos:pos + 8] == buf[pos - 8:pos]:
            out.append(2 | (7 << 2))  # an 8-byte copy, 2-byte offset 8
            out += (8).to_bytes(2, "little")
            pos += 8
            continue
        out.append((n - 1) << 2)
        out += buf[pos:pos + n]
        pos += n
    return bytes(out)


def test_hand_made_snappy_block_with_copies_reads_as_jax():
    data = (b"abcdefgh" * 5 + b"\x00" * 30 + bytes(range(40)) + b"zz" * 9
            + b"q" * 23)
    stream = _snappy_with_copies(data)
    assert len(stream) < len(data)
    assert pldb.snappy_decompress(stream) == \
        jldb.snappy_decompress(stream) == data
    with pytest.raises(pldb.LevelDBError, match="bad copy offset"):
        pldb.snappy_decompress(b"\x08\x01\x05")  # copy before any byte


def _read_both(path):
    port, jax = pldb.LevelDBReader(path), jldb.LevelDBReader(path)
    got, want = list(port.items()), list(jax.items())
    assert got == want and len(port) == len(jax) == len(want)
    for i in (0, len(want) // 2, len(want) - 1):
        assert port.value_at(i) == jax.value_at(i)
        assert port.get(want[i][0]) == want[i][1]
    assert port.get(b"absent") is None
    port.close()
    jax.close()
    return want


@pytest.mark.parametrize("layout", ["wal_only", "tables_overwrites",
                                    "snappy_copies"])
def test_readers_give_the_jax_readers_items(tmp_path, layout, monkeypatch):
    path = str(tmp_path / "db")
    items = _kv(40, seed=1)
    if layout == "wal_only":
        os.makedirs(path)
        pldb.write_wal(os.path.join(path, "000003.log"), items)
        want = sorted(items)
    elif layout == "tables_overwrites":
        # two tables (the second copied in from another write) and a log
        # whose newer sequences overwrite some keys
        pldb.write_leveldb(path, items[:25], block_size=300)
        pldb.write_leveldb(str(tmp_path / "b"), items[20:], compress=True)
        shutil.copy(tmp_path / "b" / "000005.ldb",
                    os.path.join(path, "000009.ldb"))
        newer = [(k, b"new" + v[:5]) for k, v in items[::4]]
        pldb.write_wal(os.path.join(path, "000011.log"), newer,
                       start_seq=1000)
        want = dict(items)
        want.update(newer)
        want = sorted(want.items())
    else:
        # both writers emit snappy blocks made with copy elements
        for mod in (pldb, jldb):
            monkeypatch.setattr(mod, "snappy_compress_literal",
                                _snappy_with_copies)
        items = [(k, v[:6] * 7) for k, v in items]
        pldb.write_leveldb(path, items, compress=True, block_size=200)
        jldb.write_leveldb(str(tmp_path / "j"), items, compress=True,
                           block_size=200)
        _same_dirs(path, tmp_path / "j")
        want = sorted(items)
    assert _read_both(path) == want


def _datum_leveldb(path, n=24, shape=(3, 12, 12), **kw):
    imgs, labels = _records(n, shape, seed=5)
    pldb.write_leveldb(path, _items(imgs, labels), **kw)
    return path


def test_corrupt_block_raises_record_integrity_error_in_both(tmp_path):
    """One flipped byte inside the first data block after the datasets
    are open: the block fails its masked crc32c on read, so both datasets
    raise RecordIntegrityError for its records and read the others; a
    fresh open, which reads every block for its key index, raises
    LevelDBError in both."""
    path = _datum_leveldb(str(tmp_path / "db"), block_size=512)
    port = pds.open_dataset("LEVELDB", path)
    jax = jds.open_dataset("LEVELDB", path)
    with open(os.path.join(path, "000005.ldb"), "r+b") as f:
        f.seek(100)
        b = f.read(1)
        f.seek(100)
        f.write(bytes([b[0] ^ 0x5A]))
    with pytest.raises(pres.RecordIntegrityError, match="crc32c"):
        port.get(0)
    with pytest.raises(jres.RecordIntegrityError, match="crc32c"):
        jax.get(0)
    np.testing.assert_array_equal(port.get(len(port) - 1)[0],
                                  jax.get(len(jax) - 1)[0])
    with pytest.raises(pldb.LevelDBError, match="failed crc32c"):
        pds.open_dataset("LEVELDB", path)
    with pytest.raises(jldb.LevelDBError, match="failed crc32c"):
        jds.open_dataset("LEVELDB", path)


def test_leveldb_reader_refuses_what_jax_refuses(tmp_path):
    os.makedirs(tmp_path / "empty")
    with pytest.raises(pldb.LevelDBError, match="no SSTable or WAL"):
        pldb.LevelDBReader(str(tmp_path / "empty"))
    bad = tmp_path / "bad"
    os.makedirs(bad)
    (bad / "000005.ldb").write_bytes(b"\x00" * 40 + struct.pack("<Q", 7))
    with pytest.raises(pldb.LevelDBError, match="bad table magic"):
        pldb.LevelDBReader(str(bad))


# -- the Feeder over a LevelDB --------------------------------------------------

@pytest.mark.parametrize("device", [False, True])
@pytest.mark.parametrize("phase", ["TRAIN", "TEST"])
def test_feeder_over_a_leveldb_is_bitwise_the_jax_feeder(tmp_path, phase,
                                                         device):
    """Iterations 0..4 of batch 5 over 24 snappy-block records, shuffle
    in TRAIN, the classic host transform (`_native = False`, as
    tests/test_torch_data.py) or the device transform's raw stack and
    decisions."""
    shape = (3, 12, 12)
    path = _datum_leveldb(str(tmp_path / "db"), compress=True,
                          block_size=1024)
    tp, jtp = _tp(TRANSFORMS[3].replace("crop_size: 20", "crop_size: 10"),
                  _mean_file(tmp_path, shape))
    kw = dict(shuffle=phase == "TRAIN", seed=3, threads=2,
              device_transform=device)
    port = pfeeder.Feeder(pds.open_dataset("LEVELDB", path),
                          DataTransformer(tp, phase), 5, **kw)
    jax = jfeeder.Feeder(jds.open_dataset("LEVELDB", path),
                         JaxTF(jtp, phase), 5, **kw)
    port._native = jax._native = False
    try:
        for it in range(5):
            got, want = port._build_batch_inner(it), \
                jax._build_batch_inner(it)
            assert list(got) == list(want)
            for key in want:
                assert got[key].dtype == want[key].dtype
                np.testing.assert_array_equal(got[key], want[key],
                                              err_msg=f"{key} it {it}")
    finally:
        port.close()
        close_jax(jax)


def test_leveldb_data_layer_trains_through_the_cli_feeder(tmp_path):
    """A Data net naming no backend (LEVELDB, the prototxt default) gets
    its Feeder from the CLI's build_feeder, with the device transform,
    and gives the JAX CLI Feeder's batches."""
    from caffe_mpi_tpu.net import Net as JaxNet
    from caffe_mpi_tpu.proto import NetParameter as JaxNP
    from caffe_mpi_tpu.tools import cli as jax_cli
    from caffe_mpi_tpu_torch.net import Net
    from caffe_mpi_tpu_torch.proto import NetParameter
    from caffe_mpi_tpu_torch.tools import cli
    path = _datum_leveldb(str(tmp_path / "db"))
    text = (f'layer {{ name: "d" type: "Data" top: "data" top: "label" '
            f'transform_param {{ crop_size: 8 mirror: true }} data_param {{ '
            f'source: "{path}" batch_size: 4 shuffle: true }} }}')
    net = Net(NetParameter.from_text(text), "TRAIN", device="cpu")
    jnet = JaxNet(JaxNP.from_text(text), "TRAIN")
    port = cli.build_feeder(net, "TRAIN")
    jax = jax_cli._build_feeders(jnet, "TRAIN")
    assert net.layers[0].dev_transform and port.device_transform
    try:
        for it in range(3):
            got, want = port._build_batch_inner(it), \
                jax._build_batch_inner(it)
            for key in want:
                np.testing.assert_array_equal(got[key], want[key])
    finally:
        port.close()
        close_jax(jax)


def test_block_rotting_after_open_is_quarantined_as_jax(tmp_path):
    """A block that fails its crc32c on a read after the open (the key
    index read every block at the open): the Feeder substitutes the next
    record and journals it, as the JAX Feeder does; one record a block
    (records larger than block_size)."""
    path = _datum_leveldb(str(tmp_path / "db"), n=12, block_size=64,
                          compress=True)
    pres.QUARANTINE.configure(None)
    jres.QUARANTINE.configure(None)
    tp, jtp = _tp("crop_size: 8", "")
    port = pfeeder.Feeder(pds.open_dataset("LEVELDB", path),
                          DataTransformer(tp, "TRAIN"), 4, threads=1,
                          device_transform=True)
    jax = jfeeder.Feeder(jds.open_dataset("LEVELDB", path),
                         JaxTF(jtp, "TRAIN"), 4, threads=1,
                         device_transform=True)
    reader = pldb.LevelDBReader(path)
    off, size = list(reader._tables[0].block_handles())[5]
    reader.close()
    with open(os.path.join(path, "000005.ldb"), "r+b") as f:
        f.seek(off + size // 2)
        b = f.read(1)
        f.seek(off + size // 2)
        f.write(bytes([b[0] ^ 0xFF]))
    try:
        for it in range(3):
            got, want = port._build_batch_inner(it), \
                jax._build_batch_inner(it)
            for key in want:
                np.testing.assert_array_equal(got[key], want[key])
        assert port._sub_cache == jax._sub_cache == {5: 6}
        (entry,) = pres.QUARANTINE.entries
        (jentry,) = jres.QUARANTINE.entries
        assert (entry["index"], entry["substitute"]) == \
            (jentry["index"], jentry["substitute"]) == (5, 6)
        assert "crc32c" in entry["reason"]
    finally:
        port.close()
        close_jax(jax)
        pres.QUARANTINE.configure(None)
        jres.QUARANTINE.configure(None)
