"""Port parity: the Feeder's quarantine of corrupt records against the JAX
Feeder's, on the CPU, on LMDBs of 24-400 records of 3x32x32.

A record whose bytes no longer match the crc sidecar (or that does not
parse) is replaced by the next healthy record by index; both Feeders make
the same substitutions, keep the same memo, write the same journal entries
(utils/resilience.py QUARANTINE; the entries' times aside) and raise
DataIntegrityError past the same bound. The port's records come through
its native raw gather, which declines a corrupt record to the per-record
path; the JAX Feeder reads each record in Python. Also: the CLI binds the
journal beside the snapshots, the fault sites and the read retry.
"""

import json
import os

import numpy as np
import pytest

from caffe_mpi_tpu.data import datasets as jds
from caffe_mpi_tpu.data import feeder as jfeeder
from caffe_mpi_tpu.data.transformer import DataTransformer as JaxTF
from caffe_mpi_tpu.utils import resilience as jres
from caffe_mpi_tpu_torch.data import datasets as pds
from caffe_mpi_tpu_torch.data import feeder as pfeeder
from caffe_mpi_tpu_torch.data import lmdb_io as plmdb
from caffe_mpi_tpu_torch.data.transformer import DataTransformer
from caffe_mpi_tpu_torch.tools import cli
from caffe_mpi_tpu_torch.utils import resilience as pres
from test_torch_data import TRANSFORMS, _items, _records, _tp, close_jax
from test_torch_native import jax_native  # noqa: F401 (a fixture)

# the JAX Feeder transforms natively only with its library loaded
pytestmark = pytest.mark.usefixtures("jax_native")

SHAPE = (3, 32, 32)


@pytest.fixture(autouse=True)
def journals():
    """Both packages' journals unbound and empty, and no fault sites."""
    for res in (pres, jres):
        res.QUARANTINE.configure(None)
        res.FAULTS.configure("")
    yield
    for res in (pres, jres):
        res.QUARANTINE.configure(None)
        res.FAULTS.configure("")


def _corrupt_db(tmp_path, n, bad, name="db"):
    """An LMDB of n raw records, the records `bad` each with one pixel
    byte flipped after the sidecar was written."""
    imgs, labels = _records(n, SHAPE, seed=3)
    path = str(tmp_path / name)
    plmdb.write_lmdb(path, _items(imgs, labels))
    with plmdb.LMDBReader(path) as r:
        spans = [s for _, s in r.spans()]
    with open(os.path.join(path, "data.mdb"), "r+b") as f:
        for i in bad:
            off, size = spans[i]
            f.seek(off + size - 20)
            b = f.read(1)
            f.seek(off + size - 20)
            f.write(bytes([b[0] ^ 0xFF]))
    return path


def _entries(log):
    return [{k: v for k, v in e.items() if k != "time"} for e in log.entries]


def _feeders(db, device, shuffle=True, batch=5):
    tp, jtp = _tp(TRANSFORMS[2], "")
    kw = dict(shuffle=shuffle, seed=2, threads=1, device_transform=device)
    port = pfeeder.Feeder(pds.open_dataset("LMDB", db),
                          DataTransformer(tp, "TRAIN"), batch, **kw)
    jax = jfeeder.Feeder(jds.open_dataset("LMDB", db), JaxTF(jtp, "TRAIN"),
                         batch, **kw)
    return port, jax


@pytest.mark.parametrize("device", [False, True])
@pytest.mark.parametrize("bad", [(5,), (0, 17), (6, 7, 8)])
def test_substitutes_and_journal_are_jaxs(tmp_path, device, bad):
    """Two epochs of batch 5 over 24 records (shuffled); the second epoch
    reads the memoised substitutes. (6, 7, 8) makes probe casualties,
    journaled with substitute -1 and upgraded when substituted."""
    db = _corrupt_db(tmp_path, 24, bad)
    port, jax = _feeders(db, device)
    for it in range(10):  # in order, no prefetch: the journal's order too
        got, want = port._build_batch_inner(it), jax._build_batch_inner(it)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key],
                                          err_msg=f"{key} it {it}")
    assert port._sub_cache == jax._sub_cache
    assert port._quarantined == jax._quarantined == set(bad)
    assert _entries(pres.QUARANTINE) == _entries(jres.QUARANTINE)
    assert {e["index"] for e in pres.QUARANTINE.entries} == set(bad)
    assert all("crc32c mismatch" in e["reason"]
               for e in pres.QUARANTINE.entries)
    assert port._raw_shape == SHAPE  # the port gathered natively
    port.close()
    close_jax(jax)


def test_the_gathered_and_the_classic_build_quarantine_alike(tmp_path):
    db = _corrupt_db(tmp_path, 24, (3, 4, 20))
    tp, _ = _tp(TRANSFORMS[2], "")
    fast = pfeeder.Feeder(pds.open_dataset("LMDB", db),
                          DataTransformer(tp, "TRAIN"), 6, threads=1)
    plain = pfeeder.Feeder(pds.LMDBDataset(db, reader="python"),
                           DataTransformer(tp, "TRAIN"), 6, threads=1)
    plain._gather_ok = False
    for it in range(8):
        a, b = fast._build_batch_inner(it), plain._build_batch_inner(it)
        for key in b:
            np.testing.assert_array_equal(a[key], b[key])
    assert fast._sub_cache == plain._sub_cache == {3: 5, 4: 5, 20: 21}
    fast.close()
    plain.close()


def test_past_the_bound_raises_data_integrity_error(tmp_path):
    """24 records: the bound is max(4, 5% of 24) = 4 distinct corrupt
    records; the fifth raises, in both packages, at the same batch."""
    db = _corrupt_db(tmp_path, 24, (1, 5, 9, 13, 17))
    port, jax = _feeders(db, device=True, shuffle=False, batch=4)
    for it in range(4):
        port._build_batch_inner(it)
        jax._build_batch_inner(it)
    with pytest.raises(pres.DataIntegrityError, match="5 distinct corrupt"):
        port._build_batch_inner(4)
    with pytest.raises(jres.DataIntegrityError, match="5 distinct corrupt"):
        jax._build_batch_inner(4)
    port.close()
    close_jax(jax)


def test_a_whole_corrupt_neighbourhood_raises(tmp_path):
    db = _corrupt_db(tmp_path, 400, range(100, 118))
    port = pfeeder.Feeder(pds.open_dataset("LMDB", db), None, 4, threads=1)
    with pytest.raises(pres.DataIntegrityError, match="ALL corrupt"):
        port._build_batch_inner(25)  # records 100..103
    port.close()


def test_the_journal_file_and_a_resumed_run(tmp_path):
    db = _corrupt_db(tmp_path, 24, (5,))
    journal = pres.quarantine_journal_path(str(tmp_path / "snap"))
    assert journal == str(tmp_path / "snap.quarantine.json")
    pres.QUARANTINE.configure(journal)
    port, _ = _feeders(db, device=True, shuffle=False)
    port._build_batch_inner(1)  # records 5..9
    with open(journal) as f:
        doc = json.load(f)
    assert [(e["index"], e["substitute"]) for e in doc["records"]] == \
        [(5, 6)]
    # a resumed run appends to the journal it finds
    pres.QUARANTINE.configure(journal)
    assert pres.QUARANTINE.count() == 1
    pres.QUARANTINE.record(db, 5, 6, "again")
    pres.QUARANTINE.flush()
    with open(journal) as f:
        assert len(json.load(f)["records"]) == 1
    port.close()


def test_cli_train_journals_a_corrupt_record_and_goes_on(tmp_path):
    from test_torch_cli_tools import _solver_text, example_net
    net = example_net(tmp_path, "mnist")
    train_db = os.path.join(tmp_path, "mnist_train_lmdb")
    with plmdb.LMDBReader(train_db) as r:
        # record 9: outside the records the Net's shape probe reads
        off, size = [s for _, s in r.spans()][9]
    with open(os.path.join(train_db, "data.mdb"), "r+b") as f:
        f.seek(off + size - 30)
        b = f.read(1)
        f.seek(off + size - 30)
        f.write(bytes([b[0] ^ 0xFF]))
    solver = tmp_path / "solver.prototxt"
    solver.write_text(_solver_text(net))
    prefix = str(tmp_path / "lenet")
    _, summary = cli.train(cli.parse_args(
        ["train", "-solver", str(solver), "-max_iter", "3", "-device", "cpu",
         "-snapshot_prefix", prefix]))
    assert summary["quarantined"] == 1
    assert len(summary["losses"]) == 3
    with open(prefix + ".quarantine.json") as f:
        records = json.load(f)["records"]
    assert [(r["index"], r["substitute"]) for r in records] == [(9, 10)]
    assert records[0]["source"] == train_db


def test_record_fault_sites_quarantine_as_jax(tmp_path):
    """CAFFE_TPU_FAULTS' record_corrupt and record_decode rewrite fetched
    records [arg, arg + count): the port reads record by record then (its
    gather cannot see the rewrite) and substitutes as JAX does."""
    db = _corrupt_db(tmp_path, 24, ())
    spec = "record_corrupt:2::6,record_decode:1::15"
    pres.FAULTS.configure(spec)
    jres.FAULTS.configure(spec)
    port, jax = _feeders(db, device=True, shuffle=False, batch=6)
    for it in range(4):
        got, want = port._build_batch_inner(it), jax._build_batch_inner(it)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key])
    assert port._sub_cache == jax._sub_cache == {6: 8, 7: 8, 15: 16}
    assert _entries(pres.QUARANTINE) == _entries(jres.QUARANTINE)
    port.close()
    close_jax(jax)


@pytest.mark.parametrize("gather", [True, False])
def test_a_transient_read_error_is_retried(tmp_path, gather):
    db = _corrupt_db(tmp_path, 24, ())
    pres.FAULTS.configure("feeder_read:2")
    port, _ = _feeders(db, device=True, shuffle=False)
    port._gather_ok = gather
    ref, _ = _feeders(db, device=True, shuffle=False)
    got = port._build_batch_inner(0)
    for key, v in ref._build_batch_inner(0).items():
        np.testing.assert_array_equal(got[key], v)
    assert not pres.FAULTS.active("feeder_read")  # both firings used
    pres.FAULTS.configure("feeder_read:0")  # sticky: the read never works
    with pytest.raises(OSError, match="injected dataset read fault"):
        port._build_batch_inner(1)
    port.close()
    ref.close()
