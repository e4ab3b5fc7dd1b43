"""Dataset backends — the Datum codec and the record readers, host-side.

Own copy of the JAX package's caffe_mpi_tpu/data/datasets.py (the port
imports nothing of that package). Reference: include/caffe/util/db*.hpp and
src/caffe/util/db*.cpp (a cursor over key -> Datum records), and
tools/convert_imageset.cpp, which writes raw or encoded Datums.

A dataset is random-access (`__len__` + `get(i) -> (chw_array, label)`),
which subsumes the reference's forward-only cursor and makes the
round-robin record striping of its CursorManager (data_reader.hpp:28-53)
an index calculation (feeder.py).

Ported: the Datum codec both ways (raw, encoded and float Datums); LMDB
through the native mmap cursor (native.NativeLMDB, csrc/native/
lmdb_reader.cc) with the crc sidecar verified on every read, crc32c
computed in C over the mapping; the single-file datumfile container
through the native reader (native.NativeDatumDB) beside the Python one;
the whole-DB RAM cache (`data_param.cache`, CachedDataset); the bounded
decoded-record cache (`decoded_cache_mb`, DecodedCacheDataset); and the
synthetic template dataset. `get_datum` gives a record's verified wire
fields without decoding the image (the Feeder's fused decode), and
`gather_raw` a whole batch of raw Datums in one native call (its raw
gather). The pure-Python LMDB reader of lmdb_io.py is the plain version:
`LMDBDataset(path, reader="python")`, for the tests and a caller who
asks; the main path does not use it.

A record that fails its checksum or does not parse raises
RecordIntegrityError (utils/resilience.py); the Feeder quarantines it.

LevelDB reads through the pure-Python SSTable and write-ahead-log reader
of leveldb_io.py (each block's masked crc32c verified), as the JAX
package reads it: there is no native LevelDB path. ImageFolderDataset is
the ImageData layer's list of image files, decoded and resized by
decode.decode_file.
"""

from __future__ import annotations

import mmap
import os
import struct
import threading
from typing import NamedTuple, Protocol

import numpy as np

from ..io import _tag as _dfield, _varint as _dvarint
from ..utils.resilience import FAULTS
from ..utils.resilience import RecordIntegrityError  # noqa: F401 (re-export)
from .lmdb_io import LMDBError, LMDBReader, crc32c, read_crc_sidecar

# the ROADMAP.md section 1 item that ports what is refused here
DATA_PLANE_ITEM = 3


class Dataset(Protocol):
    def __len__(self) -> int: ...
    def get(self, index: int) -> tuple[np.ndarray, int]:
        """Returns (CHW uint8 or float image, integer label)."""
        ...


def unported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md §1 item {DATA_PLANE_ITEM})")


# ---------------------------------------------------------------------------
# Datum wire format (reference caffe.proto Datum message, field numbers:
# 1=channels 2=height 3=width 4=data(bytes) 5=label 6=float_data(rep)
# 7=encoded(bool))
# ---------------------------------------------------------------------------

def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


class DatumFields(NamedTuple):
    """A parsed Datum with the image payload still in its stored form
    (bytes, or a view into the buffer parsed): the fused native decode
    (feeder.py) takes encoded payloads from here a batch at a time."""
    channels: int
    height: int
    width: int
    data: bytes
    label: int
    encoded: bool
    float_data: list[float]


def parse_datum_fields(buf: bytes) -> DatumFields:
    """Minimal protobuf-wire Datum parser (no protoc dependency); `buf`
    may be bytes or a memoryview, whose payload slices stay views."""
    channels = height = width = label = 0
    data = b""
    float_data: list[float] = []
    encoded = False
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            val, pos = _read_varint(buf, pos)
            if field == 1:
                channels = val
            elif field == 2:
                height = val
            elif field == 3:
                width = val
            elif field == 5:
                label = val - (1 << 64) if val >= 1 << 63 else val
            elif field == 7:
                encoded = bool(val)
        elif wire == 2:
            size, pos = _read_varint(buf, pos)
            chunk = buf[pos:pos + size]
            pos += size
            if field == 4:
                data = chunk
            elif field == 6:  # packed float_data
                float_data.extend(struct.unpack(f"<{size // 4}f", chunk))
        elif wire == 5:
            if field == 6:
                float_data.append(struct.unpack("<f", buf[pos:pos + 4])[0])
            pos += 4
        elif wire == 1:
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")
    return DatumFields(channels, height, width, data, label, encoded,
                       float_data)


def materialize_datum(f: DatumFields) -> tuple[np.ndarray, int]:
    """DatumFields -> (CHW array, label); encoded payloads decode through
    decode.py (PIL, BGR CHW as the reference's OpenCV decode gives)."""
    if f.encoded:
        from .decode import decode_image
        arr = decode_image(f.data)
    elif f.data:
        arr = np.frombuffer(f.data, np.uint8).reshape(
            f.channels, f.height, f.width)
    else:
        arr = np.asarray(f.float_data, np.float32).reshape(
            f.channels, f.height, f.width)
    return arr, f.label


def parse_datum(buf: bytes) -> tuple[np.ndarray, int]:
    """Datum wire bytes -> (CHW array, label)."""
    return materialize_datum(parse_datum_fields(buf))


def _datum_header(c: int, h: int, w: int) -> bytearray:
    out = bytearray()
    out += _dfield(1, 0) + _dvarint(c)
    out += _dfield(2, 0) + _dvarint(h)
    out += _dfield(3, 0) + _dvarint(w)
    return out


def _label_field(label: int) -> bytes:
    return _dfield(5, 0) + _dvarint(label if label >= 0
                                    else label + (1 << 64))


def encode_datum(arr: np.ndarray, label: int) -> bytes:
    """A raw-bytes Datum (tools/convert_imageset, unencoded)."""
    c, h, w = arr.shape
    out = _datum_header(c, h, w)
    raw = arr.astype(np.uint8).tobytes()
    out += _dfield(4, 2) + _dvarint(len(raw)) + raw
    out += _label_field(label)
    return bytes(out)


def encode_datum_image(arr: np.ndarray, label: int, codec: str = "jpeg",
                       quality: int = 95) -> bytes:
    """A Datum carrying an ENCODED image (field 7 = true, data = JPEG/PNG
    bytes): the reference's `convert_imageset -encoded` path (io.cpp
    EncodeDatum). `arr` is BGR CHW uint8, as parse_datum returns it."""
    import io as _io

    from PIL import Image
    c, h, w = arr.shape
    if c != 3:
        raise ValueError("encoded datums are 3-channel BGR")
    rgb = np.ascontiguousarray(
        arr.astype(np.uint8)[::-1].transpose(1, 2, 0))  # BGR CHW -> RGB HWC
    buf = _io.BytesIO()
    if codec.lower() in ("jpeg", "jpg"):
        Image.fromarray(rgb).save(buf, "JPEG", quality=quality)
    elif codec.lower() == "png":
        Image.fromarray(rgb).save(buf, "PNG")
    else:
        raise ValueError(f"unknown codec {codec!r}")
    raw = buf.getvalue()
    out = _datum_header(c, h, w)
    out += _dfield(4, 2) + _dvarint(len(raw)) + raw
    out += _label_field(label)
    out += _dfield(7, 0) + _dvarint(1)
    return bytes(out)


def encode_datum_float(arr: np.ndarray, label: int) -> bytes:
    """A Datum carrying packed float_data (field 6): the reference's float
    path (caffe.proto Datum.float_data)."""
    c, h, w = arr.shape
    out = _datum_header(c, h, w)
    raw = np.ascontiguousarray(arr, "<f4").tobytes()
    out += _dfield(6, 2) + _dvarint(len(raw)) + raw
    out += _label_field(label)
    return bytes(out)


def _decode_verified(raw, index: int, source: str,
                     expect_crc: int | None = None,
                     actual_crc: int | None = None, *,
                     fields: bool = False):
    """Datum decode with integrity verification. `expect_crc` (the
    sidecar's) is compared against `actual_crc` — computed here over the
    bytes when the caller has none (the native LMDB path computes it in C
    over the mapping). A mismatch or a parse failure raises
    RecordIntegrityError, the signal the Feeder quarantines on. The fault
    sites work on the FETCHED bytes, free when CAFFE_TPU_FAULTS is
    unset. fields=True returns the wire fields, the image not decoded."""
    if FAULTS.active("record_corrupt") or FAULTS.active("record_decode"):
        poisoned = FAULTS.corrupt_bytes("record_corrupt", raw, index)
        poisoned = FAULTS.corrupt_bytes("record_decode", poisoned, index)
        if poisoned is not raw:
            raw, actual_crc = poisoned, None  # re-checksum injected rot
    if expect_crc is not None:
        if actual_crc is None:
            actual_crc = crc32c(raw)
        if actual_crc != expect_crc:
            raise RecordIntegrityError(
                source, index, f"crc32c mismatch (sidecar {expect_crc:08x}, "
                f"computed {actual_crc:08x})")
    try:
        f = parse_datum_fields(raw)
        return f if fields else materialize_datum(f)
    except Exception as e:
        raise RecordIntegrityError(
            source, index, f"undecodable Datum: {e!r}") from e


def _faults_on_records() -> bool:
    """Whether a fault site rewrites fetched records: the native gather
    and the C-side crc cannot see that, so the per-record path runs."""
    return FAULTS.active("record_corrupt") or FAULTS.active("record_decode")


# ---------------------------------------------------------------------------
# Backends
# ---------------------------------------------------------------------------

class LMDBDataset:
    """LMDBs written by the reference's convert_imageset (db_lmdb.cpp), the
    JAX package or the port. reader="native" (the default) reads through
    native.NativeLMDB: the tree is walked once at open into a table of
    each record's place in the mapping, a value's crc32c is computed in C
    over the mapping, and `gather_raw` reads a batch of raw Datums in one
    call. reader="python" reads through lmdb_io.LMDBReader, the plain
    version (a zero-copy view of its mmap a record). Where the crc sidecar
    (`data.mdb.crc32c`) is present, every value read is checked against
    its crc32c; sidecar-less (reference-written) DBs load unverified."""

    def __init__(self, path: str, reader: str = "native"):
        self.path = path
        self._native = self._reader = None
        if reader == "native":
            from ..native import NativeLMDB
            try:
                self._native = NativeLMDB(path)
            except ValueError as e:
                # the native walk names no reason: ask the plain reader
                # for it, and refuse the file either way
                try:
                    list(LMDBReader(path).keys())
                except LMDBError as why:
                    raise RecordIntegrityError(
                        path, -1, f"structural: {why}") from why
                raise RecordIntegrityError(path, -1,
                                           f"structural: {e}") from e
            # records are read by slicing this process's own mapping of
            # the file at the native table's offsets: no ctypes call (and
            # no GIL hand-off) a record but the crc32c's
            data = os.path.join(path, "data.mdb") if os.path.isdir(path) \
                else path
            with open(data, "rb") as f:
                self._mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
            koff, klen, self._voff, self._vlen = self._native.spans()
            self.keys = [self._mm[o:o + n] for o, n in zip(koff.tolist(),
                                                           klen.tolist())]
        elif reader == "python":
            self._reader = LMDBReader(path)
            try:
                spans = list(self._reader.spans())
            except LMDBError as e:
                raise RecordIntegrityError(path, -1,
                                           f"structural: {e}") from e
            self.keys = [k for k, _ in spans]
            self._spans = [s for _, s in spans]
        else:
            raise ValueError(f"unknown LMDB reader {reader!r}")
        self._crcs = read_crc_sidecar(path, expect_count=len(self.keys))
        # whether the records are encoded images (the first one says)
        self.encoded = bool(self.keys) and parse_datum_fields(
            self._value(0)).encoded

    def __len__(self) -> int:
        return len(self.keys)

    def _value(self, index: int):
        if self._native is not None:
            off = int(self._voff[index])
            return self._mm[off:off + int(self._vlen[index])]
        return self._reader.view(*self._spans[index])

    def get(self, index: int) -> tuple[np.ndarray, int]:
        return self._get(index, fields=False)

    def get_datum(self, index: int) -> DatumFields:
        """Verified wire fields WITHOUT decoding the image — the fused
        native decode's fetch; verification is get()'s."""
        return self._get(index, fields=True)

    def _get(self, index: int, fields: bool):
        expect = int(self._crcs[index]) if self._crcs is not None else None
        raw = self._value(index)
        actual = None
        if self._native is not None and expect is not None \
                and not _faults_on_records():
            actual = self._native.value_crc32c(index)
        return _decode_verified(raw, index, self.path, expect, actual,
                                fields=fields)

    def gather_raw(self, idx, shape, out: np.ndarray,
                   num_threads: int = 1):
        """Records `idx` as raw `shape` uint8 Datums into `out` in one
        native call, each checked against its sidecar crc32c over the
        mapping; returns (labels, statuses) (native.gather_raw). None on
        the plain reader, or while a fault site rewrites records."""
        if self._native is None or _faults_on_records():
            return None
        idx = np.asarray(idx, np.int64)
        crcs = None if self._crcs is None else self._crcs[idx]
        return self._native.gather_raw(idx, shape, out, crcs, num_threads)


class DatumFileDataset:
    """Single-file Datum container: MAGIC, raw back-to-back Datum messages,
    then an index [int64 count][count x (int64 offset, int64 size)]
    [int64 index_offset]. Written by tools/convert_imageset
    `-backend datumfile`. This is the Python reader; open_dataset reads
    the file through the native one beside it (_HybridDatumDataset)."""

    MAGIC = b"CAFFEDATUMv1"

    def __init__(self, path: str):
        self.path = path
        self.f = open(path, "rb")
        self._fd = self.f.fileno()
        header = self.f.read(len(self.MAGIC))
        if header != self.MAGIC:
            raise ValueError(f"{path}: not a datumfile")
        self.f.seek(-8, os.SEEK_END)
        index_off = struct.unpack("<q", self.f.read(8))[0]
        self.f.seek(index_off)
        count = struct.unpack("<q", self.f.read(8))[0]
        self.offsets = np.frombuffer(self.f.read(count * 16),
                                     "<i8").reshape(-1, 2)
        self.encoded = bool(len(self.offsets)) and self.get_datum(0).encoded

    def __len__(self) -> int:
        return len(self.offsets)

    def _raw(self, index: int) -> bytes:
        off, size = self.offsets[index]
        # pread: positioned read, safe under the Feeder's threads
        return os.pread(self._fd, int(size), int(off))

    def get(self, index: int) -> tuple[np.ndarray, int]:
        return _decode_verified(self._raw(index), index, self.path)

    def get_datum(self, index: int) -> DatumFields:
        """Verified wire fields without decoding the image."""
        return _decode_verified(self._raw(index), index, self.path,
                                fields=True)

    @classmethod
    def write(cls, path: str, records) -> int:
        """records: an iterable of encoded Datum bytes."""
        offsets = []
        with open(path, "wb") as f:
            f.write(cls.MAGIC)
            for buf in records:
                offsets.append((f.tell(), len(buf)))
                f.write(buf)
            index_off = f.tell()
            f.write(struct.pack("<q", len(offsets)))
            f.write(np.asarray(offsets, "<i8").tobytes())
            f.write(struct.pack("<q", index_off))
        return len(offsets)


class _HybridDatumDataset:
    """A datumfile through the native mmap reader, the Python reader for
    the records the native one declines (encoded and float Datums, and
    any that fail to parse, which raise there)."""

    def __init__(self, native_db, py_ds: DatumFileDataset):
        self.native = native_db
        self.py = py_ds
        self.path = py_ds.path
        self.encoded = py_ds.encoded

    def __len__(self) -> int:
        return len(self.py)

    def get(self, index: int):
        try:
            return self.native.get(index)
        except ValueError:
            return self.py.get(index)

    def get_datum(self, index: int) -> DatumFields:
        # encoded/float records live on the python reader either way
        return self.py.get_datum(index)

    def gather_raw(self, idx, shape, out: np.ndarray, num_threads: int = 1):
        """As LMDBDataset.gather_raw (the datumfile has no checksums)."""
        if _faults_on_records():
            return None
        return self.native.gather_raw(idx, shape, out, num_threads)


class LevelDBDataset:
    """LevelDB datasets written by the reference's convert tools
    (db_leveldb.cpp), through the dependency-free reader of leveldb_io.py:
    every table and write-ahead log merged, key order, Datum values. A
    block that fails its masked crc32c, or a value that does not parse,
    raises RecordIntegrityError for the Feeder's quarantine."""

    def __init__(self, path: str):
        from .leveldb_io import LevelDBReader
        self.path = path
        self._reader = LevelDBReader(path)

    def __len__(self) -> int:
        return len(self._reader)

    def get(self, index: int) -> tuple[np.ndarray, int]:
        return self._get(index, fields=False)

    def get_datum(self, index: int) -> DatumFields:
        """Verified wire fields without image materialization (the fused
        decode); block crc verification as in get()."""
        return self._get(index, fields=True)

    def _get(self, index: int, fields: bool):
        from .leveldb_io import LevelDBError
        try:
            # positional: values decode on demand from the mmap'd tables
            raw = self._reader.value_at(index)
        except LevelDBError as e:
            raise RecordIntegrityError(self.path, index, str(e)) from e
        return _decode_verified(raw, index, self.path, fields=fields)


class ImageFolderDataset:
    """An index file of `relative/path.jpg label` lines (the reference
    ImageData layer's source format, image_data_layer.cpp), each image
    decoded and, given new_height and new_width, resized bilinearly
    (decode.decode_file)."""

    encoded = True  # every record decodes (the Feeder's auto workers)

    def __init__(self, source: str, root: str = "", new_height: int = 0,
                 new_width: int = 0, is_color: bool = True):
        self.root = root
        self.new_hw = (new_height, new_width)
        self.is_color = is_color
        self.items: list[tuple[str, int]] = []
        with open(source) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                path, _, label = line.rpartition(" ")
                self.items.append((path, int(label)))

    def __len__(self) -> int:
        return len(self.items)

    def get(self, index: int) -> tuple[np.ndarray, int]:
        from .decode import decode_file
        path, label = self.items[index]
        with open(os.path.join(self.root, path), "rb") as f:
            data = f.read()
        return decode_file(data, is_color=self.is_color,
                           new_h=self.new_hw[0], new_w=self.new_hw[1]), label


class SyntheticDataset:
    """Deterministic class-template images — a test stand-in."""

    def __init__(self, num: int, shape=(3, 32, 32), classes: int = 10,
                 seed: int = 0, noise: float = 0.3):
        self.num = num
        self.classes = classes
        self.shape = shape
        self.noise = noise
        r = np.random.RandomState(seed)
        self.templates = r.randint(0, 256, (classes, *shape)).astype(np.uint8)

    def __len__(self) -> int:
        return self.num

    def get(self, index: int) -> tuple[np.ndarray, int]:
        label = index % self.classes
        r = np.random.RandomState(index)
        img = self.templates[label].astype(np.float32)
        img = img + self.noise * 255 * r.randn(*self.shape)
        return np.clip(img, 0, 255).astype(np.uint8), label


class CachedDataset:
    """Whole-dataset RAM cache (`data_param { cache: true }`; reference
    DataReader's DataCache, data_reader.hpp:55-101): every record read
    once at open, epoch shuffling left to the Feeder's permutations."""

    def __init__(self, base: Dataset):
        self.path = getattr(base, "path", "") or type(base).__name__
        self.records = [base.get(i) for i in range(len(base))]

    def __len__(self) -> int:
        return len(self.records)

    def get(self, index: int) -> tuple[np.ndarray, int]:
        return self.records[index]


class DecodedCacheDataset:
    """Bounded decoded-record cache (the solver's `decoded_cache_mb`):
    post-decode, pre-augment CHW uint8 arrays kept up to `budget_mb`, so
    every epoch after the first skips the DB read, the crc check and the
    image decode for the cached span — the costly stages of a JPEG or PNG
    LMDB, which otherwise decodes the whole dataset every epoch.

    Admission is first-fit and keyed by record index: once the budget is
    reached nothing is evicted or replaced, so under the Feeder's
    per-epoch permutations the same records hit every epoch. Misses go
    through the base dataset's crc and quarantine path, and only records
    that decoded are admitted. Thread-safe; cached arrays are read-only
    (every consumer copies before it writes)."""

    def __init__(self, base: Dataset, budget_mb: float):
        self.base = base
        self.path = getattr(base, "path", "") or type(base).__name__
        self._budget = int(budget_mb * 2**20)
        self._bytes = 0
        self._full = False
        self._cache: dict[int, tuple[np.ndarray, int]] = {}
        self._lock = threading.Lock()
        base_datum = getattr(base, "get_datum", None)
        if base_datum is not None:
            # the fused decode's fields API only where the base has it
            # (the Feeder probes with getattr)
            self.get_datum = base_datum

    def __len__(self) -> int:
        return len(self.base)

    def lookup(self, index: int):
        """Cached (arr, label) or None — the fused decode asks before it
        fetches the encoded bytes."""
        with self._lock:
            hit = self._cache.get(index)
        if hit is not None:
            from .decode import STATS
            STATS.count("cache_hits")
        return hit

    def admitting(self) -> bool:
        """False once the budget is reached: callers skip decode side
        buffers that could never be admitted."""
        return not self._full

    def insert(self, index: int, arr: np.ndarray, label: int) -> None:
        """Admit a decoded record (first-fit under the byte budget)."""
        if arr.dtype != np.uint8 or self._full:
            return
        arr = np.array(arr)  # own copy: must not pin batch buffers or
        #                      views of a mapping
        arr.setflags(write=False)
        with self._lock:
            if index in self._cache:
                return
            if self._bytes + arr.nbytes > self._budget:
                self._full = True
                return
            self._cache[index] = (arr, int(label))
            self._bytes += arr.nbytes
        from .decode import STATS
        STATS.count("cache_inserts")
        STATS.count("cache_bytes", arr.nbytes)

    def get(self, index: int) -> tuple[np.ndarray, int]:
        hit = self.lookup(index)
        if hit is not None:
            return hit
        arr, label = self.base.get(index)
        self.insert(index, arr, label)
        return arr, label


def open_dataset(backend: str, source: str) -> Dataset:
    """db::GetDB analogue (reference db.cpp factory)."""
    backend = str(backend).upper()
    if backend == "LMDB":
        return LMDBDataset(source)
    if backend == "DATUMFILE":
        from ..native import NativeDatumDB
        py = DatumFileDataset(source)
        return _HybridDatumDataset(NativeDatumDB(source), py)
    if backend == "LEVELDB":
        return LevelDBDataset(source)
    raise ValueError(f"unknown db backend {backend!r}")
