"""Dataset backends — the Datum codec and the record readers, host-side.

Own copy of the JAX package's caffe_mpi_tpu/data/datasets.py (the port
imports nothing of that package). Reference: include/caffe/util/db*.hpp and
src/caffe/util/db*.cpp (a cursor over key -> Datum records), and
tools/convert_imageset.cpp, which writes raw or encoded Datums.

A dataset is random-access (`__len__` + `get(i) -> (chw_array, label)`),
which subsumes the reference's forward-only cursor and makes the
round-robin record striping of its CursorManager (data_reader.hpp:28-53)
an index calculation (feeder.py).

Ported: the Datum codec both ways (raw, encoded and float Datums), LMDB
through the dependency-free reader of lmdb_io.py with the crc sidecar
verified on every read, the single-file datumfile container, and the
synthetic template dataset. A record that fails its checksum or does not
parse raises RecordIntegrityError: the JAX Feeder's quarantine, which
substitutes a healthy record, is not ported yet (ROADMAP.md §1 item 3),
so a corrupt record stops the run, loudly. Not ported (each raises
NotImplementedError naming ROADMAP.md §1 item 3): `backend: LEVELDB`, the
whole-DB RAM cache (`data_param.cache`, CachedDataset) and the bounded
decoded-record cache (`decoded_cache_mb`, DecodedCacheDataset).
"""

from __future__ import annotations

import os
import struct
from typing import NamedTuple, Protocol

import numpy as np

from ..io import _tag as _dfield, _varint as _dvarint
from .lmdb_io import LMDBError, LMDBReader, crc32c, read_crc_sidecar

# the ROADMAP.md section 1 item that ports what is refused here
DATA_PLANE_ITEM = 3


class RecordIntegrityError(RuntimeError):
    """A record failed its crc32c, its page structure, or its parse."""

    def __init__(self, source: str, index: int, reason: str):
        super().__init__(f"{source}: record {index}: {reason}")
        self.source, self.index, self.reason = source, index, reason


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
    (bytes, or a view into the buffer parsed)."""
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


def _decode_verified(raw: bytes, index: int, source: str,
                     expect_crc: int | None = None):
    """Datum decode, the record's crc32c checked against `expect_crc` (the
    sidecar's) first; a mismatch or a parse failure raises
    RecordIntegrityError."""
    if expect_crc is not None:
        actual = crc32c(raw)
        if actual != expect_crc:
            raise RecordIntegrityError(
                source, index, f"crc32c mismatch (sidecar {expect_crc:08x}, "
                f"computed {actual:08x})")
    try:
        return parse_datum(raw)
    except Exception as e:
        raise RecordIntegrityError(
            source, index, f"undecodable Datum: {e!r}") from e


# ---------------------------------------------------------------------------
# Backends
# ---------------------------------------------------------------------------

class LMDBDataset:
    """LMDBs written by the reference's convert_imageset (db_lmdb.cpp), the
    JAX package or the port, through lmdb_io.LMDBReader. The tree is
    walked once at open for each record's place in the file (a structural
    fault raises there); a read is then a zero-copy view of the mmap, and
    a raw record's pixels are copied once, into the batch. Where the crc
    sidecar (`data.mdb.crc32c`) is present, every value read is checked
    against its crc32c; sidecar-less (reference-written) DBs load
    unverified."""

    def __init__(self, path: str):
        self.path = path
        self._reader = LMDBReader(path)
        try:
            spans = list(self._reader.spans())
        except LMDBError as e:
            raise RecordIntegrityError(path, -1, f"structural: {e}") from e
        self.keys = [k for k, _ in spans]
        self._spans = [s for _, s in spans]
        self._crcs = read_crc_sidecar(path, expect_count=len(self.keys))
        # whether the records are encoded images (the first one says)
        self.encoded = bool(spans) and parse_datum_fields(
            self._reader.view(*self._spans[0])).encoded

    def __len__(self) -> int:
        return len(self.keys)

    def get(self, index: int) -> tuple[np.ndarray, int]:
        expect = int(self._crcs[index]) if self._crcs is not None else None
        raw = self._reader.view(*self._spans[index])
        return _decode_verified(raw, index, self.path, expect)


class DatumFileDataset:
    """Single-file Datum container: MAGIC, raw back-to-back Datum messages,
    then an index [int64 count][count x (int64 offset, int64 size)]
    [int64 index_offset]. Written by tools/convert_imageset
    `-backend datumfile`."""

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

    def __len__(self) -> int:
        return len(self.offsets)

    def get(self, index: int) -> tuple[np.ndarray, int]:
        off, size = self.offsets[index]
        # pread: positioned read, safe under the Feeder's threads
        return _decode_verified(os.pread(self._fd, int(size), int(off)),
                                index, self.path)

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
    """The whole-DB RAM cache (`data_param { cache: true }`): not ported."""

    def __init__(self, *args, **kwargs):
        raise unported("data_param.cache (the whole-DB RAM cache)")


class DecodedCacheDataset:
    """The bounded decoded-record cache (`decoded_cache_mb`): not ported."""

    def __init__(self, *args, **kwargs):
        raise unported("decoded_cache_mb (the decoded-record cache)")


def open_dataset(backend: str, source: str) -> Dataset:
    """db::GetDB analogue (reference db.cpp factory)."""
    backend = str(backend).upper()
    if backend == "LMDB":
        return LMDBDataset(source)
    if backend == "DATUMFILE":
        return DatumFileDataset(source)
    if backend == "LEVELDB":
        raise unported("backend: LEVELDB")
    raise ValueError(f"unknown db backend {backend!r}")
