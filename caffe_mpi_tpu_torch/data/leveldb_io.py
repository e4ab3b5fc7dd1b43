"""Dependency-free read-only LevelDB (SSTable + write-ahead log) reader
and fixture writer.

Own copy of the JAX package's caffe_mpi_tpu/data/leveldb_io.py (the port
imports nothing of that package); its files are byte for byte the JAX
writer's for the same items. Replaces src/caffe/util/db_leveldb.{hpp,cpp}
(the reference links libleveldb; neither it nor a python binding is
needed). Caffe opens LevelDB datasets read-only and walks a sequential
cursor (db_leveldb.cpp:8-19, block_size 64KiB), so the full
B-tree-of-logs machinery is unnecessary: a once-written dataset lives in
SSTable files, and reading them needs only the stable on-disk table
format (leveldb/doc/table_format.md):

  [data block]*  [metaindex block]  [index block]  footer(48B)
  footer  = metaindex BlockHandle | index BlockHandle | pad | magic
  handle  = varint64 offset, varint64 size
  block   = entries (prefix-compressed keys) + restarts[] + n_restarts,
            followed by a 5-byte trailer: compression(0=raw,1=snappy)+crc
  entry   = varint shared, varint non_shared, varint value_len,
            key_delta, value
  keys    = InternalKey: user_key + 8 bytes ((sequence<<8) | type),
            type 1=value, 0=deletion

Snappy is decoded in pure Python (format: varint uncompressed length,
then literal/copy tags) — Caffe-era LevelDBs are snappy-compressed by
default. The reader scans every *.ldb/*.sst in the directory and the
NNNNNN.log write-ahead files, and merge-iterates by user key with the
highest sequence number winning, which reproduces the cursor view of a
(possibly compacted) dataset; CURRENT/MANIFEST/LOG files are ignored. A
deletion tombstone hides the key. Every block's masked crc32c is
verified on read (crc32c by the native library, lmdb_io.crc32c).

The writer emits a single valid SSTable (prefix-compressed keys, restart
interval 16, raw or literal-snappy blocks) plus CURRENT/MANIFEST stubs —
enough to build test fixtures and datasets this reader and real leveldb
can open; it is not a general-purpose LSM engine.
"""

from __future__ import annotations

import glob
import os
import struct
import threading

from .lmdb_io import crc32c

TABLE_MAGIC = 0xDB4775248B80FB57
RESTART_INTERVAL = 16
TYPE_VALUE = 1
TYPE_DELETION = 0


class LevelDBError(RuntimeError):
    pass


# crc32c is the native data plane's (lmdb_io.crc32c); leveldb verifies the
# masked checksum on every WAL record during recovery (and on blocks when
# verify_checksums is set), so files written here carry the real one or
# real leveldb drops the records as corrupt.

def masked_crc32c(data: bytes) -> int:
    """leveldb's checksum masking (crc32c.h Mask): rotate right 15 and add
    a constant, so CRCs of CRC-bearing data stay well-distributed."""
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# varints + snappy
# ---------------------------------------------------------------------------

def _uvarint(buf: bytes, pos: int) -> tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _put_uvarint(v: int) -> bytes:
    out = bytearray()
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


def snappy_decompress(buf: bytes) -> bytes:
    """Pure-Python snappy (raw format) decoder."""
    n, pos = _uvarint(buf, 0)
    out = bytearray()
    ln = len(buf)
    while pos < ln:
        tag = buf[pos]
        pos += 1
        kind = tag & 3
        if kind == 0:  # literal
            length = tag >> 2
            if length >= 60:
                nbytes = length - 59
                length = int.from_bytes(buf[pos:pos + nbytes], "little")
                pos += nbytes
            length += 1
            out += buf[pos:pos + length]
            pos += length
            continue
        if kind == 1:  # copy, 1-byte offset
            length = ((tag >> 2) & 0x7) + 4
            offset = ((tag >> 5) << 8) | buf[pos]
            pos += 1
        elif kind == 2:  # copy, 2-byte offset
            length = (tag >> 2) + 1
            offset = int.from_bytes(buf[pos:pos + 2], "little")
            pos += 2
        else:  # copy, 4-byte offset
            length = (tag >> 2) + 1
            offset = int.from_bytes(buf[pos:pos + 4], "little")
            pos += 4
        if offset == 0 or offset > len(out):
            raise LevelDBError("corrupt snappy stream: bad copy offset")
        start = len(out) - offset
        if offset >= length:  # non-overlapping: one slice copy
            out += out[start:start + length]
        else:  # overlapping run: byte-at-a-time semantics
            for i in range(length):
                out.append(out[start + i])
    if len(out) != n:
        raise LevelDBError(
            f"corrupt snappy stream: {len(out)} != declared {n}")
    return bytes(out)


def snappy_compress_literal(buf: bytes) -> bytes:
    """Minimal VALID snappy encoder: everything as literals (no copies).
    Real snappy accepts it; used by the fixture writer."""
    out = bytearray(_put_uvarint(len(buf)))
    pos = 0
    while pos < len(buf):
        chunk = buf[pos:pos + 65536]
        ln = len(chunk) - 1
        if ln < 60:
            out.append(ln << 2)
        else:
            nbytes = (ln.bit_length() + 7) // 8
            out.append((59 + nbytes) << 2)
            out += ln.to_bytes(nbytes, "little")
        out += chunk
        pos += len(chunk)
    return bytes(out)


# ---------------------------------------------------------------------------
# Reader
# ---------------------------------------------------------------------------

def _parse_block(raw: bytes):
    """Yield (key, value) from one decoded block (prefix-compressed)."""
    if len(raw) < 4:
        raise LevelDBError("short block")
    (n_restarts,) = struct.unpack_from("<I", raw, len(raw) - 4)
    data_end = len(raw) - 4 - 4 * n_restarts
    if data_end < 0:
        raise LevelDBError("corrupt block: restart array overruns")
    pos = 0
    key = b""
    while pos < data_end:
        shared, pos = _uvarint(raw, pos)
        non_shared, pos = _uvarint(raw, pos)
        value_len, pos = _uvarint(raw, pos)
        key = key[:shared] + raw[pos:pos + non_shared]
        pos += non_shared
        value = raw[pos:pos + value_len]
        pos += value_len
        yield key, value


class _Table:
    """One mmap'd SSTable file; blocks decode on demand."""

    def __init__(self, path: str):
        import mmap
        self.path = path
        self._f = open(path, "rb")
        self._data = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        if len(self._data) < 48:
            raise LevelDBError(f"{path}: too short for an SSTable")
        footer = self._data[-48:]
        (magic,) = struct.unpack_from("<Q", footer, 40)
        if magic != TABLE_MAGIC:
            raise LevelDBError(f"{path}: bad table magic 0x{magic:x}")
        _mi_off, p = _uvarint(footer, 0)
        _mi_size, p = _uvarint(footer, p)
        idx_off, p = _uvarint(footer, p)
        idx_size, p = _uvarint(footer, p)
        self._index = list(_parse_block(self.read_block(idx_off, idx_size)))

    def read_block(self, offset: int, size: int) -> bytes:
        raw = self._data[offset: offset + size]
        trailer = self._data[offset + size: offset + size + 5]
        if len(raw) != size or len(trailer) != 5:
            raise LevelDBError(f"{self.path}: truncated block")
        comp = trailer[0]
        # the trailer's masked crc32c (over the STORED block bytes + the
        # compression byte, the checksum every writer computes:
        # emit_block below, table_builder.cc in real leveldb) is verified
        # on every block read, as the reference opening with
        # verify_checksums: flipped bits raise LevelDBError naming the
        # file and offset. One crc pass a block decode, amortized by the
        # block cache.
        (want,) = struct.unpack("<I", trailer[1:5])
        got = masked_crc32c(raw + bytes([comp]))
        if got != want:
            raise LevelDBError(
                f"{self.path}: block at offset {offset} failed crc32c "
                f"verification (stored {want:08x}, computed {got:08x})")
        if comp == 0:
            return raw
        if comp == 1:
            return snappy_decompress(raw)
        raise LevelDBError(f"{self.path}: unknown compression {comp}")

    def block_handles(self):
        for _idx_key, handle in self._index:
            off, p = _uvarint(handle, 0)
            size, p = _uvarint(handle, p)
            yield off, size

    def close(self):
        self._data.close()
        self._f.close()


def _split_ikey(ikey: bytes, path: str) -> tuple[bytes, int, int]:
    if len(ikey) < 8:
        raise LevelDBError(f"{path}: short internal key")
    (tail,) = struct.unpack("<Q", ikey[-8:])
    return ikey[:-8], tail >> 8, tail & 0xFF


# -- write-ahead log (leveldb log_format.h) ---------------------------------
# 32KiB blocks of records: crc(4) length(2) type(1) payload; FULL=1,
# FIRST=2, MIDDLE=3, LAST=4. Each reassembled record is a WriteBatch:
# sequence(8) count(4) then count x { kTypeValue(1) klen key vlen value |
# kTypeDeletion(0) klen key }.

_LOG_BLOCK = 32768


def _wal_records(path: str):
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    partial = b""
    while pos + 7 <= len(data):
        block_left = _LOG_BLOCK - (pos % _LOG_BLOCK)
        if block_left < 7:  # trailer padding
            pos += block_left
            continue
        (crc,) = struct.unpack_from("<I", data, pos)
        length, rtype = struct.unpack_from("<HB", data, pos + 4)
        payload = data[pos + 7: pos + 7 + length]
        if rtype == 0 and length == 0:  # preallocated zero region: EOF
            break
        if (len(payload) < length
                or crc != masked_crc32c(bytes([rtype]) + payload)):
            # torn/corrupt tail (writer crashed mid-append): real leveldb
            # recovery keeps the valid prefix and stops here — so do we
            break
        pos += 7 + length
        if rtype == 1:          # FULL
            yield payload
        elif rtype == 2:        # FIRST
            partial = payload
        elif rtype == 3:        # MIDDLE
            partial += payload
        elif rtype == 4:        # LAST
            yield partial + payload
            partial = b""
        else:
            raise LevelDBError(f"{path}: bad WAL record type {rtype}")


def _wal_entries(path: str):
    """Yield (user_key, sequence, type, value) from one WAL file."""
    for batch in _wal_records(path):
        if len(batch) < 12:
            raise LevelDBError(f"{path}: short WriteBatch")
        seq, count = struct.unpack_from("<QI", batch, 0)
        pos = 12
        for i in range(count):
            typ = batch[pos]
            pos += 1
            klen, pos = _uvarint(batch, pos)
            key = batch[pos:pos + klen]
            pos += klen
            if typ == TYPE_VALUE:
                vlen, pos = _uvarint(batch, pos)
                value = batch[pos:pos + vlen]
                pos += vlen
            else:
                value = b""
            yield key, seq + i, typ, value


class LevelDBReader:
    """Read-only cursor over a LevelDB directory: every SSTable plus the
    write-ahead log (leveldb keeps the newest ~write_buffer_size of
    records ONLY in NNNNNN.log until a memtable flush — a freshly written
    small dataset may have no .ldb files at all). Merged by user key,
    newest sequence wins, deletions hide keys — the same view the
    reference's sequential cursor sees after recovery.

    Memory: the key index (key -> block locator) lives in RAM; values
    decode on demand from mmap'd tables through a small block LRU, so a
    multi-GB dataset costs keys + a few blocks, not the file."""

    _BLOCK_CACHE = 8

    def __init__(self, path: str):
        self.path = path
        table_files = sorted(glob.glob(os.path.join(path, "*.ldb"))
                             + glob.glob(os.path.join(path, "*.sst")))
        wal_files = sorted(
            f for f in glob.glob(os.path.join(path, "*.log"))
            if os.path.basename(f).split(".")[0].isdigit())
        if not table_files and not wal_files:
            raise LevelDBError(f"no SSTable or WAL files in {path}")
        self._tables = [_Table(t) for t in table_files]
        # locator: (table_idx, block_off, block_size, entry_idx) for table
        # entries; (-1, wal_value) for WAL-resident values (already bytes)
        best: dict[bytes, tuple[int, int, tuple]] = {}

        def offer(key, seq, typ, loc):
            cur = best.get(key)
            if cur is None or seq > cur[0]:
                best[key] = (seq, typ, loc)

        for ti, table in enumerate(self._tables):
            for off, size in table.block_handles():
                for ei, (ikey, _value) in enumerate(
                        _parse_block(table.read_block(off, size))):
                    key, seq, typ = _split_ikey(ikey, table.path)
                    offer(key, seq, typ, (ti, off, size, ei))
        for wf in wal_files:
            for key, seq, typ, value in _wal_entries(wf):
                offer(key, seq, typ, (-1, value))
        self._records = [(k, loc) for k, (s, typ, loc) in sorted(best.items())
                         if typ == TYPE_VALUE]
        self._block_cache: dict[tuple, list] = {}
        # multi-threaded feeders share one reader; the FIFO eviction's
        # read-evict-insert is not atomic (two threads popping the same
        # head key would race to a KeyError)
        self._cache_lock = threading.Lock()

    def _block_values(self, ti: int, off: int, size: int) -> list:
        key = (ti, off)
        vals = self._block_cache.get(key)  # lock-free hit path (GIL-atomic)
        if vals is None:
            vals = [v for _k, v in
                    _parse_block(self._tables[ti].read_block(off, size))]
            with self._cache_lock:
                while len(self._block_cache) >= self._BLOCK_CACHE:
                    self._block_cache.pop(next(iter(self._block_cache)),
                                          None)
                self._block_cache[key] = vals
        return vals

    def _value(self, loc) -> bytes:
        if loc[0] == -1:
            return loc[1]
        ti, off, size, ei = loc
        return self._block_values(ti, off, size)[ei]

    def __len__(self) -> int:
        return len(self._records)

    def items(self):
        for k, loc in self._records:
            yield k, self._value(loc)

    def keys(self):
        return (k for k, _ in self._records)

    def value_at(self, index: int) -> bytes:
        """Positional access in key order — the datasets' hot path (no
        per-record key bisect)."""
        return self._value(self._records[index][1])

    def get(self, key: bytes):
        import bisect
        # (key,) sorts strictly before (key, loc) — tuple comparison by
        # prefix — so no `key=` kwarg is needed (that kwarg is 3.10+).
        i = bisect.bisect_left(self._records, (key,))
        if i < len(self._records) and self._records[i][0] == key:
            return self._value(self._records[i][1])
        return None

    def close(self):
        for t in self._tables:
            t.close()
        self._block_cache.clear()


# ---------------------------------------------------------------------------
# Fixture writer (single SSTable + CURRENT/MANIFEST stubs)
# ---------------------------------------------------------------------------

class _BlockBuilder:
    def __init__(self):
        self.buf = bytearray()
        self.restarts = [0]
        self.count = 0
        self.last_key = b""

    def add(self, key: bytes, value: bytes):
        shared = 0
        if self.count % RESTART_INTERVAL == 0:
            if self.count:  # restart point: full key stored
                self.restarts.append(len(self.buf))
        else:
            m = min(len(key), len(self.last_key))
            while shared < m and key[shared] == self.last_key[shared]:
                shared += 1
        self.buf += _put_uvarint(shared)
        self.buf += _put_uvarint(len(key) - shared)
        self.buf += _put_uvarint(len(value))
        self.buf += key[shared:]
        self.buf += value
        self.last_key = key
        self.count += 1

    def finish(self) -> bytes:
        out = bytes(self.buf)
        for r in self.restarts:
            out += struct.pack("<I", r)
        return out + struct.pack("<I", len(self.restarts))

    def size(self) -> int:
        return len(self.buf) + 4 * (len(self.restarts) + 1)


def write_wal(path: str, items, start_seq: int = 1) -> None:
    """Write (key, value) pairs as one WriteBatch per record into a
    leveldb write-ahead log file — the shape of the unflushed tail a real
    writer leaves behind. Records carry real masked crc32c, so actual
    leveldb recovery accepts them."""
    out = bytearray()
    for i, (key, value) in enumerate(items):
        batch = struct.pack("<QI", start_seq + i, 1)
        batch += bytes([TYPE_VALUE]) + _put_uvarint(len(key)) + key
        batch += _put_uvarint(len(value)) + value
        # emit FULL records, splitting at 32KiB block boundaries
        pos = 0
        while pos < len(batch) or pos == 0:
            block_left = _LOG_BLOCK - (len(out) % _LOG_BLOCK)
            if block_left < 7:
                out += b"\x00" * block_left
                continue
            chunk = batch[pos: pos + block_left - 7]
            end = pos + len(chunk)
            rtype = (1 if pos == 0 and end == len(batch)
                     else 2 if pos == 0
                     else 4 if end == len(batch) else 3)
            crc = masked_crc32c(bytes([rtype]) + chunk)
            out += struct.pack("<IHB", crc, len(chunk), rtype) + chunk
            pos = end
            if end == len(batch):
                break
    with open(path, "wb") as f:
        f.write(bytes(out))


def write_leveldb(path: str, items, block_size: int = 4096,
                  compress: bool = False, wal_tail: int = 0) -> str:
    """Write a LevelDB directory holding one SSTable with the given
    (key, value) pairs (sorted here). Readable by this module AND by real
    leveldb (valid table format + MANIFEST is regenerated by repair, but
    Caffe's read-only open only needs CURRENT to exist for the impl here;
    the canonical consumer in this repo is LevelDBReader).

    wal_tail: keep the last N records OUT of the SSTable and write them
    to a NNNNNN.log write-ahead file instead — models the unflushed
    memtable tail a real leveldb writer leaves on close."""
    items = sorted(dict(items).items())
    os.makedirs(path, exist_ok=True)
    if wal_tail:
        n_table = max(len(items) - wal_tail, 0)
        write_wal(os.path.join(path, "000006.log"),
                  items[n_table:], start_seq=n_table + 1)
        items = items[:n_table]
    table = bytearray()
    index: list[tuple[bytes, bytes]] = []

    def emit_block(block: bytes) -> bytes:
        nonlocal table
        off = len(table)
        if compress:
            block = snappy_compress_literal(block)
            comp = 1
        else:
            comp = 0
        table += block
        # trailer: compression byte + MASKED crc32c of block+type — the
        # checksum real leveldb verifies under verify_checksums
        crc = masked_crc32c(block + bytes([comp]))
        table += bytes([comp]) + struct.pack("<I", crc)
        return _put_uvarint(off) + _put_uvarint(len(block))

    builder = _BlockBuilder()
    for seq, (key, value) in enumerate(items, start=1):
        ikey = key + struct.pack("<Q", (seq << 8) | TYPE_VALUE)
        builder.add(ikey, value)
        if builder.size() >= block_size:
            handle = emit_block(builder.finish())
            index.append((builder.last_key, handle))
            builder = _BlockBuilder()
    if builder.count:
        handle = emit_block(builder.finish())
        index.append((builder.last_key, handle))

    # metaindex (empty) + index blocks, never compressed here
    mi = _BlockBuilder()
    mi_handle = emit_block(mi.finish())
    ib = _BlockBuilder()
    for last_key, handle in index:
        ib.add(last_key, handle)
    idx_handle = emit_block(ib.finish())

    footer = mi_handle + idx_handle
    footer += b"\x00" * (40 - len(footer))
    footer += struct.pack("<Q", TABLE_MAGIC)
    table += footer

    with open(os.path.join(path, "000005.ldb"), "wb") as f:
        f.write(bytes(table))
    # stubs so the directory shape matches a real environment
    with open(os.path.join(path, "CURRENT"), "w") as f:
        f.write("MANIFEST-000004\n")
    open(os.path.join(path, "MANIFEST-000004"), "wb").close()
    open(os.path.join(path, "LOG"), "w").close()
    return path
