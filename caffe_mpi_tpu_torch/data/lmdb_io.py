"""Dependency-free LMDB reader and writer (mmap'd B+tree pages).

Own copy of the JAX package's caffe_mpi_tpu/data/lmdb_io.py (the port
imports nothing of that package). Replaces src/caffe/util/db_lmdb.{hpp,cpp}:
neither liblmdb nor the python `lmdb` module is needed, because the
on-disk format itself is implemented here — the small, stable B+tree
layout of LMDB 0.9.x "data version 1", which every Caffe-era LMDB uses:

  page 0/1   meta pages (the one with the larger txnid wins)
  page N     branch pages (key -> child pgno), leaf pages (key -> value),
             overflow pages (values larger than ~2KB, F_BIGDATA nodes)

Struct layout follows mdb.c on LP64:
  MDB_page   u64 pgno | u16 pad | u16 flags | u16 lower | u16 upper | ptrs[]
  MDB_meta   u32 magic(0xBEEFC0DE) | u32 version(1) | u64 addr | u64 mapsize
             | MDB_db[2] | u64 last_pg | u64 txnid     (page psize is
             stored in mm_dbs[0].md_pad)
  MDB_db     u32 pad | u16 flags | u16 depth | u64 branch | u64 leaf
             | u64 overflow | u64 entries | u64 root
  MDB_node   u16 lo | u16 hi | u16 flags | u16 ksize | key | data
             (branch: child pgno = lo | hi<<16 | flags<<32;
              leaf: data size = lo | hi<<16, F_BIGDATA=0x01 means the data
              area holds a u64 overflow pgno)

The reader is read-only: `items()` and `get()` copy values out of the
mmap, `spans()` and `view()` read them in place; the writer is a
bulk sorted-insert B+tree writer — what convert_imageset needs — not a
transactional store. Its output is byte for byte the JAX writer's for the
same items, and so is the per-record crc32c sidecar both publish.

crc32c (Castagnoli) is the checksum of that sidecar: the native data
plane's (`csrc/native/lmdb_reader.cc`: SSE4.2's crc32 instruction where
the CPU has it, else a slice-by-8 table loop), built by the host C++
compiler at first use (ops/build.py), on the card's machine and the CPU
alike. A missing compiler or a failed build raises; it does not fall
back.
"""

from __future__ import annotations

import logging
import mmap
import os
import struct

import numpy as np

log = logging.getLogger("caffe_mpi_tpu_torch.lmdb")

PAGEHDRSZ = 16
META_MAGIC = 0xBEEFC0DE
META_VERSION = 1
P_INVALID = 0xFFFFFFFFFFFFFFFF

P_BRANCH = 0x01
P_LEAF = 0x02
P_OVERFLOW = 0x04
P_META = 0x08

F_BIGDATA = 0x01

_META = struct.Struct("<IIQQ")          # magic, version, address, mapsize
_DB = struct.Struct("<IHHQQQQQ")        # pad, flags, depth, b, l, o, entries, root
_PAGEHDR = struct.Struct("<QHHHH")      # pgno, pad, flags, lower, upper
_NODEHDR = struct.Struct("<HHHH")       # lo, hi, flags, ksize


def _even(n: int) -> int:
    return (n + 1) & ~1


class LMDBError(RuntimeError):
    pass


class LMDBReader:
    """Read-only cursor over the main DB of an LMDB environment.

    `path` may be the environment directory (containing data.mdb) or the
    data file itself (MDB_NOSUBDIR layout). Iteration yields (key, value)
    bytes in key order — the order the reference's sequential cursor sees.
    """

    def __init__(self, path: str):
        if os.path.isdir(path):
            path = os.path.join(path, "data.mdb")
        self.path = path
        self._f = open(path, "rb")
        self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        self._view = memoryview(self._mm)
        meta = self._pick_meta()
        (self.psize, main_flags, self.depth, branch_pages, leaf_pages,
         overflow_pages, self.entries, self.root) = meta
        if main_flags:  # DUPSORT(0x04)/INTEGERKEY(0x08)/REVERSEKEY(0x02)
            # all change key comparison or node layout; Caffe main DBs
            # always have md_flags == 0
            raise LMDBError(
                f"unsupported main-DB flags 0x{main_flags:x} in {path}")

    # -- meta ------------------------------------------------------------
    def _parse_meta_at(self, off: int):
        hdr = _PAGEHDR.unpack_from(self._view, off)
        if not hdr[2] & P_META:
            raise LMDBError(f"page at {off} is not a meta page")
        magic, version, _addr, _mapsize = _META.unpack_from(
            self._view, off + PAGEHDRSZ)
        if magic != META_MAGIC:
            raise LMDBError(f"bad LMDB magic 0x{magic:x} in {self.path}")
        if version != META_VERSION:
            raise LMDBError(f"unsupported LMDB data version {version}")
        base = off + PAGEHDRSZ + _META.size
        free_db = _DB.unpack_from(self._view, base)
        main_db = _DB.unpack_from(self._view, base + _DB.size)
        last_pg, txnid = struct.unpack_from("<QQ", self._view,
                                            base + 2 * _DB.size)
        psize = free_db[0] or 4096  # mm_psize lives in mm_dbs[0].md_pad
        return txnid, (psize, main_db[1], main_db[2], main_db[3], main_db[4],
                       main_db[5], main_db[6], main_db[7])

    def _pick_meta(self):
        # meta 0 is at offset 0; meta 1 is at offset psize (mm_psize, read
        # from meta 0's mm_dbs[0].md_pad). Newest (larger txnid) wins.
        t0, m0 = self._parse_meta_at(0)
        try:
            t1, m1 = self._parse_meta_at(m0[0])
        except (LMDBError, struct.error):
            return m0
        return m1 if t1 > t0 else m0

    # -- pages -----------------------------------------------------------
    def _page(self, pgno: int):
        off = pgno * self.psize
        if off + self.psize > len(self._view):
            raise LMDBError(f"page {pgno} beyond EOF in {self.path}")
        pg, _pad, flags, lower, upper = _PAGEHDR.unpack_from(self._view, off)
        return off, flags, lower, upper

    def _nkeys(self, lower: int) -> int:
        return (lower - PAGEHDRSZ) >> 1

    def _node(self, page_off: int, i: int):
        (ptr,) = struct.unpack_from("<H", self._view,
                                    page_off + PAGEHDRSZ + 2 * i)
        noff = page_off + ptr
        lo, hi, flags, ksize = _NODEHDR.unpack_from(self._view, noff)
        return noff, lo, hi, flags, ksize

    def _node_key(self, noff: int, ksize: int) -> bytes:
        return bytes(self._view[noff + 8: noff + 8 + ksize])

    def _value_span(self, noff: int, lo: int, hi: int, flags: int,
                    ksize: int) -> tuple[int, int]:
        """(file offset, size) of a leaf node's value."""
        dsize = lo | (hi << 16)
        doff = noff + 8 + ksize
        if flags & F_BIGDATA:
            (ovpgno,) = struct.unpack_from("<Q", self._view, doff)
            ooff, oflags, olower, oupper = self._page(ovpgno)
            if not oflags & P_OVERFLOW:
                raise LMDBError(f"page {ovpgno} is not an overflow page")
            # The value may span several overflow pages; _page() only
            # validated the first one, so check the full extent.
            if ooff + PAGEHDRSZ + dsize > len(self._view):
                raise LMDBError(
                    f"overflow value at page {ovpgno} extends beyond EOF "
                    f"in {self.path}")
            return ooff + PAGEHDRSZ, dsize
        return doff, dsize

    def _leaf_value(self, noff: int, lo: int, hi: int, flags: int,
                    ksize: int) -> bytes:
        off, size = self._value_span(noff, lo, hi, flags, ksize)
        return bytes(self._view[off:off + size])

    # -- public API ------------------------------------------------------
    def __len__(self) -> int:
        return self.entries

    def _walk(self, with_values: bool, spans: bool = False):
        """DFS over the B+tree in key order (LMDB has no leaf sibling
        links; the C cursor keeps the same page stack)."""
        if self.root == P_INVALID:
            return
        stack = [(self.root, 0)]
        while stack:
            pgno, i = stack.pop()
            off, flags, lower, _upper = self._page(pgno)
            n = self._nkeys(lower)
            if flags & P_LEAF:
                for j in range(n):
                    noff, lo, hi, nflags, ksize = self._node(off, j)
                    key = self._node_key(noff, ksize)
                    if spans:
                        yield key, self._value_span(noff, lo, hi, nflags,
                                                    ksize)
                    elif with_values:
                        yield key, self._leaf_value(noff, lo, hi, nflags,
                                                    ksize)
                    else:
                        yield key
            elif flags & P_BRANCH:
                if i + 1 < n:
                    stack.append((pgno, i + 1))
                noff, lo, hi, nflags, _ksize = self._node(off, i)
                stack.append((lo | (hi << 16) | (nflags << 32), 0))
            else:
                raise LMDBError(f"unexpected page flags 0x{flags:x}")

    def items(self):
        return self._walk(with_values=True)

    def keys(self):
        # keys-only walk: touches page headers + key bytes, never copies
        # values (a multi-GB DB's key list costs MBs, not the whole file)
        return self._walk(with_values=False)

    def spans(self):
        """(key, (offset, size)) of every record in key order, from one
        walk that copies no value; `view(offset, size)` reads one."""
        return self._walk(with_values=False, spans=True)

    def view(self, offset: int, size: int) -> memoryview:
        """A value as a zero-copy view of the mmap (valid until close)."""
        return self._view[offset:offset + size]

    def get(self, key: bytes):
        """Point lookup, binary search down the tree (mdb_cursor_set)."""
        if self.root == P_INVALID:
            return None
        pgno = self.root
        while True:
            off, flags, lower, _upper = self._page(pgno)
            n = self._nkeys(lower)
            if flags & P_LEAF:
                lo_i, hi_i = 0, n - 1
                while lo_i <= hi_i:
                    mid = (lo_i + hi_i) // 2
                    noff, lo, hi, nflags, ksize = self._node(off, mid)
                    k = self._node_key(noff, ksize)
                    if k == key:
                        return self._leaf_value(noff, lo, hi, nflags, ksize)
                    if k < key:
                        lo_i = mid + 1
                    else:
                        hi_i = mid - 1
                return None
            # branch: rightmost child whose separator <= key (node 0 is the
            # -inf child: its stored key, if any, is not consulted)
            child_i = 0
            lo_i, hi_i = 1, n - 1
            while lo_i <= hi_i:
                mid = (lo_i + hi_i) // 2
                noff, _lo, _hi, _f, ksize = self._node(off, mid)
                if self._node_key(noff, ksize) <= key:
                    child_i = mid
                    lo_i = mid + 1
                else:
                    hi_i = mid - 1
            noff, lo, hi, nflags, _ksize = self._node(off, child_i)
            pgno = lo | (hi << 16) | (nflags << 32)

    def close(self):
        self._view.release()
        self._mm.close()
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# crc32c (Castagnoli, reflected polynomial 0x82F63B78)
# ---------------------------------------------------------------------------

def crc32c(data) -> int:
    """crc32c of bytes-like `data`, bytes or a memoryview, by the native
    library, read through the buffer's address (no copy; ctypes lets go
    of the GIL for the call)."""
    from ..native import crc32c as native_crc32c
    return native_crc32c(data)


def _atomic_output_write(path: str, chunks) -> None:
    """Write `chunks` to a temporary file beside `path`, fsync it and
    move it into place, so a reader sees the whole file or none."""
    tmp = f"{path}.tmp{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            for c in chunks:
                f.write(c)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


# ---------------------------------------------------------------------------
# Per-record integrity sidecar
# ---------------------------------------------------------------------------
# The LMDB format itself carries no record checksums (mdb.c trusts the
# filesystem), so corruption inside a value is invisible to the B+tree
# walk: the page structure stays valid while the pixels rot. The writer
# publishes a compact sidecar next to data.mdb — one crc32c per value,
# in key order, self-checksummed — and the reader verifies every value
# against it when present. Reference-written LMDBs have no sidecar and
# load unverified.

CRC_SIDECAR_MAGIC = b"LMDBCRC1"
CRC_SIDECAR_SUFFIX = ".crc32c"


def crc_sidecar_path(data_path: str) -> str:
    """Sidecar path for a data file; accepts the env dir too."""
    if os.path.isdir(data_path):
        data_path = os.path.join(data_path, "data.mdb")
    return data_path + CRC_SIDECAR_SUFFIX


def write_crc_sidecar(data_path: str, crcs: list[int]) -> str:
    """Publish `<data.mdb>.crc32c`: magic | u64 count | u32 crc per
    record (key order) | u32 crc32c of the array — the trailing
    checksum means a rotten sidecar is detected and IGNORED (treated
    as absent) rather than quarantining the whole dataset."""
    path = crc_sidecar_path(data_path)
    body = struct.pack(f"<{len(crcs)}I", *crcs)
    # temp+rename: a crash mid-publish must not leave a torn sidecar that
    # silently disables verification for the dataset
    _atomic_output_write(path, (CRC_SIDECAR_MAGIC,
                                struct.pack("<Q", len(crcs)), body,
                                struct.pack("<I", crc32c(body))))
    return path


def read_crc_sidecar(data_path: str, expect_count: int | None = None):
    """Load the sidecar's u32 crc array, or None when absent/invalid
    (a warning names WHY — count mismatch or self-checksum failure
    means the sidecar rotted, not the data)."""
    path = crc_sidecar_path(data_path)
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except OSError:
        return None
    hdr = len(CRC_SIDECAR_MAGIC)
    if len(raw) < hdr + 12 or raw[:hdr] != CRC_SIDECAR_MAGIC:
        log.warning("%s: not a crc sidecar; ignoring", path)
        return None
    (count,) = struct.unpack_from("<Q", raw, hdr)
    body = raw[hdr + 8:-4]
    (self_crc,) = struct.unpack_from("<I", raw, len(raw) - 4)
    if len(body) != 4 * count or crc32c(body) != self_crc:
        log.warning("%s: crc sidecar failed its self-checksum; record "
                    "verification disabled for this dataset", path)
        return None
    if expect_count is not None and count != expect_count:
        log.warning("%s: crc sidecar covers %d records but the DB has "
                    "%d; ignoring (stale sidecar?)", path, count,
                    expect_count)
        return None
    return np.frombuffer(body, "<u4")


# ---------------------------------------------------------------------------
# Writer: bulk sorted B+tree construction
# ---------------------------------------------------------------------------

class _PageBuf:
    def __init__(self, pgno: int, flags: int, psize: int):
        self.pgno = pgno
        self.flags = flags
        self.psize = psize
        self.ptrs: list[int] = []
        self.blobs: list[bytes] = []
        self.upper = psize

    def free(self) -> int:
        lower = PAGEHDRSZ + 2 * len(self.ptrs)
        return self.upper - lower

    def add(self, node: bytes) -> bool:
        need = _even(len(node)) + 2
        if need > self.free():
            return False
        self.upper -= _even(len(node))
        self.ptrs.append(self.upper)
        self.blobs.append(node)
        return True

    def render(self) -> bytes:
        buf = bytearray(self.psize)
        lower = PAGEHDRSZ + 2 * len(self.ptrs)
        _PAGEHDR.pack_into(buf, 0, self.pgno, 0, self.flags, lower,
                           self.upper)
        struct.pack_into(f"<{len(self.ptrs)}H", buf, PAGEHDRSZ, *self.ptrs)
        for ptr, blob in zip(self.ptrs, self.blobs):
            buf[ptr: ptr + len(blob)] = blob
        return bytes(buf)


def _leaf_node(key: bytes, value: bytes, big_pgno: int | None) -> bytes:
    dsize = len(value)
    if big_pgno is not None:
        return _NODEHDR.pack(dsize & 0xFFFF, dsize >> 16, F_BIGDATA,
                             len(key)) + key + struct.pack("<Q", big_pgno)
    return _NODEHDR.pack(dsize & 0xFFFF, dsize >> 16, 0, len(key)) + key + value


def _branch_node(key: bytes, pgno: int) -> bytes:
    return _NODEHDR.pack(pgno & 0xFFFF, (pgno >> 16) & 0xFFFF,
                         (pgno >> 32) & 0xFFFF, len(key)) + key


def write_lmdb(path: str, items, psize: int = 4096,
               subdir: bool = True, integrity: bool = True) -> str:
    """Write a fresh single-DB LMDB environment from (key, value) pairs.

    STREAMING: items may be any iterable; keys must arrive in ascending
    order (convert_imageset's "%08d" keys already do — the same order
    mdb_put sees) unless a list/tuple is passed, which is sorted here.
    Finalized pages are written straight to their file offset, so memory
    stays O(one page + one (first_key, pgno) pair per tree node), never
    O(dataset) — an ImageNet-scale conversion streams through.

    Values larger than the in-page node budget go to overflow pages with
    F_BIGDATA nodes, same threshold rule as mdb.c
    (me_nodemax = (psize - PAGEHDRSZ)/2 & -2). Returns the data file path.

    integrity=True (default) also publishes the per-record crc32c
    sidecar (`data.mdb.crc32c`) the readers verify against;
    the 4 bytes/record accumulate in RAM (an ImageNet-scale conversion
    costs a few MB), everything else stays streaming.
    """
    if isinstance(items, (list, tuple)):
        # mdb_put semantics: last write to a key wins
        items = {k: v for k, v in sorted(items, key=lambda kv: kv[0])}.items()
    nodemax = ((psize - PAGEHDRSZ) // 2) & ~1
    maxkey = nodemax - 8 - 8  # node header + overflow pgno must also fit

    if subdir:
        os.makedirs(path, exist_ok=True)
        data_path = os.path.join(path, "data.mdb")
    else:
        data_path = path

    next_pgno = 2  # 0/1 are the metas
    n_leaf = n_branch = n_over = n_entries = 0
    value_crcs: list[int] = [] if integrity else None

    with open(data_path, "wb") as f:

        def alloc(n=1):
            nonlocal next_pgno
            pg = next_pgno
            next_pgno += n
            return pg

        def put_page(pgno: int, data: bytes):
            f.seek(pgno * psize)
            f.write(data)

        # ---- leaves (and overflow chains), streamed --------------------
        leaves: list[tuple[bytes, int]] = []  # (first_key, pgno)
        cur: _PageBuf | None = None
        prev_key = None

        def flush_leaf():
            nonlocal cur, n_leaf
            if cur is not None and cur.ptrs:
                put_page(cur.pgno, cur.render())
                n_leaf += 1
            cur = None

        for key, value in items:
            if len(key) > maxkey:
                raise LMDBError(f"key too long ({len(key)} > {maxkey})")
            if prev_key is not None and key <= prev_key:
                if key == prev_key:
                    raise LMDBError(
                        f"duplicate key {key!r} in stream (pass a list to "
                        "get mdb_put last-write-wins semantics)")
                raise LMDBError(
                    "streamed items must have strictly ascending keys "
                    f"({key!r} after {prev_key!r}); pass a list to sort")
            prev_key = key
            n_entries += 1
            if integrity:
                value_crcs.append(crc32c(value))
            big = None
            if 8 + len(key) + len(value) > nodemax:
                npg = (PAGEHDRSZ + len(value) + psize - 1) // psize
                big = alloc(npg)
                n_over += npg
                ov = bytearray(npg * psize)
                _PAGEHDR.pack_into(ov, 0, big, 0, P_OVERFLOW, 0, 0)
                struct.pack_into("<I", ov, 12, npg)  # mp_pages union
                ov[PAGEHDRSZ: PAGEHDRSZ + len(value)] = value
                put_page(big, bytes(ov))
            node = _leaf_node(key, value, big)
            if cur is None or not cur.add(node):
                flush_leaf()
                cur = _PageBuf(alloc(), P_LEAF, psize)
                leaves.append((key, cur.pgno))
                if not cur.add(node):
                    raise LMDBError("node cannot fit an empty leaf page")
        flush_leaf()

        # ---- branches, bottom-up ---------------------------------------
        level = leaves
        depth = 1 if leaves else 0
        while len(level) > 1:
            nxt: list[tuple[bytes, int]] = []
            buf: _PageBuf | None = None
            for first_key, child in level:
                # node 0 of each branch page carries no key (-inf child)
                key = b"" if buf is None else first_key
                node = _branch_node(key, child)
                if buf is not None and not buf.add(node):
                    put_page(buf.pgno, buf.render())
                    n_branch += 1
                    buf = None
                    node = _branch_node(b"", child)
                if buf is None:
                    buf = _PageBuf(alloc(), P_BRANCH, psize)
                    nxt.append((first_key, buf.pgno))
                    if not buf.add(node):
                        raise LMDBError(
                            "branch node cannot fit an empty page")
            if buf is not None and buf.ptrs:
                put_page(buf.pgno, buf.render())
                n_branch += 1
            level = nxt
            depth += 1

        root = level[0][1] if level else P_INVALID

        # ---- metas (written last: root/counters now known) -------------
        last_pg = next_pgno - 1
        mapsize = next_pgno * psize

        def meta_page(pgno: int, txnid: int) -> bytes:
            buf = bytearray(psize)
            _PAGEHDR.pack_into(buf, 0, pgno, 0, P_META, 0, 0)
            _META.pack_into(buf, PAGEHDRSZ, META_MAGIC, META_VERSION, 0,
                            mapsize)
            base = PAGEHDRSZ + _META.size
            # free DB: empty; md_pad carries the page size (mm_psize)
            _DB.pack_into(buf, base, psize, 0, 0, 0, 0, 0, 0, P_INVALID)
            _DB.pack_into(buf, base + _DB.size, 0, 0, depth, n_branch,
                          n_leaf, n_over, n_entries, root)
            struct.pack_into("<QQ", buf, base + 2 * _DB.size, last_pg,
                             txnid)
            return bytes(buf)

        put_page(0, meta_page(0, 0))
        put_page(1, meta_page(1, 1))
    if integrity:
        write_crc_sidecar(data_path, value_crcs)
    return data_path
