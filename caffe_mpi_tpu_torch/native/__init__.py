"""ctypes bindings of the port's native data plane (`csrc/native/`).

Own copy of the JAX package's caffe_mpi_tpu/native/__init__.py, name for
name: the mmap'd LMDB cursor (`NativeLMDB`), the datumfile reader
(`NativeDatumDB`), the threaded batch transform (`transform_batch`), and
the libjpeg/libpng decode plane (`decode_available`, `decode_probe`,
`decode_image_native`, `decode_resize_native`, `decode_transform_batch`,
the `DECODE_*` statuses) and the serving window preprocess
(`serve_preprocess_available`, `serve_preprocess_batch`). The port adds the raw-batch gathers
(`NativeLMDB.gather_raw`, `NativeDatumDB.gather_raw`): a batch of raw
Datums checked, walked and copied into one uint8 stack in one call.

The library is built by ops/build.py at first use (`build.load
("native")`) and loaded with `ctypes.CDLL`, which lets go of the GIL for
every call. There is no quiet fallback: a library that does not build
raises at the first call. Where the host has no libjpeg/libpng headers
the library is built with stubbed decode entry points and
`decode_available()` is False: the records then decode through PIL
(data/decode.py), as in the JAX package.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

ABI_VERSION = 2  # csrc/native/transform.cc caffe_tpu_native_abi_version

_LIB = None
_LOCK = threading.Lock()
_DECODE: tuple = (None, False)  # (the library asked, its answer)

_P = ctypes.POINTER
_I64P = _P(ctypes.c_int64)
_I32P = _P(ctypes.c_int32)

_SIGNATURES = {
    "caffe_tpu_native_abi_version": (ctypes.c_int, []),
    "caffe_tpu_db_open": (ctypes.c_void_p, [ctypes.c_char_p]),
    "caffe_tpu_db_count": (ctypes.c_int64, [ctypes.c_void_p]),
    "caffe_tpu_db_get": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_int64, _P(ctypes.c_void_p),
        _P(ctypes.c_int), _P(ctypes.c_int), _P(ctypes.c_int),
        _P(ctypes.c_int)]),
    "caffe_tpu_db_gather_raw": (ctypes.c_int, [
        ctypes.c_void_p, _I64P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, _I64P, _I32P, ctypes.c_int]),
    "caffe_tpu_db_close": (None, [ctypes.c_void_p]),
    "caffe_tpu_lmdb_open": (ctypes.c_void_p, [ctypes.c_char_p]),
    "caffe_tpu_lmdb_count": (ctypes.c_int64, [ctypes.c_void_p]),
    "caffe_tpu_lmdb_record": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_int64, _P(ctypes.c_void_p), _I64P,
        _P(ctypes.c_void_p), _I64P]),
    "caffe_tpu_lmdb_spans": (ctypes.c_int, [ctypes.c_void_p, _I64P, _I64P,
                                            _I64P, _I64P]),
    "caffe_tpu_lmdb_value_crc32c": (ctypes.c_int64,
                                    [ctypes.c_void_p, ctypes.c_int64]),
    "caffe_tpu_lmdb_gather_raw": (ctypes.c_int, [
        ctypes.c_void_p, _I64P, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, _I64P,
        _I32P, ctypes.c_int]),
    "caffe_tpu_lmdb_close": (None, [ctypes.c_void_p]),
    "caffe_tpu_crc32c": (ctypes.c_int64,
                         [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int]),
    "caffe_tpu_philox_aug": (ctypes.c_int, [
        _I64P, ctypes.c_int, ctypes.c_uint64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, _I32P]),
    "caffe_tpu_decode_available": (ctypes.c_int, []),
    "caffe_tpu_decode_probe": (ctypes.c_int, [
        ctypes.c_char_p, ctypes.c_int64, _P(ctypes.c_int),
        _P(ctypes.c_int)]),
    "caffe_tpu_decode_image": (ctypes.c_int, [
        ctypes.c_char_p, ctypes.c_int64, _P(ctypes.c_uint8),
        ctypes.c_int64, _P(ctypes.c_int), _P(ctypes.c_int)]),
    "caffe_tpu_decode_resize": (ctypes.c_int, [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        _P(ctypes.c_uint8), ctypes.c_int64]),
    "caffe_tpu_decode_transform_batch": (ctypes.c_int, [
        _P(ctypes.c_char_p),                      # srcs
        _I64P,                                    # lens
        _I64P,                                    # record_ids
        ctypes.c_int,                             # n
        ctypes.c_int,                             # crop
        ctypes.c_void_p,                          # mean
        ctypes.c_int, ctypes.c_float,             # mean_mode, scale
        ctypes.c_int, ctypes.c_int,               # train, mirror
        ctypes.c_uint64,                          # seed
        ctypes.c_int, ctypes.c_int,               # out_h, out_w
        _P(ctypes.c_float),                       # out (nullable)
        _P(ctypes.c_void_p),                      # decoded_out (nullable)
        _I64P,                                    # decoded_caps
        _I32P,                                    # status
        ctypes.c_int,                             # num_threads
    ]),
    "caffe_tpu_serve_preprocess_batch": (ctypes.c_int, [
        _P(ctypes.c_void_p),                      # srcs
        _I32P,                                    # dims (h, w pairs)
        ctypes.c_int, ctypes.c_int,               # n, channels
        ctypes.c_int, ctypes.c_int,               # img_h, img_w
        ctypes.c_int, ctypes.c_int,               # crop_h, crop_w
        _I32P,                                    # swap
        ctypes.c_int, ctypes.c_float,             # has_raw, raw_scale
        _P(ctypes.c_float),                       # mean (nullable)
        ctypes.c_int, ctypes.c_float,             # has_iscale, input_scale
        _P(ctypes.c_float),                       # out
        _I32P,                                    # status
        ctypes.c_int,                             # num_threads
    ]),
    "caffe_tpu_transform_batch": (ctypes.c_int, [
        _P(ctypes.c_void_p),                      # srcs
        _I64P,                                    # record_ids
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # n c h w
        ctypes.c_int,                             # crop
        ctypes.c_void_p,                          # mean
        ctypes.c_int, ctypes.c_float,             # mean_mode, scale
        ctypes.c_int, ctypes.c_int,               # train, mirror
        ctypes.c_uint64,                          # seed
        _P(ctypes.c_float),                       # out
        ctypes.c_int,                             # num_threads
    ]),
}


def lib() -> ctypes.CDLL:
    """The loaded library, built on first use; raises when it does not
    build or its ABI version is not this binding's."""
    global _LIB
    if _LIB is None:
        with _LOCK:
            if _LIB is None:
                from ..ops import build
                lb = build.load(build.NATIVE)
                for name, (res, args) in _SIGNATURES.items():
                    fn = getattr(lb, name)
                    fn.restype, fn.argtypes = res, args
                got = lb.caffe_tpu_native_abi_version()
                if got != ABI_VERSION:
                    raise RuntimeError(
                        f"native library ABI {got}, binding {ABI_VERSION}")
                _LIB = lb
    return _LIB


def crc32c(data, hw: bool = True) -> int:
    """crc32c of bytes-like `data` by the library's table (hw False) or
    its SSE4.2 loop where the CPU has one (the gathers' checksum)."""
    a = np.frombuffer(data, np.uint8)
    return int(lib().caffe_tpu_crc32c(a.ctypes.data, a.size, int(hw)))


def philox_aug(flats, seed: int, h: int, w: int, crop: int,
               mirror: bool) -> np.ndarray:
    """TRAIN augmentation decisions (B, 3) int32 [off_h, off_w, mirror]
    of the records `flats`, drawn from numpy's Philox streams keyed
    (seed << 32) ^ flat as data/device_transform.compute_aug draws them
    (csrc/native/philox_aug.cc). seed in [0, 2^64), flats >= 0,
    crop <= h and w."""
    flats = np.ascontiguousarray(flats, np.int64)
    out = np.empty((flats.size, 3), np.int32)
    rc = lib().caffe_tpu_philox_aug(
        flats.ctypes.data_as(_I64P), flats.size, seed, h, w, crop,
        int(mirror), out.ctypes.data_as(_I32P))
    if rc != 0:
        raise ValueError(f"philox_aug: crop {crop} exceeds {h}x{w}")
    return out


# statuses of the raw gathers (csrc/native/datum_wire.h kGather*)
GATHER_OK = 0
GATHER_INDEX = 1
GATHER_CRC = 2
GATHER_WIRE = 3
GATHER_NOT_RAW = 4


def _gather_args(idx, shape, out):
    c, h, w = (int(v) for v in shape)
    idx = np.ascontiguousarray(idx, np.int64)
    n = idx.size
    if out.dtype != np.uint8 or not out.flags.c_contiguous or \
            out.shape != (n, c, h, w):
        raise ValueError(f"gather out must be a contiguous uint8 "
                         f"{(n, c, h, w)}, got {out.dtype} {out.shape}")
    return idx, n, c, h, w


class NativeDatumDB:
    """mmap'd zero-copy datumfile reader (datumdb.cc); records parsed in C,
    pixel pointers point into the map — no per-record Python work."""

    def __init__(self, path: str):
        self._lib = lib()
        self._h = self._lib.caffe_tpu_db_open(path.encode())
        if not self._h:
            raise ValueError(f"{path}: not a readable datumfile")
        self._n = self._lib.caffe_tpu_db_count(self._h)

    def __len__(self) -> int:
        return self._n

    def get(self, index: int) -> tuple[np.ndarray, int]:
        ptr = ctypes.c_void_p()
        c, h, w, label = (ctypes.c_int() for _ in range(4))
        rc = self._lib.caffe_tpu_db_get(self._h, index, ctypes.byref(ptr),
                                        ctypes.byref(c), ctypes.byref(h),
                                        ctypes.byref(w), ctypes.byref(label))
        if rc != 0:
            raise ValueError(f"record {index}: native parse failed (rc {rc}; "
                             "encoded/float datums use the python reader)")
        size = c.value * h.value * w.value
        arr = np.ctypeslib.as_array(
            ctypes.cast(ptr, ctypes.POINTER(ctypes.c_uint8)), (size,))
        # copy out of the mmap so the array outlives close()
        return arr.reshape(c.value, h.value, w.value).copy(), label.value

    def gather_raw(self, idx, shape, out: np.ndarray,
                   num_threads: int = 1) -> tuple[np.ndarray, np.ndarray]:
        """Records `idx` as raw (c, h, w) uint8 Datums into `out` (n, c, h,
        w) in one call; returns (labels int64, statuses int32). A record
        whose status is not GATHER_OK leaves its row untouched."""
        idx, n, c, h, w = _gather_args(idx, shape, out)
        labels = np.zeros(n, np.int64)
        status = np.empty(n, np.int32)
        rc = self._lib.caffe_tpu_db_gather_raw(
            self._h, idx.ctypes.data_as(_I64P), n, c, h, w,
            out.ctypes.data, labels.ctypes.data_as(_I64P),
            status.ctypes.data_as(_I32P), num_threads)
        if rc != 0:
            raise RuntimeError(f"native datumfile gather rejected (code {rc})")
        return labels, status

    def close(self) -> None:
        if self._h:
            self._lib.caffe_tpu_db_close(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


class NativeLMDB:
    """mmap'd LMDB B+tree reader (lmdb_reader.cc): open walks the tree
    once into a key-ordered locator table; per-record access is one C
    call returning pointers into the mapping. data/lmdb_io.py is the
    plain version.

    `spans()` gives the table to Python in one call, so a caller that maps
    the file too (data/datasets.py LMDBDataset) reads a record by slicing
    its own mapping: every ctypes call lets go of the GIL and takes it
    back, and under a pool of Feeder threads taking it back can wait a
    switch interval, so the per-record path makes as few as it can."""

    def __init__(self, path: str):
        self._lib = lib()
        self._h = self._lib.caffe_tpu_lmdb_open(path.encode())
        if not self._h:
            raise ValueError(f"{path}: not a readable LMDB (native)")
        self._n = self._lib.caffe_tpu_lmdb_count(self._h)

    def spans(self) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """(key offsets, key lengths, value offsets, value lengths) of every
        record, int64, in key order; offsets are into the LMDB's data
        file."""
        out = [np.empty(self._n, np.int64) for _ in range(4)]
        rc = self._lib.caffe_tpu_lmdb_spans(
            self._h, *(a.ctypes.data_as(_I64P) for a in out))
        if rc != 0:
            raise RuntimeError(f"native LMDB spans rejected (code {rc})")
        return tuple(out)

    def __len__(self) -> int:
        return self._n

    def _locate(self, index: int):
        kp, vp = ctypes.c_void_p(), ctypes.c_void_p()
        kl, vl = ctypes.c_int64(), ctypes.c_int64()
        rc = self._lib.caffe_tpu_lmdb_record(
            self._h, index, ctypes.byref(kp), ctypes.byref(kl),
            ctypes.byref(vp), ctypes.byref(vl))
        if rc != 0:
            raise IndexError(index)
        return kp, kl, vp, vl

    def record(self, index: int) -> tuple[bytes, bytes]:
        kp, kl, vp, vl = self._locate(index)
        # copies out of the mmap so the bytes outlive close()
        return (ctypes.string_at(kp, kl.value),
                ctypes.string_at(vp, vl.value))

    def key(self, index: int) -> bytes:
        """Key bytes only — never touches (or pages in) the value, so a
        key scan over a multi-GB DB costs MBs."""
        kp, kl, _vp, _vl = self._locate(index)
        return ctypes.string_at(kp, kl.value)

    def value(self, index: int) -> bytes:
        _kp, _kl, vp, vl = self._locate(index)
        return ctypes.string_at(vp, vl.value)

    def value_crc32c(self, index: int) -> int:
        """crc32c of the value bytes, computed in C over the mmap (no
        bytes copied into Python) — the native half of the read-path
        integrity check."""
        crc = self._lib.caffe_tpu_lmdb_value_crc32c(self._h, index)
        if crc < 0:
            raise IndexError(index)
        return int(crc)

    def gather_raw(self, idx, shape, out: np.ndarray,
                   expect_crcs: np.ndarray | None = None,
                   num_threads: int = 1) -> tuple[np.ndarray, np.ndarray]:
        """Records `idx` (key order) as raw (c, h, w) uint8 Datums into
        `out` (n, c, h, w) in one call, each value's crc32c checked over
        the mapping against `expect_crcs` (the sidecar's, per record of
        `idx`) first; returns (labels int64, statuses int32). A record
        whose status is not GATHER_OK leaves its row untouched."""
        idx, n, c, h, w = _gather_args(idx, shape, out)
        crc_ptr = None
        if expect_crcs is not None:
            expect_crcs = np.ascontiguousarray(expect_crcs, np.uint32)
            if expect_crcs.size != n:
                raise ValueError("one expected crc32c per record")
            crc_ptr = expect_crcs.ctypes.data
        labels = np.zeros(n, np.int64)
        status = np.empty(n, np.int32)
        rc = self._lib.caffe_tpu_lmdb_gather_raw(
            self._h, idx.ctypes.data_as(_I64P), n, crc_ptr, c, h, w,
            out.ctypes.data, labels.ctypes.data_as(_I64P),
            status.ctypes.data_as(_I32P), num_threads)
        if rc != 0:
            raise RuntimeError(f"native LMDB gather rejected (code {rc})")
        return labels, status

    def close(self) -> None:
        if self._h:
            self._lib.caffe_tpu_lmdb_close(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


def transform_batch(images: np.ndarray, record_ids: np.ndarray, *,
                    crop: int = 0, mean: np.ndarray | None = None,
                    scale: float = 1.0, train: bool = True,
                    mirror: bool = False, seed: int = 0,
                    num_threads: int = 4,
                    out: np.ndarray | None = None) -> np.ndarray:
    """images: (N,C,H,W) uint8 contiguous. Returns (N,C,oh,ow) float32,
    written into `out` when given (contiguous, of that shape)."""
    lb = lib()
    images = np.ascontiguousarray(images, np.uint8)
    n, c, h, w = images.shape
    oh, ow = (crop, crop) if crop else (h, w)
    if out is None:
        out = np.empty((n, c, oh, ow), np.float32)
    elif out.dtype != np.float32 or not out.flags.c_contiguous or \
            out.shape != (n, c, oh, ow):
        raise ValueError(f"transform out must be a contiguous float32 "
                         f"{(n, c, oh, ow)}, got {out.dtype} {out.shape}")
    src_ptrs = (ctypes.c_void_p * n)(*[
        images.ctypes.data + i * c * h * w for i in range(n)])
    rec = np.ascontiguousarray(record_ids, np.int64)
    mean_mode = 0
    mean_ptr = None
    if mean is not None:
        mean = np.ascontiguousarray(mean, np.float32)
        if mean.ndim == 1 or mean.size == c:
            mean_mode = 1
        else:
            if mean.shape[-2:] != (h, w):
                raise ValueError("full mean must match image size")
            mean_mode = 2
        mean_ptr = mean.ctypes.data_as(ctypes.c_void_p)
    rc = lb.caffe_tpu_transform_batch(
        src_ptrs, rec.ctypes.data_as(_I64P), n, c, h, w, crop, mean_ptr,
        mean_mode, scale, int(train), int(mirror), seed,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), num_threads)
    if rc != 0:
        raise RuntimeError(f"native transform failed with code {rc}")
    return out


# ---------------------------------------------------------------------------
# Decode plane (decode.cc). Status codes match the C enum; "not handled
# natively" statuses (unknown format / unsupported variant / codec-less
# build) map to None returns so callers fall back to PIL — geometry/buffer
# statuses are caller bugs and raise.
# ---------------------------------------------------------------------------

DECODE_OK = 0
DECODE_UNKNOWN_FORMAT = 1
DECODE_ERROR = 2
DECODE_GEOMETRY = 3
DECODE_BUFFER = 4
DECODE_UNAVAILABLE = 5
# statuses that mean "this record is not ours — hand it to PIL"
_DECODE_FALLBACK = (DECODE_UNKNOWN_FORMAT, DECODE_ERROR, DECODE_UNAVAILABLE)


def decode_available() -> bool:
    """True when the library was built with libjpeg/libpng (the decode
    entry points are not the stubs). Asked once a library: the per-record
    decode asks it every record."""
    global _DECODE
    lb = lib()
    if _DECODE[0] is not lb:
        _DECODE = (lb, bool(lb.caffe_tpu_decode_available()))
    return _DECODE[1]


def decode_probe(data: bytes) -> tuple[int, int] | None:
    """Header-only (h, w) of JPEG/PNG bytes; None = not natively
    decodable (decoded output is always 3-channel BGR)."""
    h, w = ctypes.c_int(), ctypes.c_int()
    rc = lib().caffe_tpu_decode_probe(data, len(data), ctypes.byref(h),
                                      ctypes.byref(w))
    if rc in _DECODE_FALLBACK:
        return None
    if rc != DECODE_OK:
        raise RuntimeError(f"native decode probe failed with code {rc}")
    return h.value, w.value


def decode_image_native(data: bytes) -> np.ndarray | None:
    """JPEG/PNG bytes -> (3, h, w) planar BGR uint8, or None when the
    record is not natively decodable (caller falls back to PIL)."""
    dims = decode_probe(data)
    if dims is None:
        return None
    h, w = dims
    out = np.empty((3, h, w), np.uint8)
    oh, ow = ctypes.c_int(), ctypes.c_int()
    rc = lib().caffe_tpu_decode_image(
        data, len(data), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.nbytes, ctypes.byref(oh), ctypes.byref(ow))
    if rc in _DECODE_FALLBACK:
        return None
    if rc != DECODE_OK:
        raise RuntimeError(f"native decode failed with code {rc}")
    return out


def decode_resize_native(data: bytes, out_h: int,
                         out_w: int) -> np.ndarray | None:
    """JPEG/PNG bytes -> decode + bilinear resize (cv::resize
    INTER_LINEAR convention, the reference ImageData layer's semantics)
    -> (3, out_h, out_w) planar BGR uint8; None = PIL fallback."""
    out = np.empty((3, out_h, out_w), np.uint8)
    rc = lib().caffe_tpu_decode_resize(
        data, len(data), out_h, out_w,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), out.nbytes)
    if rc in _DECODE_FALLBACK:
        return None
    if rc != DECODE_OK:
        raise RuntimeError(f"native decode+resize failed with code {rc}")
    return out


def decode_transform_batch(bufs: list[bytes], record_ids, *,
                           crop: int = 0, mean: np.ndarray | None = None,
                           scale: float = 1.0, train: bool = True,
                           mirror: bool = False, seed: int = 0,
                           out_h: int, out_w: int,
                           out: np.ndarray | None = None,
                           decoded_out: list[np.ndarray | None] | None = None,
                           num_threads: int = 4):
    """Fused ingestion: decode -> crop -> mirror -> mean/scale -> f32 for
    a range of records in ONE ctypes call (GIL released for the whole
    batch). Augmentation keys and arithmetic are identical to
    transform_batch (shared transform_core.h).

    out: (n, 3, out_h, out_w) float32 to fill, or None for decode-only
    mode (the device-transform staging fill — then out_h/out_w are the
    REQUIRED decoded dims). decoded_out: optional per-record (3, h, w)
    uint8 buffers (each entry may be None) receiving the raw decode —
    the decoded-record cache fill. Returns the (n,) int32 per-record
    status array; rows whose status != DECODE_OK are untouched and the
    caller re-reads those records through the PIL + quarantine path.
    Full-image mean is not expressible here (decoded dims vary per
    record); callers keep such transforms on the per-record path."""
    lb = lib()
    n = len(bufs)
    srcs = (ctypes.c_char_p * n)(*bufs)
    lens = np.asarray([len(b) for b in bufs], np.int64)
    rec = np.ascontiguousarray(record_ids, np.int64)
    mean_mode = 0
    mean_ptr = None
    if mean is not None:
        mean = np.ascontiguousarray(mean, np.float32).reshape(-1)
        mean_mode = 1
        mean_ptr = mean.ctypes.data_as(ctypes.c_void_p)
    out_ptr = None
    if out is not None:
        assert out.dtype == np.float32 and out.flags.c_contiguous
        out_ptr = out.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    dec_ptrs = None
    caps = np.zeros(n, np.int64)
    if decoded_out is not None:
        dec_ptrs = (ctypes.c_void_p * n)()
        for i, buf in enumerate(decoded_out):
            if buf is not None:
                assert buf.dtype == np.uint8 and buf.flags.c_contiguous
                dec_ptrs[i] = buf.ctypes.data
                caps[i] = buf.nbytes
    status = np.empty(n, np.int32)
    rc = lb.caffe_tpu_decode_transform_batch(
        srcs, lens.ctypes.data_as(_I64P), rec.ctypes.data_as(_I64P), n,
        crop, mean_ptr, mean_mode, scale, int(train), int(mirror), seed,
        out_h, out_w, out_ptr, dec_ptrs, caps.ctypes.data_as(_I64P),
        status.ctypes.data_as(_I32P), num_threads)
    if rc != 0:
        raise RuntimeError(f"native fused decode call rejected (code {rc})")
    return status


def serve_preprocess_available() -> bool:
    """True when the library carries the serving window-preprocess entry.
    It lies outside the codec gate (it transforms decoded arrays), so a
    build without libjpeg/libpng has it too."""
    return hasattr(lib(), "caffe_tpu_serve_preprocess_batch")


def serve_preprocess_batch(raws, *, img_h: int, img_w: int, crop_h: int,
                           crop_w: int, swap, raw_scale: float | None = None,
                           mean=None, input_scale: float | None = None,
                           num_threads: int = 4):
    """Window-fused serving preprocess: `raws` is a list of (c, h, w)
    uint8 contiguous planar images (dims may vary a record). Returns
    (out, status): out (n, c, crop_h, crop_w) float32, each row bitwise
    the per-request chain (caffe_io.resize_center_crop + Transformer) for
    the same pixels, and the (n,) int32 per-record status (0 ok; a
    nonzero row is untouched, and the caller preprocesses that record in
    Python)."""
    lb = lib()
    n = len(raws)
    if n == 0:
        raise ValueError("empty preprocess batch")
    c = int(raws[0].shape[0])
    dims = np.empty(2 * n, np.int32)
    src_ptrs = (ctypes.c_void_p * n)()
    for i, a in enumerate(raws):
        if a.dtype != np.uint8 or a.ndim != 3 or not a.flags.c_contiguous \
                or a.shape[0] != c:
            raise ValueError(f"record {i}: expected contiguous ({c}, h, w) "
                             f"uint8, got {a.dtype} {a.shape}")
        dims[2 * i], dims[2 * i + 1] = a.shape[1], a.shape[2]
        src_ptrs[i] = a.ctypes.data
    swap = np.ascontiguousarray(swap, np.int32)
    if swap.size != c:
        raise ValueError(f"swap must name {c} source planes")
    mean_ptr = None
    if mean is not None:
        mean = np.ascontiguousarray(mean, np.float32).reshape(-1)
        if mean.size != c:
            raise ValueError("serving fused preprocess needs a per-channel "
                             "mean")
        mean_ptr = mean.ctypes.data_as(_P(ctypes.c_float))
    out = np.empty((n, c, crop_h, crop_w), np.float32)
    status = np.empty(n, np.int32)
    rc = lb.caffe_tpu_serve_preprocess_batch(
        src_ptrs, dims.ctypes.data_as(_I32P), n, c, img_h, img_w, crop_h,
        crop_w, swap.ctypes.data_as(_I32P), int(raw_scale is not None),
        float(raw_scale) if raw_scale is not None else 0.0, mean_ptr,
        int(input_scale is not None),
        float(input_scale) if input_scale is not None else 0.0,
        out.ctypes.data_as(_P(ctypes.c_float)),
        status.ctypes.data_as(_I32P), num_threads)
    if rc != 0:
        raise RuntimeError(f"native serve preprocess rejected (code {rc})")
    return out, status
