"""Serving request ingest — decode, window-fused preprocessing, and the
hot-content decoded cache.

Port of the JAX package's caffe_mpi_tpu/serving/ingest.py. Reference:
python/caffe/io.py load_image + python/caffe/classifier.py preprocess each
request one image at a time on the Python host, and
examples/web_demo/app.py pays that per HTTP upload.

  * Request decode rides the training decode plane's policy and counters
    (data/decode.py: `CAFFE_NATIVE_DECODE` 0/1/auto, PIL for the records
    the native decoder declines: CMYK JPEG, alpha or 16-bit PNG). Bytes no
    decoder takes raise PIL's error, which the HTTP front turns into a
    typed 400.
  * Preprocessing is fused at window granularity: the batcher hands a
    closed dispatch window's decoded images to one GIL-released native
    call (csrc/native/decode.cc caffe_tpu_serve_preprocess_batch ->
    transform_core.h serve_preprocess_one), bitwise the per-request
    `caffe_io.resize_center_crop` + Transformer chain. It lies outside
    the codec gate, so it engages where the library was built without
    libjpeg/libpng and requests decode through PIL.
  * A decoded-request cache (`serve_decoded_cache_mb`) keyed by the
    crc32c of the request bytes, LRU, with the bytes stored beside the
    pixels so that a hit is an exact match, not a trusted checksum: a
    repeated hot image skips decode (data/decode.py's `decode_calls`
    does not move).

Decoded-request pixel contract: planar CHW, BGR, uint8 (the decode
plane's), so native- and PIL-decoded requests are interchangeable (PNG
bitwise, JPEG within 1 LSB).

The cache and counter lock here is a leaf: decode and the native call run
outside it, and outside every engine and batcher lock.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from collections import OrderedDict

import numpy as np

from ..data import decode as decode_mod

log = logging.getLogger(__name__)

_STAT_KEYS = ("requests", "cache_hits", "cache_misses", "cache_inserts",
              "cache_evictions", "fused_batches", "fused_rows",
              "fused_fallback_rows", "immediate_rows", "deferred_rows")


def _content_key(data: bytes) -> int:
    """crc32c of the request bytes, by the native library."""
    from .. import native
    return native.crc32c(data)


class RequestIngest:
    """Per-engine request-ingest plane: decode (and the hot-content cache)
    and the window-fused preprocess counters. Thread-safe: HTTP handler
    threads decode concurrently while the dispatcher preprocesses."""

    def __init__(self, cache_mb: float = 0.0):
        self.cache_budget = int(float(cache_mb) * 2**20)  # 0 = cache off
        # key -> (encoded bytes, decoded array); the bytes make a hit an
        # exact match and are charged to the budget
        self._cache: OrderedDict[int, tuple[bytes, np.ndarray]] = \
            OrderedDict()
        self.cache_bytes = 0
        self._lock = threading.Lock()
        self.decode_s = 0.0
        self.preprocess_s = 0.0
        for k in _STAT_KEYS:
            setattr(self, k, 0)

    def _count(self, key: str, n: int = 1) -> None:
        with self._lock:
            setattr(self, key, getattr(self, key) + n)

    # -- decode + cache -------------------------------------------------
    def decode(self, data: bytes) -> np.ndarray:
        """Encoded request bytes -> (3, h, w) planar BGR uint8 through the
        decode plane's policy and counters. A cache hit decodes nothing;
        bytes that are no image raise the decoder's error."""
        self._count("requests")
        key = None
        if self.cache_budget:
            key = _content_key(data)
            with self._lock:
                hit = self._cache.get(key)
                if hit is not None and hit[0] == data:
                    self._cache.move_to_end(key)
                    self.cache_hits += 1
                    return hit[1]
                self.cache_misses += 1
        t0 = time.perf_counter()
        arr = np.ascontiguousarray(decode_mod.decode_image(data))
        arr.setflags(write=False)  # one array may serve many requests
        dt = time.perf_counter() - t0
        entry_bytes = arr.nbytes + len(data)
        with self._lock:
            self.decode_s += dt
            if key is not None and entry_bytes <= self.cache_budget:
                old = self._cache.pop(key, None)
                if old is not None:
                    if old[0] == data:
                        # two handler threads raced the same miss: keep
                        # the first copy (the bytes are counted once)
                        self._cache[key] = old
                        self._cache.move_to_end(key)
                        return arr
                    # a crc collision: the newer content wins
                    self.cache_bytes -= old[1].nbytes + len(old[0])
                self._cache[key] = (data, arr)
                self.cache_bytes += entry_bytes
                self.cache_inserts += 1
                while self.cache_bytes > self.cache_budget:
                    _, (odata, oarr) = self._cache.popitem(last=False)
                    self.cache_bytes -= oarr.nbytes + len(odata)
                    self.cache_evictions += 1
        return arr

    # -- telemetry ------------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            out = {k: getattr(self, k) for k in _STAT_KEYS}
            out.update({
                "cache_budget_mb": round(self.cache_budget / 2**20, 3),
                "cache_bytes": self.cache_bytes,
                "decode_ms": round(self.decode_s * 1e3, 3),
                "preprocess_ms": round(self.preprocess_s * 1e3, 3),
            })
        # the process-wide decode-plane counters: which decoder ran
        out["decode_plane"] = decode_mod.STATS.snapshot()
        return out


def build_plan(model):
    """The native window-preprocess spec of one model, or None when its
    preprocessing is not expressible in the fused kernel (non-image input,
    not 3 channels, a full-image mean, another transpose): such a model
    keeps the per-request path. Whether the native plane is engaged is
    asked each window (`fused_engaged`)."""
    fwd = model.fwd
    in_shape = fwd.input_shape()
    if model.crop_dims is None or len(in_shape) != 4 or in_shape[1] != 3:
        return None
    t = model.transformer
    in_blob = fwd.input_blob()
    if t.transpose.get(in_blob) != (2, 0, 1):
        return None
    swap_rgb = t.channel_swap.get(in_blob, (0, 1, 2))
    if sorted(swap_rgb) != [0, 1, 2]:
        return None
    mean = t.mean.get(in_blob)
    if mean is not None:
        mean = np.asarray(mean, np.float32)
        if mean.size != 3:  # full-image mean: dims vary per request
            return None
        mean = mean.reshape(3)
    img_h, img_w = (int(d) for d in model.image_dims)
    crop_h, crop_w = (int(d) for d in model.crop_dims)
    if crop_h > img_h or crop_w > img_w:
        return None
    return {
        "img_h": img_h, "img_w": img_w, "crop_h": crop_h, "crop_w": crop_w,
        # decoded storage is BGR planar; the Transformer's channel_swap is
        # spelled over the RGB float image: output channel j reads
        # storage plane swap[j]
        "swap": np.asarray([2 - s for s in swap_rgb], np.int32),
        "raw_scale": t.raw_scale.get(in_blob),
        "mean": mean,
        "input_scale": t.input_scale.get(in_blob),
    }


def fused_engaged(model) -> bool:
    """True when this model's deferred requests preprocess through the
    native fused kernel now: the model has a plan, the library carries the
    entry, and `CAFFE_NATIVE_DECODE=0` is not forcing the Python path."""
    if getattr(model, "ingest_plan", None) is None:
        return False
    if decode_mod.native_mode() < 0:
        return False
    from .. import native
    return native.serve_preprocess_available()


def preprocess_rows(model, raws: list, ingest: RequestIngest):
    """Window-fused preprocessing of one closed dispatch window: `raws`
    are decoded (3, h, w) BGR uint8 images (dims may vary). Returns (rows,
    errs) aligned with `raws`: the model's float32 input rows, and each
    record's exception (a bad record fails only its own future). One
    GIL-released native call for the window when engaged; the records it
    declines, and the `CAFFE_NATIVE_DECODE=0` path, take the Python
    chain, which the native kernel matches bitwise."""
    n = len(raws)
    rows: list = [None] * n
    errs: list = [None] * n
    t0 = time.perf_counter()
    plan = getattr(model, "ingest_plan", None)
    if plan is not None and fused_engaged(model):
        from .. import native
        try:
            out, status = native.serve_preprocess_batch(
                raws, img_h=plan["img_h"], img_w=plan["img_w"],
                crop_h=plan["crop_h"], crop_w=plan["crop_w"],
                swap=plan["swap"], raw_scale=plan["raw_scale"],
                mean=plan["mean"], input_scale=plan["input_scale"],
                # below ~8 records a spawned thread costs more than it
                # saves (the JAX package's measurement)
                num_threads=max(1, min(n // 8, os.cpu_count() or 4)))
        except Exception:  # noqa: BLE001 — falls back per record below
            log.exception("serving ingest: fused native preprocess "
                          "rejected a window; preprocessing per record")
            out, status = None, None
        if status is not None:
            fused = 0
            for i in range(n):
                if status[i] == 0:
                    rows[i] = out[i]
                    fused += 1
            ingest._count("fused_rows", fused)
            ingest._count("fused_batches")
    for i in range(n):
        if rows[i] is not None:
            continue
        try:
            rows[i] = model.preprocess(decode_mod.to_float_image(raws[i]))
            ingest._count("fused_fallback_rows")
        except Exception as e:  # noqa: BLE001 — this request's future only
            errs[i] = e
    dt = time.perf_counter() - t0
    with ingest._lock:
        ingest.preprocess_s += dt
    return rows, errs
