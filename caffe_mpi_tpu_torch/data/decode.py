"""Host image decode — the policy, the counters, and the PIL path beside
the native libjpeg/libpng decoder.

Own copy of the JAX package's caffe_mpi_tpu/data/decode.py (`STATS`,
`native_mode`, `native_enabled`, `decode_image`, `to_float_image`,
`decode_file`).
Reference: src/caffe/util/io.cpp DecodeDatumToCVMat (an encoded Datum ->
cv::Mat, BGR), called per record from the C++ reader threads. Here the
same work runs in csrc/native/decode.cc behind ctypes (native/), and this
module owns:

  * the engagement policy, `CAFFE_NATIVE_DECODE`: "0" forces PIL, "1"
    forces native (raising where the library was built without the
    codecs), unset is native where available;
  * the PIL path, which is also the plain version: records the native
    decoder declines (CMYK JPEGs, 16-bit or alpha PNGs, other formats)
    decode here, as in the JAX package, and STATS counts them;
  * `STATS`: per-path record counters (tools/bench_data, chip_smoke.py's
    lmdb phase, the decoded-record cache's second-epoch check).

Pixel contract: planar CHW, BGR channel order, uint8 — the reference's
OpenCV decode. PNG is bitwise PIL's; JPEG within 1 LSB of PIL's
(tests/test_torch_native_decode.py).
"""

from __future__ import annotations

import io
import os
import threading

import numpy as np


class DecodeStats:
    """Thread-safe decode counters (Feeder workers decode concurrently;
    the cache check needs exact counts)."""

    _KEYS = ("native_records", "pil_records", "native_fallbacks",
             "fused_batches", "fused_records", "fused_fallback_records",
             "cache_hits", "cache_inserts", "cache_bytes")

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            for k in self._KEYS:
                setattr(self, k, 0)

    def count(self, key: str, n: int = 1) -> None:
        with self._lock:
            setattr(self, key, getattr(self, key) + n)

    def snapshot(self) -> dict:
        with self._lock:
            out = {k: getattr(self, k) for k in self._KEYS}
        # image decodes performed on any path (cache hits perform none)
        out["decode_calls"] = (out["native_records"] + out["pil_records"]
                               + out["fused_records"])
        return out


STATS = DecodeStats()


def native_mode() -> int:
    """CAFFE_NATIVE_DECODE: -1 forced PIL ("0"), +1 forced native ("1"),
    0 auto (unset or anything else). Read at each call: tests and
    tools/bench_data flip it at run time."""
    v = os.environ.get("CAFFE_NATIVE_DECODE", "").strip()
    if v == "0":
        return -1
    if v == "1":
        return 1
    return 0


def native_enabled() -> bool:
    """True when records should try the native decoder first. The
    library itself always builds or raises (native.lib()); only the
    codecs may be missing, and then forced native raises."""
    mode = native_mode()
    if mode < 0:
        return False
    from .. import native
    ok = native.decode_available()
    if mode > 0 and not ok:
        raise RuntimeError(
            "CAFFE_NATIVE_DECODE=1 but the native library was built "
            "without libjpeg/libpng (their headers were not found)")
    return ok


def _pil_decode(data: bytes) -> np.ndarray:
    """PIL RGB -> BGR CHW (the plain version)."""
    from PIL import Image
    img = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    STATS.count("pil_records")
    return img[:, :, ::-1].transpose(2, 0, 1)


def decode_image(data: bytes) -> np.ndarray:
    """Encoded image bytes -> (3, h, w) planar BGR uint8: native where
    enabled and the record is expressible there, else PIL; raises PIL's
    error when the bytes are no image (datasets turn it into
    RecordIntegrityError)."""
    if native_enabled():
        from .. import native
        arr = native.decode_image_native(data)
        if arr is not None:
            STATS.count("native_records")
            return arr
        STATS.count("native_fallbacks")
    return _pil_decode(data)


def to_float_image(arr: np.ndarray) -> np.ndarray:
    """(3, h, w) planar BGR uint8 -> HWC RGB float32 in [0, 1], the pycaffe
    load_image convention (u8 -> f32 is exact, /255.0 one IEEE divide)."""
    if arr.ndim != 3 or arr.shape[0] != 3:
        raise ValueError(f"expected (3, h, w) BGR uint8, got {arr.shape}")
    return arr[::-1].transpose(1, 2, 0).astype(np.float32) / 255.0


def decode_file(data: bytes, *, is_color: bool = True, new_h: int = 0,
                new_w: int = 0) -> np.ndarray:
    """Image file bytes -> CHW uint8, with the ImageData layer's optional
    bilinear resize to (new_h, new_w) (reference io.cpp
    ReadImageToCVMat). The native path takes color images, resizing by
    the reference's cv::resize INTER_LINEAR convention; PIL takes the
    rest (grayscale by PIL's "L" luma weights; PIL's BILINEAR, which
    antialiases on a downscale), as in the JAX package."""
    if is_color and native_enabled():
        from .. import native
        if new_h and new_w:
            arr = native.decode_resize_native(data, new_h, new_w)
        else:
            arr = native.decode_image_native(data)
        if arr is not None:
            STATS.count("native_records")
            return arr
        STATS.count("native_fallbacks")
    from PIL import Image
    img = Image.open(io.BytesIO(data))
    img = img.convert("RGB" if is_color else "L")
    if new_h and new_w:
        img = img.resize((new_w, new_h), Image.BILINEAR)
    arr = np.asarray(img)
    STATS.count("pil_records")
    if arr.ndim == 2:
        return arr[None, :, :]
    return arr[:, :, ::-1].transpose(2, 0, 1)  # RGB HWC -> BGR CHW
