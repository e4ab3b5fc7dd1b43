"""Host image decode — the PIL path.

Own copy of the PIL half of the JAX package's caffe_mpi_tpu/data/decode.py
(`_pil_decode`, `decode_image`, `to_float_image`). Reference:
src/caffe/util/io.cpp DecodeDatumToCVMat (an encoded Datum -> cv::Mat,
BGR). The JAX package's native libjpeg/libpng decoder waits for the
port's copy of `native/` (ROADMAP.md §1 item 3); until then every encoded
record decodes here, one PIL call a record.

Pixel contract: planar CHW, BGR channel order, uint8 — the reference's
OpenCV decode.
"""

from __future__ import annotations

import io

import numpy as np


def _pil_decode(data: bytes) -> np.ndarray:
    """PIL RGB -> BGR CHW."""
    from PIL import Image
    img = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    return img[:, :, ::-1].transpose(2, 0, 1)


def decode_image(data: bytes) -> np.ndarray:
    """Encoded image bytes -> (3, h, w) planar BGR uint8; raises PIL's
    error when the bytes are no image."""
    return _pil_decode(data)


def to_float_image(arr: np.ndarray) -> np.ndarray:
    """(3, h, w) planar BGR uint8 -> HWC RGB float32 in [0, 1], the pycaffe
    load_image convention (u8 -> f32 is exact, /255.0 one IEEE divide)."""
    if arr.ndim != 3 or arr.shape[0] != 3:
        raise ValueError(f"expected (3, h, w) BGR uint8, got {arr.shape}")
    return arr[::-1].transpose(1, 2, 0).astype(np.float32) / 255.0
