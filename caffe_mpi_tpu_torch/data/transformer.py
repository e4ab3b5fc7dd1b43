"""DataTransformer — Caffe's augmentation, on the host, in numpy.

Own copy of the JAX package's caffe_mpi_tpu/data/transformer.py.
Reference: src/caffe/data_transformer.cpp: mean-file or per-channel
mean-value subtraction, scale, random crop (TRAIN) or centre crop (TEST),
horizontal mirror (TRAIN).

The draws come from a per-record Philox stream (`record_rng`), an
explicitly seeded numpy Generator, so the crops and mirrors are the JAX
package's draw for draw whatever thread builds the record. The order of
operations is the reference's: out = (pixel - mean) * scale, sampled from
the (possibly mirrored) crop window.
"""

from __future__ import annotations

import os

import numpy as np

from ..proto.config import TransformationParameter


class DataTransformer:
    def __init__(self, tp: TransformationParameter | None, phase: str,
                 seed: int | None = None, model_dir: str = ""):
        self.tp = tp or TransformationParameter()
        self.phase = phase
        if seed is None and self.tp.random_seed >= 0:
            seed = self.tp.random_seed
        self.seed = seed
        # the stream of single-threaded calls that pass no rng
        self.rng = np.random.default_rng(seed)
        self.mean: np.ndarray | None = None
        if self.tp.mean_file:
            from ..io import load_blob_binaryproto
            self.mean = load_blob_binaryproto(
                os.path.join(model_dir, self.tp.mean_file))
            if self.mean.ndim == 4:
                self.mean = self.mean[0]
        elif self.tp.mean_value:
            self.mean = np.asarray(self.tp.mean_value,
                                   np.float32)[:, None, None]

    def record_rng(self, record_index: int) -> np.random.Generator:
        """Deterministic per-record stream (counter-based Philox)."""
        return np.random.Generator(
            np.random.Philox(key=((self.seed or 0) << 32) ^ record_index))

    def output_shape(self, in_shape: tuple[int, int, int]
                     ) -> tuple[int, int, int]:
        c, h, w = in_shape
        if self.tp.force_color:
            c = 3
        elif self.tp.force_gray:
            c = 1
        crop = self.tp.crop_size
        return (c, crop, crop) if crop else (c, h, w)

    def __call__(self, img: np.ndarray,
                 rng: np.random.Generator | None = None) -> np.ndarray:
        """img: CHW uint8/float -> transformed float32 CHW."""
        if rng is None:
            rng = self.rng
        tp = self.tp
        c, h, w = img.shape
        if tp.force_color and c == 1:
            img = np.broadcast_to(img, (3, h, w))
            c = 3
        elif tp.force_gray and c == 3:
            # OpenCV BGR2GRAY weights (the reference decodes via OpenCV)
            img = (0.114 * img[0] + 0.587 * img[1] + 0.299 * img[2])[None]
            c = 1
        out = img.astype(np.float32)

        crop = tp.crop_size
        if crop:
            if crop > h or crop > w:
                raise ValueError(f"crop_size {crop} exceeds image {h}x{w}")
            if self.phase == "TRAIN":
                off_h = int(rng.integers(0, h - crop + 1))
                off_w = int(rng.integers(0, w - crop + 1))
            else:  # centre crop (data_transformer.cpp Transform)
                off_h = (h - crop) // 2
                off_w = (w - crop) // 2
            out = out[:, off_h:off_h + crop, off_w:off_w + crop]

        if self.mean is not None:
            mean = self.mean
            if crop and mean.shape[-2:] == (h, w):
                # a full-size mean file: subtract at the same crop window
                mean = mean[:, off_h:off_h + crop, off_w:off_w + crop]
            out = out - mean

        if tp.mirror and self.phase == "TRAIN" and rng.integers(2):
            out = out[:, :, ::-1]

        if tp.scale != 1.0:
            out = out * tp.scale
        return np.ascontiguousarray(out, np.float32)
