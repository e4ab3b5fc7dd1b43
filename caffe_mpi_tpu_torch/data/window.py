"""WindowData pipeline — R-CNN-style fg/bg window sampling.

Own copy of the JAX package's caffe_mpi_tpu/data/window.py (the port
imports nothing of that package); batches are the JAX WindowFeeder's bit
for bit at the same seed. Reference: src/caffe/layers/window_data_layer.cpp: parses a "window file"
(per image: path, dims, and proposal windows with class + overlap), then per
batch samples `fg_fraction` foreground windows (overlap >= fg_threshold)
and the rest background (overlap in [0, bg_threshold)), crops each window
with `context_pad`, warps to crop_size x crop_size, mean-subtracts and
optionally mirrors.

Window file format (reference window_data_layer.cpp:72-120):

    # <image_index>
    <image_path>
    <channels> <height> <width>
    <num_windows>
    <class_index> <overlap> <x1> <y1> <x2> <y2>
    ...
"""

from __future__ import annotations

import os

import numpy as np

from ..proto.config import LayerParameter
from .transformer import DataTransformer


class WindowFile:
    def __init__(self, path: str, root: str = "",
                 fg_threshold: float = 0.5, bg_threshold: float = 0.5):
        self.images: list[str] = []
        self._records: list[tuple[int, int, float, int, int, int, int]] = []
        self._parse(path, root)
        # classified at load time like the reference (fg_threshold /
        # bg_threshold fixed per layer, window_data_layer.cpp:121-135)
        self.fg = [r for r in self._records if r[2] >= fg_threshold]
        self.bg = [r for r in self._records if 0 <= r[2] < bg_threshold]
        if not self.fg or not self.bg:
            raise ValueError(
                f"window file {path}: need both fg ({len(self.fg)}) and bg "
                f"({len(self.bg)}) windows at thresholds")

    def _parse(self, path: str, root: str) -> None:
        with open(path) as f:
            lines = [l.rstrip("\n") for l in f]
        i = 0
        while i < len(lines):
            if not lines[i].strip():
                i += 1
                continue
            if not lines[i].startswith("#"):
                raise ValueError(f"window file: expected '# index' at line {i}")
            img_path = lines[i + 1].strip()
            _c, _h, _w = (int(x) for x in lines[i + 2].split())
            num = int(lines[i + 3])
            img_id = len(self.images)
            self.images.append(os.path.join(root, img_path))
            for j in range(num):
                parts = lines[i + 4 + j].split()
                cls = int(parts[0])
                overlap = float(parts[1])
                x1, y1, x2, y2 = (int(float(v)) for v in parts[2:6])
                self._records.append((img_id, cls, overlap, x1, y1, x2, y2))
            i += 4 + num


class WindowFeeder:
    """The feed function of a WindowData layer: iteration -> {data (B, 3,
    crop, crop) float32, label (B,) int32}. Slots below
    round(batch * fg_fraction) take a foreground window, the rest a
    background one (class 0), each drawn uniformly from a Philox stream
    keyed on (seed, iteration * world + rank); the draws, the warp and
    the mirror are the JAX WindowFeeder's."""

    def __init__(self, lp: LayerParameter, phase: str, *, model_dir: str = "",
                 seed: int = 1701, rank: int = 0, world: int = 1):
        p = lp.window_data_param
        self.p = p
        self.tops = list(lp.top)
        self.phase = phase
        self.batch = p.batch_size
        tp = lp.transform_param
        self.crop = p.crop_size or (tp.crop_size if tp else 0)
        if not self.crop:
            raise ValueError(
                "WindowData requires crop_size (window_data_param or "
                "transform_param)")
        self.num_fg = int(round(p.batch_size * p.fg_fraction))
        self.wf = WindowFile(os.path.join(model_dir, p.source), p.root_folder,
                             p.fg_threshold, p.bg_threshold)
        # rank folded into the stream key: each rank samples distinct windows
        # (the reference stripes records per solver, data_reader.hpp:28-53)
        self.seed = seed
        self.rank, self.world = rank, world
        self.mean = None
        if tp is not None:
            tf = DataTransformer(tp, phase, model_dir=model_dir)
            self.mean = tf.mean
            self.mirror = tp.mirror
            self.scale = tp.scale
        else:
            self.mirror = bool(p.mirror)
            self.scale = p.scale
            if p.mean_file:
                from ..io import load_blob_binaryproto
                self.mean = load_blob_binaryproto(
                    os.path.join(model_dir, p.mean_file))
                if self.mean.ndim == 4:
                    self.mean = self.mean[0]
        if self.mean is not None and self.mean.shape[-1] > 1 \
                and self.mean.shape[-2:] != (self.crop, self.crop):
            # full-size mean: center-crop to the warped window size
            # (window_data_layer.cpp mean_off logic)
            mh = (self.mean.shape[-2] - self.crop) // 2
            mw = (self.mean.shape[-1] - self.crop) // 2
            if mh < 0 or mw < 0:
                raise ValueError("mean smaller than crop_size")
            self.mean = self.mean[:, mh:mh + self.crop, mw:mw + self.crop]
        self._img_cache: dict[int, np.ndarray] = {}

    def _load_image(self, img_id: int) -> np.ndarray:
        img = self._img_cache.get(img_id)
        if img is None:
            from PIL import Image
            arr = np.asarray(Image.open(self.wf.images[img_id]).convert("RGB"))
            img = arr[:, :, ::-1].astype(np.float32)  # BGR HWC
            if len(self._img_cache) > 64:
                self._img_cache.clear()
            self._img_cache[img_id] = img
        return img

    def _crop_window(self, rec, rng) -> np.ndarray:
        from PIL import Image
        img_id, cls, overlap, x1, y1, x2, y2 = rec
        img = self._load_image(img_id)
        h, w = img.shape[:2]
        if self.p.context_pad:
            # scale the context pad into window coordinates
            # (window_data_layer.cpp context_scale logic, crop_mode 'warp')
            cw, chh = x2 - x1 + 1, y2 - y1 + 1
            context_scale = self.crop / (self.crop - 2.0 * self.p.context_pad)
            pad_w = (context_scale * cw - cw) / 2.0
            pad_h = (context_scale * chh - chh) / 2.0
            x1, x2 = int(x1 - pad_w), int(x2 + pad_w)
            y1, y2 = int(y1 - pad_h), int(y2 + pad_h)
        x1c, y1c = max(x1, 0), max(y1, 0)
        x2c, y2c = min(x2, w - 1), min(y2, h - 1)
        window = img[y1c:y2c + 1, x1c:x2c + 1]
        pil = Image.fromarray(window.astype(np.uint8)[:, :, ::-1])
        warped = np.asarray(
            pil.resize((self.crop, self.crop), Image.BILINEAR))[:, :, ::-1]
        out = warped.transpose(2, 0, 1).astype(np.float32)
        if self.mean is not None:
            out = out - self.mean
        if self.mirror and self.phase == "TRAIN" and rng.integers(2):
            out = out[:, :, ::-1]
        return np.ascontiguousarray(out * self.scale)

    def __call__(self, it: int) -> dict[str, np.ndarray]:
        stream = it * self.world + self.rank
        rng = np.random.Generator(
            np.random.Philox(key=(self.seed << 32) ^ stream))
        data = np.empty((self.batch, 3, self.crop, self.crop), np.float32)
        labels = np.empty((self.batch,), np.int32)
        for slot in range(self.batch):
            if slot < self.num_fg:
                rec = self.wf.fg[int(rng.integers(len(self.wf.fg)))]
            else:
                rec = self.wf.bg[int(rng.integers(len(self.wf.bg)))]
                rec = (*rec[:1], 0, *rec[2:])  # bg windows are class 0
            data[slot] = self._crop_window(rec, rng)
            labels[slot] = rec[1]
        out = {self.tops[0]: data}
        if len(self.tops) > 1:
            out[self.tops[1]] = labels
        return out

    def close(self) -> None:
        """Nothing runs in the background; DeviceFeed closes its feeder."""
        self._img_cache.clear()
