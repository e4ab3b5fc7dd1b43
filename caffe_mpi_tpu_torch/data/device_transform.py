"""Device-side data augmentation: crop, mean, mirror and scale on the card.

Own copy of the JAX package's caffe_mpi_tpu/data/device_transform.py
(`compute_aug`, `wants_device_transform`), with a torch `device_transform`.
Reference: src/caffe/data_transformer.cu (TransformKernel) and
base_data_layer.hpp:111-116 (`use_gpu_transform`): the host cannot feed a
fast card transformed float32, so the batch goes up as raw uint8 (a
quarter of the bytes) with a (B, 3) int32 tensor of the augmentation
decisions, and the Data layer transforms it on the card.

The decisions stay on the host (`compute_aug`): the same per-record
Philox draws as the host DataTransformer, in the same order, so the card
and the host transform a record alike.

The order of operations is the JAX package's (device_transform.py:65-99)
and the reference's: out = mirror(crop(img) - crop(mean)) * scale, the
mean cropped at the record's window (a full-size mean file) or broadcast
(mean values). Here the crop and the mirror are one gather: a (B, crop)
row index and a (B, crop) column index, the column index reversed for a
mirrored record, index the raw batch, and the same indices a full-size
mean. A mirror is a permutation, so folding it into the index changes no
value: the result is bitwise the host DataTransformer's. The JAX package
lowers its version to XLA's stock ops (`dynamic_slice`, `where`); this one
is PyTorch's stock advanced indexing — one gather launch a batch, not a
launch a record.
"""

from __future__ import annotations

import numpy as np
import torch

AUG_FIELDS = 3  # off_h, off_w, mirror — per-record int32


def aug_key(top: str) -> str:
    """Feed-dict key for a data top's augmentation decisions."""
    return f"{top}__aug"


def compute_aug(tf, flats, in_hw, batch: int) -> np.ndarray:
    """Host-side decisions: (B, 3) int32 [off_h, off_w, mirror]. `tf` is the
    host DataTransformer; the draws replay its call sequence (off_h, off_w,
    then mirror, from the per-record Philox stream)."""
    tp = tf.tp
    h, w = in_hw
    crop = tp.crop_size
    train = tf.phase == "TRAIN"
    out = np.zeros((batch, AUG_FIELDS), np.int32)
    if crop and not train:
        out[:, 0] = (h - crop) // 2
        out[:, 1] = (w - crop) // 2
    if train and (crop or tp.mirror):
        for i, flat in enumerate(flats):
            rng = tf.record_rng(int(flat))
            if crop:
                out[i, 0] = rng.integers(0, h - crop + 1)
                out[i, 1] = rng.integers(0, w - crop + 1)
            if tp.mirror:
                out[i, 2] = rng.integers(2)
    return out


def device_transform(raw: torch.Tensor, aug: torch.Tensor, *, crop: int,
                     mean: torch.Tensor | None, scale: float) -> torch.Tensor:
    """raw (B, C, H, W) uint8 and aug (B, 3) int32 -> (B, C, crop, crop)
    float32 ((B, C, H, W) without crop), on raw's device.

    mean: None, a per-channel (C, 1, 1) tensor, a full-size (C, H, W) one
    (cropped at each record's window), or one the crop-size output
    broadcasts against (subtracted before the mirror, as in JAX)."""
    b, c, h, w = raw.shape
    dev = raw.device
    oh, ow = (crop, crop) if crop else (h, w)
    aug = aug.to(device=dev, dtype=torch.int64)
    local_r = torch.arange(oh, device=dev).expand(b, oh)
    ar = torch.arange(ow, device=dev)
    local_c = torch.where(aug[:, 2:3] > 0, ow - 1 - ar, ar)  # (B, ow)
    if crop:
        rows = aug[:, 0:1] + local_r
        cols = aug[:, 1:2] + local_c
    else:
        rows, cols = local_r, local_c
    bi = torch.arange(b, device=dev).view(b, 1, 1, 1)
    ci = torch.arange(c, device=dev).view(1, c, 1, 1)
    x = raw[bi, ci, rows.view(b, 1, oh, 1), cols.view(b, 1, 1, ow)]
    x = x.float()
    if mean is not None:
        m = mean.to(device=dev, dtype=torch.float32)
        if m.dim() == 3 and m.shape[-2:] == (1, 1):
            x = x - m
        elif crop and m.dim() == 3 and tuple(m.shape[-2:]) == (h, w):
            x = x - m.expand(c, h, w)[ci, rows.view(b, 1, oh, 1),
                                      cols.view(b, 1, 1, ow)]
        else:
            m = m.expand(c, oh, ow)
            x = x - m[ci, local_r.view(b, 1, oh, 1),
                      local_c.view(b, 1, 1, ow)]
    if scale != 1.0:
        x = x * scale
    return x


def wants_device_transform(lp) -> bool:
    """The per-layer device-transform request (base_data_layer.hpp:111-116):
    an explicit transform_param.use_gpu_transform wins; unset is ON, as in
    the JAX package. force_color / force_gray change the channel count on
    the host decode side and stay host-only."""
    tp = lp.transform_param
    if tp is not None and (tp.force_color or tp.force_gray):
        return False
    if tp is not None and tp.has("use_gpu_transform"):
        return bool(tp.use_gpu_transform)
    return True
