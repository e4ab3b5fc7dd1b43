"""DetectNet detection pipeline — augmentation + coverage-grid labels.

Own copy of the JAX package's caffe_mpi_tpu/data/detectnet.py (the port
imports nothing of that package): the same random draws from the same
Philox streams, so a seed gives the JAX augmenter's crops, shifts, flips,
hue rotations and desaturations. Reference: src/caffe/layers/detectnet_transform_layer.{cpp,cu} (753+268 LoC)
+ src/caffe/util/detectnet_coverage_rectangular.cpp. The reference augments
on the GPU mid-graph; here augmentation runs on the host, as in the JAX
package (layers/detection.py moves its bottoms to the host and back).

Implemented semantics:
- augmentation (DetectNetAugmentationParameter): random crop/shift to the
  network input size, random scale, horizontal flip, hue rotation and
  desaturation — each gated by its *_prob; bboxes transformed alongside.
- ground truth (DetectNetGroundTruthParameter, RECTANGULAR coverage): the
  label tensor has, per class, 5 channels on the stride-decimated grid:
  [coverage, dx1, dy1, dx2, dy2] where the d* channels hold the bbox
  corner offsets (in pixels, relative to each covered grid-cell center) —
  the coverage region is the bbox shrunk by scale_cvg and clamped per
  gridbox_type.
"""

from __future__ import annotations

import numpy as np

from ..proto.config import (
    DetectNetAugmentationParameter,
    DetectNetGroundTruthParameter,
)


# RGB <-> YIQ bases, fixed. The hue-rotation matrix is linear in
# (cos t, sin t): m(t) = _HUE_A + cos(t) * _HUE_B + sin(t) * _HUE_C, the
# three terms composed once at import; the per-call math is the JAX
# module's scalar and ufunc arithmetic, in its order (same bits).
_T_YIQ = np.array([[0.299, 0.587, 0.114],
                   [0.596, -0.274, -0.322],
                   [0.211, -0.523, 0.312]])
_T_YIQ_INV = np.linalg.inv(_T_YIQ)
_HUE_A = _T_YIQ_INV @ np.diag([1.0, 0.0, 0.0]) @ _T_YIQ
_HUE_B = _T_YIQ_INV @ np.diag([0.0, 1.0, 1.0]) @ _T_YIQ
_HUE_C = _T_YIQ_INV @ np.array([[0, 0, 0], [0, 0, -1.0], [0, 1.0, 0]]) @ _T_YIQ


def _hue_rotate(img: np.ndarray, degrees: float) -> np.ndarray:
    """Rotate hue via a YIQ-space rotation (cheap approximation of the
    reference's HSV hue shift; BGR CHW float input)."""
    theta = np.deg2rad(degrees)
    m = _HUE_A + np.cos(theta) * _HUE_B + np.sin(theta) * _HUE_C
    rgb = img[::-1]  # BGR -> RGB
    out = np.stack([m[i, 0] * rgb[0] + m[i, 1] * rgb[1] + m[i, 2] * rgb[2]
                    for i in range(3)])
    return np.clip(out[::-1], 0, 255)


def _desaturate(img: np.ndarray, amount: float) -> np.ndarray:
    gray = 0.114 * img[0] + 0.587 * img[1] + 0.299 * img[2]
    return img * (1 - amount) + gray[None] * amount


class DetectNetAugmenter:
    """(image CHW float BGR, bboxes (N,5)=[cls,x1,y1,x2,y2]) -> augmented
    pair at the fixed network input size."""

    def __init__(self, aug: DetectNetAugmentationParameter | None,
                 gt: DetectNetGroundTruthParameter, phase: str = "TRAIN"):
        self.aug = aug or DetectNetAugmentationParameter()
        self.gt = gt
        self.phase = phase

    def __call__(self, img: np.ndarray, bboxes: np.ndarray,
                 rng: np.random.Generator, mean: np.ndarray | None = None
                 ) -> tuple[np.ndarray, np.ndarray]:
        """mean: optional per-channel (C,) mean subtracted AFTER the
        photometric augmentations but BEFORE the geometric ones — the
        reference's order (transform_image_cpu: HSV transforms, then
        meanSubtract, then flip/scale/crop), which makes the crop's
        zero-pad equal the mean in pixel space."""
        a = self.aug
        out_w, out_h = self.gt.image_size_x, self.gt.image_size_y
        img = np.asarray(img, np.float32)
        bboxes = np.asarray(bboxes, np.float32).reshape(-1, 5).copy()
        train = self.phase == "TRAIN"

        # photometric first, in [0,255] pixel space (reference does HSV
        # before mean subtraction)
        if train and a.hue_rotation_prob > 0 and rng.random() < a.hue_rotation_prob:
            img = _hue_rotate(img, float(rng.uniform(-a.hue_rotation,
                                                     a.hue_rotation)))
        if train and a.desaturation_prob > 0 and rng.random() < a.desaturation_prob:
            img = _desaturate(img, float(rng.random() * a.desaturation_max))
        if mean is not None:
            img = img - np.asarray(mean, np.float32)[:, None, None]

        if train and a.scale_prob > 0 and rng.random() < a.scale_prob:
            s = a.scale_min + rng.random() * (a.scale_max - a.scale_min)
            c, h, w = img.shape
            nh, nw = max(int(h * s), 1), max(int(w * s), 1)
            from PIL import Image
            # resize in FLOAT (mode 'F', per channel): the image may be
            # mean-subtracted (negative) here — a uint8 round-trip would
            # wrap negatives modulo 256 (the reference resizes the float
            # cv::Mat, transform_image_cpu)
            img = np.stack([
                np.asarray(Image.fromarray(ch, mode="F").resize(
                    (nw, nh), Image.BILINEAR), np.float32)
                for ch in img])
            bboxes[:, 1:] *= s

        c, h, w = img.shape
        # crop/shift to (out_h, out_w)
        if train and rng.random() < a.crop_prob:
            max_x = max(w - out_w, 0) + a.shift_x
            max_y = max(h - out_h, 0) + a.shift_y
            off_x = int(rng.integers(-a.shift_x, max_x + 1)) if max_x else 0
            off_y = int(rng.integers(-a.shift_y, max_y + 1)) if max_y else 0
        else:
            off_x = max((w - out_w) // 2, 0)
            off_y = max((h - out_h) // 2, 0)
        canvas = np.zeros((c, out_h, out_w), np.float32)
        src_x0, src_y0 = max(off_x, 0), max(off_y, 0)
        dst_x0, dst_y0 = max(-off_x, 0), max(-off_y, 0)
        cw = min(w - src_x0, out_w - dst_x0)
        ch = min(h - src_y0, out_h - dst_y0)
        if cw > 0 and ch > 0:
            canvas[:, dst_y0:dst_y0 + ch, dst_x0:dst_x0 + cw] = \
                img[:, src_y0:src_y0 + ch, src_x0:src_x0 + cw]
        img = canvas
        bboxes[:, [1, 3]] -= off_x
        bboxes[:, [2, 4]] -= off_y

        if train and rng.random() < a.flip_prob:
            img = img[:, :, ::-1].copy()
            x1 = out_w - 1 - bboxes[:, 3]
            x2 = out_w - 1 - bboxes[:, 1]
            bboxes[:, 1], bboxes[:, 3] = x1, x2

        # drop bboxes that left the canvas entirely
        keep = (bboxes[:, 3] > 0) & (bboxes[:, 4] > 0) & \
               (bboxes[:, 1] < out_w) & (bboxes[:, 2] < out_h)
        return img, bboxes[keep]


def coverage_label(bboxes: np.ndarray, gt: DetectNetGroundTruthParameter,
                   num_classes: int = 1) -> np.ndarray:
    """bboxes (N,5)=[cls,x1,y1,x2,y2] -> (num_classes*5, gh, gw) label:
    per class [coverage, dx1, dy1, dx2, dy2]
    (detectnet_coverage_rectangular.cpp)."""
    stride = gt.stride
    gw = gt.image_size_x // stride
    gh = gt.image_size_y // stride
    out = np.zeros((num_classes * 5, gh, gw), np.float32)
    for cls, x1, y1, x2, y2 in np.asarray(bboxes, np.float32).reshape(-1, 5):
        ci = int(cls)
        if not 0 <= ci < num_classes:
            continue
        if gt.crop_bboxes:
            x1 = np.clip(x1, 0, gt.image_size_x - 1)
            x2 = np.clip(x2, 0, gt.image_size_x - 1)
            y1 = np.clip(y1, 0, gt.image_size_y - 1)
            y2 = np.clip(y2, 0, gt.image_size_y - 1)
        # coverage region: bbox shrunk around its center by scale_cvg,
        # clamped per gridbox_type
        cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
        cw, ch = (x2 - x1) * gt.scale_cvg, (y2 - y1) * gt.scale_cvg
        if gt.gridbox_type == "GRIDBOX_MAX":
            cw, ch = min(cw, gt.max_cvg_len), min(ch, gt.max_cvg_len)
        else:
            cw, ch = max(cw, gt.min_cvg_len), max(ch, gt.min_cvg_len)
        gx1 = int(np.floor((cx - cw / 2) / stride))
        gx2 = int(np.ceil((cx + cw / 2) / stride))
        gy1 = int(np.floor((cy - ch / 2) / stride))
        gy2 = int(np.ceil((cy + ch / 2) / stride))
        gx1, gy1 = max(gx1, 0), max(gy1, 0)
        gx2, gy2 = min(max(gx2, gx1 + 1), gw), min(max(gy2, gy1 + 1), gh)
        base = ci * 5
        out[base, gy1:gy2, gx1:gx2] = 1.0
        # bbox corner offsets relative to each covered cell center
        ys, xs = np.mgrid[gy1:gy2, gx1:gx2]
        cell_cx = xs * stride + stride / 2
        cell_cy = ys * stride + stride / 2
        out[base + 1, gy1:gy2, gx1:gx2] = x1 - cell_cx
        out[base + 2, gy1:gy2, gx1:gx2] = y1 - cell_cy
        out[base + 3, gy1:gy2, gx1:gx2] = x2 - cell_cx
        out[base + 4, gy1:gy2, gx1:gx2] = y2 - cell_cy
    return out


class DetectNetFeeder:
    """feed_fn producing (data, label) batches from a detection dataset:
    dataset.get(i) -> (CHW uint8 BGR image, bboxes (N,5))."""

    def __init__(self, dataset, lp, phase: str = "TRAIN", *, seed: int = 1701,
                 num_classes: int = 1, rank: int = 0, world: int = 1,
                 top_names=("data", "label")):
        self.ds = dataset
        self.gt = lp.detectnet_groundtruth_param or DetectNetGroundTruthParameter()
        self.augmenter = DetectNetAugmenter(
            lp.detectnet_augmentation_param, self.gt, phase)
        p = lp.data_param
        self.batch = p.batch_size if p else 8
        self.num_classes = num_classes
        self.seed = seed
        self.rank, self.world = rank, world
        self.top_names = top_names

    def __call__(self, it: int) -> dict[str, np.ndarray]:
        gt = self.gt
        imgs, labels = [], []
        n = len(self.ds)
        for slot in range(self.batch):
            flat = it * self.batch * self.world + self.rank * self.batch + slot
            rng = np.random.Generator(np.random.Philox(
                key=(self.seed << 32) ^ flat))
            img, bboxes = self.ds.get(flat % n)
            img, bboxes = self.augmenter(img, bboxes, rng)
            imgs.append(img)
            labels.append(coverage_label(bboxes, gt, self.num_classes))
        return {self.top_names[0]: np.stack(imgs),
                self.top_names[1]: np.stack(labels)}
