"""DetectNetTransformation layer — detection augmentation as a net layer.

Reference: src/caffe/layers/detectnet_transform_layer.{cpp,cu} (753+268
LoC) + util/detectnet_coverage_rectangular.cpp, used by
examples/kitti/detectnet_network.prototxt:65-127: bottoms (data, label)
from the DIGITS-format image/label DBs, tops (transformed_data,
transformed_label) where the label becomes the stride-decimated coverage
grid [coverage, dx1, dy1, dx2, dy2] per class. JAX package:
caffe_mpi_tpu/layers/detection.py.

The augmentation is branchy per-record host work (random crop, flip, hue
on variable bbox lists), so the layer is a host step in the middle of the
net, as the JAX layer is (there through `jax.pure_callback`): its forward
copies the bottoms to the host, runs data/detectnet.py's augmenter and
coverage_label on each record, and copies the results back to the
layer's device. Record i of a batch draws from
Philox((seed << 32) ^ i); in TRAIN the seed is the layer's draw from the
net's generator (`draw_mask`, or the `mask` the caller gives), in TEST 0,
as the JAX layer's. Over data-parallel ranks the step runs on the global
batch, as the JAX callback is handed it under a mesh (detection.py:198):
the bottoms are all-gathered, i is the global row, and each rank keeps
its rows (`Layer.host_ranks`). No gradient flows into the bottoms (the
reference's layer feeds data). A net holding it cannot be captured as a
CUDA graph (`host_step`): the solver runs its chunks eagerly.

Label wire format (blobToLabels, detectnet_transform_layer.cpp:199-219):
per record a flat float list [numBboxes, bboxLen(=16), <numBboxes x 16
fields>] where each 16-field row is [x, y, w, h, alpha, class, ...]
(include/caffe/util/detectnet_coverage.hpp:21-50).
"""

from __future__ import annotations

import numpy as np
import torch

from ..data.detectnet import DetectNetAugmenter, coverage_label
from ..proto.config import (DetectNetAugmentationParameter,
                            DetectNetGroundTruthParameter)
from .base import Layer, Shape, register

BBOX_LEN = 16  # sizeof(BboxLabel)/sizeof(Dtype) in the reference
SEED_RANGE = 2**31 - 1  # a TRAIN seed is drawn from [0, SEED_RANGE)


def parse_label_blob(rec: np.ndarray) -> np.ndarray:
    """One record's label blob (any shape, flattened) -> (n, 5) bboxes
    [cls, x1, y1, x2, y2]. Mirrors blobToLabels + the Rect(x,y,w,h) ->
    corners conversion the coverage generator performs (bbox.br())."""
    flat = np.asarray(rec, np.float32).reshape(-1)
    n = int(flat[0])
    blen = int(flat[1])
    if blen == 0:
        blen = BBOX_LEN  # header row of an empty record may be all-zero
    elif blen != BBOX_LEN:
        # reference: CHECK_EQ(bboxLen, sizeof(BboxLabel)/sizeof(Dtype)),
        # detectnet_transform_layer.cpp:212
        raise ValueError(f"label record declares bboxLen {blen}, "
                         f"expected {BBOX_LEN}")
    rows = flat[blen: blen + n * blen].reshape(n, blen)
    out = np.zeros((n, 5), np.float32)
    out[:, 0] = rows[:, 5]                    # classNumber
    out[:, 1] = rows[:, 0]                    # x1
    out[:, 2] = rows[:, 1]                    # y1
    out[:, 3] = rows[:, 0] + rows[:, 2]       # x + w
    out[:, 4] = rows[:, 1] + rows[:, 3]       # y + h
    return out


def encode_label_blob(bboxes: np.ndarray, max_bboxes: int) -> np.ndarray:
    """Inverse of parse_label_blob for fixtures and datasets: (n, 5)
    corner bboxes -> (1, max_bboxes + 1, 16) DIGITS-format label blob."""
    bboxes = np.asarray(bboxes, np.float32).reshape(-1, 5)
    n = len(bboxes)
    if n > max_bboxes:
        raise ValueError(f"{n} bboxes > max {max_bboxes}")
    out = np.zeros((1, max_bboxes + 1, BBOX_LEN), np.float32)
    out[0, 0, 0] = n
    out[0, 0, 1] = BBOX_LEN
    out[0, 1:1 + n, 0] = bboxes[:, 1]
    out[0, 1:1 + n, 1] = bboxes[:, 2]
    out[0, 1:1 + n, 2] = bboxes[:, 3] - bboxes[:, 1]
    out[0, 1:1 + n, 3] = bboxes[:, 4] - bboxes[:, 2]
    out[0, 1:1 + n, 5] = bboxes[:, 0]
    return out


@register("DetectNetTransformation")
class DetectNetTransformationLayer(Layer):
    needs_rng = True
    host_step = True

    def setup(self, in_shapes: list[Shape]) -> list[Shape]:
        if len(in_shapes) != 2:
            raise ValueError(
                f"layer {self.name!r}: DetectNetTransformation takes "
                "(data, label) bottoms")
        gt = (self.lp.detectnet_groundtruth_param
              or DetectNetGroundTruthParameter())
        self.gt = gt
        aug = (self.lp.detectnet_augmentation_param
               or DetectNetAugmentationParameter())
        # class mapping: dataset ids -> contiguous coverage indices
        self.class_map = {m.src: m.dst for m in gt.object_class} or {1: 0}
        self.num_classes = max(self.class_map.values()) + 1
        n = in_shapes[0][0]
        if in_shapes[1][0] != n:
            raise ValueError(
                f"layer {self.name!r}: data batch {n} != label batch "
                f"{in_shapes[1][0]} (detectnet_transform_layer.cpp:116)")
        if in_shapes[0][1] != 3:
            raise ValueError(
                f"layer {self.name!r}: expects 3-channel images, got "
                f"{in_shapes[0][1]} (detectnet_transform_layer.cpp:115 "
                "CHECK_EQ(channels, 3))")
        tp = self.lp.transform_param
        mean_values = list(tp.mean_value) if tp else []
        channels = in_shapes[0][1]
        if len(mean_values) not in (0, 1, channels):
            # the reference's retrieveMeanChannels handles only 1 or C
            # values and silently does nothing otherwise
            raise ValueError(
                f"layer {self.name!r}: {len(mean_values)} mean_value "
                f"entries for {channels} channels (expected 1 or "
                f"{channels})")
        if len(mean_values) == 1:
            mean_values = mean_values * channels
        self._mean = (np.asarray(mean_values, np.float32)
                      if mean_values else None)
        self._augmenter = DetectNetAugmenter(aug, gt, self.phase)
        gh, gw = gt.image_size_y // gt.stride, gt.image_size_x // gt.stride
        return [(n, 3, gt.image_size_y, gt.image_size_x),
                (n, self.num_classes * 5, gh, gw)]

    def draw_mask(self, generator: torch.Generator) -> torch.Tensor:
        """The seed a TRAIN forward draws from `generator` (0-d int64)."""
        return torch.randint(0, SEED_RANGE, (), generator=generator,
                             device=generator.device)

    def host_transform(self, data: np.ndarray, label: np.ndarray,
                       seed: int) -> tuple[np.ndarray, np.ndarray]:
        """The batch on the host: each record's bboxes parsed and mapped
        to coverage classes (unmapped ids drop), the image and bboxes
        augmented (the mean subtracted before the crop, so its zero-pad
        sits in mean-subtracted space, as the reference's
        transform_image_cpu), the coverage grid built."""
        imgs, covs = [], []
        for i in range(data.shape[0]):
            rng = np.random.Generator(np.random.Philox(
                key=(seed << 32) ^ i))
            raw = parse_label_blob(label[i])
            mapped = [np.concatenate(([[self.class_map[int(b[0])]]], [b[1:]]),
                                     axis=None)
                      for b in raw if int(b[0]) in self.class_map]
            boxes = (np.stack(mapped) if mapped
                     else np.zeros((0, 5), np.float32))
            img, boxes = self._augmenter(data[i], boxes, rng,
                                         mean=self._mean)
            imgs.append(img)
            covs.append(coverage_label(boxes, self.gt, self.num_classes))
        return (np.stack(imgs).astype(np.float32),
                np.stack(covs).astype(np.float32))

    def forward(self, bottoms, *, generator=None, mask=None):
        seed = 0
        if self.training:
            if mask is None and generator is not None:
                mask = self.draw_mask(generator)
            if mask is not None:
                seed = int(mask)
        data, label = bottoms[0].detach(), bottoms[1].detach()
        mesh = self.host_ranks()
        if mesh is not None:
            data, label = mesh.gather_rows(data), mesh.gather_rows(label)
        img, cov = self.host_transform(data.float().cpu().numpy(),
                                       label.cpu().numpy(), seed)
        img, cov = (torch.from_numpy(a).to(self.device) for a in (img, cov))
        if mesh is not None:
            img, cov = mesh.shard(img), mesh.shard(cov)
        return [self.f(img), cov]
