"""Graph-input layers: Input, DummyData, MemoryData, Data, ImageData,
WindowData.

Reference: src/caffe/layers/{input,dummy_data,memory_data,data,image_data,
window_data}_layer.cpp.
As in the JAX package (caffe_mpi_tpu/layers/data_layers.py), data layers
do not *produce* data inside the graph — they declare input shapes, and
the caller feeds tensors in by blob name (a Feeder for a Data layer,
data/feeder.py). DummyData is the exception: it fills its tops itself.

The Data layer's shape comes from a probe of its dataset, which the Net
runs before setup (`bound_shape`). With the device transform (default on,
as in JAX; `transform_param { use_gpu_transform: false }` turns it off)
its feed contract is {top0: raw uint8 (B, C, H, W), top0 + "__aug": (B, 3)
int32, label: int}, and its forward crops, subtracts the mean, mirrors
and scales on the tensors' device (data/device_transform.py).

ImageData (a list of image files, data/datasets.py ImageFolderDataset)
and WindowData (R-CNN's window file, data/window.py WindowFeeder) are
feed slots whose batches their host feeders transform. HDF5Data is
registered so that a net naming it is refused at setup with
NotImplementedError (ROADMAP.md §1 item 3), not reported as an unknown
type, as HDF5Output is (layers/extension.py, item 7). Every JAX layer
type is registered (Pipeline in layers/composite.py).
"""

from __future__ import annotations

import torch

from ..core.fillers import fill
from ..proto.config import FillerParameter
from .base import Layer, Shape, register


class InputLayerBase(Layer):
    """Marker base: tops come from the feed dict, not from bottoms."""

    def feed_specs(self) -> list[tuple[str, Shape, str]]:
        """The host feed contract: [(feed key, shape, kind)], kind in
        {"float", "int", "uint8", "aug"}. Default: one float blob per
        top."""
        return [(t, s, "float")
                for t, s in zip(self.lp.top, self.out_shapes)]

    def gather_feeds(self, feeds: dict) -> list:
        """Pull + validate this layer's feeds; returns forward() bottoms."""
        bottoms = []
        for key, shape, _kind in self.feed_specs():
            try:
                v = feeds[key]
            except KeyError:
                raise KeyError(
                    f"input layer {self.name!r}: missing feed for blob "
                    f"{key!r}") from None
            if tuple(v.shape) != tuple(shape):
                raise ValueError(
                    f"feed {key!r}: shape {tuple(v.shape)} != declared {shape}")
            bottoms.append(v)
        return bottoms

    def forward(self, bottoms):
        # bottoms here are the fed tensors, passed through (floating ones
        # cast to the policy)
        return [self.f(b) for b in bottoms]


@register("Input")
class InputLayer(InputLayerBase):
    def setup(self, in_shapes: list[Shape]) -> list[Shape]:
        p = self.lp.input_param
        if not p or not p.shape:
            raise ValueError(f"{self.name}: input_param.shape required")
        shapes = [tuple(s.dim) for s in p.shape]
        if len(shapes) == 1 and len(self.lp.top) > 1:
            shapes = shapes * len(self.lp.top)
        return shapes


@register("DummyData")
class DummyDataLayer(Layer):
    """Filled tops (dummy_data_layer.cpp), made in every forward. A
    constant filler gives the JAX layer's tops exactly; a random one draws
    from the layer's own CPU generator (seeded 0 at setup), where the JAX
    layer folds its step key — the same distribution, other bits."""

    def setup(self, in_shapes: list[Shape]) -> list[Shape]:
        p = self.lp.dummy_data_param
        if p.shape:
            shapes = [tuple(s.dim) for s in p.shape]
        else:  # legacy num/channels/height/width
            shapes = [(p.num[i], p.channels[i], p.height[i], p.width[i])
                      for i in range(len(p.num))]
        if len(shapes) == 1:
            shapes = shapes * len(self.lp.top)
        self.fillers = list(p.data_filler) or [
            FillerParameter(type="constant")]
        if len(self.fillers) == 1:
            self.fillers = self.fillers * len(shapes)
        self._gen = torch.Generator().manual_seed(0)
        return shapes

    def forward(self, bottoms):
        return [fill(filler, self._gen, shape, self.policy.forward).to(
                    self.device)
                for shape, filler in zip(self.out_shapes, self.fillers)]


@register("MemoryData")
class MemoryDataLayer(InputLayerBase):
    """In the reference, user code Reset()s a pointer to host memory
    (memory_data_layer.cpp); here it is a typed feed slot."""

    def setup(self, in_shapes: list[Shape]) -> list[Shape]:
        p = self.lp.memory_data_param
        return [(p.batch_size, p.channels, p.height, p.width),
                (p.batch_size,)][: len(self.lp.top)]


class PipelineDataLayer(InputLayerBase):
    """Base for DB-backed layers: a host-side Feeder produces the batches;
    in the graph they are feed slots shaped from transform_param and the
    batch size."""

    def _data_shapes(self, batch: int, channels: int, height: int,
                     width: int):
        tp = self.lp.transform_param
        if tp and tp.crop_size:
            height = width = tp.crop_size
        shapes = [(batch, channels, height, width)]
        if len(self.lp.top) > 1:
            shapes.append((batch,))
        return shapes


@register("Data")
class DataLayer(PipelineDataLayer):
    """LMDB-backed (data_layer.cpp). The Net sets `bound_shape` from a
    dataset probe before setup (its raw shape, where there is one, allows
    the device transform); `model_dir` resolves the mean file."""

    bound_shape: tuple | None = None
    model_dir: str = ""

    def setup(self, in_shapes: list[Shape]) -> list[Shape]:
        from ..data.device_transform import wants_device_transform
        p = self.lp.data_param
        if self.bound_shape is None:
            raise ValueError(
                f"{self.name}: Data layer requires a dataset probe; the "
                "runner must set layer.bound_shape = (C, H, W) before setup")
        c, h, w = self.bound_shape
        # the raw record shape, reported by the probe for uniform uint8
        # datasets; None leaves the transform on the host
        self.raw_shape = getattr(self.bound_shape, "raw", None)
        self.dev_transform = bool(
            self.raw_shape is not None and wants_device_transform(self.lp))
        self._mean = None
        if self.dev_transform:
            from ..data.transformer import DataTransformer
            mean = DataTransformer(self.lp.transform_param, self.phase,
                                   model_dir=self.model_dir or "").mean
            if mean is not None:
                self._mean = torch.from_numpy(mean).to(self.device)
        return self._data_shapes(p.batch_size, c, h, w)

    def feed_specs(self):
        if not getattr(self, "dev_transform", False):
            return super().feed_specs()
        from ..data.device_transform import AUG_FIELDS, aug_key
        b = self.lp.data_param.batch_size
        top0 = self.lp.top[0]
        specs = [(top0, (b, *self.raw_shape), "uint8"),
                 (aug_key(top0), (b, AUG_FIELDS), "aug")]
        for t, s in zip(self.lp.top[1:], self.out_shapes[1:]):
            specs.append((t, s, "int"))
        return specs

    def forward(self, bottoms):
        if not self.dev_transform:
            return super().forward(bottoms)
        from ..data.device_transform import device_transform
        raw, aug, *rest = bottoms
        tp = self.lp.transform_param
        x = device_transform(raw, aug, crop=tp.crop_size if tp else 0,
                             mean=self._mean,
                             scale=tp.scale if tp else 1.0)
        return [self.f(x), *rest]


@register("ImageData")
class ImageDataLayer(PipelineDataLayer):
    """A list of image files (image_data_layer.cpp), each resized to
    new_height x new_width; the Feeder transforms on the host."""

    def setup(self, in_shapes: list[Shape]) -> list[Shape]:
        p = self.lp.image_data_param
        c = 3 if p.is_color else 1
        h, w = p.new_height, p.new_width
        if not (h and w):
            raise ValueError(
                f"{self.name}: ImageData requires new_height/new_width for "
                "static shapes")
        return self._data_shapes(p.batch_size, c, h, w)


@register("WindowData")
class WindowDataLayer(InputLayerBase):
    """R-CNN window sampling (window_data_layer.cpp); the batches come
    from data/window.py WindowFeeder, warped to crop_size."""

    def setup(self, in_shapes: list[Shape]) -> list[Shape]:
        p = self.lp.window_data_param
        crop = p.crop_size or (self.lp.transform_param.crop_size
                               if self.lp.transform_param else 0)
        if not crop:
            raise ValueError(f"{self.name}: WindowData requires crop_size")
        shapes = [(p.batch_size, 3, crop, crop)]
        if len(self.lp.top) > 1:
            shapes.append((p.batch_size,))
        return shapes


@register("HDF5Data")
class HDF5DataLayer(Layer):
    def setup(self, in_shapes: list[Shape]) -> list[Shape]:
        raise NotImplementedError(
            f"layer {self.name!r}: the {self.type_name} layer is not ported "
            "yet (ROADMAP.md §1 item 3)")
