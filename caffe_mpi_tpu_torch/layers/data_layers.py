"""Graph-input layers. The port has Input only so far.

Reference: src/caffe/layers/input_layer.cpp. As in the JAX package
(caffe_mpi_tpu/layers/data_layers.py), data layers do not *produce* data
inside the graph — they declare input shapes, and the caller feeds tensors
in by blob name.
"""

from __future__ import annotations

from .base import Layer, Shape, register


class InputLayerBase(Layer):
    """Marker base: tops come from the feed dict, not from bottoms."""

    def feed_specs(self) -> list[tuple[str, Shape, str]]:
        """The host feed contract: [(feed key, shape, kind)]. One float
        blob per top."""
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
        # bottoms here are the fed tensors, passed through (cast to policy)
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
