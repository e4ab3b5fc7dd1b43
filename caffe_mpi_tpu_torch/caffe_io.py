"""pycaffe io module — preprocessing and array/proto conversions.

Reference: python/caffe/io.py (Transformer, load_image, resize_image,
oversample, array_to_datum / datum_to_array, blobproto_to_array /
array_to_blobproto); JAX package caffe_mpi_tpu/caffe_io.py, of which this
is the port's own copy. `pycaffe.io` is this module.
"""

from __future__ import annotations

import numpy as np

from .data.datasets import encode_datum, parse_datum
from .io import encode_blob, parse_blob


# -- proto conversions ------------------------------------------------------

def blobproto_to_array(buf: bytes) -> np.ndarray:
    return parse_blob(buf)


def array_to_blobproto(arr: np.ndarray) -> bytes:
    return encode_blob(np.asarray(arr, np.float32))


def array_to_datum(arr: np.ndarray, label: int = 0) -> bytes:
    return encode_datum(np.asarray(arr, np.uint8), label)


def datum_to_array(buf: bytes) -> tuple[np.ndarray, int]:
    return parse_datum(buf)


# -- images -----------------------------------------------------------------

def load_image(filename: str, color: bool = True) -> np.ndarray:
    """An image file as float [0, 1] HWC (RGB for color, one channel
    otherwise), decoded through the port's decode policy (the native
    decoder where it is built, PIL otherwise), as the JAX `load_image`."""
    from .data import decode as _decode
    with open(filename, "rb") as f:
        data = f.read()
    if color:
        return _decode.to_float_image(_decode.decode_file(data))
    arr = _decode.decode_file(data, is_color=False)
    return arr[0, :, :, None].astype(np.float32) / 255.0


def resize_image(im: np.ndarray, new_dims, interp_order: int = 1) -> np.ndarray:
    """Resize HWC float image (PIL bilinear for order=1, nearest for 0).
    PIL is imported here, at the first resize, and only here."""
    try:
        from PIL import Image
    except ImportError:
        raise RuntimeError(
            f"resizing a {im.shape[:2]} image to {tuple(new_dims)} needs PIL, "
            "which is not installed; send images already at the model's "
            "input size") from None
    h, w = int(new_dims[0]), int(new_dims[1])
    mode = Image.BILINEAR if interp_order else Image.NEAREST
    chans = []
    for c in range(im.shape[2]):
        chan = Image.fromarray(im[:, :, c].astype(np.float32), mode="F")
        chans.append(np.asarray(chan.resize((w, h), mode)))
    return np.stack(chans, axis=2)


def resize_center_crop(im: np.ndarray, image_dims, crop_dims) -> np.ndarray:
    """Resize HWC image to image_dims, center-crop to crop_dims — the
    Classifier.predict(oversample=False) geometry. Same-size inputs skip
    the resize (and PIL)."""
    image_dims = np.asarray(image_dims)
    crop_dims = np.asarray(crop_dims)
    if tuple(im.shape[:2]) != tuple(int(d) for d in image_dims):
        im = resize_image(im, image_dims)
    if not np.array_equal(image_dims, crop_dims):
        center = ((image_dims - crop_dims) // 2).astype(int)
        im = im[center[0]:center[0] + int(crop_dims[0]),
                center[1]:center[1] + int(crop_dims[1]), :]
    return im


def oversample(images, crop_dims) -> np.ndarray:
    """10-crop augmentation: the 4 corners and the center of each image,
    then the same 5 mirrored (reference io.py oversample)."""
    im_shape = np.array(images[0].shape[:2])
    crop_dims = np.array(crop_dims)
    im_center = im_shape / 2.0
    h_indices = (0, im_shape[0] - crop_dims[0])
    w_indices = (0, im_shape[1] - crop_dims[1])
    crops_ix = np.empty((5, 4), dtype=int)
    curr = 0
    for i in h_indices:
        for j in w_indices:
            crops_ix[curr] = (i, j, i + crop_dims[0], j + crop_dims[1])
            curr += 1
    crops_ix[4] = np.tile(im_center, (1, 2)) + np.concatenate(
        [-crop_dims / 2.0, crop_dims / 2.0])
    crops_ix = np.tile(crops_ix, (2, 1))
    crops = np.empty((10 * len(images), crop_dims[0], crop_dims[1],
                      images[0].shape[-1]), dtype=np.float32)
    ix = 0
    for im in images:
        for crop in crops_ix:
            crops[ix] = im[crop[0]:crop[2], crop[1]:crop[3], :]
            ix += 1
        crops[ix - 5:ix] = crops[ix - 5:ix, :, ::-1, :]  # mirror last 5
    return crops


class Transformer:
    """Input preprocessing (reference io.py Transformer): per-input
    transpose, channel_swap, raw_scale, mean, input_scale."""

    def __init__(self, inputs: dict[str, tuple]):
        self.inputs = inputs
        self.transpose: dict[str, tuple] = {}
        self.channel_swap: dict[str, tuple] = {}
        self.raw_scale: dict[str, float] = {}
        self.mean: dict[str, np.ndarray] = {}
        self.input_scale: dict[str, float] = {}

    def _check(self, in_: str) -> None:
        if in_ not in self.inputs:
            raise ValueError(f"{in_} is not one of the net inputs "
                             f"{list(self.inputs)}")

    def set_transpose(self, in_: str, order) -> None:
        self._check(in_)
        self.transpose[in_] = tuple(order)

    def set_channel_swap(self, in_: str, order) -> None:
        self._check(in_)
        self.channel_swap[in_] = tuple(order)

    def set_raw_scale(self, in_: str, scale: float) -> None:
        self._check(in_)
        self.raw_scale[in_] = scale

    def set_mean(self, in_: str, mean: np.ndarray) -> None:
        self._check(in_)
        mean = np.asarray(mean, np.float32)
        if mean.ndim == 1:
            mean = mean[:, None, None]
        self.mean[in_] = mean

    def set_input_scale(self, in_: str, scale: float) -> None:
        self._check(in_)
        self.input_scale[in_] = scale

    def preprocess(self, in_: str, data: np.ndarray) -> np.ndarray:
        self._check(in_)
        out = np.asarray(data, np.float32)
        in_dims = self.inputs[in_][2:]
        if out.shape[:2] != tuple(in_dims):
            out = resize_image(out, in_dims)
        if in_ in self.transpose:
            out = out.transpose(self.transpose[in_])
        if in_ in self.channel_swap:
            out = out[np.array(self.channel_swap[in_]), :, :]
        if in_ in self.raw_scale:
            out = out * self.raw_scale[in_]
        if in_ in self.mean:
            out = out - self.mean[in_]
        if in_ in self.input_scale:
            out = out * self.input_scale[in_]
        return out

    @classmethod
    def for_input(cls, in_: str, shape: tuple, *, transpose=(2, 0, 1),
                  mean=None, input_scale=None, raw_scale=None,
                  channel_swap=None) -> "Transformer":
        """One-input transformer with the pycaffe Classifier defaults."""
        t = cls({in_: shape})
        if transpose is not None:
            t.set_transpose(in_, transpose)
        if mean is not None:
            t.set_mean(in_, mean)
        if input_scale is not None:
            t.set_input_scale(in_, input_scale)
        if raw_scale is not None:
            t.set_raw_scale(in_, raw_scale)
        if channel_swap is not None:
            t.set_channel_swap(in_, channel_swap)
        return t
