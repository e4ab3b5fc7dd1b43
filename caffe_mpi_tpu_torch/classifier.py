"""Classifier / Detector — batch inference wrappers (pycaffe parity).

Reference: python/caffe/classifier.py (center-crop or oversampled
classification) and python/caffe/detector.py (R-CNN window detection
with context padding); JAX package caffe_mpi_tpu/classifier.py. The
batched forward is the serving engine's padded-bucket path
(serving/engine.py `BucketedForward`, `full_env=True`): on the card each
bucket is a CUDA graph captured at its first use, whose static outputs
are every blob, so `net.blobs` reads the last bucket's values after a
predict. The bucket nets hold this Net's params, so `copy_from` and
params assignment reach the graphs. A deploy net that cannot ladder (no
Input batch to rewrite, or more than one input) runs the declared-batch
loop through `Net.forward`, as in the JAX module. Rows are
batch-independent at inference, so both give the same scores.
"""

from __future__ import annotations

import numpy as np

from . import caffe_io
from .pycaffe import Net


class _PreprocessingNet(Net):
    """Shared transformer setup and the engine's padded-bucket forward."""

    def __init__(self, model_file: str, pretrained_file: str, mean=None,
                 input_scale=None, raw_scale=None, channel_swap=None,
                 device=None):
        super().__init__(model_file, pretrained_file, "TEST", device=device)
        in_ = self.inputs[0]
        self.transformer = caffe_io.Transformer.for_input(
            in_, self._net.blob_shapes[in_], mean=mean,
            input_scale=input_scale, raw_scale=raw_scale,
            channel_swap=channel_swap)
        self._bucket_fwd = None

    def bucket_forward(self):
        """The BucketedForward this net predicts through, or None for a
        net that cannot ladder."""
        from .serving.engine import BucketedForward
        if self._bucket_fwd is None:
            in_ = self.inputs[0]
            try:
                fwd = BucketedForward(
                    self._net.param, out_blob=self.outputs[-1],
                    max_batch=self._net.blob_shapes[in_][0],
                    device=self._net.device, model_dir=self._net.model_dir,
                    full_env=True, params_from=self._net)
                fwd.input_blob()  # multi-input nets raise here
                self._bucket_fwd = fwd
            except ValueError:
                # fed by a non-Input layer (no batch to rewrite) or by
                # several inputs (zero-filled): the declared-batch loop
                self._bucket_fwd = False
        return self._bucket_fwd or None

    def _forward_batched(self, crops) -> np.ndarray:
        """Preprocess and forward HWC crops through the bucket ladder
        (the largest bucket the net's declared batch), a chunk at a time;
        returns the last output blob's rows."""
        if not len(crops):
            raise ValueError("no crops to forward (empty input)")
        fwd = self.bucket_forward()
        if fwd is None:
            return self._forward_classic(crops)
        in_ = self.inputs[0]
        preds = []
        for start in range(0, len(crops), fwd.max_batch):
            data = np.stack([self.transformer.preprocess(in_, c)
                             for c in crops[start:start + fwd.max_batch]])
            preds.append(fwd.forward(data))
        self.env, self._blob_values = fwd.last_env, {}
        return np.concatenate(preds)

    def _forward_classic(self, crops) -> np.ndarray:
        """Pad-to-declared-batch loop through Net.forward."""
        in_ = self.inputs[0]
        batch_size = self._net.blob_shapes[in_][0]
        out_blob = self.outputs[-1]
        preds = []
        for start in range(0, len(crops), batch_size):
            chunk = crops[start:start + batch_size]
            data = np.stack([self.transformer.preprocess(in_, c)
                             for c in chunk])
            if len(data) < batch_size:
                pad = np.zeros((batch_size - len(data), *data.shape[1:]),
                               np.float32)
                data = np.concatenate([data, pad])
            out = self.forward(**{in_: data})
            preds.append(out[out_blob][:len(chunk)])
        return np.concatenate(preds)


class Classifier(_PreprocessingNet):
    def __init__(self, model_file: str, pretrained_file: str,
                 image_dims=None, mean=None, input_scale=None,
                 raw_scale=None, channel_swap=None, device=None):
        super().__init__(model_file, pretrained_file, mean, input_scale,
                         raw_scale, channel_swap, device)
        self.crop_dims = np.array(self._net.blob_shapes[self.inputs[0]][2:])
        self.image_dims = np.array(image_dims) if image_dims is not None \
            else self.crop_dims

    def predict(self, inputs, oversample: bool = True) -> np.ndarray:
        """Class scores of HWC images: with `oversample` the mean over the
        10 crops of each image resized to image_dims, else the center
        crop."""
        if oversample:
            resized = [caffe_io.resize_image(im, self.image_dims)
                       for im in inputs]
            crops = caffe_io.oversample(resized, self.crop_dims)
        else:
            crops = np.stack([
                caffe_io.resize_center_crop(im, self.image_dims,
                                            self.crop_dims)
                for im in inputs])
        preds = self._forward_batched(list(crops))
        if oversample:
            preds = preds.reshape(len(inputs), 10, -1).mean(axis=1)
        return preds


class Detector(_PreprocessingNet):
    """Window detector: classify image crops (reference detector.py)."""

    def __init__(self, model_file: str, pretrained_file: str, mean=None,
                 input_scale=None, raw_scale=None, channel_swap=None,
                 context_pad: int = 0, device=None):
        super().__init__(model_file, pretrained_file, mean, input_scale,
                         raw_scale, channel_swap, device)
        self.context_pad = context_pad

    def _expand_window(self, window, im_shape, crop_dims):
        """Context padding in window coordinates (reference detector.py
        detect_windows, window_data_layer's context_scale)."""
        y0, x0, y1, x1 = [float(v) for v in window]
        if self.context_pad:
            crop_h = float(crop_dims[0])
            scale = crop_h / (crop_h - 2.0 * self.context_pad)
            half_h = (y1 - y0 + 1) / 2.0
            half_w = (x1 - x0 + 1) / 2.0
            cy, cx = y0 + half_h, x0 + half_w
            y0, y1 = cy - half_h * scale, cy + half_h * scale
            x0, x1 = cx - half_w * scale, cx + half_w * scale
        y0, x0 = max(int(y0), 0), max(int(x0), 0)
        y1 = min(int(y1), im_shape[0])
        x1 = min(int(x1), im_shape[1])
        return y0, x0, y1, x1

    def detect_windows(self, images_windows) -> list[dict]:
        """[(image file, [(y0, x0, y1, x1), ...]), ...] -> one
        {"window", "prediction", "filename"} a window."""
        crop_dims = self._net.blob_shapes[self.inputs[0]][2:]
        window_inputs = []
        meta = []
        for image_fname, windows in images_windows:
            image = caffe_io.load_image(image_fname)
            for window in windows:
                y0, x0, y1, x1 = self._expand_window(window, image.shape,
                                                     crop_dims)
                window_inputs.append(caffe_io.resize_image(
                    image[y0:y1, x0:x1, :], crop_dims))
                meta.append((image_fname, window))
        scores = self._forward_batched(window_inputs)
        return [{"window": window, "prediction": score, "filename": fname}
                for (fname, window), score in zip(meta, scores)]
