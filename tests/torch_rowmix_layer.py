"""A user Python layer whose rows are coupled, for the host-layer tests
under data parallelism (tests/test_torch_host_dp.py): each row is
centred on the batch's mean row, so its output depends on every row of
the batch the layer is handed."""

import numpy as np


class BatchCenter:
    """top = bottom - its mean over the batch (axis 0); the backward is
    the same centring of the top diff."""

    def infer_shapes(self, shapes):
        return [shapes[0]]

    def forward(self, bottoms):
        x = np.asarray(bottoms[0], np.float32)
        return [x - x.mean(axis=0, keepdims=True)]

    def backward(self, top_diffs, bottoms):
        g = np.asarray(top_diffs[0], np.float32)
        return [g - g.mean(axis=0, keepdims=True)]


class HalfMeanSquare:
    """A loss over the batch: top (1,) = 0.5 * sum(x^2) / rows; a top the
    batch does not split."""

    def infer_shapes(self, shapes):
        return [(1,)]

    def forward(self, bottoms):
        x = np.asarray(bottoms[0], np.float32)
        return [np.asarray([0.5 * np.square(x).sum() / x.shape[0]],
                           np.float32)]

    def backward(self, top_diffs, bottoms):
        x = np.asarray(bottoms[0], np.float32)
        g = np.asarray(top_diffs[0], np.float32).reshape(-1)[0]
        return [(g / x.shape[0]) * x]
