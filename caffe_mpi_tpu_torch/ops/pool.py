"""Pooling with exact Caffe output-size and divisor semantics.

Reference: src/caffe/layers/pooling_layer.cpp; JAX package
caffe_mpi_tpu/ops/pool.py.
- Output size rounds UP: ceil((H + 2p - k)/s) + 1 (pooling_layer.cpp:92-95),
  then clipped so the last window starts inside the padded image
  (pooling_layer.cpp:99-107) — and only when some pad is nonzero, then in
  both dims. torch's `ceil_mode` always clips, so it is not used: the
  input is padded explicitly (-inf for MAX, 0 for AVE) to exactly the
  extent the Caffe output needs, and pooled with `ceil_mode=False`.
- AVE pooling divides by the window's intersection with the *padded* image
  (count includes pad cells, clipped at H+p on the high side) — the
  hstart/hend/pool_size arithmetic at pooling_layer.cpp:196-215, which
  `count_include_pad` cannot express. The window sums are divided by a
  static divisor table instead.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def pool_output_dim(size: int, kernel: int, pad: int, stride: int,
                    any_pad: bool | None = None) -> int:
    """One output dimension. `any_pad` mirrors the reference's
    `if (pad_h_ || pad_w_)` guard (pooling_layer.cpp:96-108): the last-window
    clip applies to BOTH dims whenever EITHER pad is nonzero."""
    out = int(math.ceil((size + 2 * pad - kernel) / stride)) + 1
    if any_pad is None:
        any_pad = pad > 0
    if any_pad and (out - 1) * stride >= size + pad:
        out -= 1
    return out


def _pad_amounts(size: int, kernel: int, pad: int, stride: int, out: int) -> tuple[int, int]:
    """(lo, hi) padding so a floor-mode window emits exactly `out` positions."""
    hi = (out - 1) * stride + kernel - size - pad
    return pad, max(hi, 0)


def _padded(x: torch.Tensor, kernel, stride, pad, value: float):
    n, c, h, w = x.shape
    any_pad = pad[0] > 0 or pad[1] > 0
    oh = pool_output_dim(h, kernel[0], pad[0], stride[0], any_pad)
    ow = pool_output_dim(w, kernel[1], pad[1], stride[1], any_pad)
    ph = _pad_amounts(h, kernel[0], pad[0], stride[0], oh)
    pw = _pad_amounts(w, kernel[1], pad[1], stride[1], ow)
    if ph != (0, 0) or pw != (0, 0):
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=value)
    return x, oh, ow


def max_pool2d(x: torch.Tensor, kernel: tuple[int, int], stride: tuple[int, int],
               pad: tuple[int, int]) -> torch.Tensor:
    """NCHW max pooling, Caffe ceil-mode output size."""
    xp, _, _ = _padded(x, kernel, stride, pad, float("-inf"))
    return F.max_pool2d(xp, tuple(kernel), tuple(stride), padding=0,
                        ceil_mode=False)


def _divisors(size, kernel, pad, stride, out, device):
    # |[hstart, min(hstart+k, H+pad))| per position, hstart = i*s - pad
    # (pooling_layer.cpp:198-201); made on the device, so a CUDA graph
    # can capture it
    starts = torch.arange(out, device=device) * stride - pad
    ends = torch.clamp(starts + kernel, max=size + pad)
    return (ends - starts).to(torch.float32)


def avg_pool2d(x: torch.Tensor, kernel: tuple[int, int], stride: tuple[int, int],
               pad: tuple[int, int]) -> torch.Tensor:
    """NCHW average pooling with Caffe's padded-window divisor."""
    n, c, h, w = x.shape
    xp, oh, ow = _padded(x, kernel, stride, pad, 0.0)
    sums = F.avg_pool2d(xp, tuple(kernel), tuple(stride), padding=0,
                        ceil_mode=False, divisor_override=1)
    dh = _divisors(h, kernel[0], pad[0], stride[0], oh, x.device)
    dw = _divisors(w, kernel[1], pad[1], stride[1], ow, x.device)
    div = torch.outer(dh, dw).to(x.dtype)
    return sums / div
