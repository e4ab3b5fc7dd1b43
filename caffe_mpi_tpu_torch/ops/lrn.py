"""Across-channel LRN forward: the CUDA kernel and its plain version.

Replaces the TPU kernel `caffe_mpi_tpu/ops/lrn.py:_fwd_kernel` (Pallas),
which the JAX package reaches through `lrn_across_channels`:

    y_i = x_i * s_i^-beta,  s_i = k + (alpha/n) * sum_{W(i)} x_j^2

with W(i) the centred n-channel window, zero beyond the edges (reference
src/caffe/layers/lrn_layer.cpp:94-116, lrn_layer.cu LRNFillScale /
LRNComputeOutput).

`lrn_across_channels` launches `csrc/lrn.cu` for a tensor on the card and
takes `lrn_across_channels_ref` — plain torch, f32 math, the window sum as
`size` shifted adds of the zero-padded squares, as the TPU kernel's
`_window_sum` does — only for a tensor on the CPU. There is no fallback:
a CUDA tensor the kernel cannot take, a failed build or a refused launch
raises.

`lrn_across_channels.launches` counts kernel launches (one per launch,
nowhere else), so a run can show that its path went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

_KERNEL_SOURCE = "lrn.cu"
_KERNEL_DTYPES = {torch.float32: "lrn_fwd_f32", torch.bfloat16: "lrn_fwd_bf16"}
# the TPU kernel this one replaces, for reports
REPLACES = "caffe_mpi_tpu/ops/lrn.py:54 _fwd_kernel"


def _window_sum(t: torch.Tensor, size: int) -> torch.Tensor:
    """Centred channel-window sum over dim 1 of (N, C, ...): out[:, i] =
    sum_{j in [i-half, i+half]} t[:, j], zero beyond the edges."""
    half = (size - 1) // 2
    c = t.shape[1]
    pad_shape = (t.shape[0], half, *t.shape[2:])
    zeros = t.new_zeros(pad_shape)
    padded = torch.cat([zeros, t, zeros], dim=1)
    out = padded[:, 0:c]
    for off in range(1, size):
        out = out + padded[:, off:off + c]
    return out


def _check(x: torch.Tensor, size: int) -> None:
    if x.dim() != 4:
        raise ValueError(f"lrn_across_channels expects NCHW, got "
                         f"shape {tuple(x.shape)}")
    if size % 2 != 1:
        raise ValueError("LRN local_size must be odd")


def lrn_across_channels_ref(x: torch.Tensor, size: int, alpha: float,
                            beta: float, k: float) -> torch.Tensor:
    """Plain torch across-channel LRN, any device: f32 math, output in
    x's dtype."""
    _check(x, size)
    xf = x.float()
    scale = k + _window_sum(xf * xf, size) * (alpha / size)
    return (xf * torch.exp(-beta * torch.log(scale))).to(x.dtype)


def _launch(x: torch.Tensor, size: int, alpha: float, beta: float,
            k: float) -> torch.Tensor:
    from . import build
    fn_name = _KERNEL_DTYPES.get(x.dtype)
    if fn_name is None:
        raise TypeError(f"lrn kernel takes float32 or bfloat16, got {x.dtype}")
    n, c, h, w = x.shape
    if n > 65535 or c > 65535 * 8:
        raise ValueError(f"lrn kernel grid takes at most 65535 images and "
                         f"{65535 * 8} channels, got {n} and {c}")
    x = x.contiguous()
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    fn = getattr(build.load(_KERNEL_SOURCE), fn_name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_float, ctypes.c_float, ctypes.c_float,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), y.data_ptr(), n, c, h * w, size,
                 alpha / size, beta, k, stream)
    if err != 0:
        raise RuntimeError(f"lrn kernel launch failed: cudaError {err}")
    lrn_across_channels.launches += 1
    return y


def lrn_across_channels(x: torch.Tensor, size: int, alpha: float,
                        beta: float, k: float) -> torch.Tensor:
    """Across-channels LRN over a (N, C, H, W) tensor — the AlexNet /
    CaffeNet norm_region=ACROSS_CHANNELS case. On the card: the CUDA
    kernel (float32 or bfloat16 I/O). On the CPU: the plain version."""
    _check(x, size)
    size, alpha, beta, k = int(size), float(alpha), float(beta), float(k)
    if x.device.type == "cuda":
        return _launch(x, size, alpha, beta, k)
    if x.device.type == "cpu":
        return lrn_across_channels_ref(x, size, alpha, beta, k)
    raise ValueError(f"lrn_across_channels: unsupported device {x.device}")


lrn_across_channels.launches = 0
