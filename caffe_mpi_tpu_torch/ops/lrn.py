"""Across-channel LRN, forward and backward: the CUDA kernels and their plain
versions.

Replaces the TPU kernels `caffe_mpi_tpu/ops/lrn.py:_fwd_kernel` (K1) and
`:_bwd_kernel` (K2) (Pallas), which the JAX package reaches through
`lrn_across_channels` and its `custom_vjp`:

    y_i  = x_i * s_i^-beta,  s_i = k + (alpha/n) * sum_{W(i)} x_j^2
    dx_m = dy_m * s_m^-beta
           - (2*alpha*beta/n) * x_m * sum_{W(m)} dy_i x_i s_i^{-beta-1}

with W(i) the centred n-channel window, zero beyond the edges (reference
src/caffe/layers/lrn_layer.cpp:94-116, lrn_layer.cu LRNFillScale /
LRNComputeOutput / LRNComputeDiff).

`lrn_across_channels` goes through `_LRNFunction`, a
`torch.autograd.Function` that saves x alone (the backward recomputes the
scale, as the TPU kernel does). For a tensor on the card its forward
launches K1 and its backward K2 (`csrc/lrn.cu`); for a tensor on the CPU
they take `lrn_across_channels_ref` and `lrn_across_channels_bwd_ref` —
plain torch, f32 math (f64 for a float64 tensor), the window sums as
`size` shifted adds of the zero-padded terms, as the TPU kernel's
`_window_sum` does. There is no fallback: a CUDA tensor the kernels cannot
take, a failed build or a refused launch raises.

The kernels take any odd `local_size` (a register kernel for windows up
to 15, a runtime-window kernel beyond: the shape picks it in
`csrc/lrn.cu`) and any image count: their grid has one axis of
2**31 - 1 blocks, and a tensor that would pass it is cut into launches
over runs of images (`_image_chunks`).

`lrn_across_channels.launches` and `lrn_across_channels_bwd.launches`
count kernel launches (one per launch, nowhere else), so a run can show
that its path went through the kernels.
"""

from __future__ import annotations

import ctypes

import torch

_KERNEL_SOURCE = "lrn.cu"
_FWD = {torch.float32: "lrn_fwd_f32", torch.bfloat16: "lrn_fwd_bf16"}
_BWD = {torch.float32: "lrn_bwd_f32", torch.bfloat16: "lrn_bwd_bf16"}
# the TPU kernels these replace, for reports
REPLACES = "caffe_mpi_tpu/ops/lrn.py:61 _fwd_kernel"
REPLACES_BWD = "caffe_mpi_tpu/ops/lrn.py:70 _bwd_kernel"
# the kernels' one grid axis, and the fewest channels and positions a
# block of theirs takes (csrc/lrn.cu kSmallRun, half of kThreads)
_GRID_BLOCKS = 2**31 - 1
_MIN_RUN, _MIN_POSITIONS = 8, 128


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


def _math(x: torch.Tensor) -> torch.Tensor:
    """x in the plain versions' math type: f32, or f64 for a float64 x."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def lrn_across_channels_ref(x: torch.Tensor, size: int, alpha: float,
                            beta: float, k: float) -> torch.Tensor:
    """Plain torch across-channel LRN, any device: f32 math, output in
    x's dtype."""
    _check(x, size)
    xf = _math(x)
    scale = k + _window_sum(xf * xf, size) * (alpha / size)
    return (xf * torch.exp(-beta * torch.log(scale))).to(x.dtype)


def lrn_across_channels_bwd_ref(x: torch.Tensor, dy: torch.Tensor,
                                size: int, alpha: float, beta: float,
                                k: float) -> torch.Tensor:
    """Plain torch LRN backward, any device, in the TPU kernel's order: the
    scale recomputed from x, f32 math, dx in x's dtype."""
    _check(x, size)
    xf, dyf = _math(x), _math(dy)
    scale = k + _window_sum(xf * xf, size) * (alpha / size)
    inv = torch.exp(-beta * torch.log(scale))
    ratio = dyf * xf * inv / scale
    dx = dyf * inv - (2.0 * alpha * beta / size) * xf * _window_sum(
        ratio, size)
    return dx.to(x.dtype)


def _kernel(table: dict, x: torch.Tensor, argtypes: list):
    from . import build
    fn_name = table.get(x.dtype)
    if fn_name is None:
        raise TypeError(f"lrn kernel takes float32 or bfloat16, got {x.dtype}")
    fn = getattr(build.load(_KERNEL_SOURCE), fn_name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


_I, _F, _P = ctypes.c_int, ctypes.c_float, ctypes.c_void_p


def _image_chunks(n: int, c: int, hw: int) -> list[tuple[int, int]]:
    """(first image, images) of each launch: as many images as the grid's
    one axis holds at the most blocks an image can take."""
    per_image = -(-c // _MIN_RUN) * -(-hw // _MIN_POSITIONS)
    per = max(1, _GRID_BLOCKS // per_image)
    return [(i, min(per, n - i)) for i in range(0, n, per)]


def _run(fn, counter, tensors, *args) -> None:
    """Launch `fn` over `tensors` (all of one shape, x first) once a chunk
    of images, raising `counter.launches` (the entry point's) by one a
    launch."""
    x = tensors[0]
    n, c, h, w = x.shape
    step = c * h * w * x.element_size()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        for i0, m in _image_chunks(n, c, h * w):
            err = fn(*(t.data_ptr() + i0 * step for t in tensors), m, c,
                     h * w, *args, stream)
            if err != 0:
                raise RuntimeError(f"{counter.__name__} kernel launch "
                                   f"failed: cudaError {err}")
            counter.launches += 1


def _launch(x: torch.Tensor, size: int, alpha: float, beta: float,
            k: float) -> torch.Tensor:
    fn = _kernel(_FWD, x, [_P, _P, _I, _I, _I, _I, _F, _F, _F, _P])
    x = x.contiguous()
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    _run(fn, lrn_across_channels, (x, y), size,
         alpha / size, beta, k)
    return y


def _launch_bwd(x: torch.Tensor, dy: torch.Tensor, size: int, alpha: float,
                beta: float, k: float) -> torch.Tensor:
    fn = _kernel(_BWD, x, [_P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _F, _P])
    x, dy = x.contiguous(), dy.contiguous()
    dx = torch.empty_like(x)
    if x.numel() == 0:
        return dx
    _run(fn, lrn_across_channels_bwd, (x, dy, dx),
         size, alpha / size, beta, k, 2.0 * alpha * beta / size)
    return dx


def _device_type(x: torch.Tensor) -> str:
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"lrn_across_channels: unsupported device "
                         f"{x.device}")
    return x.device.type


class _LRNFunction(torch.autograd.Function):
    """K1 forward, K2 backward on the card; the plain pair on the CPU. The
    residual is x alone."""

    @staticmethod
    def forward(ctx, x, size, alpha, beta, k):
        ctx.save_for_backward(x)
        ctx.hyper = (size, alpha, beta, k)
        if x.device.type == "cuda":
            return _launch(x, size, alpha, beta, k)
        return lrn_across_channels_ref(x, size, alpha, beta, k)

    @staticmethod
    def backward(ctx, dy):
        (x,) = ctx.saved_tensors
        return (lrn_across_channels_bwd(x, dy, *ctx.hyper),
                None, None, None, None)


def lrn_across_channels(x: torch.Tensor, size: int, alpha: float,
                        beta: float, k: float) -> torch.Tensor:
    """Across-channels LRN over a (N, C, H, W) tensor — the AlexNet /
    CaffeNet norm_region=ACROSS_CHANNELS case. Differentiable. On the card:
    the CUDA kernels (float32 or bfloat16 I/O). On the CPU: the plain
    versions."""
    _check(x, size)
    _device_type(x)
    return _LRNFunction.apply(x, int(size), float(alpha), float(beta),
                              float(k))


def lrn_across_channels_bwd(x: torch.Tensor, dy: torch.Tensor, size: int,
                            alpha: float, beta: float,
                            k: float) -> torch.Tensor:
    """dx of the across-channel LRN from x and dy. On the card: K2. On the
    CPU: the plain version."""
    _check(x, size)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"lrn backward: dy {tuple(dy.shape)} {dy.dtype} "
                         f"{dy.device} does not match x {tuple(x.shape)} "
                         f"{x.dtype} {x.device}")
    size, alpha, beta, k = int(size), float(alpha), float(beta), float(k)
    if _device_type(x) == "cuda":
        return _launch_bwd(x, dy, size, alpha, beta, k)
    return lrn_across_channels_bwd_ref(x, dy, size, alpha, beta, k)


lrn_across_channels.launches = 0
lrn_across_channels_bwd.launches = 0
