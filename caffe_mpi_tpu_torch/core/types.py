"""Dtype policy — the port's mapping of the reference's mixed-precision system.

The reference threads a 5-value `Type` enum (DOUBLE/FLOAT/FLOAT16/INT/UINT,
caffe.proto:6-12) through each layer's forward/backward storage and math
precision (caffe.proto:374-382); the JAX package collapses that into a
per-layer dtype policy (caffe_mpi_tpu/core/types.py). The port keeps the
same policy with torch dtypes. FLOAT16 maps to bfloat16 as in the JAX
package, and DOUBLE to float32 (the port computes nothing in f64).

`precision` is the math mode of a layer's convolution or matrix product.
On the card a float32 convolution runs in TF32 through cuDNN unless told
otherwise, so the mode is applied per call: "highest" (a FLOAT or DOUBLE
*_math request) turns TF32 off for that call, "default" allows it.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass

import torch

_NAME_TO_DTYPE = {
    "DOUBLE": torch.float32,
    "FLOAT": torch.float32,
    "FLOAT16": torch.bfloat16,
    "INT": torch.int32,
    "UINT": torch.uint32,
}

# the TF32 switches are process-wide; layers on several threads must not
# interleave their set/restore pairs
_TF32_LOCK = threading.RLock()
# per thread: a layer's forward is being run again by a backward (remat)
_LOCAL = threading.local()


def dtype_for(type_name: str, default: torch.dtype = torch.float32):
    if not type_name:
        return default
    try:
        return _NAME_TO_DTYPE[type_name]
    except KeyError:
        raise ValueError(f"unknown Type name {type_name!r}") from None


@contextmanager
def recomputing():
    """Within: a layer's forward run again inside a backward (`remat`).
    On the card autograd runs that backward on its own device thread,
    while the thread that called backward waits, holding the TF32 lock
    for the whole step; `_tf32` then sets the switches without the lock
    (its holder is blocked until the recompute returns)."""
    prev = getattr(_LOCAL, "recompute", False)
    _LOCAL.recompute = True
    try:
        yield
    finally:
        _LOCAL.recompute = prev


@contextmanager
def _tf32(allow: bool):
    cudnn = torch.backends.cudnn
    matmul = torch.backends.cuda.matmul
    lock = nullcontext() if getattr(_LOCAL, "recompute", False) \
        else _TF32_LOCK
    with lock:
        saved = (cudnn.allow_tf32, matmul.allow_tf32)
        cudnn.allow_tf32 = allow
        matmul.allow_tf32 = allow
        try:
            yield
        finally:
            cudnn.allow_tf32, matmul.allow_tf32 = saved


@dataclass(frozen=True)
class DtypePolicy:
    """Per-layer precision choice, resolved from layer + net defaults the way
    reference net.cpp:100-156 resolves forward_type/backward_type and
    forward_math/backward_math."""

    forward: torch.dtype = torch.float32   # activation compute dtype
    backward: torch.dtype = torch.float32  # gradient compute dtype
    master: torch.dtype = torch.float32    # parameter storage dtype
    # "default": TF32 allowed for float32 convolutions and products;
    # "highest": full float32 multiplies (FLOAT/DOUBLE *_math request)
    precision: str = "default"

    @classmethod
    def resolve(cls, layer_fwd: str, layer_bwd: str, net_fwd: str, net_bwd: str,
                solver_storage: str = "FLOAT", layer_math: str = "",
                net_math: str = "", layer_bmath: str = "",
                net_bmath: str = "") -> "DtypePolicy":
        fwd = dtype_for(layer_fwd or net_fwd)
        bwd = dtype_for(layer_bwd or net_bwd)
        # one math mode per layer: the stricter of the forward/backward
        # requests, as in the JAX package
        fmath = (layer_math or net_math).upper()
        bmath = (layer_bmath or net_bmath).upper()
        strict = {"FLOAT", "DOUBLE"}
        precision = "highest" if (fmath in strict or bmath in strict) else "default"
        return cls(forward=fwd, backward=bwd,
                   master=dtype_for(solver_storage), precision=precision)

    def math(self, device: torch.device):
        """Context for one convolution or matrix product on `device`: sets
        the cuDNN and cuBLAS TF32 switches to this policy's precision for
        the call and restores them after. The CPU has no TF32 mode."""
        if device.type != "cuda":
            return nullcontext()
        return _tf32(self.precision == "default")

    def cast_in(self, x: torch.Tensor) -> torch.Tensor:
        """Cast an input/param to the forward compute dtype (no-op for ints)."""
        if x.is_floating_point() and x.dtype != self.forward:
            return x.to(self.forward)
        return x
