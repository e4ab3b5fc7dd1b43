"""Parameter initializers — the reference fillers, drawn from a torch.Generator.

The reference's Filler hierarchy (include/caffe/filler.hpp) mutates a Blob in
place from a `FillerParameter`; the JAX package makes each filler a pure
function of a PRNG key (caffe_mpi_tpu/core/fillers.py). Here each filler
draws from an explicit `torch.Generator` on the CPU, so a seed fixes the
weights whatever device the net later runs on. The bits differ from JAX's
for the same seed; parity with the JAX package is reached by carrying
weights across (weights.py), and fillers are checked by distribution.

Fan-in/fan-out conventions match filler.hpp: for a weight of shape
(out, in, kh, kw), fan_in = count/out = in*kh*kw and fan_out = count/in.
"""

from __future__ import annotations

import math

import torch

from ..proto.config import FillerParameter


def _fans(shape: tuple[int, ...]) -> tuple[float, float]:
    count = math.prod(shape)
    num = shape[0] if shape else 1
    channels = shape[1] if len(shape) > 1 else 1
    fan_in = count / num if num else 1
    fan_out = count / channels if channels else 1
    return fan_in, fan_out


def _scale_n(filler: FillerParameter, shape) -> float:
    fan_in, fan_out = _fans(shape)
    norm = filler.variance_norm.upper()
    if norm == "FAN_OUT":
        return fan_out
    if norm == "AVERAGE":
        return (fan_in + fan_out) / 2.0
    return fan_in


def _uniform(gen, shape, lo, hi):
    return torch.rand(shape, generator=gen) * (hi - lo) + lo


def fill(filler: FillerParameter | None, gen: torch.Generator,
         shape: tuple[int, ...], dtype=torch.float32) -> torch.Tensor:
    """A CPU tensor initialized per the filler spec from `gen`."""
    if filler is None:
        filler = FillerParameter()
    ftype = filler.type
    shape = tuple(int(d) for d in shape)
    if ftype == "constant":
        return torch.full(shape, filler.value, dtype=dtype)
    if ftype == "uniform":
        return _uniform(gen, shape, filler.min, filler.max).to(dtype)
    if ftype == "gaussian":
        out = filler.mean + filler.std * torch.randn(shape, generator=gen)
        # sparse option (filler.hpp GaussianFiller): keep each output unit's
        # weights with prob sparse/fan_in, zero the rest
        if filler.sparse > 0:
            fan_in, _ = _fans(shape)
            prob = min(1.0, filler.sparse / max(fan_in, 1))
            keep = torch.rand(shape, generator=gen) < prob
            out = torch.where(keep, out, torch.zeros(()))
        return out.to(dtype)
    if ftype == "xavier":
        scale = math.sqrt(3.0 / _scale_n(filler, shape))
        return _uniform(gen, shape, -scale, scale).to(dtype)
    if ftype == "msra":
        std = math.sqrt(2.0 / _scale_n(filler, shape))
        return (std * torch.randn(shape, generator=gen)).to(dtype)
    raise ValueError(f"unknown filler type {ftype!r} (the port fills "
                     "constant, uniform, gaussian, xavier and msra)")
