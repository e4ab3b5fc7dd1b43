"""Learning-rate and momentum schedules, as plain Python floats.

Reference: src/caffe/solvers/sgd_solver.cpp:24-91 GetLearningRate /
GetMomentum; JAX package caffe_mpi_tpu/solver/lr_policy.py, which evaluates
the same formulas in f32 on the device inside the jitted step. The port
runs each iteration from the host, so it evaluates them on the host in
double precision: fixed/step/exp/inv/multistep/poly(+min_lr)/sigmoid, the
linear warm-up ramp (rampup_interval/rampup_lr), and the momentum policies
fixed/poly/opt. `table` gives a chunk's rows of them as float32 for the
device.
"""

from __future__ import annotations

import bisect
import math

import numpy as np

from ..proto.config import SolverParameter


def learning_rate(p: SolverParameter, it: int) -> float:
    """lr at iteration `it`."""
    policy = p.lr_policy
    if policy == "fixed":
        rate = p.base_lr
    elif policy == "step":
        if p.stepsize <= 0:
            raise ValueError("step policy requires stepsize > 0")
        rate = p.base_lr * p.gamma ** math.floor(it / p.stepsize)
    elif policy == "exp":
        rate = p.base_lr * p.gamma ** it
    elif policy == "inv":
        rate = p.base_lr * (1.0 + p.gamma * it) ** -p.power
    elif policy == "multistep":
        step = bisect.bisect_right(p.stepvalue or [2**31 - 1], it)
        rate = p.base_lr * p.gamma ** step
    elif policy == "poly":
        frac = 1.0 - it / max(p.max_iter, 1)
        rate = p.min_lr + (p.base_lr - p.min_lr) * max(frac, 0.0) ** p.power
    elif policy == "sigmoid":
        rate = p.base_lr / (1.0 + math.exp(-p.gamma * (it - p.stepsize)))
    else:
        raise ValueError(f"unknown lr_policy {policy!r}")
    if p.rampup_interval > 0 and it < p.rampup_interval:
        alpha = it / p.rampup_interval
        rate = p.rampup_lr + (p.base_lr - p.rampup_lr) * alpha
    return float(rate)


def momentum(p: SolverParameter, it: int) -> float:
    """momentum at iteration `it`."""
    policy = p.momentum_policy
    if policy == "fixed":
        return float(p.momentum)
    if policy == "poly":
        frac = it / max(p.max_iter, 1)
        return float(p.momentum + (p.max_momentum - p.momentum)
                     * frac ** p.momentum_power)
    if policy == "opt":
        m = (1.0 - 0.5 * math.sqrt(learning_rate(p, it))) ** 2
        if p.has("max_momentum"):
            m = min(m, p.max_momentum)
        return float(m)
    raise ValueError(f"unknown momentum_policy {policy!r}")


def schedule(p: SolverParameter, it: int) -> tuple[float, float]:
    """(lr, momentum) at iteration `it`."""
    return learning_rate(p, it), momentum(p, it)


def table(p: SolverParameter, it0: int, n: int):
    """The per-iteration scalars of iterations it0 .. it0 + n - 1 as one
    (n, 3) float32 array, a row (lr, momentum, t = iteration + 1): what a
    chunk of iterations uploads to the device at its start, so that an
    iteration (or its CUDA graph) reads its row there."""
    return np.array([(*schedule(p, it), it + 1)
                     for it in range(it0, it0 + n)], np.float32)
