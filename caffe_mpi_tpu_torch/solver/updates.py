"""Optimizer update rules: the six reference solvers, as functions of
tensors.

Reference: src/caffe/solvers/*.{cpp,cu} (e.g. sgd_reg_update_all_and_clear_
gpu, sgd_solver.cpp:194-252); JAX package caffe_mpi_tpu/solver/updates.py.
The JAX package never had a Pallas kernel for the update, so the port keeps
it plain torch. Each rule maps (param, grad, slots, hyper, lr_mult,
decay_mult) to (new param, new slots), in float32, with the reference's
order and epsilon clamps:

- regularization is folded into the gradient first: L2 adds
  local_decay*param, L1 adds local_decay*sign(param);
- per-param local_rate = global_rate * lr_mult, local_decay =
  weight_decay * decay_mult;
- Adam clamps eps to >= 1e-4 and corrects by sqrt(1-b2^t)/(1-b1^t)
  (adam_solver.cpp:42-46); AdaDelta clamps eps to >= 1e-3
  (adadelta_solver.cpp:36).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

Slots = tuple[torch.Tensor, ...]


class Hyper(NamedTuple):
    """Per-step scalars."""
    rate: float           # global learning rate this step
    momentum: float       # momentum / beta1 / adadelta decay
    momentum2: float      # adam beta2
    delta: float          # epsilon
    weight_decay: float
    reg_l1: bool          # regularization_type == "L1"
    t: int                # iteration + 1 (adam bias correction)


def n_slots(solver_type: str) -> int:
    return {"SGD": 1, "Nesterov": 1, "AdaGrad": 1, "RMSProp": 1,
            "AdaDelta": 2, "Adam": 2}[solver_type]


def _regularize(g, w, h: Hyper, decay_mult: float):
    local_decay = h.weight_decay * decay_mult
    if h.reg_l1:
        return g + local_decay * torch.sign(w)
    return g + local_decay * w


def sgd(w, g, slots: Slots, h: Hyper, lr_mult: float, decay_mult: float):
    """history = local_rate*g + momentum*history; w -= history
    (sgd_solver.cpp ComputeUpdateValue)."""
    (hist,) = slots
    g = _regularize(g, w, h, decay_mult)
    hist = h.rate * lr_mult * g + h.momentum * hist
    return w - hist, (hist,)


def nesterov(w, g, slots: Slots, h: Hyper, lr_mult: float,
             decay_mult: float):
    """update = (1+momentum)*new_hist - momentum*old_hist
    (nesterov_solver.cpp)."""
    (hist,) = slots
    g = _regularize(g, w, h, decay_mult)
    new_hist = h.rate * lr_mult * g + h.momentum * hist
    update = (1.0 + h.momentum) * new_hist - h.momentum * hist
    return w - update, (new_hist,)


def adagrad(w, g, slots: Slots, h: Hyper, lr_mult: float,
            decay_mult: float):
    (hist,) = slots
    g = _regularize(g, w, h, decay_mult)
    hist = hist + torch.square(g)
    update = h.rate * lr_mult * g / (torch.sqrt(hist) + h.delta)
    return w - update, (hist,)


def rmsprop(w, g, slots: Slots, h: Hyper, lr_mult: float, decay_mult: float,
            rms_decay: float = 0.99):
    (hist,) = slots
    g = _regularize(g, w, h, decay_mult)
    hist = rms_decay * hist + (1.0 - rms_decay) * torch.square(g)
    update = h.rate * lr_mult * g / (torch.sqrt(hist) + h.delta)
    return w - update, (hist,)


def adadelta(w, g, slots: Slots, h: Hyper, lr_mult: float,
             decay_mult: float):
    g_hist, u_hist = slots
    g = _regularize(g, w, h, decay_mult)
    delta = max(h.delta, 1e-3)
    g_hist = h.momentum * g_hist + (1.0 - h.momentum) * torch.square(g)
    update = g * torch.sqrt((delta + u_hist) / (delta + g_hist))
    u_hist = h.momentum * u_hist + (1.0 - h.momentum) * torch.square(update)
    return w - h.rate * lr_mult * update, (g_hist, u_hist)


def adam(w, g, slots: Slots, h: Hyper, lr_mult: float, decay_mult: float):
    m, v = slots
    g = _regularize(g, w, h, decay_mult)
    beta1, beta2 = h.momentum, h.momentum2
    eps_hat = max(h.delta, 1e-4)
    m = beta1 * m + (1.0 - beta1) * g
    v = beta2 * v + (1.0 - beta2) * torch.square(g)
    correction = math.sqrt(1.0 - beta2 ** h.t) / (1.0 - beta1 ** h.t)
    update = h.rate * lr_mult * correction * m / (torch.sqrt(v) + eps_hat)
    return w - update, (m, v)


UPDATE_FNS = {
    "SGD": sgd,
    "Nesterov": nesterov,
    "AdaGrad": adagrad,
    "RMSProp": rmsprop,
    "AdaDelta": adadelta,
    "Adam": adam,
}
