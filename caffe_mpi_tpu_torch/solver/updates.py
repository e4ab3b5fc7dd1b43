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
  (adam_solver.cpp:42-46), in float32 from t as the JAX rule does;
  AdaDelta clamps eps to >= 1e-3 (adadelta_solver.cpp:36).

The per-step scalars (rate, momentum, t) may be Python numbers or 0-d
float32 tensors on the params' device: the solver reads them from a
table on the device, so an iteration captured in a CUDA graph takes new
values at every replay. Products of them alone (rate x lr_mult, Adam's
bias correction, 1 - momentum) are then formed once a step, not once a
param: a Hyper with a `memo` dict keeps them (`_once`), in the order of
operations each rule writes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

Slots = tuple[torch.Tensor, ...]


class Hyper(NamedTuple):
    """Per-step scalars; rate, momentum and t: numbers or 0-d tensors."""
    rate: float | torch.Tensor      # global learning rate this step
    momentum: float | torch.Tensor  # momentum / beta1 / adadelta decay
    momentum2: float      # adam beta2
    delta: float          # epsilon
    weight_decay: float
    reg_l1: bool          # regularization_type == "L1"
    t: int | torch.Tensor  # iteration + 1 (adam bias correction)
    memo: dict | None = None  # the step's scalar products, formed once


def _once(h: Hyper, key, fn):
    """A product of the step's scalars: formed once a step into h.memo
    where h carries one, else each call."""
    if h.memo is None:
        return fn()
    if key not in h.memo:
        h.memo[key] = fn()
    return h.memo[key]


def _local_rate(h: Hyper, lr_mult: float):
    return _once(h, ("rate", lr_mult), lambda: h.rate * lr_mult)


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
    hist = _local_rate(h, lr_mult) * g + h.momentum * hist
    return w - hist, (hist,)


def nesterov(w, g, slots: Slots, h: Hyper, lr_mult: float,
             decay_mult: float):
    """update = (1+momentum)*new_hist - momentum*old_hist
    (nesterov_solver.cpp)."""
    (hist,) = slots
    g = _regularize(g, w, h, decay_mult)
    new_hist = _local_rate(h, lr_mult) * g + h.momentum * hist
    update = _once(h, "1+m", lambda: 1.0 + h.momentum) * new_hist \
        - h.momentum * hist
    return w - update, (new_hist,)


def adagrad(w, g, slots: Slots, h: Hyper, lr_mult: float,
            decay_mult: float):
    (hist,) = slots
    g = _regularize(g, w, h, decay_mult)
    hist = hist + torch.square(g)
    update = _local_rate(h, lr_mult) * g / (torch.sqrt(hist) + h.delta)
    return w - update, (hist,)


def rmsprop(w, g, slots: Slots, h: Hyper, lr_mult: float, decay_mult: float,
            rms_decay: float = 0.99):
    (hist,) = slots
    g = _regularize(g, w, h, decay_mult)
    hist = rms_decay * hist + (1.0 - rms_decay) * torch.square(g)
    update = _local_rate(h, lr_mult) * g / (torch.sqrt(hist) + h.delta)
    return w - update, (hist,)


def adadelta(w, g, slots: Slots, h: Hyper, lr_mult: float,
             decay_mult: float):
    g_hist, u_hist = slots
    g = _regularize(g, w, h, decay_mult)
    delta = max(h.delta, 1e-3)
    one_minus = _once(h, "1-m", lambda: 1.0 - h.momentum)
    g_hist = h.momentum * g_hist + one_minus * torch.square(g)
    update = g * torch.sqrt((delta + u_hist) / (delta + g_hist))
    u_hist = h.momentum * u_hist + one_minus * torch.square(update)
    return w - _local_rate(h, lr_mult) * update, (g_hist, u_hist)


def adam(w, g, slots: Slots, h: Hyper, lr_mult: float, decay_mult: float):
    m, v = slots
    g = _regularize(g, w, h, decay_mult)
    beta1, beta2 = h.momentum, h.momentum2
    eps_hat = max(h.delta, 1e-4)
    m = beta1 * m + _once(h, "1-m", lambda: 1.0 - beta1) * g
    v = beta2 * v + (1.0 - beta2) * torch.square(g)

    def step_size():
        tf = torch.as_tensor(h.t, dtype=torch.float32, device=w.device)
        b1 = torch.as_tensor(beta1, dtype=torch.float32, device=w.device)
        correction = torch.sqrt(1.0 - torch.pow(beta2, tf)) \
            / (1.0 - torch.pow(b1, tf))
        return h.rate * lr_mult * correction
    update = _once(h, ("adam", lr_mult), step_size) * m \
        / (torch.sqrt(v) + eps_hat)
    return w - update, (m, v)


UPDATE_FNS = {
    "SGD": sgd,
    "Nesterov": nesterov,
    "AdaGrad": adagrad,
    "RMSProp": rmsprop,
    "AdaDelta": adadelta,
    "Adam": adam,
}
