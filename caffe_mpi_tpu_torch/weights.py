"""Carry the JAX package's parameter trees (and its solver's history) into
the port's `Net` (and `Solver`).

The JAX `Net.init` returns `params[layer][name]` and `state[layer][name]`
trees (caffe_mpi_tpu/net.py:306-325). The port registers the same names in
the same layouts (params as `nn.Parameter`s, state as buffers), so
loading them is a checked copy: every array must name a param (or a state
buffer) the port's net declares, with the same shape, and every param the
port's net owns and every state buffer must be given. The JAX
`Solver.opt_state` tree, `opt_state[layer][name]` = a tuple of slot
arrays, loads into the port's solver history the same way. Arrays arrive as numpy (or anything
`np.asarray` takes); this module imports no JAX.

The JAX Pipeline's stacked params ("{inner}.{param}", shape (S, ...))
load as any other. A param the net holds split by a placement over the
mesh's axes (`Net.place`, any spec) takes the full array, of which the
rank keeps its shard by the placement's rule; its history slots the
same.
"""

from __future__ import annotations

import numpy as np
import torch

from .net import Net


def _copy_in(cur: torch.Tensor, arr, where: str) -> None:
    a = np.asarray(arr, np.float32)
    if a.shape != tuple(cur.shape):
        raise ValueError(f"{where}: shape {a.shape} != {tuple(cur.shape)}")
    cur.copy_(torch.from_numpy(np.array(a)))


def _local(net: Net, lname: str, pname: str, arr):
    """This rank's part of a full array: its shard where the net holds
    the param split by its placement, else the array."""
    if not net.sharded(lname, pname):
        return arr
    return net.local_param(lname, pname, torch.from_numpy(
        np.array(arr, np.float32))).numpy()


@torch.no_grad()
def load_jax_params(net: Net, params: dict, state: dict | None = None) -> None:
    given = set()
    for lname, blobs in params.items():
        layer = net.layer_by_name(lname)
        for pname, arr in blobs.items():
            if pname not in layer.decls:
                raise KeyError(f"layer {lname!r} has no param {pname!r} "
                               f"(declares {list(layer.decls)})")
            _copy_in(getattr(layer, pname), _local(net, lname, pname, arr),
                     f"{lname}.{pname}")
            given.add((lname, pname))
    missing = [(l, p) for l, p, _ in net.learnable_param_decls()
               if (l, p) not in given]
    if missing:
        raise KeyError(f"no array given for params {missing}")
    given = set()
    for lname, blobs in (state or {}).items():
        layer = net.layer_by_name(lname)
        for sname, arr in blobs.items():
            if sname not in layer.state_shapes:
                raise KeyError(f"layer {lname!r} has no state {sname!r} "
                               f"(declares {list(layer.state_shapes)})")
            _copy_in(getattr(layer, sname), arr, f"{lname}.{sname}")
            given.add((lname, sname))
    missing = [(l, s) for l, s, _ in net.state_buffers()
               if (l, s) not in given]
    if missing:
        raise KeyError(f"no array given for state {missing}")


@torch.no_grad()
def load_jax_opt_state(solver, opt_state: dict) -> None:
    """Copy the JAX `Solver`'s history slots into the port's `Solver`:
    every owned learnable param's slots must be given, as many as the
    solver type keeps, each of the param's shape."""
    given = set()
    for lname, blobs in opt_state.items():
        for pname, slots in blobs.items():
            key = (lname, pname)
            cur = solver.history.get(key)
            if cur is None:
                raise KeyError(f"solver has no history for {lname}.{pname}")
            if len(slots) != len(cur):
                raise ValueError(f"{lname}.{pname}: {len(slots)} slots given"
                                 f", the {solver.type} solver keeps "
                                 f"{len(cur)}")
            slots = [_local(solver.net, lname, pname, a) for a in slots]
            for arr, t in zip(slots, cur):
                # lint: ok(host-sync) — weights being loaded: host arrays
                a = np.asarray(arr, np.float32)
                if a.shape != tuple(t.shape):
                    raise ValueError(f"{lname}.{pname} slot: shape "
                                     f"{a.shape} != {tuple(t.shape)}")
            for arr, t in zip(slots, cur):
                # in place: a captured iteration holds these very tensors
                # lint: ok(host-sync) — weights being loaded: host arrays
                t.copy_(torch.from_numpy(np.array(arr, np.float32)))
            given.add(key)
    missing = sorted(set(solver.history) - given)
    if missing:
        raise KeyError(f"no history given for params {missing}")
