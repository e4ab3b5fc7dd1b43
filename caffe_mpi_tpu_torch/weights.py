"""Carry the JAX package's parameter trees into the port's `Net`.

The JAX `Net.init` returns `params[layer][name]` and `state[layer][name]`
trees (caffe_mpi_tpu/net.py:306-325). The port registers the same names in
the same layouts, so loading them is a checked copy: every array must name
a param the port's net declares, with the same shape, and every param the
port's net owns must be given. Arrays arrive as numpy (or anything
`np.asarray` takes); this module imports no JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from .net import Net


@torch.no_grad()
def load_jax_params(net: Net, params: dict, state: dict | None = None) -> None:
    if state and any(state.values()):
        raise ValueError(f"state for layers {sorted(state)}: the port's "
                         "ported layers keep no state")
    given = set()
    for lname, blobs in params.items():
        layer = net.layer_by_name(lname)
        for pname, arr in blobs.items():
            if pname not in layer.decls:
                raise KeyError(f"layer {lname!r} has no param {pname!r} "
                               f"(declares {list(layer.decls)})")
            a = np.asarray(arr, np.float32)
            cur = getattr(layer, pname)
            if a.shape != tuple(cur.shape):
                raise ValueError(f"{lname}.{pname}: shape {a.shape} != "
                                 f"{tuple(cur.shape)}")
            cur.copy_(torch.from_numpy(np.array(a)))
            given.add((lname, pname))
    missing = [(l, p) for l, p, _ in net.learnable_param_decls()
               if (l, p) not in given]
    if missing:
        raise KeyError(f"no array given for params {missing}")
