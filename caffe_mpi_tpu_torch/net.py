"""Net — graph runtime, as an `nn.Module`.

Reference: src/caffe/net.cpp; JAX package caffe_mpi_tpu/net.py, which
compiles the graph into one pure function. The port runs it eagerly: layers
are built in declaration order from a normalized, phase-filtered
NetParameter and kept in an `nn.ModuleList`; `forward(feeds)` walks them
over a blob environment. What stays faithful to the reference: layer
declaration order IS execution order, in-place tops (a top that reuses its
bottom's name rebinds the environment entry; nothing is overwritten in
memory), param sharing by ParamSpec.name (the sharing layers hold the same
`nn.Parameter`), phase filtering, per-layer dtype policy, and .caffemodel
import/export in each layer's `caffe_blobs` order.

The port runs nets in TEST phase only so far: no loss, no backward.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from . import layers  # noqa: F401 — registers the layer types
from .core.device import resolve_device
from .core.types import DtypePolicy
from .layers.base import Layer, create_layer
from .layers.data_layers import InputLayerBase
from .proto.config import NetParameter, NetState
from .proto.upgrade import filter_net, normalize_net


class Net(nn.Module):
    """Build from a NetParameter on `device` (default: the card)."""

    def __init__(self, param: NetParameter, phase: str = "TEST", *,
                 device: str | torch.device = "cuda"):
        super().__init__()
        self.device = resolve_device(device)
        param = normalize_net(param)
        state = NetState(phase=phase)
        param = filter_net(param, state)
        self.param = param
        self.phase = phase
        self.name = param.name

        layers: list[Layer] = []
        self._layer_index: dict[str, Layer] = {}
        self.blob_shapes: dict[str, tuple] = {}
        self.feed_blobs: list[str] = []  # blob names fed by the caller
        # param sharing: ParamSpec.name -> (owner layer, param name)
        self._shared_owner: dict[str, tuple[str, str]] = {}
        self.param_aliases: dict[tuple[str, str], tuple[str, str]] = {}

        for lp in param.layer:
            policy = DtypePolicy.resolve(
                lp.forward_type, lp.backward_type,
                param.default_forward_type, param.default_backward_type,
                "FLOAT",
                lp.forward_math, param.default_forward_math,
                lp.backward_math, param.default_backward_math,
            )
            layer = create_layer(lp, policy, phase, self.device)
            in_shapes = []
            for b in lp.bottom:
                if b not in self.blob_shapes:
                    raise ValueError(
                        f"layer {lp.name!r}: unknown bottom blob {b!r} "
                        "(layers execute in declaration order)"
                    )
                in_shapes.append(self.blob_shapes[b])
            layer.in_shapes = in_shapes
            out_shapes = layer.setup(in_shapes)
            layer.out_shapes = out_shapes
            if len(out_shapes) != len(lp.top):
                raise ValueError(
                    f"layer {lp.name!r}: produces {len(out_shapes)} tops, "
                    f"prototxt names {len(lp.top)}"
                )
            for t, s in zip(lp.top, out_shapes):
                if t in self.blob_shapes and t not in lp.bottom:
                    raise ValueError(f"duplicate top blob {t!r} (layer {lp.name!r})")
                self.blob_shapes[t] = tuple(s)
            if isinstance(layer, InputLayerBase):
                self.feed_blobs.extend(lp.top)
            self._share_params(layer)
            layers.append(layer)
            self._layer_index.setdefault(layer.name, layer)

        if len(self.feed_blobs) != len(set(self.feed_blobs)):
            raise ValueError("duplicate feed blob names")
        self.layers = nn.ModuleList(layers)
        self.train(phase == "TRAIN")

    def _share_params(self, layer: Layer) -> None:
        """Net::AppendParam sharing: a param whose ParamSpec names an
        already-declared param becomes that very `nn.Parameter`."""
        for pname, decl in layer.decls.items():
            if not decl.shared_name:
                continue
            owner = self._shared_owner.get(decl.shared_name)
            if owner is None:
                self._shared_owner[decl.shared_name] = (layer.name, pname)
                continue
            src = getattr(self._layer_index[owner[0]], owner[1])
            if tuple(src.shape) != decl.shape:
                raise ValueError(
                    f"shared param {decl.shared_name!r}: shape mismatch "
                    f"{decl.shape} vs {tuple(src.shape)}")
            setattr(layer, pname, src)
            self.param_aliases[(layer.name, pname)] = owner

    def layer_by_name(self, name: str) -> Layer:
        try:
            return self._layer_index[name]
        except KeyError:
            raise KeyError(f"net {self.name!r} has no layer {name!r}") from None

    # ------------------------------------------------------------------
    @torch.no_grad()
    def init(self, seed: int = 0) -> None:
        """Fill every owned param from one `torch.Generator(seed)`, layer
        by layer in declaration order. Shared params are filled once, by
        their owner."""
        gen = torch.Generator().manual_seed(int(seed))
        for layer in self.layers:
            skip = {p for p in layer.decls
                    if (layer.name, p) in self.param_aliases}
            layer.init_params(gen, skip)

    def forward(self, feeds: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """Run the graph (reference Net::Forward). Returns every named blob."""
        env: dict[str, torch.Tensor] = {}
        for layer in self.layers:
            if isinstance(layer, InputLayerBase):
                bottoms = layer.gather_feeds(feeds)
            else:
                bottoms = [env[b] for b in layer.lp.bottom]
            for t, v in zip(layer.lp.top, layer(bottoms)):
                env[t] = v
        return env

    # -- introspection (pycaffe parity helpers) -------------------------
    def learnable_param_decls(self):
        """Yield (layer_name, param_name, decl) for each OWNED param, in
        declaration order — the analogue of Net::learnable_params()."""
        for layer in self.layers:
            for pname, decl in layer.decls.items():
                if (layer.name, pname) in self.param_aliases:
                    continue
                yield layer.name, pname, decl

    # -- .caffemodel interop (reference net.cpp:1055-1248) ----------------
    @torch.no_grad()
    def export_weights(self) -> dict[str, list[np.ndarray]]:
        """{layer_name: positional float32 blob list} in the reference's
        blobs_ order (Net::ToProto)."""
        out: dict[str, list[np.ndarray]] = {}
        for layer in self.layers:
            blobs = [getattr(layer, pname).detach().float().cpu().numpy()
                     for kind, pname in layer.caffe_blobs() if kind == "param"]
            if blobs:
                out[layer.name] = blobs
        return out

    @torch.no_grad()
    def import_weights(self, weights: dict[str, list],
                       strict: bool = False) -> None:
        """Load by layer-name matching (Net::CopyTrainedLayersFrom:
        unmatched layers keep their initialization unless strict)."""
        matched = set()
        for layer in self.layers:
            blobs = weights.get(layer.name)
            if blobs is None:
                continue
            matched.add(layer.name)
            for (kind, pname), blob in zip(layer.caffe_blobs(), blobs):
                blob = np.asarray(blob, np.float32)
                cur = getattr(layer, pname)
                if tuple(cur.shape) != blob.shape:
                    if blob.size != cur.numel():
                        raise ValueError(
                            f"layer {layer.name!r} blob {pname!r}: shape "
                            f"{blob.shape} incompatible with {tuple(cur.shape)}")
                    blob = blob.reshape(tuple(cur.shape))
                cur.copy_(torch.from_numpy(np.ascontiguousarray(blob)))
        if strict:
            missing = {l.name for l in self.layers if l.decls} - matched
            if missing:
                raise ValueError(f"no weights for layers: {sorted(missing)}")
