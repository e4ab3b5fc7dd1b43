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
import/export in each layer's `caffe_blobs` order, state blobs (BatchNorm's
running mean and variance) and the correction scalar included.

In TRAIN phase the net sums its loss as the reference does: every top with
a nonzero loss weight (the prototxt's `loss_weight`, else the layer's
default: 1 for a loss layer's first top) adds weight x sum(top). A
bottom whose `propagate_down` is false is detached. Dropout draws its mask
from the generator `forward` is given. Parameters are `nn.Parameter`s
that the solver switches to `requires_grad` for training; autograd does
the backward.
"""

from __future__ import annotations

import logging

import numpy as np
import torch
from torch import nn

from . import layers  # noqa: F401 — registers the layer types
from .core.device import resolve_device
from .core.types import DtypePolicy
from .layers.base import Layer, create_layer
from .layers.data_layers import InputLayerBase
from .proto.config import NetParameter, NetState
from .proto.netshape import BF16_INELIGIBLE
from .proto.upgrade import filter_net, normalize_net

log = logging.getLogger("caffe_mpi_tpu_torch.net")


class Net(nn.Module):
    """Build from a NetParameter on `device` (default: the card)."""

    def __init__(self, param: NetParameter, phase: str = "TEST", *,
                 device: str | torch.device = "cuda", level: int = 0,
                 stages: tuple[str, ...] = (), model_dir: str = "",
                 data_shape_probe=None, solver_storage: str = "FLOAT",
                 precision: str = ""):
        """model_dir: the base of the Data layers' sources and mean files.
        data_shape_probe(lp) -> (C, H, W) binds a Data layer's record
        shape before its setup (default: open its dataset once,
        data/feeder.py); a probe shape without a raw record shape keeps
        that layer's transform on the host.
        solver_storage: the solver's `solver_data_type`, the storage type
        of the learnable params (the master weights): FLOAT (float32),
        FLOAT16 (bfloat16 storage; the solver updates in float32 and
        casts back) or DOUBLE (float32); integer types are refused.
        precision: the solver's `precision`. "" or "f32" keeps the
        prototxt's types; "bf16" makes FLOAT16 the net-level default
        forward and backward type where the prototxt sets none, and a
        layer's own forward_type/backward_type still wins (the JAX
        `Net`'s rules, caffe_mpi_tpu/net.py)."""
        super().__init__()
        self.device = resolve_device(device)
        self.model_dir = model_dir
        param = normalize_net(param)
        state = NetState(phase=phase, level=level, stage=list(stages))
        param = filter_net(param, state)
        self.param = param
        self.phase = phase
        self.name = param.name

        layers: list[Layer] = []
        self._layer_index: dict[str, Layer] = {}
        self.blob_shapes: dict[str, tuple] = {}
        self.feed_blobs: list[str] = []  # blob names fed by the caller
        # feed key -> (shape, kind), in feed order (InputLayerBase)
        self.feed_specs: dict[str, tuple[tuple, str]] = {}
        # param sharing: ParamSpec.name -> (owner layer, param name)
        self._shared_owner: dict[str, tuple[str, str]] = {}
        self.param_aliases: dict[tuple[str, str], tuple[str, str]] = {}
        # (blob, loss weight) for every top that adds to the loss
        self.loss_blobs: list[tuple[str, float]] = []

        if solver_storage not in ("", "FLOAT", "FLOAT16", "DOUBLE"):
            raise ValueError(
                f"unsupported solver_data_type {solver_storage!r}: learnable "
                "params must be floating point (FLOAT, FLOAT16, or DOUBLE)")
        solver_storage = solver_storage or "FLOAT"
        if precision not in ("", "f32", "bf16"):
            raise ValueError(f"unknown precision {precision!r} "
                             "(expected 'f32' or 'bf16')")
        net_fwd = param.default_forward_type
        net_bwd = param.default_backward_type
        if precision == "bf16":
            if not param.has("default_forward_type"):
                net_fwd = "FLOAT16"
            if not param.has("default_backward_type"):
                net_bwd = "FLOAT16"
            if "FLOAT16" not in (net_fwd, net_bwd):
                log.warning(
                    "precision: bf16 requested, but the net prototxt "
                    "explicitly sets default_forward_type/"
                    "default_backward_type (%s/%s) and the prototxt "
                    "wins: bf16 did not engage net-wide (per-layer "
                    "forward_type overrides may still apply)",
                    net_fwd, net_bwd)

        for lp in param.layer:
            policy = DtypePolicy.resolve(
                lp.forward_type, lp.backward_type, net_fwd, net_bwd,
                solver_storage,
                lp.forward_math, param.default_forward_math,
                lp.backward_math, param.default_backward_math,
            )
            if policy.forward == torch.bfloat16 \
                    and lp.type in BF16_INELIGIBLE:
                log.warning(
                    "layer %s (%s): FLOAT16 compute requested but the "
                    "layer is bf16-ineligible (host callback / IO, "
                    "proto/netshape.py BF16_INELIGIBLE); it will compute "
                    "in f32. Pin `forward_type: FLOAT` to silence.",
                    lp.name, lp.type)
            layer = create_layer(lp, policy, phase, self.device)
            if lp.type == "Data":
                # the JAX Net's probe binding (caffe_mpi_tpu/net.py:155-167)
                if data_shape_probe is None:
                    from .data.feeder import data_shape_probe as probe
                    layer.bound_shape = probe(lp, model_dir)
                else:
                    layer.bound_shape = data_shape_probe(lp)
                layer.model_dir = model_dir
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
                for key, shape, kind in layer.feed_specs():
                    self.feed_specs[key] = (tuple(shape), kind)
            # loss weights (reference layer.hpp SetLossWeights)
            for ti, t in enumerate(lp.top):
                w = (lp.loss_weight[ti] if ti < len(lp.loss_weight)
                     else layer.default_loss_weight(ti))
                if w:
                    self.loss_blobs.append((t, float(w)))
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

    def forward(self, feeds: dict[str, torch.Tensor], *,
                generator: torch.Generator | None = None,
                dropout_masks: dict[str, torch.Tensor] | None = None
                ) -> tuple[dict[str, torch.Tensor], torch.Tensor]:
        """Run the graph (reference Net::Forward). Returns (every named
        blob, the loss: sum of weight x sum(top) over the loss tops, a
        float32 scalar). `generator` feeds Dropout's draws in TRAIN phase;
        `dropout_masks` {layer name: bool mask} replaces a layer's draw."""
        env: dict[str, torch.Tensor] = {}
        masks = dropout_masks or {}
        for layer in self.layers:
            if isinstance(layer, InputLayerBase):
                bottoms = layer.gather_feeds(feeds)
            else:
                bottoms = [env[b] for b in layer.lp.bottom]
                # per-bottom gradient blocking (LayerParameter.
                # propagate_down; reference net.cpp backward-need analysis)
                pd = layer.lp.propagate_down
                bottoms = [b.detach() if i < len(pd) and not pd[i] else b
                           for i, b in enumerate(bottoms)]
            if layer.needs_rng:
                tops = layer(bottoms, generator=generator,
                             mask=masks.get(layer.name))
            else:
                tops = layer(bottoms)
            for t, v in zip(layer.lp.top, tops):
                env[t] = v
        loss = torch.zeros((), dtype=torch.float32, device=self.device)
        for blob, w in self.loss_blobs:
            loss = loss + w * env[blob].float().sum()
        return env, loss

    def math_precision(self) -> str:
        """The one `DtypePolicy.precision` every layer of the net shares.
        The backward runs under one TF32 setting, so a net whose layers
        ask for different ones is refused."""
        kinds = {layer.policy.precision for layer in self.layers}
        if len(kinds) != 1:
            raise NotImplementedError(
                f"net {self.name!r} mixes math precisions {sorted(kinds)} "
                "across layers; the port's backward runs under one TF32 "
                "setting")
        return kinds.pop()

    # -- introspection (pycaffe parity helpers) -------------------------
    def learnable_param_decls(self):
        """Yield (layer_name, param_name, decl) for each OWNED param, in
        declaration order — the analogue of Net::learnable_params()."""
        for layer in self.layers:
            for pname, decl in layer.decls.items():
                if (layer.name, pname) in self.param_aliases:
                    continue
                yield layer.name, pname, decl

    def state_buffers(self):
        """Yield (layer_name, state name, buffer) for every state blob, in
        declaration order: the layers' running statistics, which test nets
        and serving buckets share with the net that updates them."""
        for layer in self.layers:
            for sname in layer.state_shapes:
                yield layer.name, sname, getattr(layer, sname)

    # -- .caffemodel interop (reference net.cpp:1055-1248) ----------------
    @torch.no_grad()
    def export_weights(self) -> dict[str, list[np.ndarray]]:
        """{layer_name: positional float32 blob list} in the reference's
        blobs_ order (Net::ToProto): params, state blobs, and a [1.0]
        correction scalar where the layer has one."""
        out: dict[str, list[np.ndarray]] = {}
        for layer in self.layers:
            blobs = [np.ones((1,), np.float32) if kind == "correction"
                     else getattr(layer, name).detach().float().cpu().numpy()
                     for kind, name in layer.caffe_blobs()]
            if blobs:
                out[layer.name] = blobs
        return out

    @torch.no_grad()
    def import_weights(self, weights: dict[str, list],
                       strict: bool = False) -> None:
        """Load by layer-name matching (Net::CopyTrainedLayersFrom:
        unmatched layers keep their initialization unless strict). As the
        JAX `Net.import_weights`: a state blob is multiplied by 1/c, c the
        layer's correction blob (BVLC stores the statistics scaled by it;
        c = 0 zeroes them), and a layer given fewer blobs than it has
        (a 3-blob BatchNorm into one with scale_bias) takes the leading
        ones."""
        matched = set()
        for layer in self.layers:
            blobs = weights.get(layer.name)
            if blobs is None:
                continue
            matched.add(layer.name)
            spec = layer.caffe_blobs()[: len(blobs)]
            factor = 1.0
            for (kind, _), blob in zip(spec, blobs):
                if kind == "correction":
                    c = float(np.asarray(blob).reshape(-1)[0])
                    factor = 0.0 if c == 0.0 else 1.0 / c
            for (kind, name), blob in zip(spec, blobs):
                if kind == "correction":
                    continue
                blob = np.asarray(blob, np.float32)
                cur = getattr(layer, name)
                if tuple(cur.shape) != blob.shape:
                    if blob.size != cur.numel():
                        raise ValueError(
                            f"layer {layer.name!r} blob {name!r}: shape "
                            f"{blob.shape} incompatible with {tuple(cur.shape)}")
                    blob = blob.reshape(tuple(cur.shape))
                if kind == "state":
                    blob = blob * np.float32(factor)
                cur.copy_(torch.from_numpy(np.ascontiguousarray(blob)))
        if strict:
            missing = {l.name for l in self.layers if l.decls} - matched
            if missing:
                raise ValueError(f"no weights for layers: {sorted(missing)}")
