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
bottom whose `propagate_down` is false is detached. A layer's use of a
param whose own ParamSpec has `lr_mult: 0` is detached in TRAIN (the JAX
Net's stop_gradient), so a shared param frozen in one layer and trained
in another takes gradient from the trained use only. Dropout draws its mask
from the generator `forward` is given. Parameters are `nn.Parameter`s
that the solver switches to `requires_grad` for training; autograd does
the backward.

`forward_range(feeds, env, lo, hi)` runs layers [lo, hi) on a blob
environment that earlier layers produced (the JAX `Net.apply_range`):
`forward` is its full range, and a GPipe stage (parallel/gpipe.py) is
one range of it; a range sums the loss tops produced in it.

A layer with `remat: true` is rematerialised in TRAIN, as the JAX `Net`
runs it under `jax.checkpoint`: its forward runs through
`torch.utils.checkpoint` (non-reentrant), which keeps only its inputs and
runs the forward again in the backward. Its random draws are made ahead
and handed in, and a recompute leaves the layer's state buffers as the
first forward left them, so the values are those of the run without it.
"""

from __future__ import annotations

import copy
import logging
from contextlib import contextmanager

import numpy as np
import torch
import torch.utils.checkpoint
from torch import nn

from . import layers  # noqa: F401 — registers the layer types
from .core.device import resolve_device
from .core.types import DtypePolicy, recomputing
from .layers.base import Layer, create_layer
from .layers.data_layers import InputLayerBase
from .parallel.mesh import gather_on_use
from .proto.config import NetParameter, NetState
from .proto.netshape import BF16_INELIGIBLE
from .proto.upgrade import filter_net, normalize_net

log = logging.getLogger("caffe_mpi_tpu_torch.net")


@contextmanager
def reading(entries):
    """Each (dict, name, tensor) of `entries` in place of a module's own
    param or buffer for the block, restored after. The module's own
    dicts are swapped, so a Pipeline's stacked "inner.param" names swap
    like any other (`torch.func.functional_call` resolves a dotted name
    as a submodule path)."""
    saved = [(d, name, d[name]) for d, name, _ in entries]
    try:
        for d, name, t in entries:
            d[name] = t
        yield
    finally:
        for d, name, t in saved:
            d[name] = t


class IndivisibleBatch(ValueError):
    """A global batch that does not divide into the data-parallel ranks."""


class Net(nn.Module):
    """Build from a NetParameter on `device` (default: the card)."""

    def __init__(self, param: NetParameter, phase: str = "TEST", *,
                 device: str | torch.device = "cuda", level: int = 0,
                 stages: tuple[str, ...] = (), model_dir: str = "",
                 data_shape_probe=None, solver_storage: str = "FLOAT",
                 precision: str = "", batch_divisor: int = 1):
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
        `Net`'s rules, caffe_mpi_tpu/net.py).
        batch_divisor: the data-parallel ranks; the prototxt batch is
        global and each rank's net takes its share (reference
        divide_batch_size, parallel.cpp:295-348; the JAX `Net`'s
        `_divide_batch`): Input dims and the batch_size of Data,
        ImageData and WindowData. An indivisible batch raises."""
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
        self._loss_at: list[int] = []  # the layer index adding each one
        # the placement of the params over the mesh (`place`), or None,
        # and each split param's spec, by (layer, param) (aliases too)
        self.placement = None
        self.specs: dict[tuple[str, str], tuple] = {}

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
            if batch_divisor > 1 and lp.type in ("Data", "ImageData",
                                                 "Input", "WindowData"):
                # the NetParameter is shared with the test nets and the
                # caller: divide a copy
                lp = copy.deepcopy(lp)
                self._divide_batch(lp, batch_divisor)
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
            layer.model_dir = model_dir
            if lp.type == "Data":
                # the JAX Net's probe binding (caffe_mpi_tpu/net.py:155-167)
                if data_shape_probe is None:
                    from .data.feeder import data_shape_probe as probe
                    layer.bound_shape = probe(lp, model_dir)
                else:
                    layer.bound_shape = data_shape_probe(lp)
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
                    # lint: ok(host-sync) — a prototxt loss weight
                    self.loss_blobs.append((t, float(w)))
                    self._loss_at.append(len(layers))
            self._share_params(layer)
            layers.append(layer)
            self._layer_index.setdefault(layer.name, layer)

        if len(self.feed_blobs) != len(set(self.feed_blobs)):
            raise ValueError("duplicate feed blob names")
        # each layer's params whose own lr_mult is 0 (its frozen uses)
        self._frozen_uses = [tuple(p for p, d in layer.decls.items()
                                   if d.lr_mult == 0.0) for layer in layers]
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

    def _divide_batch(self, lp, divisor: int) -> None:
        """Divide a layer's global batch by `divisor` (the JAX `Net`'s
        `_divide_batch`). WindowData is divided too: its feeder stripes
        windows by rank, as the Data layers' do."""
        if lp.type == "Input":
            if lp.input_param:
                for shape in lp.input_param.shape:
                    if shape.dim:
                        b = shape.dim[0]
                        if b % divisor:
                            self._reject_indivisible(lp, b, divisor)
                        shape.dim[0] = max(1, b // divisor)
            return
        p = {"Data": lp.data_param, "ImageData": lp.image_data_param,
             "WindowData": lp.window_data_param}[lp.type]
        if p and p.batch_size:
            if p.batch_size % divisor:
                self._reject_indivisible(lp, p.batch_size, divisor)
            p.batch_size = max(1, p.batch_size // divisor)

    @staticmethod
    def _reject_indivisible(lp, batch: int, divisor: int):
        micro = (batch + divisor - 1) // divisor
        raise IndivisibleBatch(
            f"layer {lp.name!r}: global batch {batch} is not divisible by "
            f"{divisor} (micro-batches x replicas); rounding up would "
            f"train at an effective global batch of {micro * divisor}, "
            f"not the configured {batch}. Use a divisible batch_size or "
            f"another rank count.")

    def bind_mesh(self, mesh_plan) -> None:
        """Hand every layer the rank's MeshPlan (the reference's
        solver_count/rank that layers consult). BatchNorm, the losses and
        Accuracy then compute global-batch results across the data ranks,
        MoE routes over the global batch, Attention with
        `sequence_parallel` runs the ring over the model ranks, and the
        layers `place` splits run model-parallel; other layers ignore
        it."""
        for layer in self.layers:
            layer.mesh_plan = mesh_plan

    @torch.no_grad()
    def place(self, placement) -> None:
        """Split the params a `mesh.Placement` names over the mesh's axes:
        each such param becomes this rank's shard of it (a new
        `nn.Parameter`) and `specs` records its spec. A layer whose
        model-parallel forward takes those shards (`accepts_shards`: one
        dim each, over 'model') runs it (`shards` says which dim); any
        other gathers the whole params before its forward (`gathered`,
        `mesh.gather_on_use`). After `bind_mesh` and `init` (the full
        arrays are drawn first, so a split run starts from the
        one-process run's values). A layer that shares a param by name
        holds its owner's shard, split as the owner's rule says."""
        self.placement = placement
        self.specs = {}
        for layer in self.layers:
            specs = {}
            for pname in layer.decls:
                owner = self.param_aliases.get((layer.name, pname))
                if owner is not None:
                    # the owner comes first in declaration order
                    spec = self.specs.get(owner)
                else:
                    spec = placement.spec(layer.name, pname,
                                          getattr(layer, pname).dim())
                if spec is not None:
                    specs[pname] = spec
            shards = {p: placement.model_dim(spec)
                      for p, spec in specs.items()}
            if None not in shards.values() and layer.accepts_shards(shards):
                layer.shards, layer.gathered = shards, {}
            else:
                layer.shards, layer.gathered = {}, specs
            for pname, spec in specs.items():
                self.specs[(layer.name, pname)] = spec
                owner = self.param_aliases.get((layer.name, pname))
                if owner is not None:
                    setattr(layer, pname,
                            getattr(self.layer_by_name(owner[0]), owner[1]))
                    continue
                p = getattr(layer, pname)
                try:
                    local = placement.local_spec(spec, p)
                except ValueError as e:
                    raise ValueError(f"{layer.name}.{pname}: {e}") from None
                setattr(layer, pname, nn.Parameter(
                    local.clone(), requires_grad=p.requires_grad))
        if not self.specs:  # every rule placed whole: nothing is split
            self.placement = None

    def owner_of(self, lname: str, pname: str) -> tuple[str, str]:
        """The (layer, param) that owns a param: itself, or the first
        layer that declared a param it shares by name."""
        return self.param_aliases.get((lname, pname), (lname, pname))

    def sharded(self, lname: str, pname: str) -> bool:
        """Whether this rank holds a shard of the param (`place`)."""
        return (lname, pname) in self.specs

    def spec_of(self, lname: str, pname: str):
        """The param's placement spec (`place`), None when whole."""
        return self.specs.get((lname, pname))

    def gather_param(self, lname: str, pname: str, t: torch.Tensor
                     ) -> torch.Tensor:
        """The whole array of a param (or of a slot aligned with it) of
        which `t` is this rank's shard (a collective over the axes that
        split it); `t` itself when the param is whole."""
        spec = self.specs.get((lname, pname))
        return t if spec is None else self.placement.gather_spec(
            spec, t.detach())

    def local_param(self, lname: str, pname: str, t: torch.Tensor
                    ) -> torch.Tensor:
        """This rank's shard of the whole array `t` of a param."""
        spec = self.specs.get((lname, pname))
        return t if spec is None else self.placement.local_spec(spec, t)

    def full_shape(self, lname: str, pname: str, shape) -> tuple:
        """The whole shape of a param of which `shape` is the shard."""
        spec = self.specs.get((lname, pname))
        return tuple(shape) if spec is None else \
            self.placement.full_shape(spec, shape)

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
        return self.forward_range(feeds, {}, 0, len(self.layers),
                                  generator=generator,
                                  dropout_masks=dropout_masks)

    def forward_range(self, feeds: dict[str, torch.Tensor],
                      env: dict[str, torch.Tensor], lo: int, hi: int, *,
                      generator: torch.Generator | None = None,
                      dropout_masks: dict[str, torch.Tensor] | None = None,
                      params: dict[str, dict[str, torch.Tensor]] | None
                      = None, device: torch.device | None = None
                      ) -> tuple[dict[str, torch.Tensor], torch.Tensor]:
        """Run layers [lo, hi): the pipeline stage's primitive (the JAX
        `Net.apply_range`); `forward` is its full range, so a stage and
        the whole net share one code path. `env` seeds the blobs that
        earlier layers produced; `feeds` serves the input layers in the
        range. Returns (env with this range's tops, the loss of the loss
        tops produced in the range, a float32 scalar on `device`, default
        the net's). Dropout masks are keyed by layer name, so a partition
        cannot change a draw. `params` {layer: {param: tensor}} replaces
        those layers' params for this call (a stage's copy of a param its
        owner keeps on another device)."""
        env = dict(env)
        masks = dropout_masks or {}
        params = params or {}
        for i in range(lo, hi):
            layer, frozen = self.layers[i], self._frozen_uses[i]
            if isinstance(layer, InputLayerBase):
                bottoms = layer.gather_feeds(feeds)
            else:
                bottoms = [env[b] for b in layer.lp.bottom]
                # per-bottom gradient blocking (LayerParameter.
                # propagate_down; reference net.cpp backward-need analysis)
                pd = layer.lp.propagate_down
                bottoms = [b.detach() if i < len(pd) and not pd[i] else b
                           for i, b in enumerate(bottoms)]
            kw = {}
            remat = self.training and layer.lp.remat
            if layer.needs_rng:
                mask = masks.get(layer.name)
                if remat and mask is None and generator is not None:
                    # the recompute must read the forward's draw
                    mask = layer.draw_mask(generator)
                kw = dict(generator=generator, mask=mask)
            given = params.get(layer.name, {})
            frozen = [p for p in frozen
                      if self.training and getattr(layer, p).requires_grad]

            def call(*bs, layer=layer, given=given, frozen=frozen, kw=kw):
                swap = dict(given)
                for p, spec in layer.gathered.items():
                    # a shard with no model-parallel forward: the whole
                    # param, gathered here (again in a recompute)
                    if p not in swap:
                        swap[p] = gather_on_use(getattr(layer, p),
                                                self.placement, spec)
                for p in frozen:
                    # a frozen use of a param that another use trains:
                    # the forward reads it detached (JAX: stop_gradient)
                    swap[p] = swap.get(p, getattr(layer, p)).detach()
                with reading([(layer._parameters, p, t)
                              for p, t in swap.items()]):
                    return layer(list(bs), **kw)

            tops = _rematerialised(layer, call, bottoms) if remat \
                else call(*bottoms)
            for t, v in zip(layer.lp.top, tops):
                env[t] = v
        loss = torch.zeros((), dtype=torch.float32,
                           device=device or self.device)
        for (blob, w), at in zip(self.loss_blobs, self._loss_at):
            if lo <= at < hi:  # produced in this range
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
    def weight_tensors(self, full: bool = False) -> dict[str, list]:
        """{layer_name: the tensors of its blobs in the reference's blobs_
        order}, None for a correction scalar: what export_weights writes,
        as live tensors (a snapshot copies them before the next step).
        full: a param split over 'model' (`place`) is gathered whole (a
        collective: every model rank calls it, in the same order)."""
        out: dict[str, list] = {}
        for layer in self.layers:
            blobs = []
            for kind, name in layer.caffe_blobs():
                t = None if kind == "correction" else getattr(layer, name)
                if full and kind == "param":
                    t = self.gather_param(layer.name, name, t)
                blobs.append(t)
            if blobs:
                out[layer.name] = blobs
        return out

    @torch.no_grad()
    def export_weights(self, tensors: dict[str, list] | None = None
                       ) -> dict[str, list[np.ndarray]]:
        """{layer_name: positional float32 blob list} in the reference's
        blobs_ order (Net::ToProto): params, state blobs, and a [1.0]
        correction scalar where the layer has one. `tensors` (a copy of
        `weight_tensors()`) is written instead of the live tensors."""
        if tensors is None:
            tensors = self.weight_tensors()
        # lint: ok(host-sync) — the caller asked for the blobs as host arrays,
        # once a call
        return {name: [np.ones((1,), np.float32) if t is None
                       else t.detach().float().cpu().numpy() for t in blobs]
                for name, blobs in tensors.items()}

    @torch.no_grad()
    def import_weights(self, weights: dict[str, list],
                       strict: bool = False, into: dict | None = None
                       ) -> None:
        """Load by layer-name matching (Net::CopyTrainedLayersFrom:
        unmatched layers keep their initialization unless strict). As the
        JAX `Net.import_weights`: a state blob is multiplied by 1/c, c the
        layer's correction blob (BVLC stores the statistics scaled by it;
        c = 0 zeroes them), and a layer given fewer blobs than it has
        (a 3-blob BatchNorm into one with scale_bias) takes the leading
        ones. `into` {(layer name, blob attr): tensor} takes the values
        instead of the layers' own tensors (the serving plane's host
        copies; a shared param is keyed by its owner)."""
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
                    # lint: ok(host-sync) — weights being loaded: host arrays
                    c = float(np.asarray(blob).reshape(-1)[0])
                    factor = 0.0 if c == 0.0 else 1.0 / c
            for (kind, name), blob in zip(spec, blobs):
                if kind == "correction":
                    continue
                # lint: ok(host-sync) — weights being loaded: host arrays
                blob = np.asarray(blob, np.float32)
                if into is None:
                    cur = getattr(layer, name)
                    if self.sharded(layer.name, name):
                        # a whole array, of which this rank takes its shard
                        full = self.full_shape(layer.name, name, cur.shape)
                        # lint: ok(host-sync) — shape arithmetic on host ints
                        if blob.size == int(np.prod(full)):
                            blob = blob.reshape(full)
                        # lint: ok(host-sync) — a loaded host array's shard,
                        # once a load
                        blob = self.local_param(
                            layer.name, name, torch.from_numpy(
                                np.ascontiguousarray(blob))).numpy()
                else:
                    cur = into[self.owner_of(layer.name, name)]
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


def _rematerialised(layer: Layer, call, bottoms):
    """`call(*bottoms)` under a non-reentrant checkpoint. The recompute in
    the backward puts the layer's state buffers back as the forward left
    them (a TRAIN BatchNorm would otherwise update its running statistics
    twice), and runs under `recomputing()` (on the card it runs on
    autograd's device thread while the caller holds the TF32 lock). RNG
    state is not stashed: every draw is handed in."""
    runs = [0]

    def run(*bs):
        runs[0] += 1
        if runs[0] == 1:
            return call(*bs)
        with recomputing():
            if not layer.state_shapes:
                return call(*bs)
            saved = [getattr(layer, n).clone() for n in layer.state_shapes]
            tops = call(*bs)
        with torch.no_grad():
            for n, v in zip(layer.state_shapes, saved):
                getattr(layer, n).copy_(v)
        return tops

    return torch.utils.checkpoint.checkpoint(
        run, *bottoms, use_reentrant=False, preserve_rng_state=False)
