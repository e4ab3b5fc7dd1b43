"""Layer abstraction + registry — the reference's Layer class hierarchy and
LayerRegistry, as `nn.Module`s.

The reference's layers are stateful C++ objects dispatched through a factory
(include/caffe/layer.hpp:43-549, src/caffe/layer_factory.cpp); the JAX package
makes each a pure `apply(params, state, bottoms)` (caffe_mpi_tpu/layers/
base.py). Here a layer is an `nn.Module`: shape inference (`setup`) declares
its learnables, which are registered as `nn.Parameter`s under the JAX names
(`weight`, `bias`) and layouts, and `forward(bottoms) -> tops` runs it.
Non-learnable state (BatchNorm's running `mean` and `var`) is declared
with `declare_state` and registered as float32 buffers under the JAX
state names; a layer updates its buffers in place during a TRAIN forward,
so nets that hold the very same buffer tensors (test nets, serving
buckets) see each update.

Caffe's positional param blobs (blobs_[0]=weight, blobs_[1]=bias...) are kept
as an *ordered* dict of declarations so .caffemodel import/export can map by
position.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Sequence

import torch
from torch import nn

from ..core.fillers import fill
from ..core.types import DtypePolicy
from ..proto.config import FillerParameter, LayerParameter

Shape = tuple[int, ...]


@dataclass
class ParamDecl:
    """One learnable blob: shape + init + training multipliers.

    Mirrors the union of the reference's Blob allocation in each layer's
    LayerSetUp and the per-param ParamSpec (lr_mult/decay_mult) resolution
    in Net::AppendParam (net.cpp:501-667)."""
    shape: Shape
    filler: FillerParameter | None = None
    lr_mult: float = 1.0
    decay_mult: float = 1.0
    shared_name: str = ""  # non-empty -> net-level weight sharing by name
    dtype: Any = None  # defaults to policy.master


class Layer(nn.Module):
    """Base class. Subclasses set `type_name` and implement setup/forward."""

    type_name: str = ""
    # True for a layer whose forward takes `generator=` and `mask=`
    needs_rng: bool = False
    # True for a layer whose forward runs on the host (no CUDA graph)
    host_step: bool = False
    # the rank's MeshPlan (Net.bind_mesh), or None
    mesh_plan = None
    # {param name: the dim split over the mesh's 'model' axis}: the layer
    # holds this rank's shard of those params and runs its model-parallel
    # forward (Net.place)
    shards: dict = {}
    # {param name: placement spec}: the layer holds this rank's shard of
    # those params and its forward reads them whole, gathered on use
    # (Net.place, mesh.gather_on_use)
    gathered: dict = {}
    # the base of a layer's relative file paths (Net sets it before setup)
    model_dir: str = ""

    def __init__(self, lp: LayerParameter, policy: DtypePolicy,
                 phase: str = "TRAIN", device: torch.device | None = None):
        super().__init__()
        self.lp = lp
        self.policy = policy
        self.phase = phase
        self.device = torch.device(device or "cpu")
        self.decls: dict[str, ParamDecl] = {}
        self.state_shapes: dict[str, Shape] = {}
        self.in_shapes: list[Shape] = []
        self.out_shapes: list[Shape] = []

    # -- graph construction ------------------------------------------------
    def setup(self, in_shapes: list[Shape]) -> list[Shape]:
        """Infer output shapes and declare params. Must be overridden."""
        raise NotImplementedError

    def declare(self, name: str, shape: Shape, filler: FillerParameter | None = None,
                param_idx: int | None = None, **kw) -> None:
        """Declare a learnable param; applies the prototxt `param {}` specs
        positionally like Net::AppendParam does. The tensor is allocated
        (uninitialized) on the layer's device; `init_params` fills it."""
        idx = len(self.decls) if param_idx is None else param_idx
        decl = ParamDecl(shape=tuple(shape), filler=filler, **kw)
        if idx < len(self.lp.param):
            spec = self.lp.param[idx]
            decl.lr_mult = spec.lr_mult
            decl.decay_mult = spec.decay_mult
            decl.shared_name = spec.name
        self.decls[name] = decl
        dtype = decl.dtype if decl.dtype is not None else self.policy.master
        self.register_parameter(name, nn.Parameter(
            torch.empty(decl.shape, dtype=dtype, device=self.device),
            requires_grad=False))

    def declare_state(self, name: str, shape: Shape) -> None:
        """Declare a non-learnable float32 state blob, zero-initialised as
        the JAX layers' `init_state` returns it, registered as a buffer."""
        self.state_shapes[name] = tuple(shape)
        self.register_buffer(name, torch.zeros(
            tuple(shape), dtype=torch.float32, device=self.device))

    # -- initialization ----------------------------------------------------
    @torch.no_grad()
    def init_params(self, gen: torch.Generator, skip=()) -> None:
        """Fill every declared param not in `skip` from `gen` (drawn on the
        CPU, then copied to the layer's device), and zero the state."""
        for name, decl in self.decls.items():
            if name in skip:
                continue
            p = getattr(self, name)
            p.copy_(fill(decl.filler, gen, decl.shape, p.dtype))
        for name in self.state_shapes:
            getattr(self, name).zero_()

    # -- execution ---------------------------------------------------------
    def forward(self, bottoms: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        raise NotImplementedError

    def accepts_shards(self, shards: dict) -> bool:
        """Whether the layer's model-parallel forward runs with these
        params split over 'model' ({param: dim}); the layers that have
        one say which. Any other split is gathered on use (Net.place)."""
        return not shards

    def host_ranks(self):
        """The MeshPlan whose data ranks a host step spans (its bottoms
        all-gathered to the global batch, each rank keeping its rows of
        the tops: the JAX `jax.pure_callback` is handed the global
        batch), or None."""
        mp = self.mesh_plan
        return mp if mp is not None and mp.n_data > 1 else None

    def model_plan(self):
        """The MeshPlan when the layer holds shards over 'model', else
        None."""
        mp = self.mesh_plan
        return mp if self.shards and mp is not None and mp.n_model > 1 \
            else None

    # -- interop -----------------------------------------------------------
    def caffe_blobs(self) -> list[tuple[str, str]]:
        """Ordered (kind, name) pairs matching the reference layer's
        positional blobs_ vector — the .caffemodel contract. Kinds, as in
        the JAX package: "param" (a declared param), "state" (a state
        buffer) and "correction" (a synthesized scalar, name ""). Default:
        declared params in order (weight, bias for most layers)."""
        return [("param", n) for n in self.decls]

    # -- conveniences ------------------------------------------------------
    @property
    def name(self) -> str:
        return self.lp.name

    def f(self, x: torch.Tensor) -> torch.Tensor:
        """Cast to forward compute dtype."""
        return self.policy.cast_in(x)

    def is_loss(self) -> bool:
        return False

    def default_loss_weight(self, top_idx: int) -> float:
        """Weight of top `top_idx` in the net's loss when the prototxt
        gives no `loss_weight` (reference layer.hpp SetLossWeights)."""
        return 0.0


# ---------------------------------------------------------------------------
# Registry (reference: LayerRegistry::CreateLayer, layer_factory.cpp:53-88)
# ---------------------------------------------------------------------------

LAYER_REGISTRY: dict[str, type[Layer]] = {}


def register(type_name: str):
    def deco(cls: type[Layer]) -> type[Layer]:
        if type_name in LAYER_REGISTRY:
            raise ValueError(f"layer type {type_name!r} already registered")
        cls.type_name = type_name
        LAYER_REGISTRY[type_name] = cls
        return cls
    return deco


def create_layer(lp: LayerParameter, policy: DtypePolicy, phase: str,
                 device: torch.device | None = None) -> Layer:
    try:
        cls = LAYER_REGISTRY[lp.type]
    except KeyError:
        known = ", ".join(sorted(LAYER_REGISTRY))
        raise ValueError(
            f"unknown layer type {lp.type!r} (layer {lp.name!r}); known: {known}"
        ) from None
    return cls(lp, policy, phase, device)
