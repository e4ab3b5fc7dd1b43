"""The Pipeline layer: the prototxt surface of pipeline parallelism.

JAX package: caffe_mpi_tpu/layers/composite.py. The inner `layer {...}`
sub-graph of `pipeline_param` defines ONE block; the layer is
`num_stages` structurally identical copies of it chained head to tail,
each stage with its own weights. The params are stacked with a leading
stage dim under the names "{inner layer}.{param}", shape (S, ...). Under
a mesh whose 'model' axis equals num_stages the solver splits that dim
over the model ranks (each holds its one stage) and the layer runs
parallel/pipeline.py's schedule with the batch split into
`micro_batches`. On one device, or when the model axis is another size,
the stages run in sequence over the very same stacked params, as the
JAX `lax.scan` does.

The setup checks are the JAX layer's, with its messages: the block is
shape-preserving, takes one bottom, holds stateless layers only, has no
Dropout in TRAIN, no `sequence_parallel` attention and no shared params,
and the batch divides `micro_batches`. Each stage's params are drawn
from the block's fillers on the stage's own shape; the draws are the
port's own (weights carry across from the JAX package, weights.py).
"""

from __future__ import annotations

import logging

import torch

from ..core.fillers import fill
from ..parallel.pipeline import pipeline_apply
from .base import Layer, ParamDecl, Shape, create_layer, register

log = logging.getLogger("caffe_mpi_tpu_torch.layers")


@register("Pipeline")
class PipelineLayer(Layer):
    def register_parameter(self, name, param):
        # the stacked params are named "{inner}.{param}", which
        # nn.Module's own registration refuses
        if "." in name:
            self._parameters[name] = param
            return
        super().register_parameter(name, param)

    def setup(self, in_shapes: list[Shape]) -> list[Shape]:
        p = self.lp.pipeline_param
        if p is None or p.num_stages < 1 or not p.layer:
            raise ValueError(
                f"layer {self.name!r}: pipeline_param needs num_stages >= 1 "
                "and at least one inner layer")
        if len(self.lp.bottom) != 1:
            raise ValueError(
                f"layer {self.name!r}: Pipeline takes exactly one bottom")
        self.p = p
        self.n_stages = p.num_stages
        self.n_micro = max(p.micro_batches, 1)
        in_shape = tuple(in_shapes[0])
        if in_shape[0] % self.n_micro:
            raise ValueError(
                f"layer {self.name!r}: batch {in_shape[0]} not divisible by "
                f"micro_batches {self.n_micro}")
        self.block: list[Layer] = []
        self.block_input = self.lp.bottom[0]
        env = {self.block_input: in_shape}
        if self.n_micro % self.n_stages:
            log.warning(
                "layer %s: micro_batches %d is not a multiple of num_stages "
                "%d; the pipelined schedule runs %d ticks for %d "
                "microbatches", self.name, self.n_micro, self.n_stages,
                self.n_micro + self.n_stages - 1, self.n_micro)
        for ilp in p.layer:
            if ilp.type == "Dropout" and self.phase == "TRAIN":
                raise ValueError(
                    f"layer {self.name!r}: Dropout inside a Pipeline block "
                    "is unsupported in TRAIN phase (no per-stage rng stream)")
            if (ilp.attention_param is not None
                    and ilp.attention_param.sequence_parallel):
                raise ValueError(
                    f"pipeline block layer {ilp.name!r}: sequence_parallel "
                    "attention inside a Pipeline block is unsupported — the "
                    "stage is already shard_mapped over the 'model' axis, so "
                    "the sequence cannot shard over it too")
            il = create_layer(ilp, self.policy, self.phase, self.device)
            il.model_dir = self.model_dir
            shapes = []
            for b in ilp.bottom:
                if b not in env:
                    raise ValueError(
                        f"pipeline block layer {ilp.name!r}: unknown bottom "
                        f"{b!r}")
                shapes.append(env[b])
            il.in_shapes = shapes
            outs = il.setup(shapes)
            il.out_shapes = outs
            if il.state_shapes or il.host_step or (
                    il.needs_rng and self.phase == "TRAIN"):
                raise ValueError(
                    f"pipeline block layer {ilp.name!r} ({ilp.type}) is "
                    "stateful; only stateless ops can be pipelined")
            for t, s in zip(ilp.top, outs):
                env[t] = tuple(s)
            self.block.append(il)
        self.block_output = self.block[-1].lp.top[0]
        out_shape = env[self.block_output]
        if out_shape != in_shape:
            raise ValueError(
                f"layer {self.name!r}: pipeline block must be "
                f"shape-preserving, got {in_shape} -> {out_shape}")
        # stacked params: a leading stage dim on every inner param; the
        # inner lr/decay multipliers carry over
        self._inner: dict[str, tuple[Layer, str, ParamDecl]] = {}
        for il in self.block:
            for pname, decl in il.decls.items():
                if decl.shared_name:
                    raise ValueError(
                        f"pipeline block layer {il.name!r}: cross-net param "
                        "sharing inside a block is unsupported")
                name = f"{il.name}.{pname}"
                self.declare(name, (self.n_stages, *decl.shape),
                             decl.filler, param_idx=1 << 30,
                             lr_mult=decl.lr_mult,
                             decay_mult=decl.decay_mult, dtype=decl.dtype)
                self._inner[name] = (il, pname, decl)
        return [in_shape]

    @torch.no_grad()
    def init_params(self, gen: torch.Generator, skip=()) -> None:
        """Each stage its own draw of the block's filler on the stage's
        shape (fan-in and fan-out of the unstacked shape)."""
        for name, (_, _, decl) in self._inner.items():
            if name in skip:
                continue
            p = getattr(self, name)
            for s in range(self.n_stages):
                p[s].copy_(fill(decl.filler, gen, decl.shape, p.dtype))

    def accepts_shards(self, shards: dict) -> bool:
        mp = self.mesh_plan
        return not shards or (
            mp is not None and mp.n_model == self.n_stages
            and shards == {name: 0 for name in self.decls})

    def _stage(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        """One stage: the block over `params` ({stacked name: that
        stage's tensor})."""
        env = {self.block_input: x}
        for il in self.block:
            own = {pn: params[f"{il.name}.{pn}"] for pn in il.decls}
            bottoms = [env[b] for b in il.lp.bottom]
            tops = torch.func.functional_call(il, own, (bottoms,)) \
                if own else il(bottoms)
            for t, v in zip(il.lp.top, tops):
                env[t] = v
        return env[self.block_output]

    def forward(self, bottoms):
        x = bottoms[0]
        stacked = {name: getattr(self, name) for name in self.decls}
        if self.shards and self.model_plan() is not None:
            mp = self.mesh_plan
            n = x.shape[0]
            mb = x.reshape(self.n_micro, n // self.n_micro, *x.shape[1:])
            own = {k: v[0] for k, v in stacked.items()}
            y = pipeline_apply(self._stage, own, mb, mp)
            return [y.reshape(x.shape)]
        for s in range(self.n_stages):
            x = self._stage({k: v[s] for k, v in stacked.items()}, x)
        return [x]
