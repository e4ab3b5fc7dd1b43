"""Bucketed gradient reduction: the port's counterpart of the JAX package's
caffe_mpi_tpu/parallel/reduction.py, the reference's ReduceAndUpdate
plane (net.cpp:757-913).

The reference packs the learnable diffs into `reduce_buckets` (default 6)
contiguous buckets in reverse topological order, the order backward
produces them (net.cpp:824-863, 1350-1374), and a reduce thread
all-reduces each bucket on its own stream while backward still runs,
scaling by 1/solver_count after the reduce (net.cpp:891, 910).

- `plan_buckets`, `plan_for_net` and `unsupported_reason` give the JAX
  module's plans and reasons (a net's params in reverse layer order,
  sized by count or by a byte budget; `wire_dtype` bfloat16 under
  `precision: bf16`);
- `Reducer` is the counterpart of `bucketed_value_and_grad`: each
  bucket's gradients are views into one flat buffer, so autograd
  accumulates into the buffer and packing copies nothing. With `hooks`
  (`reduce_overlap`), a `register_post_accumulate_grad_hook` on every
  param of a bucket counts the bucket's gradients in; the hook that
  completes a bucket starts its all-reduce at once, on a side stream on
  the card, while backward goes on. The count (not the bucket's last
  param alone) keeps a branching net's backward order from launching a
  bucket early. Hooks act only on the last micro-batch of iter_size.
  `finish` starts the buckets no hook started (all of them on the
  implicit path: one flat all-reduce after backward), in bucket order,
  joins them to the current stream, and divides by n_data. Every rank
  starts the same buckets in the same order, since backward runs the
  same graph on every rank;
- `collective_stats` read HLO text in JAX; here `MeshPlan.collectives`
  counts the collectives issued, and the solver's `reduction_stats`
  reports them a step. `tpu_overlap_flags` / `apply_tpu_overlap_flags`
  set libtpu scheduler flags and have no counterpart on a card.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np
import torch

log = logging.getLogger("caffe_mpi_tpu_torch.parallel.reduction")

_ITEMSIZE = {"float32": 4, "float64": 8, "float16": 2, "bfloat16": 2,
             "int32": 4, "int64": 8}


def dtype_name(dtype) -> str:
    """'float32', 'bfloat16', ... for a torch or numpy dtype or a name."""
    if isinstance(dtype, str):
        return dtype
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return np.dtype(dtype).name


def _prod(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


# ---------------------------------------------------------------------------
# Bucket planning
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Bucket:
    """One contiguous reduction unit: (layer, param) keys in reverse-topo
    order, all one dtype; nbytes is the packed size."""
    entries: tuple[tuple[str, str], ...]
    sizes: tuple[int, ...]       # element counts, aligned with entries
    dtype: str
    nbytes: int


@dataclass(frozen=True)
class ReductionPlan:
    """The bucket schedule and the facts the reduce needs. wire_dtype
    (bfloat16 under `precision: bf16`): each bucket travels in this type
    and is cast back to the gradient's before the 1/n scale."""
    buckets: tuple[Bucket, ...]
    n_data: int
    wire_dtype: str | None = None

    @property
    def bucket_bytes(self) -> tuple[int, ...]:
        return tuple(b.nbytes for b in self.buckets)

    @property
    def collectives_per_step(self) -> int:
        """Gradient collectives one step issues (the loss's is not
        counted, as in JAX)."""
        return len(self.buckets)

    def stats(self) -> dict:
        out = {
            "mode": "bucketed",
            "reduce_buckets": len(self.buckets),
            "collectives_per_step": self.collectives_per_step,
            "bucket_bytes": list(self.bucket_bytes),
            "n_data": self.n_data,
        }
        if self.wire_dtype:
            out["wire_dtype"] = self.wire_dtype
        return out


def plan_buckets(entries, *, n_buckets: int = 0,
                 bucket_bytes: int = 0, n_data: int = 1,
                 wire_dtype: str | None = None) -> ReductionPlan:
    """Pack `entries` (layer, param, shape, dtype), in reverse topological
    layer order, into contiguous buckets: greedily up to `bucket_bytes`
    (a param over the budget gets its own bucket, with a warning), else
    `n_buckets` buckets of ~equal bytes (the reference's
    total_count/reduce_buckets rule, net.cpp:824-863). A dtype change
    starts a new bucket (one buffer is one dtype)."""
    if bucket_bytes <= 0 and n_buckets <= 0:
        raise ValueError("plan_buckets needs n_buckets > 0 or "
                         "bucket_bytes > 0")
    ents = []
    for (lname, pname, shape, dtype) in entries:
        dt = wire_dtype or dtype_name(dtype)
        ents.append((lname, pname, _prod(shape) if shape else 1, dt))
    if not ents:
        return ReductionPlan(buckets=(), n_data=n_data,
                             wire_dtype=wire_dtype)

    total = sum(s * _ITEMSIZE[dt] for (_, _, s, dt) in ents)
    buckets: list[Bucket] = []
    cur: list[tuple] = []
    cur_bytes = 0

    def flush():
        nonlocal cur, cur_bytes
        if cur:
            buckets.append(Bucket(
                entries=tuple((l, p) for (l, p, _, _) in cur),
                sizes=tuple(s for (_, _, s, _) in cur),
                dtype=cur[0][3], nbytes=cur_bytes))
            cur, cur_bytes = [], 0

    if bucket_bytes > 0:
        target = int(bucket_bytes)
        for (lname, pname, size, dt) in ents:
            nbytes = size * _ITEMSIZE[dt]
            if cur and (cur[0][3] != dt or cur_bytes + nbytes > target):
                flush()
            if nbytes > target:
                log.warning(
                    "param %s/%s (%d bytes) exceeds the grad_bucket_mb "
                    "budget (%d bytes); it gets its own bucket",
                    lname, pname, nbytes, target)
            cur.append((lname, pname, size, dt))
            cur_bytes += nbytes
            if cur_bytes >= target:
                flush()
        flush()
    else:
        # close bucket b when the bytes so far cross (b+1)/k of the
        # total, or when the entries left are just enough for the buckets
        # left, so k buckets come out whenever k <= the params
        k = min(int(n_buckets), len(ents))
        cum = 0
        for i, (lname, pname, size, dt) in enumerate(ents):
            nbytes = size * _ITEMSIZE[dt]
            if cur and cur[0][3] != dt:
                flush()
            cur.append((lname, pname, size, dt))
            cur_bytes += nbytes
            cum += nbytes
            remaining = len(ents) - i - 1
            still_needed = k - len(buckets) - 1
            if len(buckets) < k - 1 and (
                    cum >= (len(buckets) + 1) * total / k
                    or remaining <= still_needed):
                flush()
        flush()
    return ReductionPlan(buckets=tuple(buckets), n_data=n_data,
                         wire_dtype=wire_dtype)


def net_params(net) -> dict:
    """{layer: {param: tensor}} of a port Net's owned params, in
    declaration order (the JAX params pytree)."""
    out: dict = {}
    for lname, pname, _ in net.learnable_param_decls():
        out.setdefault(lname, {})[pname] = getattr(
            net.layer_by_name(lname), pname)
    return out


def plan_for_net(net, params=None, *, n_buckets: int = 0,
                 bucket_bytes: int = 0, n_data: int = 1,
                 wire_dtype: str | None = None) -> ReductionPlan:
    """Bucket plan over a net's params (default: `net_params(net)`),
    layers reversed (backward order). Every param lands in exactly one
    bucket: clipping reads every gradient, so one left out would carry
    an unreduced gradient into the global norm."""
    if params is None:
        params = net_params(net)
    entries = []
    seen = set()
    for layer in reversed(net.layers):
        lparams = params.get(layer.name)
        if not lparams or layer.name in seen:
            continue
        seen.add(layer.name)
        for pname, arr in lparams.items():
            entries.append((layer.name, pname, tuple(arr.shape),
                            arr.dtype))
    covered = {(l, p) for (l, p, _, _) in entries}
    want = {(ln, pn) for ln, lp in params.items() for pn in lp}
    missing = want - covered
    if missing:
        raise ValueError(
            f"bucket planner lost params {sorted(missing)} — params "
            "exist outside the net's layer list")
    return plan_buckets(entries, n_buckets=n_buckets,
                        bucket_bytes=bucket_bytes, n_data=n_data,
                        wire_dtype=wire_dtype)


# ---------------------------------------------------------------------------
# Compatibility gate (the JAX module's, reason for reason)
# ---------------------------------------------------------------------------

# losses whose normalizer is a static batch-proportional count
_DP_SAFE_LOSSES = {
    "SoftmaxWithLoss", "EuclideanLoss", "L1Loss",
    "SigmoidCrossEntropyLoss", "HingeLoss", "MultinomialLogisticLoss",
    "InfogainLoss", "ContrastiveLoss",
}
# layer types whose TRAIN computation couples examples across the batch
_CROSS_BATCH_TYPES = {"BatchNorm", "MoE"}


def _walk_layer_params(lp):
    """Every LayerParameter reachable from `lp`, into composite
    (Pipeline) bodies."""
    yield lp
    pp = getattr(lp, "pipeline_param", None)
    if pp is not None:
        for inner in pp.layer:
            yield from _walk_layer_params(inner)


def unsupported_reason(net) -> str | None:
    """None when the JAX package runs the net's TRAIN graph on its
    bucketed per-device backward; else its reason, on which the solver
    falls back to the implicit (flat) reduction, as JAX does. A layer
    that runs on the host (`host_step`) is JAX's host_callback."""
    for layer in net.layers:
        if getattr(layer, "host_step", False):
            return (f"layer {layer.name!r} re-enters the host from "
                    "inside the step (host_callback)")
        for lp in _walk_layer_params(layer.lp):
            if lp.type in _CROSS_BATCH_TYPES:
                return (f"layer {lp.name!r} ({lp.type}) couples examples "
                        "across the batch; per-device backward would "
                        "change its semantics")
        if not (hasattr(layer, "is_loss") and layer.is_loss()):
            continue
        ltype = layer.lp.type
        if ltype not in _DP_SAFE_LOSSES:
            return (f"loss layer {layer.name!r} ({ltype}) is not on the "
                    "static-normalization allowlist")
        p = layer.lp.loss_param
        mode = ""
        if p is not None and p.has("normalization"):
            mode = str(p.normalization).upper()
        if mode == "NONE":
            return (f"loss layer {layer.name!r} uses normalization NONE "
                    "(sum, not batch-mean)")
        ignore = p.ignore_label if p is not None and p.has("ignore_label") \
            else None
        if ignore is not None and ltype == "SoftmaxWithLoss" \
                and mode in ("", "VALID"):
            return (f"loss layer {layer.name!r} normalizes by a "
                    "data-dependent valid count (ignore_label + VALID)")
    return None


# ---------------------------------------------------------------------------
# The reduce
# ---------------------------------------------------------------------------

class Reducer:
    """The gradients of `params` ({(layer, param): tensor}) as views into
    one flat buffer a bucket of `plan`, reduced over `mesh`.

    Per iteration: `zero()` (the buffers; the views stay the params'
    `.grad`), `arm(last)` before each micro-batch's backward, `finish()`
    after the last: every bucket reduced, joined and divided by
    n_data."""

    def __init__(self, plan: ReductionPlan, params: dict, mesh,
                 hooks: bool):
        self.plan, self.mesh, self.hooks = plan, mesh, hooks
        self.flats: list[torch.Tensor] = []
        self._hosts: list[torch.Tensor | None] = []
        self._params = params
        owner: dict[int, int] = {}
        for b, bucket in enumerate(plan.buckets):
            p0 = params[bucket.entries[0]]
            flat = torch.zeros(sum(bucket.sizes), dtype=p0.dtype,
                               device=p0.device)
            off = 0
            for key, size in zip(bucket.entries, bucket.sizes):
                p = params[key]
                p.grad = flat[off:off + size].view(p.shape)
                owner[id(p)] = b
                off += size
            self.flats.append(flat)
            # gloo on a card: the bucket's own pinned staging buffer
            wire = torch.bfloat16 if plan.wire_dtype else flat.dtype
            self._hosts.append(torch.empty(
                flat.numel(), dtype=wire, pin_memory=True)
                if mesh._staged(flat) else None)
        # a bucket's params that take a gradient: the hooks count them in
        self._need = [sum(params[k].requires_grad for k in bucket.entries)
                      for bucket in plan.buckets]
        self._got = [0] * len(plan.buckets)
        self._pending: list = [None] * len(plan.buckets)
        self._armed = False
        self._side = None
        if hooks:
            for p in params.values():
                if p.requires_grad:
                    p.register_post_accumulate_grad_hook(
                        lambda p, b=owner[id(p)]: self._on_grad(b))

    def zero(self) -> None:
        """Zero the buffers (and re-seat a view someone took away)."""
        for flat in self.flats:
            flat.zero_()
        for bucket, flat in zip(self.plan.buckets, self.flats):
            off = 0
            for key, size in zip(bucket.entries, bucket.sizes):
                p = self._params[key]
                if p.grad is None:
                    p.grad = flat[off:off + size].view(p.shape)
                off += size
        self._got = [0] * len(self.plan.buckets)
        self._pending = [None] * len(self.plan.buckets)

    def arm(self, last: bool) -> None:
        """Hooks act on this backward: the last micro-batch's."""
        self._armed = last
        self._got = [0] * len(self.plan.buckets)

    def _on_grad(self, b: int) -> None:
        if not self._armed:
            return
        self._got[b] += 1
        if self._got[b] == self._need[b] and self._pending[b] is None:
            self._start(b, side=True)

    def _start(self, b: int, side: bool = False) -> None:
        flat = self.flats[b]
        buf = flat
        if self.plan.wire_dtype and flat.dtype != torch.bfloat16:
            buf = flat.to(torch.bfloat16)
        stream = None
        if side and flat.is_cuda and not self.mesh._staged(flat):
            if self._side is None:
                self._side = torch.cuda.Stream(flat.device)
            stream = self._side
            stream.wait_stream(torch.cuda.current_stream(flat.device))
        ctx = torch.cuda.stream(stream) if stream is not None else None
        if ctx is not None:
            with ctx:
                pending = self.mesh.all_reduce_start(buf, self._hosts[b])
        else:
            pending = self.mesh.all_reduce_start(buf, self._hosts[b])
        self._pending[b] = (pending, buf)

    def finish(self) -> None:
        """Start the buckets not started yet, in order; join every one to
        the current stream; cast back from the wire type; divide by
        n_data (the reference's post-reduce 1/solver_count)."""
        for b in range(len(self.flats)):
            if self._pending[b] is None:
                self._start(b)
        if self._side is not None:
            torch.cuda.current_stream(self.flats[0].device).wait_stream(
                self._side)
        n = self.plan.n_data
        for b, flat in enumerate(self.flats):
            pending, buf = self._pending[b]
            pending.wait()
            if buf is not flat:
                flat.copy_(buf)
            if n > 1:
                flat.div_(n)
        self._armed = False
