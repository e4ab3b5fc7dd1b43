"""Solver — the training loop, on one device or data-parallel.

Reference: src/caffe/solver.cpp + solvers/*; JAX package
caffe_mpi_tpu/solver/solver.py, whose jitted step holds the whole iteration.
The port runs an iteration as torch ops from the host: forward and loss
through the train `Net`, `loss.backward()` through autograd (on the card
the LRN backward is the CUDA kernel K2 and the flash-attention backward
K4 and K5), then the update rule over every learnable parameter.

Kept as the JAX solver keeps it:
- `iter_size` accumulation and the 1/(iter_size * global_grad_scale)
  normalization (solver.cpp:277-288, net.cpp:815-818);
- gradient clipping by global L2 norm (sgd_solver.cpp:110-128);
- per-param lr_mult/decay_mult; an lr_mult of 0 freezes the param;
- the LR and momentum policies (`lr_policy.py`) and the six update rules
  (`updates.py`);
- TEST nets that share the train net's parameters and state buffers
  (BatchNorm's running statistics) by layer name, run at `test_interval`
  and at iteration 0 under `test_initialization`, scores averaged over
  `test_iter` batches (solver.cpp:439-540);
- layer state updated once a micro-batch: each of the `iter_size`
  forwards updates the running statistics in place, as the JAX solver
  threads `net_state` through its micro-batch scan;
- smoothed-loss display over `average_loss` iterations with img/s;
- snapshot and restore in the reference's binaryproto formats, the history
  blobs in `_history_blobs` order (solver.cpp:542-604); the running
  statistics travel in the .caffemodel with a correction of 1, so a
  restore gives them back bitwise;
- mixed precision (`precision: "bf16"`): the nets compute in bfloat16
  where the prototxt sets no type (`Net`), the params stay float32
  masters (or bfloat16 storage under `solver_data_type: FLOAT16`), the
  optimizer slots float32; the update runs in float32 and is cast back to
  the storage type. `loss_scale > 0` is a static scale folded into
  global_grad_scale; `loss_scale: 0` under bf16 is dynamic: 2^15 at the
  start, halved on an overflow step (which is skipped), doubled after
  `loss_scale_window` clean steps, within [1, 2^24]. The unscale divides
  after the cast to float32;
- the skip-step guard (`train_guard`, armed too by the dynamic scale):
  after the update is computed, one all-finite check over the loss and
  the new params, slots and running statistics (and, with
  `guard_loss_spike`, the loss against spike x an EMA of accepted losses)
  selects with `torch.where` between the new values and the old ones; a
  skipped step keeps params, slots and statistics, and the iteration
  still advances. The carry (5 device scalars, 3 more under the dynamic
  scale) stays on the device; an overflow counts toward
  `guard_max_skips` only at the scale's floor, a finite spike counts at
  once and leaves the scale alone. Past `guard_max_skips` consecutive
  skips the host raises NumericAnomalyError (the CLI exits 88). With the
  guard off, an accepted step's arithmetic is the same;
- `step_chunk`: iterations run in chunks of up to K that stop at display,
  test_interval and snapshot boundaries (`_chunk_at`, the JAX rule), so a
  snapshot at a chunk boundary is the K=1 one byte for byte. A chunk
  uploads the (lr, momentum, t) rows of its iterations as one float32
  table (`lr_policy.table`); each iteration reads its row through a
  device counter and writes its loss, lr and accepted flag to a device
  buffer, which the host reads once a chunk with the guard's carry.

On the card a chunk of K > 1 (`step_chunk` > 1) replays a CUDA graph of
one iteration K times: the first iteration of a solver runs eagerly (it
warms cuDNN and cuBLAS), then one iteration is captured (one graph for
each distinct net and iter_size). Between replays the host only copies
the next batch and the iteration's Dropout masks into the graph's static
inputs: every mask is drawn ahead of the iteration from the generator
reseeded from (random_seed, iteration), the draws the forward would
make, so a replayed iteration uses the masks of the eager one and a
resumed run draws what the uninterrupted one would. Kernel launch counts
are Python integers that a capture raises once: the capture's delta is
taken back and added again at every replay. On the CPU, at K = 1, and
for a net with a layer that runs on the host (`Layer.host_step`:
DetectNetTransformation, whose forward copies its bottoms to the host),
the same chunk code runs eagerly, the chunk's losses still read back
once.

The backward runs under the TF32 switches of the net's one math precision
(`Net.math_precision`), so a prototxt's FLOAT math holds for the backward
convolutions and products as well as the forward ones; a graph keeps the
switches of its capture.

Survivable training, as the JAX solver has it (utils/resilience.py):

- verified snapshots: each file written through `atomic_output`, then
  the crc32c manifest `<prefix>_iter_<N>.manifest.json` last (the
  snapshot's commit point), then the run journal `<prefix>.run.json`
  (reason "snapshot") and the `snapshot_keep` GC, which never deletes
  the newest verified snapshot. An interval snapshot does not stall the
  loop (`snapshot(block=False)`): a point-in-time copy of the params,
  the history and the running statistics is taken on the device, on the
  current stream, before the next iteration (a replayed graph updates
  these very tensors in place); one writer thread then copies it to the
  host on a stream of its own, behind an event recorded after the copy,
  and writes the files. At most one writer is in flight;
  `wait_snapshots` joins it and re-raises a failed write with its
  iteration. `restore` checks a snapshot's manifest when there is one
  (SnapshotCorruptError); `restore_auto` takes the newest verified
  snapshot, then a manifest-less one, else None;
- the dispatch watchdog (`watchdog_deadline` > 0): every host wait on
  the device (a chunk, from its first launch to its read-back, the first
  graph capture included; a test pass; a snapshot's copy) is a section
  of a `DispatchWatchdog`, which journals `watchdog:<label>` and exits
  86 when one outlasts the deadline;
- the guard's divergence journals `numeric_anomaly` before it raises;
- `test_chunk`: each test net is evaluated in chunks of T batches (T
  pinned, or 0: as many as fit a 256 MiB budget, at most 64, the JAX
  `_test_chunk_len`), the sums accumulating on the device, one host read
  a pass. In the chunked mode on the card (step_chunk > 1) a chunk after
  the test net's first is one CUDA-graph replay of its T forwards; else
  its forwards run eagerly. The scores do not depend on T;
- the asynchronous evaluation (the JAX `_start_eval`, `_harvest_eval`):
  at a test_interval boundary the training loop harvests the previous
  pass and starts this one. The params and state buffers are copied on
  the current stream into persistent copies, which the test nets and
  their captured chunks read through `net.reading`; the
  first chunk is launched at the boundary and the rest after the next
  training chunk, on the card on a stream of the evaluation's own
  behind the copy, so training goes on updating the live tensors while
  the pass reads the boundary's. A pass is harvested (one host read a
  test net, scores logged with the iteration they evaluate and kept in
  `eval_log`) at the next boundary or at the end of `step`;
  `eval_stall_ms` is the host time the loop spent in starts and
  harvests. `test_all` is the same pass, started and harvested at once;
- the fault sites `train_abort` (each chunk's start), `dispatch_stall`
  (inside a chunk's section), `nan_grad` / `loss_spike` (the feeds),
  `snapshot_sync`, `snapshot_kill` and `snapshot_corrupt`;
- `requests`: flags a signal handler sets ("stop", "snapshot"), acted on
  at the next chunk boundary.

Data parallelism (`mesh`, a parallel.MeshPlan: one process a rank, the
JAX `Solver(mesh=)` semantics: N ranks give the parameters one device
gives on the same global batch). The prototxt batch is global and each
rank's net takes batch/N (`Net(batch_divisor=N)`); each rank is fed its
slice of the global batch (the CLI's feeders stripe by rank). Then:

- replicas start identical: rank 0's params, running statistics and
  history are broadcast after construction, after `restore` and after
  `load_weights` (the reference's ncclBcast, parallel.cpp:208-227);
- the gradients are views into flat buffers (parallel/reduction.py
  `Reducer`): the implicit path all-reduces them once after the backward
  loop; `reduce_overlap` splits them into the JAX plan's buckets, each
  all-reduced from a gradient hook as soon as the last micro-batch's
  backward has produced it (the bf16 wire under `precision: bf16`), with
  the JAX validation and fallback reasons (`reduction_stats`). The sum
  is divided by N after the reduce (net.cpp:891), then clipping, the
  guard and the update run on the reduced gradients; the loss is
  all-reduced too, so every rank accepts or skips the same step and
  moves its loss scale alike;
- BatchNorm's statistics, VALID loss normalization with ignore_label and
  Accuracy are global-batch values across the ranks (`Net.bind_mesh`);
  Dropout's mask on a rank is its slice of the global mask drawn from
  the same generator (a given `dropout_masks` is the global mask too);
  MoE routes over the global batch; host layers
  (DetectNetTransformation) are refused (ROADMAP.md §1 item 6);
- ZeRO-1 (`zero_stage: 1`, the JAX checks): a history slot whose dim 0
  divides N lives on each rank as its dim-0 shard; the rank updates its
  slice of the param from the reduced gradient and the ranks all-gather
  the param. Snapshots gather the slots first, on the main thread;
- a test net whose batch divides N evaluates the rank's slice and its
  scores are all-reduced; one that does not evaluates the whole batch on
  every rank (the JAX `_place_test_feeds` fallback);
- rank 0 displays, writes snapshots and the run journal (rank k's is
  `<prefix>.r<k>.run.json`); the other ranks wait at a barrier on the
  group's store until its files are written; `restore_auto` restores on
  every rank the point rank 0 chose, published on the store; signal
  requests are agreed at each chunk boundary;
- under NCCL a chunk's CUDA graph captures the all-reduces; gloo
  collectives cannot be captured, so under gloo on the card a chunk runs
  eagerly (`graph_route`, stated at construction).

The mesh's 'model' axis (`mesh.n_model` > 1; the JAX `Solver(mesh=,
param_shardings=)`): `param_shardings` (else the prototxt's
`param_sharding` and the Pipeline layers, `_prototxt_shardings`) place
params over the mesh's axes, any spec the JAX `param_sharding_rules`
takes. The full arrays are drawn first, then each rank keeps its shards
(`Net.place`, the test nets' layers alike), so a split run starts from
the one-process run's values. A layer with a model-parallel forward for
its shards runs it; any other gathers the whole params on use
(`mesh.gather_on_use`: a param split over 'data' is reduced by that
gather's backward, a reduce-scatter, in the Reducer's place). A rank is
fed by its data index: the model ranks of one data index take the same
slice and the same Dropout masks. The gradients reduce over the data
axis only; clipping sums a split param's squares over the axes that
split it once; the guard's check and signal requests are agreed over
every rank; the updates run on the shards. ZeRO-1 splits over 'data'
the slots of the params of the layers no rule names (the JAX rule);
those of a named layer stay aligned with their params. A chunk of
`step_chunk` iterations is one CUDA graph under NCCL (the model axis's
all-reduces, gathers, broadcasts and ring send/recv captured, their
counters added again at each replay) and eager under gloo, the test
pass's chunks alike (`_test_graphs_ok`). A test net
whose batch does not divide the data ranks runs the whole batch on
every rank over the model axis alone (`MeshPlan.model_axis_only`).
BINARYPROTO snapshots gather the whole arrays (the caffemodel and
solverstate a one-process run writes); `restore`, `load_weights` and
`weights.load_jax_params` take whole arrays and keep the rank's shards.

Sharded snapshots (`snapshot_format: ORBAX`, the JAX `snapshot_native`
and `restore_native`): `<prefix>_iter_<N>.orbax/` holds one .npy a
distinct shard, written by the rank that owns it, and the index
(`SHARDED_INDEX`); after the write barrier rank 0 commits the crc32c
manifest. A restore reads the slices the current mesh gives the rank,
so a set written on one mesh restores on any other (world 1 included).

GPipe (`gpipe`, the JAX `Solver(gpipe=)`; parallel/gpipe.py): the net
is cut into S stages, each on its device, the prototxt batch into M
micro-batches (default S; the net is built at batch / M); an iteration
is `GPipe.train_step`'s wavefront, the backward seeded with
global_grad_scale, then each stage's params updated on its own device
from the gradients unwound as iter_size's; clip_gradients takes one norm
over every stage, without a host sync. The history lives with its
param; snapshots are whole, so they restore across the modes. Every
iteration is its own dispatch (no CUDA graph); the test nets evaluate
whole on stage 0's device. Refused with the JAX messages: bf16, a
mesh, zero_stage, iter_size > 1, train_guard.

Elasticity (the JAX `host_deadline` and `min_hosts`): with
host_deadline > 0 over more than one process the cross-host heartbeat
(utils/resilience.py `HostHeartbeat`, over the group's store or
CAFFE_TPU_HB_DIR) rides the watchdog's monitor thread; a peer silent
past the deadline journals `host_lost:<peer>` and exits 87, and a
collective that fails because its peer died waits for that verdict
(`await_host_loss`). With min_hosts, rank 0 of a generation that is
missing hosts watches their supervisors' beats at every snapshot
boundary and exits 87 (`cluster_rejoin`) when one returns, so the
elastic supervisor grows the cluster back from that snapshot.

Not ported yet: HDF5 snapshots (ROADMAP.md §1 item 4). A field in
`UNPORTED_FIELDS`
(none is left) or an unported snapshot format raises
NotImplementedError before anything is built, so no field is accepted
and then ignored. An unknown `precision` raises ValueError, as the JAX
`Solver` does.
"""

from __future__ import annotations

import json
import logging
import os
import re
import shutil
import threading
import time
from collections import deque
from contextlib import nullcontext
from functools import partial
from typing import Callable

import numpy as np
import torch

from .. import io as caffe_io
from ..core.device import resolve_device
from ..net import IndivisibleBatch, Net, reading
from ..ops import launch_counters, launch_counts
from ..parallel import mesh as mesh_mod
from ..parallel import reduction
from ..proto.config import (NetParameter, SolverParameter, refuse_unported,
                            solver_type)
from ..utils import resilience
from ..utils.resilience import FAULTS, NumericAnomalyError
from . import lr_policy
from .updates import UPDATE_FNS, Hyper, n_slots

log = logging.getLogger("caffe_mpi_tpu_torch.solver")

# SolverParameter fields that the JAX package honours and the port does
# not yet, each with the ROADMAP.md section 1 item that will port it.
# Fields neither package honours (solver_mode, device_id, ...) stay
# accepted.
UNPORTED_FIELDS = ()
PRECISIONS = ("f32", "bf16")  # the JAX Solver's; "" is f32
# snapshot formats the port does not write yet, with their ROADMAP.md
# section 1 item
UNPORTED_SNAPSHOT_FORMATS = {"HDF5": 4}
SNAPSHOT_FORMATS = ("BINARYPROTO", "ORBAX")
# the port's index of a sharded (.orbax) snapshot directory
SHARDED_INDEX = "port_index.json"
ANOMALY_ACTIONS = ("rewind", "rewind_lr", "abort")

# the dynamic loss scale's schedule (the JAX solver's _LS_*)
LS_INIT = 2.0 ** 15
LS_MIN = 1.0
LS_MAX = 2.0 ** 24
LS_BACKOFF = 0.5
LS_GROWTH = 2.0

FeedFn = Callable[[int], dict]
# (iteration, micro-batch) -> {dropout layer name: bool mask}
MaskFn = Callable[[int, int], dict]
# the guard carry, in the order the host reads it
_CARRY = ("skips", "consec", "max_consec", "last_bad", "ema")
_CARRY_DYN = ("scale", "good", "overflows")


def _load_net_param(sp: SolverParameter, phase: str, model_dir: str = "",
                    test_idx: int = 0) -> NetParameter:
    """Resolve the net definition the way reference Solver::Init* does
    (solver.cpp:41-105): inline net_param / net file / train_net /
    test_net."""
    if phase == "TRAIN":
        if sp.train_net_param is not None:
            return sp.train_net_param
        if sp.train_net:
            return NetParameter.from_file(os.path.join(model_dir,
                                                       sp.train_net))
    else:
        if sp.test_net_param:
            return sp.test_net_param[test_idx]
        if sp.test_net:
            return NetParameter.from_file(
                os.path.join(model_dir, sp.test_net[test_idx]))
    if sp.net_param is not None:
        return sp.net_param
    if sp.net:
        return NetParameter.from_file(os.path.join(model_dir, sp.net))
    raise ValueError("solver specifies no net")


def _shard_owners(spec, mesh_shape) -> list[tuple[int, int]]:
    """The (data, model) coordinates of the ranks that write the distinct
    shards of an array placed by `spec` on a mesh of `mesh_shape`: index
    0 on every axis that does not split it."""
    axes = {a for dim in spec or () for a in dim}
    return [(d, m) for d in range(mesh_shape[0]) for m in range(mesh_shape[1])
            if (d == 0 or "data" in axes) and (m == 0 or "model" in axes)]


def _read_region(path: str, shards: list[dict], want, out: np.ndarray
                 ) -> None:
    """Fill `out`, the region `want` ([lo, hi) a dim) of a whole array,
    from the shard files (each {"file", "slice"}) that overlap it."""
    covered = 0
    for shard in shards:
        have = shard["slice"]
        lo = [max(a, c) for (a, _), (c, _) in zip(want, have)]
        hi = [min(b, d) for (_, b), (_, d) in zip(want, have)]
        if any(a >= b for a, b in zip(lo, hi)):
            continue
        src = np.load(os.path.join(path, shard["file"]), mmap_mode="r")
        src_at = tuple(slice(a - c, b - c) for a, b, (c, _)
                       in zip(lo, hi, have))
        dst_at = tuple(slice(a - w, b - w) for a, b, (w, _)
                       in zip(lo, hi, want))
        out[dst_at] = src[src_at]
        covered += int(np.prod([b - a for a, b in zip(lo, hi)]))
    if covered != out.size:
        raise ValueError(f"{path}: the shard files cover {covered} of the "
                         f"{out.size} elements a rank needs")


def _all_finite(tensors) -> torch.Tensor:
    """A 0-d bool: every element of every tensor finite. One multi-tensor
    kernel a dtype: PyTorch's AMP check, which also scales each tensor by
    an inverse scale in place, here 1 (no value changes)."""
    found = torch.zeros(1, dtype=torch.float32, device=tensors[0].device)
    one = torch.ones(1, dtype=torch.float32, device=tensors[0].device)
    by_dtype: dict[torch.dtype, list] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        torch._amp_foreach_non_finite_check_and_unscale_(group, found, one)
    return found[0] == 0


class _Graph:
    """One captured iteration (or test chunk): the CUDA graph, its static
    inputs (feeds and Dropout masks, one dict a micro-batch or test
    batch) and each launch counter's launches a replay."""

    def __init__(self, graph, feeds, masks, deltas):
        self.graph, self.feeds, self.masks, self.deltas = (graph, feeds,
                                                           masks, deltas)

    def replay(self, feeds: list[dict], masks: list[dict]) -> None:
        for static, given in zip(self.feeds + self.masks, feeds + masks):
            for key, buf in static.items():
                buf.copy_(torch.as_tensor(given[key]), non_blocking=True)
        self.graph.replay()
        for counter, n in self.deltas.items():
            counter.launches += n


class Solver:
    def __init__(self, sp: SolverParameter, *, model_dir: str = "",
                 device: str | torch.device | None = None,
                 mesh: mesh_mod.MeshPlan | None = None,
                 param_shardings: dict | None = None, gpipe=None):
        """device: default the card (the mesh's device under `mesh`).
        param_shardings: the JAX `Solver(param_shardings=)` rules over the
        mesh's 'model' axis ({layer: "rows" | spec | {param: spec}});
        None takes the prototxt's (`_prototxt_shardings`).
        gpipe: pipeline training over heterogeneous stages
        (parallel/gpipe.py), the JAX `Solver(gpipe=)`: S stages, or
        {"stages": S, "micro": M, "boundaries": [...], "devices": [...]}.
        The prototxt batch is the iteration's, cut into M micro-batches
        (default S), each fed by the feed fn (iter_size's contract)."""
        precision = str(sp.precision or "f32").lower()
        if precision not in PRECISIONS:
            raise ValueError(f"unknown precision {sp.precision!r} (expected "
                             "'f32' or 'bf16')")
        ls = float(sp.loss_scale or 0.0)
        if ls < 0:
            raise ValueError(
                f"loss_scale must be >= 0 (0 = dynamic), got {ls}")
        lsw = int(sp.loss_scale_window or 0)
        if lsw <= 0 and sp.has("loss_scale_window"):
            raise ValueError(
                f"loss_scale_window must be >= 1, got {lsw}")
        refuse_unported(sp, UNPORTED_FIELDS, "solver")
        self._gpipe_cfg, self._gpipe_micro = self._gpipe_config(
            sp, gpipe, precision, mesh)
        fmt = str(sp.snapshot_format or "BINARYPROTO").upper()
        if fmt in UNPORTED_SNAPSHOT_FORMATS:
            raise NotImplementedError(
                f"solver field snapshot_format: {fmt} snapshots are not "
                "ported yet (ROADMAP.md §1 item "
                f"{UNPORTED_SNAPSHOT_FORMATS[fmt]}); the port writes "
                "BINARYPROTO and ORBAX snapshots")
        if fmt not in SNAPSHOT_FORMATS:
            raise ValueError(f"unknown snapshot_format {sp.snapshot_format!r}")
        self.snapshot_format = fmt
        if str(sp.anomaly_action or "rewind") not in ANOMALY_ACTIONS:
            raise ValueError(f"unknown anomaly_action {sp.anomaly_action!r}"
                             f" (expected one of {ANOMALY_ACTIONS})")
        self.sp = sp
        self.type = solver_type(sp)
        if self.type not in UPDATE_FNS:
            raise ValueError(f"unknown solver type {self.type!r}")
        self.update_fn = UPDATE_FNS[self.type]
        if self.type == "RMSProp":
            self.update_fn = partial(self.update_fn, rms_decay=sp.rms_decay)
        zero = int(sp.zero_stage or 0)
        if zero not in (0, 1):
            raise ValueError(f"zero_stage {zero} unsupported (0 or 1)")
        if zero and mesh is None:
            raise ValueError("zero_stage: 1 requires a device mesh "
                             "(-gpu all or -mesh data=N)")
        if mesh is not None:
            if device is not None and \
                    resolve_device(device) != mesh.device:
                raise ValueError(f"device {device} is not the mesh's "
                                 f"{mesh.device}")
            device = mesh.device
        self.mesh = mesh
        self.rank = mesh.rank if mesh is not None else 0
        n_data = mesh.n_data if mesh is not None else 1
        n_model = mesh.n_model if mesh is not None else 1
        if param_shardings and mesh is None:
            raise ValueError("param_shardings requires a mesh")
        self.device = resolve_device(device or "cuda")
        self.model_dir = model_dir
        self.precision = precision
        self._ls_window = lsw if lsw > 0 else 200
        # dynamic scaling is a bf16 mechanism; the f32 path scales by 1
        self._dyn_scale = precision == "bf16" and ls == 0
        self._static_scale = ls if (precision == "bf16" and ls > 0) else 1.0
        self._guard_on = bool(sp.train_guard) or self._dyn_scale
        self.step_chunk = max(int(sp.step_chunk or 1), 1)

        ts = sp.train_state
        train_param = _load_net_param(sp, "TRAIN", model_dir)
        self.net = Net(train_param, "TRAIN",
                       device=self.device, level=ts.level if ts else 0,
                       stages=tuple(ts.stage) if ts else (),
                       model_dir=model_dir,
                       solver_storage=sp.solver_data_type,
                       precision=precision,
                       batch_divisor=n_data * max(self._gpipe_micro, 1))
        if n_data > 1:
            bad = [f"{l.name} ({l.lp.type})" for l in self.net.layers
                   if l.host_step]
            if bad:
                raise NotImplementedError(
                    f"data parallelism over layers {', '.join(bad)} is not "
                    "ported yet (ROADMAP.md §1 item 6): host layers "
                    "transform across the whole batch")
        if mesh is not None:
            self.net.bind_mesh(mesh)
        # the one TF32 setting the backward runs under (raises on a mix)
        self.net.math_precision()
        self._math = self.net.layers[0].policy
        self.test_nets: list[Net] = []
        n_tests = max(len(sp.test_net), len(sp.test_net_param),
                      1 if (sp.net or sp.net_param is not None)
                      and sp.test_iter else 0)
        # a test net whose batch divides the ranks evaluates the rank's
        # slice; else the whole batch on every rank
        self.test_sharded: list[bool] = []
        for i in range(n_tests):
            st = sp.test_state[i] if i < len(sp.test_state) else None
            kw = dict(device=self.device, level=st.level if st else 0,
                      stages=tuple(st.stage) if st else (),
                      model_dir=model_dir, precision=precision)
            tparam = _load_net_param(sp, "TEST", model_dir, i)
            try:
                tnet = Net(tparam, "TEST", batch_divisor=n_data, **kw)
                sharded = n_data > 1
            except IndivisibleBatch:
                log.warning("test net #%d: its batch does not divide into "
                            "%d ranks; every rank evaluates the whole batch",
                            i, n_data)
                tnet, sharded = Net(tparam, "TEST", **kw), False
            if sharded:
                tnet.bind_mesh(mesh)
            elif n_model > 1:
                # the whole batch on every rank: the model axis only (the
                # model ranks of a data index feed the same rows)
                tnet.bind_mesh(mesh.model_axis_only())
            self.test_nets.append(tnet)
            self.test_sharded.append(sharded)

        seed = sp.random_seed if sp.random_seed >= 0 else 0
        self.net.init(seed)
        # GPipe: each stage's params, state (and, below, history) on its
        # stage's device; the test nets hold the same tensors
        self.gpipe = None
        if self._gpipe_cfg is not None:
            from ..parallel.gpipe import GPipe
            cfg = self._gpipe_cfg
            self.gpipe = GPipe(self.net, cfg.get("stages"),
                               boundaries=cfg.get("boundaries"),
                               devices=cfg.get("devices"))
            self.gpipe.place_params()
        # the 'model' axis: the full arrays are drawn above, then each
        # rank keeps its shards (the test nets' layers alike)
        if param_shardings is None and mesh is not None:
            param_shardings = self._prototxt_shardings()
        if param_shardings:
            known = {l.name for l in self.net.layers}
            unknown = set(param_shardings) - known
            if unknown:
                raise ValueError(
                    f"param_shardings for unknown layers: {sorted(unknown)}")
        if param_shardings and n_model > 1:
            placement = mesh.param_sharding_rules(param_shardings)
            self.net.place(placement)
            for tnet in self.test_nets:
                tnet.place(placement)
        for tnet in self.test_nets:
            self._share_params(tnet)
        # ZeRO-1 leaves the slots of the layers a rule names aligned with
        # their params (the JAX `_place_params_opt`)
        tp_layers = set(param_shardings or ()) if n_model > 1 else set()
        # owned learnable params in declaration order — the history order
        self._decls = [(lname, pname, decl,
                        getattr(self.net.layer_by_name(lname), pname))
                       for lname, pname, decl
                       in self.net.learnable_param_decls()]
        k = n_slots(self.type)
        self.history: dict[tuple[str, str], tuple[torch.Tensor, ...]] = {}
        # ZeRO-1: the dim-0 length of each slot's shard on this rank (the
        # JAX `_place_params_opt`), None where the slot is replicated
        self._zero = zero
        self._shard_len: dict[tuple[str, str], int | None] = {}
        for lname, pname, decl, p in self._decls:
            p.requires_grad_(decl.lr_mult != 0.0)
            shard = mesh.zero_slot_sharding(tuple(p.shape)) \
                if zero and lname not in tp_layers else None
            self._shard_len[(lname, pname)] = shard
            shape = (shard, *p.shape[1:]) if shard else p.shape
            self.history[(lname, pname)] = tuple(
                torch.zeros(shape, dtype=torch.float32, device=p.device)
                for _ in range(k))
        self._reducer: reduction.Reducer | None = None
        self._reduction: reduction.ReductionPlan | None = None
        self._reduction_fallback: str | None = None
        self._rs_params: list[torch.Tensor] = []
        self._init_reduction(train_param)
        # collectives and iterations of the training chunks (the
        # collectives_issued_per_step of reduction_stats)
        self._train_collectives = 0
        self._train_iters = 0
        self._resume_round = 0
        self._barrier_pending = False
        self._sync_replicas()
        # per-iteration randomness (Dropout): one generator on the device,
        # reseeded from (random_seed, iteration) at every iteration as the
        # JAX solver folds the iteration into its key, so a resumed run
        # draws what the uninterrupted one would have
        self._seed = seed
        self.generator = torch.Generator(device=self.device)
        self._droppers = [layer for layer in self.net.layers
                          if layer.needs_rng]
        # a layer that runs on the host (DetectNetTransformation) cannot
        # be captured: such a net's chunks run as eager iterations
        host = [layer.name for layer in self.net.layers if layer.host_step]
        # how a chunk runs, decided here and never by trying a capture:
        # "graphs" (one CUDA graph an iteration, replayed) or "eager: "
        # and the reason
        gloo = mesh is not None and mesh.backend != "nccl"
        if host:
            self.graph_route = (f"eager: net {self.net.name} has host "
                                f"layers ({', '.join(host)})")
        elif self.device.type != "cuda":
            self.graph_route = "eager: not on a card"
        elif gloo:
            self.graph_route = ("eager: gloo collectives cannot enter a "
                                "CUDA graph")
        elif self.gpipe is not None:
            self.graph_route = "eager: GPipe's wavefront is its own dispatch"
        elif self.step_chunk <= 1:
            self.graph_route = "eager: step_chunk 1"
        else:
            self.graph_route = "graphs"
        self._graphs_ok = self.graph_route == "graphs"
        # the test pass's chunks on the same terms (its forwards issue the
        # model axis's collectives), a test net's own host layers aside;
        # GPipe evaluates on its first stage's card, with no collective
        self._test_graphs_ok = self.device.type == "cuda" and not gloo \
            and self.step_chunk > 1
        if host and self.step_chunk > 1:
            log.info("net %s has host layers (%s): step_chunk %d runs each "
                     "chunk as %d eager iterations, one host read-back a "
                     "chunk", self.net.name, ", ".join(host),
                     self.step_chunk, self.step_chunk)
        elif self.step_chunk > 1 and self.device.type == "cuda" \
                and not self._graphs_ok:
            log.info("step_chunk %d: %s; each chunk runs eagerly",
                     self.step_chunk, self.graph_route[len("eager: "):])
        # a chunk's device side: its (lr, momentum, t) rows, the row an
        # iteration reads, and each iteration's (loss, lr, accepted)
        f32 = dict(dtype=torch.float32, device=self.device)
        self._table = torch.zeros((self.step_chunk, 3), **f32)
        self._table_host = torch.zeros(
            (self.step_chunk, 3), dtype=torch.float32,
            pin_memory=self.device.type == "cuda")
        self._row = torch.zeros((1,), dtype=torch.long, device=self.device)
        self._out = torch.zeros((self.step_chunk, 3), **f32)
        self._gs = self._carry0() if self._guard_on else None
        self._graphs: dict[tuple[int, int], _Graph] = {}
        # the test pass's graphs by (test net, chunk length), the test
        # nets that have run their eager chunk, and each one's sums
        self._test_graphs: dict[tuple[int, int], _Graph] = {}
        self._test_warm: set[int] = set()
        self._test_sums: dict[int, torch.Tensor] = {}
        self._stream = None  # the side stream of graph capture and replay
        self._warm = False  # an eager iteration has run (graph capture)
        self.iter = 0
        self._loss_window: deque[float] = deque(maxlen=max(sp.average_loss,
                                                           1))
        self.losses: list[float] = []    # loss of every iteration run
        self.iter_ms: list[float] = []   # host wall time of each iteration
        self.chunk_ms: list[float] = []  # host wall time of each chunk
        self.skipped_iters: list[int] = []  # iterations the guard skipped
        # telemetry, as the JAX solver's: chunks run (one dispatch, one
        # host sync each), guard carry reads, the guard's skips, overflow
        # skips and the loss scale as of the last read
        self.dispatch_count = 0
        self.host_sync_count = 0
        self.guard_sync_count = 0
        self.graph_replays = 0
        self.graph_collectives = 0  # collectives a replay issues
        self.skipped_steps = 0
        self.overflow_steps = 0
        self.loss_scale_value = LS_INIT if self._dyn_scale \
            else float(self._static_scale)
        # evaluation: chunks run (in the chunked mode on the card, one
        # graph replay each after a test net's first), passes, host reads
        # (one a test net a pass)
        self.test_dispatch_count = 0
        self.test_pass_count = 0
        self.test_host_reads = 0
        # the asynchronous pass: its pending record, the host ms the
        # training loop lost to evaluation (boundary starts and harvests),
        # each harvested pass {"iter", "scores"}, the test nets' copies of
        # the params and state ({id of the live tensor: copy}) and each
        # test net's {module name: copy}, and the evaluation's stream
        self._pending_eval = None
        self.eval_stall_ms = 0.0
        self.eval_log: list[dict] = []
        self._eval_copies: dict[int, tuple[torch.Tensor, torch.Tensor]] = {}
        self._eval_views: dict[int, list] = {}
        self._eval_stream = None
        self.eval_stall_log: list[dict] = []
        # survivability: the watchdog (armed at the first step when
        # watchdog_deadline > 0), the cached fault-site feed wrapper, the
        # newest snapshot written (iteration, state path), the writer
        # thread and its error, the state paths written, each snapshot's
        # timing, and the flags a signal handler sets
        self._watchdog: resilience.DispatchWatchdog | None = None
        # the cross-host heartbeat (host_deadline) the watchdog's thread
        # ticks, and min_hosts' grow-back check: None until primed, False
        # when there is nothing to re-admit
        self._heartbeat: resilience.HostHeartbeat | None = None
        self._rejoin = None
        self._fault_feed_cache = None
        self._last_snapshot: tuple[int, str] | None = None
        self._snapshot_thread: threading.Thread | None = None
        self._snapshot_error: tuple[int, BaseException] | None = None
        self._copy_stream = None
        self.snapshots: list[str] = []
        self.snapshot_log: list[dict] = []
        self.requests = {"stop": False, "snapshot": False}

    @staticmethod
    def _gpipe_config(sp, gpipe, precision: str, mesh):
        """(config, micro-batches) of the `gpipe` argument, or (None, 0),
        refusing what the JAX solver refuses under GPipe, with its
        messages."""
        if not gpipe:
            return None, 0
        cfg = {"stages": gpipe} if isinstance(gpipe, int) else dict(gpipe)
        n_st = cfg.get("stages") or (len(cfg.get("boundaries") or []) - 1)
        if not n_st or n_st < 1:
            raise ValueError("gpipe needs stages >= 1 (or boundaries)")
        if precision == "bf16":
            raise ValueError(
                "precision: bf16 is unsupported under gpipe (stage-local "
                "updates bypass the loss-scaling carry); use the mesh "
                "path")
        if mesh is not None:
            raise ValueError("gpipe and mesh are mutually exclusive "
                             "(pipeline stages own whole devices)")
        if int(sp.zero_stage or 0):
            raise ValueError("zero_stage with gpipe is unsupported")
        if max(sp.iter_size, 1) > 1:
            raise ValueError(
                "iter_size > 1 under gpipe is redundant: micro_batches "
                "already accumulate with iter_size semantics")
        if sp.train_guard:
            raise ValueError(
                "train_guard is unsupported under gpipe (the guard "
                "select lives inside the SPMD step; pipeline stages "
                "update per-device)")
        return cfg, int(cfg.get("micro") or 0) or int(n_st)

    def _share_params(self, tnet: Net) -> None:
        """A test net holds the train net's very `nn.Parameter`s and state
        buffers (BatchNorm's running statistics), matched by layer name
        (reference ShareTrainedLayersWith; the JAX solver hands its one
        `net_state` to the test pass)."""
        for layer in tnet.layers:
            names = [*layer.decls, *layer.state_shapes]
            if not names:
                continue
            try:
                src = self.net.layer_by_name(layer.name)
            except KeyError:
                raise KeyError(f"test net layer {layer.name!r} has no "
                               "matching train-net params") from None
            for pname in names:
                p = getattr(src, pname, None)
                if p is None or tuple(p.shape) != tuple(
                        getattr(layer, pname).shape):
                    raise ValueError(
                        f"test net {layer.name}.{pname}: shape "
                        f"{tuple(getattr(layer, pname).shape)} != train "
                        f"{None if p is None else tuple(p.shape)}")
                setattr(layer, pname, p)

    # ------------------------------------------------------------------
    # Data parallelism
    def _init_reduction(self, train_param: NetParameter) -> None:
        """Validate the reduction knobs and pick the reduce (the JAX
        `_init_reduction`): config errors raise; a net or mesh the JAX
        bucketed step does not take falls back to the implicit flat
        reduce with the reason logged (`reduction_stats`)."""
        sp, mesh = self.sp, self.mesh
        if train_param.has("reduce_buckets") \
                and train_param.reduce_buckets <= 0:
            raise ValueError(
                f"net reduce_buckets must be >= 1, got "
                f"{train_param.reduce_buckets}")
        if sp.reduce_buckets < 0 or (
                sp.has("reduce_buckets") and sp.reduce_buckets == 0):
            raise ValueError(
                f"solver reduce_buckets must be >= 1, got "
                f"{sp.reduce_buckets}")
        if sp.grad_bucket_mb < 0 or (
                sp.has("grad_bucket_mb") and sp.grad_bucket_mb == 0):
            raise ValueError(
                f"grad_bucket_mb must be a positive MiB budget, got "
                f"{sp.grad_bucket_mb}")
        n_buckets = int(sp.reduce_buckets or 0)
        bucket_mb = float(sp.grad_bucket_mb or 0.0)
        if n_buckets > 0 and bucket_mb > 0:
            raise ValueError(
                "set either reduce_buckets (bucket count) or "
                "grad_bucket_mb (byte budget), not both")
        if sp.reduce_overlap and mesh is None:
            raise ValueError(
                "reduce_overlap requires a device mesh (-gpu all or "
                "-mesh data=N)")
        if mesh is None:
            return
        # a param split over 'data' is reduced by its gather's backward
        # (a reduce-scatter), not in the Reducer's buffers
        by_layer = {}
        for l, lp in reduction.net_params(self.net).items():
            for p, t in lp.items():
                if "data" in self._split_axes(l, p):
                    self._rs_params.append(t)
                else:
                    by_layer.setdefault(l, {})[p] = t
        params = {(l, p): t for l, lp in by_layer.items()
                  for p, t in lp.items()}
        fallback = None
        if sp.reduce_overlap:
            if mesh.n_data == 1:
                fallback = ("'data' axis has a single device — nothing to "
                            "reduce (the implicit program is already "
                            "collective-free)")
            elif self._zero:
                fallback = ("zero_stage 1 reduces via reduce-scatter; "
                            "explicit bucket psums would defeat it")
            else:
                fallback = reduction.unsupported_reason(self.net)
            if fallback is not None:
                self._reduction_fallback = fallback
                log.warning("reduce_overlap: falling back to the implicit "
                            "reduction — %s", fallback)
            else:
                n = mesh.n_data
                if n & (n - 1):
                    log.warning(
                        "reduce_overlap: 'data' axis size %d is not a power "
                        "of two; the post-reduce 1/n scale is inexact and "
                        "the bucketed step matches the implicit one only to "
                        "~1 ulp", n)
                if not n_buckets and not bucket_mb:
                    n_buckets = train_param.reduce_buckets
                self._reduction = reduction.plan_for_net(
                    self.net, by_layer, n_buckets=n_buckets,
                    bucket_bytes=int(bucket_mb * (1 << 20)), n_data=n,
                    wire_dtype="bfloat16" if self.precision == "bf16"
                    else None)
                if self.rank == 0:
                    log.info("overlapped bucketed reduction: %d bucket(s) "
                             "over 'data'=%d, bytes per bucket %s%s",
                             len(self._reduction.buckets), n,
                             list(self._reduction.bucket_bytes),
                             " (bf16 wire)" if self.precision == "bf16"
                             else "")
        # the implicit reduce: one flat buffer (a dtype run each)
        plan = self._reduction or reduction.plan_for_net(
            self.net, by_layer, bucket_bytes=1 << 62, n_data=mesh.n_data)
        self._reducer = reduction.Reducer(
            plan, params, mesh, hooks=self._reduction is not None)

    def _prototxt_shardings(self) -> dict:
        """The net prototxt's `param_sharding` rules (the JAX
        `_prototxt_shardings`): "rows" splits the output dim over 'model'
        (column-parallel), "cols" the input dim (row-parallel); a
        Pipeline's stacked params split their stage dim when the model
        axis has one rank a stage."""
        rules = {}
        n_model = self.mesh.n_model if self.mesh is not None else 1
        for layer in self.net.layers:
            if layer.lp.type == "Pipeline" and layer.n_stages == n_model \
                    and layer.n_stages > 1:
                rules[layer.name] = {pn: ("model",) for pn in layer.decls}
                continue
            s = layer.lp.param_sharding
            if not s:
                continue
            if s == "rows":
                rules[layer.name] = "rows"
            elif s == "cols":
                rules[layer.name] = (None, "model")
            else:
                raise ValueError(
                    f"layer {layer.name!r}: unknown param_sharding {s!r} "
                    "(expected 'rows' or 'cols')")
        return rules

    def reduction_stats(self) -> dict | None:
        """Gradient-reduction telemetry, the JAX keys: the bucket plan
        (mode 'bucketed'), or mode 'implicit' with the fallback reason;
        None without a mesh. The port adds the collectives its training
        chunks issued a step (BatchNorm's, the loss's and ZeRO's
        gathers included), the bytes the gradient reduce moves a step,
        the backend and the ZeRO stage."""
        if self.mesh is None:
            return None
        if self._reduction is not None:
            out = self._reduction.stats()
        else:
            out = {"mode": "implicit", "n_data": self.mesh.n_data}
            if self._reduction_fallback:
                out["fallback_reason"] = self._reduction_fallback
        hosts = self.mesh.hosts
        out["hosts"] = hosts
        out["cross_host_collectives_per_step"] = (
            out.get("collectives_per_step", 0) if hosts > 1 else 0)
        # a generation-managed run (min_hosts): which hosts it spans
        gen = mesh_mod.cluster_generation()
        if gen is not None:
            out["generation"] = gen["generation"]
            out["generation_hosts"] = gen["hosts"]
            out["world_full"] = gen["world_full"]
        wire = 2 if self._reducer.plan.wire_dtype else None
        out["reduced_bytes_per_step"] = sum(
            f.numel() * (wire or f.element_size())
            for f in self._reducer.flats)
        out["buckets"] = len(self._reducer.flats)
        out["collectives_issued_per_step"] = (
            self._train_collectives / self._train_iters
            if self._train_iters else None)
        out["backend"] = self.mesh.backend
        out["zero_stage"] = self._zero
        out["n_model"] = self.mesh.n_model
        return out

    def _replicated(self) -> list[torch.Tensor]:
        """What the ranks of a model index hold alike: params, running
        statistics and history slots, but for ZeRO-1's slot shards and
        the params (and slots) a placement splits over 'data'."""
        whole = {(l, p): "data" not in self._split_axes(l, p)
                 for l, p, _, _ in self._decls}
        out = [p for l, n, _, p in self._decls if whole[(l, n)]]
        out += [buf for _, _, buf in self.net.state_buffers()]
        out += [s for key, slots in self.history.items()
                if self._shard_len[key] is None and whole[key]
                for s in slots]
        return out

    def _sync_replicas(self) -> None:
        """Rank 0's params, statistics and history on every rank."""
        if self.mesh is not None:
            self.mesh.replicate(self._replicated())

    def _counters(self) -> list:
        """The counters a graph capture takes back and a replay adds:
        K1-K5's launches and the mesh's collectives."""
        out = list(launch_counters())
        if self.mesh is not None:
            out += [self.mesh.collectives, self.mesh.sent]
        return out

    def _split_axes(self, lname: str, pname: str) -> frozenset:
        """The mesh axes that split a param (its `Net.place` spec)."""
        spec = self.net.spec_of(lname, pname)
        return frozenset(a for axes in spec or () for a in axes)

    def full_history(self) -> dict[tuple[str, str], tuple[torch.Tensor, ...]]:
        """Every param's history slots whole: ZeRO-1 shards all-gathered
        over 'data', the slots of params split by a placement gathered
        over the axes that split them (collectives: every rank calls it,
        in the same order)."""
        out = {}
        for key, slots in self.history.items():
            if self.net.sharded(*key):
                out[key] = tuple(self.net.gather_param(*key, s)
                                 for s in slots)
            elif self._shard_len[key] is None:
                out[key] = slots
            else:
                shape = tuple(getattr(self.net.layer_by_name(key[0]),
                                      key[1]).shape)
                out[key] = tuple(self.mesh.all_gather(s).reshape(shape)
                                 for s in slots)
        return out

    def _agree(self, flag: torch.Tensor) -> torch.Tensor:
        """A 0-d bool that is True on every rank only if it is on all."""
        bad = (~flag).float().reshape(1)
        return self.mesh.world_all_reduce_(bad)[0] == 0

    def _journal_prefix(self) -> str:
        prefix = self.sp.snapshot_prefix or "snapshot"
        return prefix if self.rank == 0 else f"{prefix}.r{self.rank}"

    # ------------------------------------------------------------------
    def _carry0(self) -> dict[str, torch.Tensor]:
        """A fresh guard carry: no skips, no consecutive run, no bad
        iteration seen, the loss EMA unset (-1); under the dynamic scale
        the scale at its start, no clean steps, no overflows."""
        i32 = dict(dtype=torch.int32, device=self.device)
        f32 = dict(dtype=torch.float32, device=self.device)
        gs = {"skips": torch.zeros((), **i32),
              "consec": torch.zeros((), **i32),
              "max_consec": torch.zeros((), **i32),
              "last_bad": torch.full((), -1, **i32),
              "ema": torch.full((), -1.0, **f32)}
        if self._dyn_scale:
            gs.update(scale=torch.full((), LS_INIT, **f32),
                      good=torch.zeros((), **i32),
                      overflows=torch.zeros((), **i32))
        return gs

    def _masks(self, it: int, masks: MaskFn | None) -> list[dict]:
        """Each micro-batch's Dropout masks for iteration `it`: the given
        ones, or the draws the forwards would make from the generator
        reseeded from (random_seed, it), in micro-batch and layer order
        (GPipe's micro-batches as iter_size's)."""
        iter_size = self._micro_batches()
        mesh = self.mesh
        if masks is not None:
            out = [masks(it, m) for m in range(iter_size)]
        elif not self._droppers:
            return [{} for _ in range(iter_size)]
        else:
            n = mesh.n_data if mesh is not None else 1
            self.generator.manual_seed((self._seed << 32) + it + 1)
            out = [{layer.name: self._draw(layer, n)
                    for layer in self._droppers} for _ in range(iter_size)]
        if mesh is not None and mesh.n_data > 1:
            out = [{k: mesh.shard(v) for k, v in m.items()} for m in out]
        return out

    def _micro_batches(self) -> int:
        """The forwards of an iteration: GPipe's micro-batches, else
        iter_size."""
        return self._gpipe_micro or max(self.sp.iter_size, 1)

    def _draw(self, layer, n: int) -> torch.Tensor:
        """A layer's draw; over n > 1 ranks the global batch's mask (the
        solver refuses host layers there, so a Dropout's)."""
        if n == 1:
            return layer.draw_mask(self.generator)
        shape = layer.in_shapes[0]
        return layer.draw_mask(self.generator, (shape[0] * n, *shape[1:]))

    def _iteration(self, feeds: list[dict], masks: list[dict]) -> None:
        """One training iteration (the JAX `_iteration_fn` body) on the
        micro-batches' feeds and Dropout masks, with no host sync: the
        iteration's scalars come from its row of the chunk's table, and
        its (loss averaged over iter_size, lr, accepted) go to that row of
        the output buffer. A CUDA graph captures exactly this."""
        sp = self.sp
        iter_size = max(sp.iter_size, 1)
        grad_scale = sp.global_grad_scale if sp.global_grad_scale else 1.0
        grad_scale = grad_scale * self._static_scale
        gs = self._gs
        eff_scale = grad_scale * gs["scale"] if self._dyn_scale \
            else grad_scale
        state = [buf for _, _, buf in self.net.state_buffers()]
        if self._guard_on:
            state0 = [buf.clone() for buf in state]
        red = self._reducer
        if red is None:
            for _, _, _, p in self._decls:
                p.grad = None
        else:
            red.zero()
            # split over 'data': reduced by the gather's backward
            for p in self._rs_params:
                p.grad = None
        total = torch.zeros((), dtype=torch.float32, device=self.device)
        with self._math.math(self.device):
            for m in range(iter_size):
                if red is not None:
                    red.arm(m == iter_size - 1)
                _, loss = self.net(feeds[m], dropout_masks=masks[m])
                if loss.requires_grad:
                    (loss * eff_scale).backward()
                total = total + loss.detach()
        if red is not None:
            # the gradients' sum over the ranks / N, and the loss's mean
            red.finish()
            total = self.mesh.all_reduce_(total.reshape(1))[0] \
                / self.mesh.n_data
        # the unscale divides after the cast to float32
        denom = iter_size * eff_scale
        grads = [p.grad.float() / denom if p.grad is not None
                 else torch.zeros_like(p, dtype=torch.float32)
                 for _, _, _, p in self._decls]
        if sp.clip_gradients > 0:
            sq = [torch.sum(torch.square(g)) for g in grads]
            split = [self._split_axes(lname, pname)
                     for lname, pname, _, _ in self._decls]
            if any(split):
                # a split param counts each shard once (its squares
                # summed over the axes that split it); a replicated one
                # counts once, not once a rank
                sums = {"model": self.mesh.model_all_reduce_,
                        "data": self.mesh.all_reduce_}
                whole = [q for q, x in zip(sq, split) if not x]
                for axes in sorted({x for x in split if x}, key=sorted):
                    part = torch.stack(
                        [q for q, x in zip(sq, split) if x == axes]).sum()
                    reduce = sums[next(iter(axes))] if len(axes) == 1 \
                        else self.mesh.world_all_reduce_
                    whole.append(reduce(part.reshape(1))[0])
                sq = whole
            gnorm = torch.sqrt(sum(sq))
            scale = torch.where(gnorm > sp.clip_gradients,
                                sp.clip_gradients / gnorm, 1.0)
            grads = [g * scale for g in grads]
        row = torch.index_select(self._table, 0, self._row)[0]
        rate = row[0]
        hyper = Hyper(rate=rate, momentum=row[1], momentum2=sp.momentum2,
                      delta=sp.delta, weight_decay=sp.weight_decay,
                      reg_l1=(sp.regularization_type == "L1"), t=row[2],
                      memo={})
        # a captured iteration must write the slots it read; an eager one
        # takes the new tensors
        capturing = self.device.type == "cuda" \
            and torch.cuda.is_current_stream_capturing()
        loss_out = total / iter_size
        with torch.no_grad():
            new = []  # (layer, param name, param, new value, new slots)
            for (lname, pname, decl, p), g in zip(self._decls, grads):
                if decl.lr_mult == 0.0:
                    continue
                slots = self.history[(lname, pname)]
                shard = self._shard_len[(lname, pname)]
                if shard is None:
                    w, slots2 = self.update_fn(p.float(), g, slots, hyper,
                                               decl.lr_mult, decl.decay_mult)
                    new.append((lname, pname, p, w.to(p.dtype), slots2))
                    continue
                # ZeRO-1: this rank's dim-0 slice, then the ranks' slices
                lo = self.mesh.data_index * shard
                w, slots2 = self.update_fn(
                    p[lo:lo + shard].float(), g[lo:lo + shard], slots,
                    hyper, decl.lr_mult, decl.decay_mult)
                w = self.mesh.all_gather(w.to(p.dtype)).reshape(p.shape)
                new.append((lname, pname, p, w, slots2))
            if self._guard_on:
                ok = self._guard(loss_out, new, state, row[2])
                for lname, pname, p, w, slots2 in new:
                    torch.where(ok, w, p, out=p)
                    slots2 = tuple(torch.where(ok, s1, s0) for s0, s1 in
                                   zip(self.history[(lname, pname)], slots2))
                    self._set_slots((lname, pname), slots2, capturing)
                for buf, buf0 in zip(state, state0):
                    torch.where(ok, buf, buf0, out=buf)
                accepted = ok.float()
            else:
                for lname, pname, p, w, slots2 in new:
                    p.copy_(w)
                    self._set_slots((lname, pname), slots2, capturing)
                accepted = torch.ones((), dtype=torch.float32,
                                      device=self.device)
            self._out.index_copy_(0, self._row, torch.stack(
                [loss_out.detach(), rate, accepted])[None])
            self._row.add_(1)

    def _gpipe_iteration(self, feeds: list[dict], masks: list[dict]
                         ) -> None:
        """One pipelined iteration (the JAX `_gpipe_iteration`): the
        wavefront over the M micro-batches (`GPipe.train_step`, the
        backward seeded with global_grad_scale), then the update of each
        stage's params on the stage's own device. The gradients are
        unwound as `_iteration` unwinds iter_size's: the sum over the
        micro-batches / (M x global_grad_scale). clip_gradients takes its
        norm over every stage: each param's squares on its device, summed
        on stage 0's device in declaration order, the scale sent back to
        each stage; no host sync. The iteration's row of the chunk's
        table and output buffer as `_iteration`'s."""
        sp, gp = self.sp, self.gpipe
        lscale = float(sp.global_grad_scale or 1.0)
        with self._math.math(gp.devices[0]):
            loss, _ = gp.train_step(feeds, dropout_masks=masks,
                                    loss_scale=lscale)
        denom = self._gpipe_micro * lscale
        grads = [p.grad.float() / denom if p.grad is not None
                 else torch.zeros_like(p, dtype=torch.float32)
                 for _, _, _, p in self._decls]
        dev0 = gp.devices[0]
        scale = None
        if sp.clip_gradients > 0:
            sq = [torch.sum(torch.square(g)).to(dev0) for g in grads]
            gnorm = torch.sqrt(sum(sq))
            scale = torch.where(gnorm > sp.clip_gradients,
                                sp.clip_gradients / gnorm, 1.0)
        row = torch.index_select(self._table, 0, self._row)[0]
        hypers, scales = {}, {}
        with torch.no_grad():
            for (lname, pname, decl, p), g in zip(self._decls, grads):
                if decl.lr_mult == 0.0:
                    continue
                dev = p.device
                if dev not in hypers:
                    r = row.to(dev)
                    hypers[dev] = Hyper(
                        rate=r[0], momentum=r[1], momentum2=sp.momentum2,
                        delta=sp.delta, weight_decay=sp.weight_decay,
                        reg_l1=(sp.regularization_type == "L1"), t=r[2],
                        memo={})
                    scales[dev] = None if scale is None else scale.to(dev)
                if scales[dev] is not None:
                    g = g * scales[dev]
                w, slots2 = self.update_fn(
                    p.float(), g, self.history[(lname, pname)],
                    hypers[dev], decl.lr_mult, decl.decay_mult)
                p.copy_(w.to(p.dtype))
                self.history[(lname, pname)] = tuple(slots2)
            accepted = torch.ones((), dtype=torch.float32,
                                  device=self.device)
            self._out.index_copy_(0, self._row, torch.stack(
                [loss.detach().to(self.device), row[0], accepted])[None])
            self._row.add_(1)

    def _set_slots(self, key, slots, in_place: bool) -> None:
        if in_place:
            for s0, s1 in zip(self.history[key], slots):
                s0.copy_(s1)
        else:
            self.history[key] = tuple(slots)

    def _guard(self, loss, new, state, t) -> torch.Tensor:
        """The skip decision of one iteration (0-d bool, True = accept) and
        the carry's update in place, as the JAX `_apply_guard`: the check
        reads the update's outputs (the loss, the new params and slots,
        the running statistics after the forward)."""
        sp, gs = self.sp, self._gs
        ok_fin = torch.isfinite(loss) & _all_finite(
            [w for _, _, _, w, _ in new] + [s for *_, s2 in new for s in s2]
            + [p for _, _, decl, p in self._decls if decl.lr_mult == 0.0]
            + state)
        if (self._zero and self.mesh.n_data > 1) or \
                self.net.placement is not None:
            # the slot or param shards differ between ranks: agree on
            # the check
            ok_fin = self._agree(ok_fin)
        ok = ok_fin
        spike = float(sp.guard_loss_spike or 0.0)
        ema, decay = gs["ema"], float(sp.guard_ema_decay or 0.9)
        if spike > 0:
            # an EMA < 0 (no accepted loss yet) never spikes; a NaN loss
            # compares False, as the finite check says
            ok = ok & torch.where(ema >= 0, loss <= spike * ema, True)
        if self._dyn_scale:
            # an overflow counts toward guard_max_skips only at the
            # scale's floor; a finite spike counts at once
            overflow = ~ok_fin
            counts = torch.where(overflow, gs["scale"] <= LS_MIN, True)
            consec = torch.where(ok, 0, torch.where(
                counts, gs["consec"] + 1, 0))
        else:
            consec = torch.where(ok, 0, gs["consec"] + 1)
        upd = {
            "skips": gs["skips"] + torch.where(ok, 0, 1),
            "consec": consec,
            "max_consec": torch.maximum(gs["max_consec"],
                                        consec.to(torch.int32)),
            "last_bad": torch.where(ok, gs["last_bad"],
                                    (t - 1).to(torch.int32)),
            # the EMA takes accepted losses only
            "ema": torch.where(ok, torch.where(
                ema >= 0, decay * ema + (1.0 - decay) * loss, loss), ema),
        }
        if self._dyn_scale:
            # halve on an overflow skip only; grow after ls_window clean
            # steps; `good` counts clean steps, reset by growth and skips
            good = torch.where(ok, gs["good"] + 1, 0)
            grow = ok & (good >= self._ls_window)
            upd["scale"] = torch.where(
                grow, torch.clamp(gs["scale"] * LS_GROWTH, max=LS_MAX),
                torch.where(overflow,
                            torch.clamp(gs["scale"] * LS_BACKOFF,
                                        min=LS_MIN), gs["scale"]))
            upd["good"] = torch.where(grow, 0, good)
            upd["overflows"] = gs["overflows"] + torch.where(overflow, 1, 0)
        for key, value in upd.items():
            gs[key].copy_(value)
        return ok

    def _graph_of(self, fn) -> tuple[torch.cuda.CUDAGraph, dict]:
        """Capture what `fn` queues as a CUDA graph on the current stream.
        The launch (and collective) counts the capture raised are taken
        back; the graph adds them at every replay."""
        counters = self._counters()
        before = {c: c.launches for c in counters}
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=torch.cuda.current_stream(),
                              capture_error_mode="thread_local"):
            fn()
        deltas = {}
        for c in counters:
            if c.launches != before[c]:
                deltas[c] = c.launches - before[c]
                c.launches = before[c]
        return graph, deltas

    def _capture(self, feeds: list[dict], masks: list[dict]) -> _Graph:
        """Capture one iteration of the current net and iter_size as a
        CUDA graph on the chunk's stream."""
        key = (id(self.net), max(self.sp.iter_size, 1))
        log.info("capturing a CUDA graph of one iteration (net %s, "
                 "iter_size %d; graphs so far: %d)", self.net.name, key[1],
                 len(self._graphs) + 1)
        static_feeds = [{k: torch.empty_like(torch.as_tensor(v),
                                             device=self.device)
                         for k, v in f.items()} for f in feeds]
        static_masks = [{k: torch.empty_like(v) for k, v in m.items()}
                        for m in masks]
        graph, deltas = self._graph_of(
            lambda: self._iteration(static_feeds, static_masks))
        self._graphs[key] = _Graph(graph, static_feeds, static_masks,
                                   deltas)
        if self.mesh is not None:
            self.graph_collectives = deltas.get(self.mesh.collectives, 0)
        return self._graphs[key]

    def release_graphs(self) -> None:
        """Drop the captured graphs (they replay no more). A process group
        is left only after this: destroying NCCL communicators under a
        live graph that captured their collectives hangs on four cards."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._graphs.clear()
        self._test_graphs.clear()

    def _run_chunk(self, feed_fn: FeedFn, c: int, masks: MaskFn | None
                   ) -> np.ndarray:
        """Run iterations self.iter .. self.iter + c - 1; returns their
        (loss, lr, accepted) rows and the guard carry, read to the host in
        one transfer."""
        iter_size = self._micro_batches()
        graphs = self._graphs_ok
        stream = None
        if graphs:
            # a graph is captured, and replayed, off the default stream
            if self._stream is None:
                self._stream = torch.cuda.Stream(self.device)
            stream = self._stream
            stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream) if stream is not None \
                else nullcontext():
            # the rows go up through pinned memory without a host sync;
            # the last chunk's read-back has freed the staging rows
            self._table_host[:c].copy_(torch.from_numpy(
                lr_policy.table(self.sp, self.iter, c)))
            self._table[:c].copy_(self._table_host[:c], non_blocking=True)
            self._row.zero_()
            for i in range(c):
                it = self.iter + i
                feeds = [feed_fn(it * iter_size + m)
                         for m in range(iter_size)]
                mask = self._masks(it, masks)
                if self.gpipe is not None:
                    self._gpipe_iteration(feeds, mask)
                    continue
                graph = self._graphs.get((id(self.net), iter_size))
                if not graphs or not self._warm:
                    self._iteration(feeds, mask)
                    self._warm = True
                    continue
                if graph is None:
                    graph = self._capture(feeds, mask)
                graph.replay(feeds, mask)
                self.graph_replays += 1
            parts = [self._out[:c].reshape(-1).double()]
            if self._gs is not None:
                names = _CARRY + (_CARRY_DYN if self._dyn_scale else ())
                parts.append(torch.stack([self._gs[k].double()
                                          for k in names]))
            packed = torch.cat(parts)
        if stream is not None:
            torch.cuda.current_stream(self.device).wait_stream(stream)
        self.dispatch_count += 1
        self.host_sync_count += 1
        # a pending pass's remaining test chunks, on the card beside this
        # training chunk
        self._continue_eval()
        return packed.cpu().numpy()

    # ------------------------------------------------------------------
    def _chunk_at(self, it: int, n: int, testing: bool = True) -> int:
        """Chunk length starting at iteration `it` with `n` left (the JAX
        `_chunk_at`): min(step_chunk, distance to the next host-visible
        event). Display fires AFTER its iteration (the chunk may end ON
        it), a test pass runs BEFORE its iteration (the chunk stops just
        short), and a snapshot fires after the iteration preceding a
        multiple (the chunk ends exactly there, so snapshot/resume at
        chunk boundaries is byte-identical to K=1). testing=False (no
        test feeds given) lifts the test_interval cap."""
        sp = self.sp
        k = self.step_chunk
        if k <= 1 or self.gpipe is not None:
            # GPipe's wavefront is its own dispatch: every iteration alone
            return 1
        c = min(n, k)
        if sp.display:
            c = min(c, (-it) % sp.display + 1)
        if sp.test_interval and testing:
            c = min(c, sp.test_interval - it % sp.test_interval)
        if sp.snapshot:
            c = min(c, sp.snapshot - it % sp.snapshot)
        return max(c, 1)

    def _check_guard(self, boundary_iter: int, vals: dict) -> None:
        """The carry as of `boundary_iter`, read with the chunk's losses:
        update the telemetry and apply the divergence policy
        (guard_max_skips consecutive skips raise NumericAnomalyError)."""
        self.guard_sync_count += 1
        # max_consec is the longest burst of the run: a burst that ended
        # before this read still trips the policy
        consec = max(int(vals["consec"]), int(vals["max_consec"]))
        skips, last_bad = int(vals["skips"]), int(vals["last_bad"])
        if "scale" in vals:
            overflows, scale = int(vals["overflows"]), float(vals["scale"])
            if overflows > self.overflow_steps:
                log.warning(
                    "loss scale: %d overflow step(s) so far (+%d this "
                    "chunk), skipped and rescaled — scale now %g",
                    overflows, overflows - self.overflow_steps, scale)
            self.overflow_steps = overflows
            self.loss_scale_value = scale
        if skips > self.skipped_steps:
            log.warning(
                "train guard: %d skipped step(s) so far (+%d this chunk, "
                "last bad iteration %d, %d consecutive)", skips,
                skips - self.skipped_steps, last_bad, consec)
        self.skipped_steps = skips
        m = int(self.sp.guard_max_skips or 0)
        if m > 0 and consec >= m:
            extra = {}
            if "scale" in vals:
                extra = {"loss_scale": float(vals["scale"]),
                         "overflow_steps": int(vals["overflows"])}
            try:
                # the writer's "snapshot" entry must not land after this
                self.wait_snapshots()
            except RuntimeError:
                log.exception("snapshot writer failed before the anomaly")
            self._journal_run_state(
                "numeric_anomaly", consec_skips=consec,
                skipped_steps=skips, last_bad_iter=last_bad,
                exit_code=resilience.EXIT_NUMERIC, **extra)
            raise NumericAnomalyError(boundary_iter, consec, skips,
                                      last_bad)

    # ------------------------------------------------------------------
    # The watchdog, the run journal and the fault sites
    def _ensure_watchdog(self) -> None:
        """Arm the hard-exit watchdog when watchdog_deadline > 0, and the
        cross-host heartbeat on its thread when host_deadline > 0 in a
        run over more than one process (the JAX `_ensure_watchdog`): a
        peer silent past the deadline journals `host_lost:<peer>` and
        this process exits 87. The watchdog's thread then ticks at least
        twice a beat interval; with no watchdog_deadline its sections
        never trip."""
        if self._watchdog is not None:
            return
        deadline = float(self.sp.watchdog_deadline or 0.0)
        host_deadline = float(self.sp.host_deadline or 0.0)
        world = torch.distributed.get_world_size() \
            if self.mesh is not None else 1
        hb = None
        if host_deadline > 0 and world > 1:
            hb = resilience.HostHeartbeat(
                mesh_mod.heartbeat_transport(), self.rank, world,
                host_deadline, on_lost=self._host_lost_journal)
            log.info("cross-host heartbeat armed: %d process(es), %.1fs "
                     "deadline, %.2fs beat interval (exit %d on a lost "
                     "peer)", world, host_deadline, hb.interval,
                     resilience.EXIT_CLUSTER)
        if deadline <= 0 and hb is None:
            return
        poll = None
        if hb is not None:
            poll = hb.interval / 2.0
            if deadline > 0:
                poll = min(poll, max(deadline / 4.0, 0.05))
        self._heartbeat = hb
        self._watchdog = resilience.DispatchWatchdog(
            deadline if deadline > 0 else float("inf"),
            self._watchdog_journal, poll=poll,
            pulse=hb.tick if hb is not None else None)
        if deadline > 0:
            log.info("dispatch watchdog armed: %.1fs deadline (journals to "
                     "%s and exits %d on a stuck device wait)", deadline,
                     resilience.run_manifest_path(
                         self.sp.snapshot_prefix or "snapshot"),
                     resilience.EXIT_WATCHDOG)

    def heartbeat_farewell(self) -> None:
        """Publish the clean-departure beat. Only after the end-of-training
        barrier: peers then stop expecting beats; a failing host never
        says it, so it stays mournable."""
        if self._heartbeat is not None:
            self._heartbeat.farewell()

    def _host_lost_journal(self, peer: int, elapsed: float) -> None:
        """The heartbeat's on_lost: journal which peer went silent (every
        rank, to its own journal) before the monitor exits 87."""
        self._journal_run_state(
            f"host_lost:{int(peer)}", peer=int(peer),
            silent_s=round(elapsed, 1),
            host_deadline_s=float(self.sp.host_deadline or 0.0),
            exit_code=resilience.EXIT_CLUSTER)

    def await_host_loss(self, err: BaseException) -> None:
        """A collective failed with `err` (gloo raises at once when a peer
        process dies; the JAX collectives hang until the heartbeat trips).
        With the heartbeat armed, wait for it to name the silent peer: it
        journals `host_lost:<peer>` and exits 87 from its thread. Without
        one, or past two deadlines, raise ClusterError
        (`cluster_collective_failed`, exit 87)."""
        hb = self._heartbeat
        if hb is None:
            return
        hb.lost_event.wait(2 * hb.deadline + hb.interval + 1.0)
        raise resilience.ClusterError(
            f"a collective failed and no peer went silent within "
            f"{2 * hb.deadline:g}s: {err}",
            reason="cluster_collective_failed") from err

    def _maybe_admit_rejoin(self) -> None:
        """min_hosts' grow-back trigger (the JAX `_maybe_admit_rejoin`), at
        a snapshot boundary on rank 0. In a generation that is missing
        hosts, rank 0 watches their supervisors' beat files in the
        cluster directory: the first boundary primes their sequences (a
        frozen file of a dead incarnation is no revival), a later one
        that sees an advance journals `cluster_rejoin` and raises
        ClusterError (exit 87) on the snapshot it has just written, and
        the supervisors re-form the cluster a generation up, the host
        re-admitted, every rank resuming from this snapshot. Free when
        min_hosts is unset."""
        if not self.sp.min_hosts or self.rank != 0 or self._rejoin is False:
            return
        if self._rejoin is None:
            cdir = os.environ.get("CAFFE_TPU_CLUSTER_DIR", "")
            gen = mesh_mod.cluster_generation()
            missing: list[int] = []
            if cdir and gen is not None and gen["world_full"]:
                missing = sorted(set(range(gen["world_full"]))
                                 - set(gen["hosts"]))
            if not (cdir and missing):
                self._rejoin = False
                return
            tr = resilience.DirBeatTransport(os.path.join(cdir, "hb"))
            self._rejoin = (tr, {h: tr.latest_seq(h) for h in missing})
            return
        tr, base = self._rejoin
        back = []
        for h, primed in base.items():
            try:
                if tr.latest_seq(h) > primed:
                    back.append(h)
            except OSError:
                pass
        if not back:
            return
        # the snapshot written at this boundary is the resume target
        self.wait_snapshots()
        self._journal_run_state("cluster_rejoin", rejoining_hosts=back,
                                boundary_iter=int(self.iter))
        raise resilience.ClusterError(
            f"host(s) {back} beating again at snapshot boundary iteration "
            f"{self.iter}; exiting for the grow-back generation",
            reason="cluster_rejoin")

    def _section(self, label: str):
        """A watchdog section around one host wait on the device (a
        shared no-op when the watchdog is off; the JAX solver's
        `_guard`)."""
        wd = self._watchdog
        return resilience.NULL_SECTION if wd is None else wd.section(label)

    def _watchdog_journal(self, label: str, elapsed: float) -> None:
        self._journal_run_state(
            f"watchdog:{label}", stalled_s=round(elapsed, 1),
            deadline_s=float(self.sp.watchdog_deadline or 0.0))

    def _journal_run_state(self, reason: str, **extra) -> None:
        """Write the run journal `<prefix>.run.json` (the JAX fields:
        reason, iter, random_seed, the newest snapshot's iteration and
        state path, and `extra`), which `-resume auto` and an operator
        read after a crash. A failed write never stops training."""
        last_it, last_state = self._last_snapshot or (None, None)
        try:
            resilience.write_run_manifest(
                self._journal_prefix(), reason=reason,
                iter=int(self.iter), random_seed=int(self.sp.random_seed),
                last_snapshot_iter=last_it, last_snapshot_state=last_state,
                **extra)
        except OSError:
            log.exception("run-manifest journal failed (continuing)")

    def _fault_feed(self, feed_fn: FeedFn) -> FeedFn:
        """FAULTS.wrap_feeds cached by the feed fn's identity and the
        plane's configuration: one tuple check a step() when the sites
        are off."""
        cached = self._fault_feed_cache
        if cached is not None and cached[0] is feed_fn \
                and cached[1] == FAULTS.generation:
            return cached[2]
        wrapped = FAULTS.wrap_feeds(feed_fn)
        self._fault_feed_cache = (feed_fn, FAULTS.generation, wrapped)
        return wrapped

    def step(self, n: int, feed_fn: FeedFn, test_feed_fns=None, *,
             dropout_masks: MaskFn | None = None) -> float:
        """Run n training iterations (reference Solver::Step) in chunks
        of up to step_chunk. Returns the last iteration's loss.
        `dropout_masks(iteration, micro)` gives the masks that replace
        Dropout's draws (tests compare against another generator this
        way). Interval snapshots are written by the writer thread: the
        newest may still be landing when step returns, and is on disk
        only after `wait_snapshots`, `solve` or `close`."""
        sp = self.sp
        self._ensure_watchdog()
        feed_fn = self._fault_feed(feed_fn)
        imgs_per_iter = self._batch_images() * self._micro_batches()
        loss_val = float("nan")
        t0, it0 = time.perf_counter(), self.iter
        testing = bool(test_feed_fns)
        while n > 0:
            # test-only: the process dies at a chunk's start
            FAULTS.maybe_exit("train_abort", key=self.iter)
            if (sp.test_interval and test_feed_fns
                    and self.iter % sp.test_interval == 0
                    and (self.iter > 0 or sp.test_initialization)):
                # the asynchronous pass: harvest the previous one (its
                # chunks ran between the training chunks since), start
                # this one, and train on while it runs
                self._harvest_eval()
                self._start_eval(test_feed_fns)
            c = self._chunk_at(self.iter, n, testing)
            ts = time.perf_counter()
            # the chunk from its first launch to its read-back, a graph
            # capture included, is one dispatch the watchdog bounds
            coll0 = self.mesh.collectives.launches if self.mesh else 0
            with self._section("train dispatch"):
                FAULTS.maybe_stall("dispatch_stall")
                vals = self._run_chunk(feed_fn, c, dropout_masks)
            if self.mesh is not None:
                self._train_collectives += \
                    self.mesh.collectives.launches - coll0
                self._train_iters += c
            self.chunk_ms.append((time.perf_counter() - ts) * 1e3)
            ms = self.chunk_ms[-1] / c
            rows = vals[:3 * c].reshape(c, 3)
            for i, (loss, _, accepted) in enumerate(rows):
                self.losses.append(float(loss))
                self._loss_window.append(float(loss))
                self.iter_ms.append(ms)
                if not accepted:
                    self.skipped_iters.append(self.iter + i)
            loss_val, rate = float(rows[-1, 0]), float(rows[-1, 1])
            last_iter = self.iter + c - 1  # a chunk ends ON display iters
            if sp.display and last_iter % sp.display == 0 \
                    and self.rank == 0:
                elapsed = time.perf_counter() - t0
                done = last_iter - it0 + 1
                log.info("Iteration %d (%.4g iter/s, %.1f img/s), loss = "
                         "%.6g, lr = %.6g", last_iter,
                         done / max(elapsed, 1e-9),
                         done * imgs_per_iter / max(elapsed, 1e-9),
                         sum(self._loss_window) / len(self._loss_window),
                         rate)
            self.iter += c
            n -= c
            if self._gs is not None:
                names = _CARRY + (_CARRY_DYN if self._dyn_scale else ())
                self._check_guard(self.iter - 1,
                                  dict(zip(names, vals[3 * c:])))
            if sp.snapshot and self.iter % sp.snapshot == 0:
                # an interval snapshot does not stall the loop (the
                # reference's writes inline, solver.cpp:339-344)
                self.snapshot(block=False)
                # a degraded cluster grows back only at a snapshot
                # boundary (the snapshot just written is the resume point)
                self._maybe_admit_rejoin()
            if self.mesh is not None and \
                    self.mesh.n_data * self.mesh.n_model > 1:
                self._agree_requests()
            if self.requests["snapshot"]:
                self.requests["snapshot"] = False
                self.snapshot()
            if self.requests["stop"]:
                log.info("stop requested: stopping at iteration %d",
                         self.iter)
                break
        # a pass started in this call is harvested before it returns
        self._harvest_eval()
        return loss_val

    def _agree_requests(self) -> None:
        """A signal reaches one rank: every rank acts on a request any
        rank has (one small collective a chunk)."""
        keys = ("stop", "snapshot")
        flags = torch.tensor([float(self.requests[k]) for k in keys],
                             device=self.device)
        self.mesh.world_all_reduce_(flags)
        for k, v in zip(keys, flags.tolist()):
            self.requests[k] = v > 0

    def solve(self, feed_fn: FeedFn, test_feed_fns=None) -> float:
        """Train to max_iter (reference Solver::Solve); a stop request
        ends it early with a snapshot (solver.cpp:402-407)."""
        loss = self.step(self.sp.max_iter - self.iter, feed_fn, test_feed_fns)
        if self.requests["stop"] or self.should_snapshot_after_train():
            self.snapshot()
        self.wait_snapshots()  # interval snapshots land before return
        return loss

    def close(self) -> None:
        """Join an in-flight snapshot (re-raising its failure) and stop
        the watchdog. Training results do not depend on it."""
        try:
            self.wait_snapshots()
        finally:
            if self._pending_eval is not None:
                # step and test_all harvest what they start; no device
                # wait is added to teardown
                self._pending_eval = None
                log.warning("dropping an unharvested evaluation pass at "
                            "close")
            # no heartbeat farewell here: close also runs on a failure,
            # and a crashed host must stay mournable (the CLI says
            # farewell after the exit barrier)
            self._heartbeat = None
            if self._watchdog is not None:
                self._watchdog.stop()
                self._watchdog = None

    def should_snapshot_after_train(self) -> bool:
        """After-train snapshot, unless the interval snapshot just fired
        (reference solver.cpp:402-407)."""
        return bool(self.sp.snapshot_after_train and (
            not self.sp.snapshot or self.iter % self.sp.snapshot != 0))

    def _batch_images(self) -> int:
        for blob in self.net.feed_blobs:
            return self.net.blob_shapes[blob][0]
        return 0

    # ------------------------------------------------------------------
    # Evaluation (reference Solver::TestAll/Test, solver.cpp:439-540)
    _TEST_SUPER_BATCH_BYTES = 256 << 20  # one chunk's feeds at most

    def _test_chunk_len(self, tnet: Net, iters: int) -> int:
        """T, the test batches of one chunk (the JAX `_test_chunk_len`):
        `test_chunk` pins it; 0 takes the largest T whose feeds stay under
        _TEST_SUPER_BATCH_BYTES, at most 64."""
        k = int(self.sp.test_chunk or 0)
        if k > 0:
            return max(1, min(k, iters))
        bytes_per = 0
        for _key, (shape, kind) in tnet.feed_specs.items():
            n = 1
            for d in shape:
                n *= int(d)
            bytes_per += n * (1 if kind == "uint8" else 4)
        if not bytes_per:  # no feed specs: the feed blobs' shapes
            for b in tnet.feed_blobs:
                n = 1
                for d in tnet.blob_shapes.get(b, ()):
                    n *= int(d)
                bytes_per += n * 4
        cap = max(int(self._TEST_SUPER_BATCH_BYTES // max(bytes_per, 1)), 1)
        return max(1, min(iters, cap, 64))

    def test_all(self, test_feed_fns) -> list[dict[str, float]]:
        """Evaluate every test net, averaging each output blob's sum over
        test_iter batches (reference Solver::TestAll/Test). The direct,
        synchronous pass (the JAX `test_all`): a pass in flight is
        harvested first (its scores logged under its own iteration), then
        this one is started and harvested at once. Scores do not depend
        on the chunk length."""
        self._harvest_eval()
        self._start_eval(test_feed_fns)
        return self._harvest_eval()

    # The asynchronous pass (the JAX `_start_eval`, `_continue_eval`,
    # `_harvest_eval`). At a test_interval boundary the training loop
    # harvests the previous pass, then starts this one: the live params
    # and state buffers are copied, on the current stream, into
    # persistent copies that every test net (and every captured test
    # chunk) reads through `net.reading`, so the pass sees
    # the boundary's weights while training updates the live ones in
    # place. The first chunk is launched at the boundary, the rest right
    # after the next training chunk is launched, before its read-back
    # (`_continue_eval`, from `_run_chunk`: every feed is at hand, where
    # the JAX solver launches those its feed queue has ready), so the
    # card runs them beside that chunk. On the card the chunks run on the
    # evaluation's own stream, which waits for the current one once, after
    # the copy; each chunk's feeds are fetched on that stream (a
    # DeviceFeed then orders its upload before them) and held until the
    # harvest. The next boundary's copy waits for that stream, and the
    # harvest waits for it and reads the sums (one host read a test net a
    # pass). `eval_stall_log` keeps each pass's start and harvest ms.
    # Under a data mesh the sharded test nets' all-reduce runs at the
    # harvest; under GPipe the pass runs whole on stage 0's device.
    def _eval_device(self) -> torch.device:
        return self.gpipe.devices[0] if self.gpipe is not None \
            else self.device

    def _eval_view(self, ti: int, tnet: Net) -> list:
        """Test net `ti`'s params and buffers, each with its persistent
        copy, as `net.reading` entries ({module's dict, name, copy}),
        made once. A tensor the test nets share is copied once."""
        view = self._eval_views.get(ti)
        if view is None:
            dev = self._eval_device()
            view = []
            for module in tnet.modules():
                for d in (module._parameters, module._buffers):
                    for name, t in d.items():
                        if t is None:
                            continue
                        pair = self._eval_copies.get(id(t))
                        if pair is None:
                            pair = self._eval_copies[id(t)] = (
                                t, torch.empty_like(t, device=dev,
                                                    requires_grad=False))
                        view.append((d, name, pair[1]))
            self._eval_views[ti] = view
        return view

    @torch.no_grad()
    def _copy_eval_weights(self) -> None:
        """The point-in-time copy a pass reads, on the current stream,
        after the previous pass (which read these copies) is done."""
        for ti, tnet in enumerate(self.test_nets):
            self._eval_view(ti, tnet)
        if self._eval_stream is not None:
            torch.cuda.current_stream(self._eval_device()).wait_stream(
                self._eval_stream)
        for live, copy in self._eval_copies.values():
            copy.copy_(live.detach(), non_blocking=True)

    def _start_eval(self, test_feed_fns) -> None:
        """Start a pass at the current iteration: copy the weights, launch
        each test net's first chunk, and leave the record that
        `_continue_eval` and `_harvest_eval` take up. Its host time adds
        to eval_stall_ms."""
        t0 = time.perf_counter()
        self._copy_eval_weights()
        dev = self._eval_device()
        if dev.type == "cuda":
            if self._eval_stream is None:
                self._eval_stream = torch.cuda.Stream(dev)
            # the pass reads the copy and what came before it, nothing
            # queued after
            self._eval_stream.wait_stream(torch.cuda.current_stream(dev))
        entries = []
        for ti, tnet in enumerate(self.test_nets):
            iters = self.sp.test_iter[ti] if ti < len(self.sp.test_iter) \
                else 50
            out_blobs = self._output_blobs(tnet)
            if not out_blobs or iters == 0:
                entries.append(None)
                continue
            acc = self._test_sums.get(ti)
            if acc is None:  # the graphs add into this very tensor
                acc = self._test_sums[ti] = torch.zeros(
                    len(out_blobs), dtype=torch.float32,
                    device=self._eval_device())
            acc.zero_()
            entry = {"ti": ti, "out_blobs": out_blobs, "acc": acc,
                     "iters": iters, "next": 0, "feed_fn": test_feed_fns[ti],
                     "T": self._test_chunk_len(tnet, iters), "held": []}
            self._dispatch_eval_chunk(entry)
            entries.append(entry)
        ms = (time.perf_counter() - t0) * 1e3
        self._pending_eval = {"iter": self.iter, "entries": entries,
                              "start_ms": ms}
        self.eval_stall_ms += ms

    @torch.no_grad()
    def _dispatch_eval_chunk(self, entry) -> None:
        """Launch the next chunk of `entry`'s pass."""
        k0, ti = entry["next"], entry["ti"]
        c = min(entry["T"], entry["iters"] - k0)
        stream = self._eval_stream
        with self._section("eval dispatch"), torch.cuda.stream(stream) \
                if stream is not None else nullcontext():
            feeds = [entry["feed_fn"](k) for k in range(k0, k0 + c)]
            self._test_chunk(ti, self.test_nets[ti], feeds,
                             entry["out_blobs"], entry["acc"])
        entry["held"].append(feeds)  # read on the eval stream: held
        entry["next"] = k0 + c
        self.test_dispatch_count += 1

    def _continue_eval(self) -> None:
        """Launch the remaining chunks of the pending pass."""
        pending = self._pending_eval
        if pending is None:
            return
        for entry in pending["entries"]:
            while entry is not None and entry["next"] < entry["iters"]:
                self._dispatch_eval_chunk(entry)

    @torch.no_grad()
    def _harvest_eval(self) -> list[dict[str, float]] | None:
        """Finish the pending pass and read its scores: the rest of its
        chunks, then one host read a test net; the scores are logged
        tagged with the iteration they evaluate and appended to
        `eval_log`. None when no pass is pending. Its host time adds to
        eval_stall_ms."""
        pending = self._pending_eval
        if pending is None:
            return None
        t0 = time.perf_counter()
        self._continue_eval()
        self._pending_eval = None
        if self._eval_stream is not None:
            torch.cuda.current_stream(self._eval_device()).wait_stream(
                self._eval_stream)
        results = []
        for entry in pending["entries"]:
            if entry is None:
                results.append({})
                continue
            ti, out_blobs, iters = (entry["ti"], entry["out_blobs"],
                                    entry["iters"])
            total = entry["acc"]
            if self.test_sharded[ti]:
                # each rank's scores are its share of the global batch's
                total = self.mesh.all_reduce_(total.clone()) \
                    / self.mesh.n_data
            with self._section("eval harvest"):
                vals = total.cpu().numpy() / iters
            self.test_host_reads += 1
            self.test_pass_count += 1
            scores = {b: float(v) for b, v in zip(out_blobs, vals)}
            if self.rank == 0:
                log.info("Test net #%d, iteration %d:", ti, pending["iter"])
                for b, v in scores.items():
                    log.info("    Test net #%d: %s = %.5g", ti, b, v)
            results.append(scores)
        self.eval_log.append({"iter": pending["iter"], "scores": results})
        ms = (time.perf_counter() - t0) * 1e3
        self.eval_stall_log.append({"iter": pending["iter"],
                                    "start_ms": pending["start_ms"],
                                    "harvest_ms": ms})
        self.eval_stall_ms += ms
        return results

    def _test_chunk(self, ti: int, tnet: Net, feeds: list[dict],
                    out_blobs: list[str], acc: torch.Tensor) -> None:
        """One chunk of a test pass on the weights' copies: a forward of
        each feed, each output's sum added to `acc` in the feeds' order,
        on the current stream (the evaluation's, on the card). In the
        chunked mode on the card, once the test net has run one eager
        chunk (the capture's warm-up), a chunk is one replay of a CUDA
        graph of T forwards (one graph a chunk length), its feeds copied
        into the graph's static inputs first."""
        view = self._eval_view(ti, tnet)

        def forwards(fs):
            for f in fs:
                with reading(view):
                    blobs, _ = tnet(f)
                acc.add_(torch.stack([blobs[b].float().sum()
                                      for b in out_blobs]))
        dev = self._eval_device()
        key = (ti, len(feeds))
        if dev.type != "cuda" or not self._test_graphs_ok \
                or any(layer.host_step for layer in tnet.layers) \
                or ti not in self._test_warm:
            forwards(feeds)
            self._test_warm.add(ti)
            return
        if key not in self._test_graphs:
            static = [{k: torch.empty_like(torch.as_tensor(v), device=dev)
                       for k, v in f.items()} for f in feeds]
            graph, deltas = self._graph_of(lambda: forwards(static))
            self._test_graphs[key] = _Graph(graph, static, [], deltas)
        self._test_graphs[key].replay(feeds, [])

    @staticmethod
    def _output_blobs(net: Net) -> list[str]:
        consumed = {b for l in net.layers for b in l.lp.bottom}
        produced = [t for l in net.layers for t in l.lp.top]
        return [t for t in produced if t not in consumed]

    # ------------------------------------------------------------------
    # Snapshot / restore (reference solver.cpp:542-604): weights as a
    # .caffemodel and the solver state as a .solverstate, both binaryproto,
    # then the crc32c manifest that commits them.
    def snapshot(self, block: bool = True) -> str:
        """Write `<prefix>_iter_<N>.caffemodel`, `.solverstate` and
        `.manifest.json`; returns the state's path (block=True) or ""
        (block=False: the files are written by the writer thread, which
        `wait_snapshots` joins). The `snapshot_sync` fault site makes an
        interval snapshot block, so injected faults land at fixed
        iterations."""
        if self.snapshot_format == "ORBAX":
            return self.snapshot_sharded()
        if not block and FAULTS.fire("snapshot_sync") is not None:
            block = True
        it, step = self.iter, self._current_step()
        t0 = time.perf_counter()
        log.info("snapshot at iteration %d; kernel launches so far: %s",
                 it, json.dumps(launch_counts()))
        # ZeRO-1 slots and the params split over 'model' gathered here, on
        # the main thread, on every rank
        history = weights = None
        if mesh_mod.needs_collective_gather(self._shard_len) \
                or self.net.placement is not None:
            whole = self.full_history()
            history = [whole[k][s] for s in range(n_slots(self.type))
                       for k in self._history_keys()]
        if self.net.placement is not None:
            weights = self.net.weight_tensors(full=True)
        if self.rank != 0:
            return self._peer_snapshot(it, block)
        if block:
            self.wait_snapshots()
            with self._section("snapshot gather"):
                view = self._snapshot_view(to_host=True, history=history,
                                           weights=weights)
            path = self._write_snapshot(view, it, step)
            if self.mesh is not None:
                self._snapshot_barrier()
            ms = (time.perf_counter() - t0) * 1e3
            self.snapshot_log.append({"iter": it, "block": True,
                                      "stall_ms": ms, "write_ms": ms})
            return path
        with self._section("snapshot settle"):
            view = self._snapshot_view(to_host=False, history=history,
                                       weights=weights)
        self.wait_snapshots()  # one writer in flight: writes stay ordered
        self._barrier_pending = self.mesh is not None
        entry = {"iter": it, "block": False}
        self._snapshot_thread = threading.Thread(
            target=self._write_snapshot_guarded, args=(view, it, step, entry),
            daemon=True, name="snapshot-writer")
        self._snapshot_thread.start()
        entry["stall_ms"] = (time.perf_counter() - t0) * 1e3
        self.snapshot_log.append(entry)
        return ""

    # -- sharded snapshots (snapshot_format: ORBAX) ---------------------
    # The JAX `snapshot_native` / `restore_native`: each rank writes the
    # shards it owns, with no gather, and a restore reads the slices the
    # current mesh gives the rank, whatever mesh wrote them. The
    # directory is the port's own layout (one .npy a distinct shard and
    # SHARDED_INDEX), not orbax's tensorstore files, which need orbax.
    def _sharded_arrays(self) -> list[tuple[str, torch.Tensor, tuple, tuple]]:
        """(name, this rank's tensor, whole shape, spec) of everything a
        sharded snapshot holds: each param, its history slots and the
        state buffers. A spec names the mesh axes that split each dim
        (`mesh.Placement`); a ZeRO-1 slot's dim 0 is split over 'data'."""
        out = []
        for lname, pname, _, p in self._decls:
            spec = self.net.spec_of(lname, pname)
            full = self.net.full_shape(lname, pname, p.shape)
            out.append((f"param/{lname}/{pname}", p, full, spec))
            if self._shard_len[(lname, pname)] is not None:
                spec = (("data",),) + ((),) * (p.dim() - 1)
            for k, slot in enumerate(self.history[(lname, pname)]):
                out.append((f"history/{lname}/{pname}/{k}", slot, full,
                            spec))
        for lname, sname, buf in self.net.state_buffers():
            out.append((f"state/{lname}/{sname}", buf, tuple(buf.shape),
                        None))
        return out

    def _mesh_shape(self) -> tuple[int, int]:
        m = self.mesh
        return (1, 1) if m is None else (m.n_data, m.n_model)

    def _mesh_coords(self) -> tuple[int, int]:
        m = self.mesh
        return (0, 0) if m is None else (m.data_index, m.model_index)

    def snapshot_sharded(self) -> str:
        """Write `<prefix>_iter_<N>.orbax/` (the JAX `snapshot_native`),
        blocking: every rank writes its own shards (the one rank that
        owns each: rank 0 a whole array, a data-index-0 rank each shard
        over 'model', a model-index-0 rank each shard over 'data'), the
        ranks meet at the write barrier, then rank 0 alone commits the
        crc32c manifest (kind "orbax"), journals the run state, merges
        the quarantine journals and runs snapshot_keep. Returns the
        directory."""
        it = self.iter
        t0 = time.perf_counter()
        prefix = self.sp.snapshot_prefix or "snapshot"
        path = os.path.abspath(f"{prefix}_iter_{it}.orbax")
        self.wait_snapshots()
        if self.rank == 0:
            # a set left at this iteration (another mesh's) goes first:
            # the manifest covers every file of the directory
            mpath = resilience.manifest_for_state(path)
            if os.path.exists(mpath):
                os.remove(mpath)
            shutil.rmtree(path, ignore_errors=True)
            os.makedirs(path)
        if self.mesh is not None:
            self._snapshot_barrier()
        shape, coords = self._mesh_shape(), self._mesh_coords()
        index = {"format": "caffe_mpi_tpu_torch sharded snapshot",
                 "iteration": it, "current_step": self._current_step(),
                 "solver_type": self.type, "mesh": list(shape),
                 "arrays": []}
        if self._gs is not None:
            # the guard carry as of the snapshot (a restore starts a fresh
            # one, as a .solverstate's does)
            index["guard"] = {k: float(v) for k, v in self._gs.items()}
        with torch.no_grad():
            for i, (name, t, full, spec) in enumerate(self._sharded_arrays()):
                entry = {"name": name, "shape": list(full),
                         "dtype": str(t.dtype).replace("torch.", ""),
                         "shards": []}
                for at in _shard_owners(spec, shape):
                    fname = f"{i}.{at[0]}.{at[1]}.npy"
                    entry["shards"].append({"file": fname, "slice": [
                        list(b) for b in mesh_mod.spec_slices(
                            spec, full, shape, at)]})
                    if at == coords:
                        with resilience.atomic_output(
                                os.path.join(path, fname)) as tmp:
                            with open(tmp, "wb") as f:
                                np.save(f, t.detach().float().cpu().numpy())
                index["arrays"].append(entry)
        if self.rank == 0:
            with resilience.atomic_output(
                    os.path.join(path, SHARDED_INDEX)) as tmp:
                with open(tmp, "w") as f:
                    json.dump(index, f)
        if self.mesh is not None:
            self._snapshot_barrier()
        ms = (time.perf_counter() - t0) * 1e3
        # lint: ok(thread-shared-mutation) — blocking path: wait_snapshots()
        # above joined the writer thread, none is in flight
        self._last_snapshot = (it, path)
        if self.rank != 0:
            self.snapshot_log.append({"iter": it, "block": True,
                                      "stall_ms": ms, "write_ms": ms,
                                      "format": "ORBAX"})
            return path
        manifest = resilience.write_sharded_manifest(path, it)
        # test-only: bitrot in one shard after the commit, which a
        # restore must catch (and restore_auto fall back past)
        if FAULTS.active("snapshot_shard_corrupt"):
            FAULTS.corrupt_file("snapshot_shard_corrupt",
                                resilience.sharded_snapshot_files(path)[0])
        # lint: ok(thread-shared-mutation) — blocking path: wait_snapshots()
        # joined the writer thread before this write began
        self.snapshots.append(path)
        self._journal_run_state("snapshot")
        if self.mesh is not None and self.mesh.hosts > 1:
            resilience.merge_quarantine_journals(prefix)
        keep = int(self.sp.snapshot_keep or 0)
        if keep > 0:
            resilience.gc_snapshots(prefix, keep, assume_verified=manifest)
        ms = (time.perf_counter() - t0) * 1e3
        self.snapshot_log.append({"iter": it, "block": True, "stall_ms": ms,
                                  "write_ms": ms, "format": "ORBAX"})
        log.info("Sharded snapshot to %s (manifest %s)", path,
                 os.path.basename(manifest))
        return path

    def restore_sharded(self, path: str) -> None:
        """Restore a sharded snapshot (the JAX `restore_native`): every
        array at the current mesh's placement, each rank reading the
        slices it holds now from whichever shard files cover them."""
        path = path.rstrip("/")
        ipath = os.path.join(path, SHARDED_INDEX)
        if not os.path.exists(ipath):
            raise NotImplementedError(
                f"{path}: no {SHARDED_INDEX}: a sharded snapshot the JAX "
                "package wrote holds orbax's tensorstore files, which need "
                "orbax; restore it with the JAX package, or resume the "
                "port from one it wrote")
        with open(ipath) as f:
            index = json.load(f)
        if index.get("solver_type") != self.type:
            raise ValueError(
                f"{path}: a {index.get('solver_type')} snapshot; this "
                f"solver is {self.type}")
        arrays = {a["name"]: a for a in index["arrays"]}
        shape, coords = self._mesh_shape(), self._mesh_coords()
        with torch.no_grad():
            for name, t, full, spec in self._sharded_arrays():
                entry = arrays.get(name)
                if entry is None or tuple(entry["shape"]) != tuple(full):
                    raise ValueError(
                        f"{path}: array {name} "
                        + ("missing" if entry is None else
                           f"of shape {tuple(entry['shape'])}, want "
                           f"{tuple(full)}"))
                want = mesh_mod.spec_slices(spec, full, shape, coords)
                out = np.empty([b - a for a, b in want], np.float32)
                _read_region(path, entry["shards"], want, out)
                # in place: a captured iteration holds these very tensors
                t.copy_(torch.from_numpy(out))
            if self._gs is not None:
                for key, value in self._carry0().items():
                    self._gs[key].copy_(value)
        self.iter = int(index["iteration"])
        log.info("Restored sharded snapshot from %s (iter %d, written on a "
                 "%s mesh)", path, self.iter, index.get("mesh"))

    def _state_path(self, it: int) -> str:
        return f"{self.sp.snapshot_prefix or 'snapshot'}_iter_{it}.solverstate"

    def _peer_snapshot(self, it: int, block: bool) -> str:
        """A rank other than 0 writes nothing: it meets rank 0 at the
        snapshot barrier once rank 0's files are written (now, or at the
        next wait_snapshots for an interval snapshot)."""
        path = self._state_path(it)
        self.wait_snapshots()
        if block:
            self._snapshot_barrier()
        else:
            self._barrier_pending = True
        # lint: ok(thread-shared-mutation) — wait_snapshots() above joined
        # this rank's writer: no writer thread is in flight here
        self._last_snapshot = (it, path)
        return path if block else ""

    def _snapshot_barrier(self) -> None:
        if not mesh_mod.cluster_barrier("snapshot"):
            raise resilience.ClusterError(
                "ranks did not meet at the snapshot barrier",
                reason="cluster_snapshot_failed")

    def _history_keys(self) -> list[tuple[str, str]]:
        return [(lname, pname) for lname, pname, _, _ in self._decls]

    def _snapshot_view(self, to_host: bool, history=None,
                       weights=None) -> dict:
        """A point-in-time copy of what a snapshot writes: the weights in
        `Net.weight_tensors` form and the history in `_history_blobs`
        order. to_host: copied to the host now. Else copied on the device,
        on the current stream, which the next chunk's stream waits on
        before it replays (so the copy sees this boundary's values), with
        an event recorded after the copies for the writer to wait on."""
        done: dict[int, torch.Tensor] = {}

        def copy(t):
            if t is None:
                return None
            if id(t) not in done:  # a shared param once
                t = t.detach()
                done[id(t)] = t.to("cpu", copy=True) if to_host \
                    else t.clone()
            return done[id(t)]

        with torch.no_grad():
            weights = {name: [copy(t) for t in blobs] for name, blobs
                       in (weights or self.net.weight_tensors()).items()}
            history = [copy(t) for t in (history
                                         or self._history_tensors())]
        event = None
        if not to_host and self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
        return {"weights": weights, "history": history, "event": event}

    def _view_to_host(self, view: dict) -> dict:
        """The writer thread's copy of a device view to the host, on a
        stream of its own, after the copy's event."""
        if view["event"] is None:
            return view
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        stream = self._copy_stream
        with torch.cuda.stream(stream):
            stream.wait_event(view["event"])
            done: dict[int, torch.Tensor] = {}

            def host(t):
                if t is None:
                    return None
                if id(t) not in done:
                    done[id(t)] = t.to("cpu")
                return done[id(t)]
            out = {"weights": {name: [host(t) for t in blobs] for name, blobs
                               in view["weights"].items()},
                   "history": [host(t) for t in view["history"]],
                   "event": None}
        return out

    def wait_snapshots(self, timeout: float = 600.0) -> None:
        """Join an in-flight snapshot writer. A failed write re-raises
        with its iteration: a snapshot the user believes exists must not
        end in exit 0. The join is bounded: a writer wedged in a device
        copy fails loudly instead of hanging the exit."""
        t = self._snapshot_thread
        if t is not None:
            t.join(timeout)
            if t.is_alive():
                raise RuntimeError(
                    f"snapshot writer still running after {timeout:g}s; "
                    "the snapshot it was writing must be considered "
                    "missing")
            self._snapshot_thread = None
        if self._barrier_pending:
            self._barrier_pending = False
            self._snapshot_barrier()
        err = self._snapshot_error
        if err is not None:
            # lint: ok(thread-shared-mutation) — the writer thread was
            # joined above; the happens-before edge is the join
            self._snapshot_error = None
            it, exc = err
            raise RuntimeError(f"async snapshot failed at iteration {it}"
                               ) from exc

    def _write_snapshot_guarded(self, view: dict, it: int, step: int,
                                entry: dict) -> None:
        t0 = time.perf_counter()
        try:
            with self._section("snapshot gather"):
                view = self._view_to_host(view)
            self._write_snapshot(view, it, step)
        except BaseException as e:  # noqa: BLE001 — wait_snapshots raises
            # lint: ok(thread-shared-mutation) — one writer thread, and
            # wait_snapshots() joins it before reading or clearing this
            self._snapshot_error = (it, e)
        entry["write_ms"] = (time.perf_counter() - t0) * 1e3

    def _write_snapshot(self, view: dict, it: int, step: int) -> str:
        """The verified snapshot of a host view: each file written to a
        temporary path and moved into place, then the crc32c manifest
        last, so a kill at any point leaves a complete, verifiable
        snapshot or no manifest (and the previous one loadable). Then the
        journal's resume pointer advances and `snapshot_keep` GC runs."""
        prefix = self.sp.snapshot_prefix or "snapshot"
        os.makedirs(os.path.dirname(prefix) or ".", exist_ok=True)
        model_path = f"{prefix}_iter_{it}.caffemodel"
        with resilience.atomic_output(model_path) as tmp:
            caffe_io.save_caffemodel(
                tmp, self.net.export_weights(view["weights"]), self.net.name,
                {l.name: l.lp.type for l in self.net.layers})
        FAULTS.maybe_exit("snapshot_kill")  # test-only: die mid-snapshot
        state_path = f"{prefix}_iter_{it}.solverstate"
        with resilience.atomic_output(state_path) as tmp:
            caffe_io.save_solverstate(
                tmp, it, model_path,
                [h.float().numpy() for h in view["history"]], step)
        manifest = resilience.write_snapshot_manifest(
            state_path, it, {"model": model_path, "state": state_path})
        # test-only: bitrot after the manifest, which a load must catch
        FAULTS.corrupt_file("snapshot_corrupt", model_path)
        # lint: ok(thread-shared-mutation) — at most one snapshot writer is
        # in flight (wait_snapshots() joins the previous one before the
        # next dispatch or any blocking write starts)
        self._last_snapshot = (it, state_path)
        # lint: ok(thread-shared-mutation) — the one writer in flight, as
        # above; a sharded snapshot joins it first (wait_snapshots)
        self.snapshots.append(state_path)
        self._journal_run_state("snapshot")
        if self.mesh is not None and self.mesh.hosts > 1:
            # the hosts' quarantine journals, merged at the snapshots'
            # cadence
            resilience.merge_quarantine_journals(prefix)
        keep = int(self.sp.snapshot_keep or 0)
        if keep > 0:
            # this writer has just checksummed `manifest`'s files
            resilience.gc_snapshots(prefix, keep, assume_verified=manifest)
        log.info("Snapshotting to %s + %s (manifest %s)", model_path,
                 state_path, os.path.basename(manifest))
        return state_path

    def _history_tensors(self) -> list[torch.Tensor]:
        """Optimizer slots in the reference's flat history order: params
        in net order, slot-major (history[i + s*N] = slot s of param i;
        sgd_solver.cpp PreSolve + adam_solver.cpp:37-39)."""
        return [self.history[(lname, pname)][s]
                for s in range(n_slots(self.type))
                for lname, pname, _, _ in self._decls]

    def _history_blobs(self) -> list[np.ndarray]:
        return [h.cpu().numpy() for h in self._history_tensors()]

    def _current_step(self) -> int:
        """Reference current_step_: multistep stage index (solver.cpp)."""
        if str(self.sp.lr_policy) == "multistep":
            return sum(1 for v in self.sp.stepvalue if self.iter >= v)
        return 0

    def restore_auto(self, prefix: str | None = None) -> str | None:
        """Resume from the newest VERIFIED snapshot of `prefix` (`-resume
        auto`; the JAX `restore_auto`): manifests newest first, a corrupt
        or unloadable one logged and skipped; then manifest-less
        (legacy) snapshots, newest first, never one a manifest covers.
        Returns the state path restored, or None (a fresh start).

        Under data parallelism rank 0 chooses and publishes its choice on
        the group's store (the JAX CLI's `caffe/resume_state`); every
        other rank restores exactly that snapshot, and the replicas are
        then synchronised. No decision within CAFFE_TPU_RESUME_TIMEOUT
        (default 600 s), or a published snapshot that fails to load
        here, raises ClusterError (`cluster_resume_failed`)."""
        mesh = self.mesh
        if mesh is None or mesh.n_data * mesh.n_model == 1:
            path = self._restore_auto_local(prefix)
            self._sync_replicas()
            return path
        key = f"caffe/resume_state/{self._resume_round}"
        self._resume_round += 1
        if self.rank == 0:
            path = self._restore_auto_local(prefix)
            if not mesh_mod.cluster_kv_set(key, path or ""):
                raise resilience.ClusterError(
                    "could not publish the resume decision",
                    reason="cluster_resume_failed")
        else:
            peer = mesh_mod.cluster_kv_get(key, float(os.environ.get(
                "CAFFE_TPU_RESUME_TIMEOUT", "600") or 600))
            if peer is None:
                raise resilience.ClusterError(
                    "rank 0 never published its resume decision",
                    reason="cluster_resume_failed")
            path = peer or None
            if path:
                try:
                    self.restore(path, sync=False)
                except (resilience.SnapshotCorruptError, OSError) as e:
                    raise resilience.ClusterError(
                        f"rank 0's snapshot {path} failed to load here: "
                        f"{e}", reason="cluster_resume_failed") from e
                # lint: ok(thread-shared-mutation) — a resume runs before
                # training starts; no snapshot writer exists yet
                self._last_snapshot = (self.iter, path)
        self._sync_replicas()
        return path

    def _restore_auto_local(self, prefix: str | None) -> str | None:
        prefix = prefix or self.sp.snapshot_prefix or "snapshot"
        run = resilience.read_run_manifest(prefix)
        if run is not None:
            log.info("run manifest %s: previous run ended at iter %s "
                     "(reason %r)", resilience.run_manifest_path(prefix),
                     run.get("iter"), run.get("reason"))
        for doc in resilience.verified_snapshots(prefix):
            it = int(doc["iteration"])
            try:
                self.restore(doc["state"], verify=False, sync=False)
            except Exception:  # noqa: BLE001 — an older one is the recovery
                log.exception("verified snapshot at iter %d failed to "
                              "load; falling back", it)
                continue
            # lint: ok(thread-shared-mutation) — a resume runs before
            # training starts; no snapshot writer exists yet
            self._last_snapshot = (it, doc["state"])
            return doc["state"]
        d = os.path.dirname(prefix) or "."
        pat = re.compile(re.escape(os.path.basename(prefix) + "_iter_")
                         + r"(\d+)(\.solverstate(\.h5)?|\.orbax)$")
        cands = []
        try:
            for name in os.listdir(d):
                m = pat.match(name)
                if m:
                    cands.append((int(m.group(1)), os.path.join(d, name)))
        except OSError:
            cands = []
        for it, path in sorted(cands, reverse=True):
            mp = resilience.manifest_for_state(path)
            if mp and os.path.exists(mp):
                continue  # a manifest covers it: verified above, or failed
            try:
                self.restore(path, verify=False, sync=False)
            except Exception:  # noqa: BLE001 — an older one is the recovery
                log.exception("legacy snapshot %s failed to load; "
                              "falling back", path)
                continue
            log.warning("resumed from legacy (unverified) snapshot %s",
                        path)
            # lint: ok(thread-shared-mutation) — a resume runs before
            # training starts; no snapshot writer exists yet
            self._last_snapshot = (it, path)
            return path
        log.info("no usable snapshot under prefix %r; starting fresh",
                 prefix)
        return None

    def restore(self, path: str, *, verify: bool = True,
                sync: bool = True) -> None:
        """Resume from a .solverstate (reference Solver::Restore /
        SGDSolver::RestoreSolverStateFromBinaryProto): the iteration, the
        weights of its learned_net, and the history blobs. Where the
        snapshot has a manifest it is verified first and a mismatch
        raises SnapshotCorruptError (restore_auto falls back instead); a
        manifest-less snapshot loads unverified. Under data parallelism
        every rank restores the same path, then (sync) rank 0's values
        are broadcast; a ZeRO-1 rank keeps its shard of each slot."""
        if verify:
            mpath = resilience.manifest_for_state(path)
            if mpath is not None and os.path.exists(mpath) \
                    and resilience.verify_snapshot(mpath) is None:
                raise resilience.SnapshotCorruptError(
                    f"snapshot {path} failed crc32c verification against "
                    f"{mpath}; resume with -resume auto to fall back to "
                    "the newest prior verified snapshot")
        if path.rstrip("/").endswith(".orbax"):
            self.restore_sharded(path)
            if sync:
                self._sync_replicas()
            return
        if path.rstrip("/").endswith((".h5", ".hdf5", ".npz")):
            raise NotImplementedError(
                f"{path}: the port restores binaryproto .solverstate files "
                "only (HDF5 snapshots: ROADMAP.md §1 item 4)")
        it, learned_net, history, _ = caffe_io.load_solverstate(path)
        if learned_net:
            if not os.path.exists(learned_net):
                # stored as written, often relative to the training cwd
                cand = os.path.join(os.path.dirname(os.path.abspath(path)),
                                    os.path.basename(learned_net))
                if os.path.exists(cand):
                    learned_net = cand
            self.load_weights(learned_net, sync=False)
        n, k = len(self._decls), n_slots(self.type)
        # strict like the reference's CHECK_EQ on history size
        # (sgd_solver.cpp:324)
        if len(history) != n * k:
            raise ValueError(
                f"solverstate history has {len(history)} blobs; this solver "
                f"expects {n} params x {k} slots = {n * k} (snapshot from "
                "a different solver type?)")
        with torch.no_grad():
            # in place: a captured iteration holds these very tensors
            for i, (lname, pname, _, p) in enumerate(self._decls):
                shard = self._shard_len[(lname, pname)]
                for s, slot in enumerate(self.history[(lname, pname)]):
                    whole = np.array(history[i + s * n], np.float32).reshape(
                        self.net.full_shape(lname, pname, p.shape))
                    if shard is not None:
                        lo = self.mesh.data_index * shard
                        whole = whole[lo:lo + shard]
                    elif self.net.sharded(lname, pname):
                        whole = self.net.local_param(
                            lname, pname, torch.from_numpy(whole)).numpy()
                    slot.copy_(torch.from_numpy(whole))
            # a restored run starts with a fresh guard carry and loss
            # scale, as the JAX solver's: neither is in a .solverstate
            if self._gs is not None:
                for key, value in self._carry0().items():
                    self._gs[key].copy_(value)
        self.iter = it
        if sync:
            self._sync_replicas()
        log.info("Restored solver state from %s (iter %d)", path, it)

    def load_weights(self, path: str, sync: bool = True) -> None:
        """Finetune-style weight load (reference `caffe train -weights`):
        the train net's params and state, which the test nets share;
        then (sync) rank 0's values on every rank."""
        weights = caffe_io.load_weights(path)
        self.net.import_weights(weights)
        if sync:
            self._sync_replicas()
        log.info("Loaded weights from %s (%d layers)", path, len(weights))

