"""Solver — the single-device training loop.

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
- the fault sites `train_abort` (each chunk's start), `dispatch_stall`
  (inside a chunk's section), `nan_grad` / `loss_spike` (the feeds),
  `snapshot_sync`, `snapshot_kill` and `snapshot_corrupt`;
- `requests`: flags a signal handler sets ("stop", "snapshot"), acted on
  at the next chunk boundary.

Not ported yet (ROADMAP.md): meshes and ZeRO, gpipe, HDF5 snapshots and
the asynchronous evaluation that overlaps training. Each of their fields
is in `UNPORTED_FIELDS` (`snapshot_format` other than BINARYPROTO is
refused the same way): a value other than its default raises
NotImplementedError before anything is built, so no field is accepted
and then ignored. An unknown `precision` raises ValueError, as the JAX
`Solver` does.
"""

from __future__ import annotations

import json
import logging
import os
import re
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
from ..net import Net
from ..ops import launch_counters, launch_counts
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
UNPORTED_FIELDS = (
    ("zero_stage", 6), ("reduce_overlap", 6), ("reduce_buckets", 6),
    ("grad_bucket_mb", 6), ("hosts", 6), ("coordinator", 6),
    ("host_deadline", 6), ("min_hosts", 6),
)
PRECISIONS = ("f32", "bf16")  # the JAX Solver's; "" is f32
# snapshot formats the port does not write yet, with their ROADMAP.md
# section 1 item
UNPORTED_SNAPSHOT_FORMATS = {"HDF5": 4, "ORBAX": 6}
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
                 device: str | torch.device = "cuda"):
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
        fmt = str(sp.snapshot_format or "BINARYPROTO").upper()
        if fmt in UNPORTED_SNAPSHOT_FORMATS:
            raise NotImplementedError(
                f"solver field snapshot_format: {fmt} snapshots are not "
                "ported yet (ROADMAP.md §1 item "
                f"{UNPORTED_SNAPSHOT_FORMATS[fmt]}); the port writes "
                "BINARYPROTO snapshots")
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
        self.device = resolve_device(device)
        self.model_dir = model_dir
        self.precision = precision
        self._ls_window = lsw if lsw > 0 else 200
        # dynamic scaling is a bf16 mechanism; the f32 path scales by 1
        self._dyn_scale = precision == "bf16" and ls == 0
        self._static_scale = ls if (precision == "bf16" and ls > 0) else 1.0
        self._guard_on = bool(sp.train_guard) or self._dyn_scale
        self.step_chunk = max(int(sp.step_chunk or 1), 1)

        ts = sp.train_state
        self.net = Net(_load_net_param(sp, "TRAIN", model_dir), "TRAIN",
                       device=self.device, level=ts.level if ts else 0,
                       stages=tuple(ts.stage) if ts else (),
                       model_dir=model_dir,
                       solver_storage=sp.solver_data_type,
                       precision=precision)
        # the one TF32 setting the backward runs under (raises on a mix)
        self.net.math_precision()
        self._math = self.net.layers[0].policy
        self.test_nets: list[Net] = []
        n_tests = max(len(sp.test_net), len(sp.test_net_param),
                      1 if (sp.net or sp.net_param is not None)
                      and sp.test_iter else 0)
        for i in range(n_tests):
            st = sp.test_state[i] if i < len(sp.test_state) else None
            self.test_nets.append(Net(
                _load_net_param(sp, "TEST", model_dir, i), "TEST",
                device=self.device, level=st.level if st else 0,
                stages=tuple(st.stage) if st else (), model_dir=model_dir,
                precision=precision))

        seed = sp.random_seed if sp.random_seed >= 0 else 0
        self.net.init(seed)
        for tnet in self.test_nets:
            self._share_params(tnet)
        # owned learnable params in declaration order — the history order
        self._decls = [(lname, pname, decl,
                        getattr(self.net.layer_by_name(lname), pname))
                       for lname, pname, decl
                       in self.net.learnable_param_decls()]
        k = n_slots(self.type)
        self.history: dict[tuple[str, str], tuple[torch.Tensor, ...]] = {}
        for lname, pname, decl, p in self._decls:
            p.requires_grad_(decl.lr_mult != 0.0)
            self.history[(lname, pname)] = tuple(
                torch.zeros(p.shape, dtype=torch.float32, device=self.device)
                for _ in range(k))
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
        self._graphs_ok = self.device.type == "cuda" and not host
        if host and self.step_chunk > 1:
            log.info("net %s has host layers (%s): step_chunk %d runs each "
                     "chunk as %d eager iterations, one host read-back a "
                     "chunk", self.net.name, ", ".join(host),
                     self.step_chunk, self.step_chunk)
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
        # survivability: the watchdog (armed at the first step when
        # watchdog_deadline > 0), the cached fault-site feed wrapper, the
        # newest snapshot written (iteration, state path), the writer
        # thread and its error, the state paths written, each snapshot's
        # timing, and the flags a signal handler sets
        self._watchdog: resilience.DispatchWatchdog | None = None
        self._fault_feed_cache = None
        self._last_snapshot: tuple[int, str] | None = None
        self._snapshot_thread: threading.Thread | None = None
        self._snapshot_error: tuple[int, BaseException] | None = None
        self._copy_stream = None
        self.snapshots: list[str] = []
        self.snapshot_log: list[dict] = []
        self.requests = {"stop": False, "snapshot": False}

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
        reseeded from (random_seed, it), in micro-batch and layer order."""
        iter_size = max(self.sp.iter_size, 1)
        if masks is not None:
            return [masks(it, m) for m in range(iter_size)]
        if not self._droppers:
            return [{} for _ in range(iter_size)]
        self.generator.manual_seed((self._seed << 32) + it + 1)
        return [{layer.name: layer.draw_mask(self.generator)
                 for layer in self._droppers} for _ in range(iter_size)]

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
        for _, _, _, p in self._decls:
            p.grad = None
        total = torch.zeros((), dtype=torch.float32, device=self.device)
        with self._math.math(self.device):
            for m in range(iter_size):
                _, loss = self.net(feeds[m], dropout_masks=masks[m])
                if loss.requires_grad:
                    (loss * eff_scale).backward()
                total = total + loss.detach()
        # the unscale divides after the cast to float32
        denom = iter_size * eff_scale
        grads = [p.grad.float() / denom if p.grad is not None
                 else torch.zeros_like(p, dtype=torch.float32)
                 for _, _, _, p in self._decls]
        if sp.clip_gradients > 0:
            gnorm = torch.sqrt(sum(torch.sum(torch.square(g))
                                   for g in grads))
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
                w, slots2 = self.update_fn(p.float(), g, slots, hyper,
                                           decl.lr_mult, decl.decay_mult)
                new.append((lname, pname, p, w.to(p.dtype), slots2))
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

    @staticmethod
    def _graph_of(fn) -> tuple[torch.cuda.CUDAGraph, dict]:
        """Capture what `fn` queues as a CUDA graph on the current stream.
        The launch counts the capture raised are taken back; the graph
        adds them at every replay."""
        counters = launch_counters()
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
        return self._graphs[key]

    def _run_chunk(self, feed_fn: FeedFn, c: int, masks: MaskFn | None
                   ) -> np.ndarray:
        """Run iterations self.iter .. self.iter + c - 1; returns their
        (loss, lr, accepted) rows and the guard carry, read to the host in
        one transfer."""
        iter_size = max(self.sp.iter_size, 1)
        graphs = self._graphs_ok and self.step_chunk > 1
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
        if k <= 1:
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
        """Arm the hard-exit watchdog when watchdog_deadline > 0."""
        deadline = float(self.sp.watchdog_deadline or 0.0)
        if self._watchdog is not None or deadline <= 0:
            return
        self._watchdog = resilience.DispatchWatchdog(
            deadline, self._watchdog_journal)
        log.info("dispatch watchdog armed: %.1fs deadline (journals to %s "
                 "and exits %d on a stuck device wait)", deadline,
                 resilience.run_manifest_path(
                     self.sp.snapshot_prefix or "snapshot"),
                 resilience.EXIT_WATCHDOG)

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
                self.sp.snapshot_prefix or "snapshot", reason=reason,
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
        imgs_per_iter = self._batch_images() * max(sp.iter_size, 1)
        loss_val = float("nan")
        t0, it0 = time.perf_counter(), self.iter
        testing = bool(test_feed_fns)
        while n > 0:
            # test-only: the process dies at a chunk's start
            FAULTS.maybe_exit("train_abort", key=self.iter)
            if (sp.test_interval and test_feed_fns
                    and self.iter % sp.test_interval == 0
                    and (self.iter > 0 or sp.test_initialization)):
                self.test_all(test_feed_fns)
            c = self._chunk_at(self.iter, n, testing)
            ts = time.perf_counter()
            # the chunk from its first launch to its read-back, a graph
            # capture included, is one dispatch the watchdog bounds
            with self._section("train dispatch"):
                FAULTS.maybe_stall("dispatch_stall")
                vals = self._run_chunk(feed_fn, c, dropout_masks)
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
            if sp.display and last_iter % sp.display == 0:
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
            if self.requests["snapshot"]:
                self.requests["snapshot"] = False
                self.snapshot()
            if self.requests["stop"]:
                log.info("stop requested: stopping at iteration %d",
                         self.iter)
                break
        return loss_val

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

    @torch.no_grad()
    def test_all(self, test_feed_fns) -> list[dict[str, float]]:
        """Evaluate every test net, averaging each output blob's sum over
        test_iter batches (reference Solver::TestAll/Test), in chunks of
        `_test_chunk_len` batches (`_test_chunk`), each output's sum added
        on the device; one host read a test net a pass. The scores do not
        depend on the chunk length."""
        results = []
        for ti, tnet in enumerate(self.test_nets):
            iters = self.sp.test_iter[ti] if ti < len(self.sp.test_iter) \
                else 50
            out_blobs = self._output_blobs(tnet)
            if not out_blobs or iters == 0:
                results.append({})
                continue
            acc = self._test_sums.get(ti)
            if acc is None:  # the graphs add into this very tensor
                acc = self._test_sums[ti] = torch.zeros(
                    len(out_blobs), dtype=torch.float32, device=self.device)
            acc.zero_()
            t = self._test_chunk_len(tnet, iters)
            for k0 in range(0, iters, t):
                with self._section("eval dispatch"):
                    feeds = [test_feed_fns[ti](k)
                             for k in range(k0, min(k0 + t, iters))]
                    self._test_chunk(ti, tnet, feeds, out_blobs, acc)
                self.test_dispatch_count += 1
            with self._section("eval harvest"):
                vals = acc.cpu().numpy() / iters
            self.test_host_reads += 1
            self.test_pass_count += 1
            scores = {b: float(v) for b, v in zip(out_blobs, vals)}
            log.info("Test net #%d, iteration %d:", ti, self.iter)
            for b, v in scores.items():
                log.info("    Test net #%d: %s = %.5g", ti, b, v)
            results.append(scores)
        return results

    def _test_chunk(self, ti: int, tnet: Net, feeds: list[dict],
                    out_blobs: list[str], acc: torch.Tensor) -> None:
        """One chunk of a test pass: a forward of each feed, each output's
        sum added to `acc` in the feeds' order. In the chunked mode on the
        card, once the test net has run one eager chunk (the capture's
        warm-up), a chunk is one replay of a CUDA graph of T forwards (one
        graph a chunk length) on the solver's side stream, its feeds
        copied into the graph's static inputs first."""
        def forwards(fs):
            for f in fs:
                blobs, _ = tnet(f)
                acc.add_(torch.stack([blobs[b].float().sum()
                                      for b in out_blobs]))
        if self.device.type != "cuda" or self.step_chunk <= 1 \
                or any(layer.host_step for layer in tnet.layers):
            forwards(feeds)
            return
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        stream = self._stream
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            key = (ti, len(feeds))
            if ti not in self._test_warm:
                forwards(feeds)
                self._test_warm.add(ti)
            else:
                if key not in self._test_graphs:
                    static = [{k: torch.empty_like(torch.as_tensor(v),
                                                   device=self.device)
                               for k, v in f.items()} for f in feeds]
                    graph, deltas = self._graph_of(
                        lambda: forwards(static))
                    self._test_graphs[key] = _Graph(graph, static, [],
                                                    deltas)
                self._test_graphs[key].replay(feeds, [])
        torch.cuda.current_stream(self.device).wait_stream(stream)

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
        if not block and FAULTS.fire("snapshot_sync") is not None:
            block = True
        it, step = self.iter, self._current_step()
        t0 = time.perf_counter()
        log.info("snapshot at iteration %d; kernel launches so far: %s",
                 it, json.dumps(launch_counts()))
        if block:
            self.wait_snapshots()
            with self._section("snapshot gather"):
                view = self._snapshot_view(to_host=True)
            path = self._write_snapshot(view, it, step)
            ms = (time.perf_counter() - t0) * 1e3
            self.snapshot_log.append({"iter": it, "block": True,
                                      "stall_ms": ms, "write_ms": ms})
            return path
        with self._section("snapshot settle"):
            view = self._snapshot_view(to_host=False)
        self.wait_snapshots()  # one writer in flight: writes stay ordered
        entry = {"iter": it, "block": False}
        self._snapshot_thread = threading.Thread(
            target=self._write_snapshot_guarded, args=(view, it, step, entry),
            daemon=True, name="snapshot-writer")
        self._snapshot_thread.start()
        entry["stall_ms"] = (time.perf_counter() - t0) * 1e3
        self.snapshot_log.append(entry)
        return ""

    def _snapshot_view(self, to_host: bool) -> dict:
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
                       in self.net.weight_tensors().items()}
            history = [copy(t) for t in self._history_tensors()]
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
        err = self._snapshot_error
        if err is not None:
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
        self._last_snapshot = (it, state_path)
        self.snapshots.append(state_path)
        self._journal_run_state("snapshot")
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
        Returns the state path restored, or None (a fresh start)."""
        prefix = prefix or self.sp.snapshot_prefix or "snapshot"
        run = resilience.read_run_manifest(prefix)
        if run is not None:
            log.info("run manifest %s: previous run ended at iter %s "
                     "(reason %r)", resilience.run_manifest_path(prefix),
                     run.get("iter"), run.get("reason"))
        for doc in resilience.verified_snapshots(prefix):
            it = int(doc["iteration"])
            try:
                self.restore(doc["state"], verify=False)
            except Exception:  # noqa: BLE001 — an older one is the recovery
                log.exception("verified snapshot at iter %d failed to "
                              "load; falling back", it)
                continue
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
                self.restore(path, verify=False)
            except Exception:  # noqa: BLE001 — an older one is the recovery
                log.exception("legacy snapshot %s failed to load; "
                              "falling back", path)
                continue
            log.warning("resumed from legacy (unverified) snapshot %s",
                        path)
            self._last_snapshot = (it, path)
            return path
        log.info("no usable snapshot under prefix %r; starting fresh",
                 prefix)
        return None

    def restore(self, path: str, *, verify: bool = True) -> None:
        """Resume from a .solverstate (reference Solver::Restore /
        SGDSolver::RestoreSolverStateFromBinaryProto): the iteration, the
        weights of its learned_net, and the history blobs. Where the
        snapshot has a manifest it is verified first and a mismatch
        raises SnapshotCorruptError (restore_auto falls back instead); a
        manifest-less snapshot loads unverified."""
        if verify:
            mpath = resilience.manifest_for_state(path)
            if mpath is not None and os.path.exists(mpath) \
                    and resilience.verify_snapshot(mpath) is None:
                raise resilience.SnapshotCorruptError(
                    f"snapshot {path} failed crc32c verification against "
                    f"{mpath}; resume with -resume auto to fall back to "
                    "the newest prior verified snapshot")
        if path.rstrip("/").endswith((".h5", ".hdf5", ".npz", ".orbax")):
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
            self.load_weights(learned_net)
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
                for s, slot in enumerate(self.history[(lname, pname)]):
                    slot.copy_(torch.from_numpy(np.array(
                        history[i + s * n], np.float32).reshape(
                            tuple(p.shape))))
            # a restored run starts with a fresh guard carry and loss
            # scale, as the JAX solver's: neither is in a .solverstate
            if self._gs is not None:
                for key, value in self._carry0().items():
                    self._gs[key].copy_(value)
        self.iter = it
        log.info("Restored solver state from %s (iter %d)", path, it)

    def load_weights(self, path: str) -> None:
        """Finetune-style weight load (reference `caffe train -weights`):
        the train net's params and state, which the test nets share."""
        weights = caffe_io.load_weights(path)
        self.net.import_weights(weights)
        log.info("Loaded weights from %s (%d layers)", path, len(weights))

