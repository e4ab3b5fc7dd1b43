"""Solver — the single-device training loop.

Reference: src/caffe/solver.cpp + solvers/*; JAX package
caffe_mpi_tpu/solver/solver.py, whose jitted step holds the whole iteration.
The port runs each iteration eagerly from the host: forward and loss
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
  restore gives them back bitwise.

The loss is read back to the host every iteration, as the reference's
ForwardBackward returns it; that sync is where an iteration's wall time is
measured (`iter_ms`).

The backward runs under the TF32 switches of the net's one math precision
(`Net.math_precision`), so a prototxt's FLOAT math holds for the backward
convolutions and products as well as the forward ones.

Not ported yet (ROADMAP.md): the non-finite guard, dynamic loss scaling,
bf16 `precision`, `step_chunk`, meshes and ZeRO, gpipe, the watchdog,
snapshot manifests and HDF5 snapshots. Each of their fields is in
`UNPORTED_FIELDS`: a value other than its default raises
NotImplementedError before anything is built, so no field is accepted
and then ignored. An unknown `precision` raises ValueError, as the JAX
`Solver` does.
"""

from __future__ import annotations

import logging
import os
import time
from collections import deque
from functools import partial
from typing import Callable

import numpy as np
import torch

from .. import io as caffe_io
from ..core.device import resolve_device
from ..net import Net
from ..proto.config import (NetParameter, SolverParameter, refuse_unported,
                            solver_type)
from . import lr_policy
from .updates import UPDATE_FNS, Hyper, n_slots

log = logging.getLogger("caffe_mpi_tpu_torch.solver")

# SolverParameter fields that the JAX package honours and the port does
# not yet, each with the ROADMAP.md section 1 item that will port it.
# Fields neither package honours (solver_mode, device_id, ...) stay
# accepted.
UNPORTED_FIELDS = (
    ("precision", 4), ("loss_scale", 4), ("loss_scale_window", 4),
    ("solver_data_type", 4), ("train_guard", 4), ("guard_max_skips", 4),
    ("guard_loss_spike", 4), ("guard_ema_decay", 4), ("anomaly_action", 4),
    ("anomaly_lr_mult", 4), ("step_chunk", 4), ("test_chunk", 4),
    ("watchdog_deadline", 4), ("snapshot_keep", 4),
    ("decoded_cache_mb", 3),
    ("zero_stage", 6), ("reduce_overlap", 6), ("reduce_buckets", 6),
    ("grad_bucket_mb", 6), ("hosts", 6), ("coordinator", 6),
    ("host_deadline", 6), ("min_hosts", 6),
)
PRECISIONS = ("f32", "bf16")  # the JAX Solver's; "" is f32

FeedFn = Callable[[int], dict]
# (iteration, micro-batch) -> {dropout layer name: bool mask}
MaskFn = Callable[[int, int], dict]


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


class Solver:
    def __init__(self, sp: SolverParameter, *, model_dir: str = "",
                 device: str | torch.device = "cuda"):
        precision = str(sp.precision or "f32").lower()
        if precision not in PRECISIONS:
            raise ValueError(f"unknown precision {sp.precision!r} (expected "
                             "'f32' or 'bf16')")
        refuse_unported(sp, UNPORTED_FIELDS, "solver", precision=precision)
        self.sp = sp
        self.type = solver_type(sp)
        if self.type not in UPDATE_FNS:
            raise ValueError(f"unknown solver type {self.type!r}")
        self.update_fn = UPDATE_FNS[self.type]
        if self.type == "RMSProp":
            self.update_fn = partial(self.update_fn, rms_decay=sp.rms_decay)
        self.device = resolve_device(device)
        self.model_dir = model_dir

        ts = sp.train_state
        self.net = Net(_load_net_param(sp, "TRAIN", model_dir), "TRAIN",
                       device=self.device, level=ts.level if ts else 0,
                       stages=tuple(ts.stage) if ts else (),
                       model_dir=model_dir)
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
                stages=tuple(st.stage) if st else (), model_dir=model_dir))

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
        self.iter = 0
        self._loss_window: deque[float] = deque(maxlen=max(sp.average_loss,
                                                           1))
        self.losses: list[float] = []    # loss of every iteration run
        self.iter_ms: list[float] = []   # host wall time of each iteration

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
    def _iteration(self, feed_fn: FeedFn, masks: MaskFn | None
                   ) -> tuple[torch.Tensor, float]:
        """One training iteration (the JAX `_iteration_fn` body): returns
        (loss averaged over iter_size, the learning rate used)."""
        sp = self.sp
        iter_size = max(sp.iter_size, 1)
        grad_scale = sp.global_grad_scale if sp.global_grad_scale else 1.0
        for _, _, _, p in self._decls:
            p.grad = None
        self.generator.manual_seed((self._seed << 32) + self.iter + 1)
        total = torch.zeros((), dtype=torch.float32, device=self.device)
        with self._math.math(self.device):
            for m in range(iter_size):
                feeds = feed_fn(self.iter * iter_size + m)
                _, loss = self.net(
                    feeds, generator=self.generator,
                    dropout_masks=masks(self.iter, m) if masks else None)
                if loss.requires_grad:
                    (loss * grad_scale).backward()
                total = total + loss.detach()
        denom = iter_size * grad_scale
        grads = [p.grad / denom if p.grad is not None
                 else torch.zeros_like(p, dtype=torch.float32)
                 for _, _, _, p in self._decls]
        if sp.clip_gradients > 0:
            gnorm = torch.sqrt(sum(torch.sum(torch.square(g))
                                   for g in grads))
            scale = torch.where(gnorm > sp.clip_gradients,
                                sp.clip_gradients / gnorm, 1.0)
            grads = [g * scale for g in grads]
        rate, mom = lr_policy.schedule(sp, self.iter)
        hyper = Hyper(rate=rate, momentum=mom, momentum2=sp.momentum2,
                      delta=sp.delta, weight_decay=sp.weight_decay,
                      reg_l1=(sp.regularization_type == "L1"),
                      t=self.iter + 1)
        with torch.no_grad():
            for (lname, pname, decl, p), g in zip(self._decls, grads):
                if decl.lr_mult == 0.0:
                    continue
                key = (lname, pname)
                w, self.history[key] = self.update_fn(
                    p.float(), g, self.history[key], hyper, decl.lr_mult,
                    decl.decay_mult)
                p.copy_(w)
        return total / iter_size, rate

    def step(self, n: int, feed_fn: FeedFn, test_feed_fns=None, *,
             dropout_masks: MaskFn | None = None) -> float:
        """Run n training iterations (reference Solver::Step). Returns the
        last iteration's loss. `dropout_masks(iteration, micro)` gives the
        masks that replace Dropout's draws (tests compare against another
        generator this way)."""
        sp = self.sp
        imgs_per_iter = self._batch_images() * max(sp.iter_size, 1)
        loss_val = float("nan")
        t0, it0 = time.perf_counter(), self.iter
        for _ in range(n):
            if (sp.test_interval and test_feed_fns
                    and self.iter % sp.test_interval == 0
                    and (self.iter > 0 or sp.test_initialization)):
                self.test_all(test_feed_fns)
            ts = time.perf_counter()
            loss, rate = self._iteration(feed_fn, dropout_masks)
            loss_val = float(loss)
            self.iter_ms.append((time.perf_counter() - ts) * 1e3)
            self.losses.append(loss_val)
            self._loss_window.append(loss_val)
            if sp.display and self.iter % sp.display == 0:
                elapsed = time.perf_counter() - t0
                done = self.iter - it0 + 1
                log.info("Iteration %d (%.4g iter/s, %.1f img/s), loss = "
                         "%.6g, lr = %.6g", self.iter,
                         done / max(elapsed, 1e-9),
                         done * imgs_per_iter / max(elapsed, 1e-9),
                         sum(self._loss_window) / len(self._loss_window),
                         rate)
            self.iter += 1
            if sp.snapshot and self.iter % sp.snapshot == 0:
                self.snapshot()
        return loss_val

    def solve(self, feed_fn: FeedFn, test_feed_fns=None) -> float:
        """Train to max_iter (reference Solver::Solve)."""
        loss = self.step(self.sp.max_iter - self.iter, feed_fn, test_feed_fns)
        if self.should_snapshot_after_train():
            self.snapshot()
        return loss

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
    @torch.no_grad()
    def test_all(self, test_feed_fns) -> list[dict[str, float]]:
        """Evaluate every test net, averaging each output blob's sum over
        test_iter batches (reference Solver::TestAll/Test)."""
        results = []
        for ti, tnet in enumerate(self.test_nets):
            iters = self.sp.test_iter[ti] if ti < len(self.sp.test_iter) \
                else 50
            out_blobs = self._output_blobs(tnet)
            if not out_blobs or iters == 0:
                results.append({})
                continue
            acc = torch.zeros(len(out_blobs), dtype=torch.float32,
                              device=self.device)
            for k in range(iters):
                blobs, _ = tnet(test_feed_fns[ti](k))
                acc += torch.stack([blobs[b].float().sum()
                                    for b in out_blobs])
            vals = acc.cpu().numpy() / iters
            scores = {b: float(v) for b, v in zip(out_blobs, vals)}
            log.info("Test net #%d, iteration %d:", ti, self.iter)
            for b, v in scores.items():
                log.info("    Test net #%d: %s = %.5g", ti, b, v)
            results.append(scores)
        return results

    @staticmethod
    def _output_blobs(net: Net) -> list[str]:
        consumed = {b for l in net.layers for b in l.lp.bottom}
        produced = [t for l in net.layers for t in l.lp.top]
        return [t for t in produced if t not in consumed]

    # ------------------------------------------------------------------
    # Snapshot / restore (reference solver.cpp:542-604): weights as a
    # .caffemodel and the solver state as a .solverstate, both binaryproto,
    # each written to a temporary file and moved into place.
    def snapshot(self) -> str:
        """Write `<prefix>_iter_<N>.caffemodel` and `.solverstate`;
        returns the state's path."""
        if str(self.sp.snapshot_format).upper() != "BINARYPROTO":
            raise NotImplementedError(
                f"snapshot_format {self.sp.snapshot_format}: the port "
                "writes BINARYPROTO snapshots only")
        prefix = self.sp.snapshot_prefix or "snapshot"
        os.makedirs(os.path.dirname(prefix) or ".", exist_ok=True)
        model_path = f"{prefix}_iter_{self.iter}.caffemodel"
        caffe_io.save_caffemodel(
            model_path, self.net.export_weights(), self.net.name,
            {l.name: l.lp.type for l in self.net.layers})
        state_path = f"{prefix}_iter_{self.iter}.solverstate"
        caffe_io.save_solverstate(state_path, self.iter, model_path,
                                  self._history_blobs(),
                                  self._current_step())
        log.info("Snapshotting to %s + %s", model_path, state_path)
        return state_path

    def _history_blobs(self) -> list[np.ndarray]:
        """Optimizer slots as the reference's flat history list: params in
        net order, slot-major (history[i + s*N] = slot s of param i;
        sgd_solver.cpp PreSolve + adam_solver.cpp:37-39)."""
        out = []
        for s in range(n_slots(self.type)):
            for lname, pname, _, _ in self._decls:
                out.append(self.history[(lname, pname)][s].cpu().numpy())
        return out

    def _current_step(self) -> int:
        """Reference current_step_: multistep stage index (solver.cpp)."""
        if str(self.sp.lr_policy) == "multistep":
            return sum(1 for v in self.sp.stepvalue if self.iter >= v)
        return 0

    def restore(self, path: str) -> None:
        """Resume from a .solverstate (reference Solver::Restore /
        SGDSolver::RestoreSolverStateFromBinaryProto): the iteration, the
        weights of its learned_net, and the history blobs."""
        if path.endswith((".h5", ".hdf5", ".npz")):
            raise NotImplementedError(f"{path}: the port restores "
                                      "binaryproto .solverstate files only")
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
        for i, (lname, pname, _, p) in enumerate(self._decls):
            self.history[(lname, pname)] = tuple(
                torch.from_numpy(np.array(history[i + s * n], np.float32)
                                 .reshape(tuple(p.shape))).to(self.device)
                for s in range(k))
        self.iter = it
        log.info("Restored solver state from %s (iter %d)", path, it)

    def load_weights(self, path: str) -> None:
        """Finetune-style weight load (reference `caffe train -weights`):
        the train net's params and state, which the test nets share."""
        weights = caffe_io.load_weights(path)
        self.net.import_weights(weights)
        log.info("Loaded weights from %s (%d layers)", path, len(weights))

