"""Continuous batching — request queue, batching window, async harvest.

Port of the JAX package's caffe_mpi_tpu/serving/batcher.py. Arrivals land
in a queue; one dispatcher thread closes a batch when either the batching
window (measured from the batch's FIRST request, clamped to half of
`serve_deadline_ms`) expires or a full max-size bucket is waiting, takes
that model's head-of-line requests, fails those already past their
deadline (`_expire`), preprocesses the raw-decoded ones in one native call
(`_materialize`), pads them to the smallest ladder bucket and dispatches
WITHOUT waiting for the result: the bucket's graph replay and the
device->host copy of its scores are enqueued on the engine's serving
stream, and a separate harvest thread waits for the copy and resolves the
futures. The assembly of batch k+1 thus overlaps the device work of
batch k.

Resilience: every dispatched-but-unresolved group is registered
(`_note_inflight`), so the stall breaker can fail it from the watchdog's
monitor thread while the dispatcher is stuck (`fail_inflight`); a
dispatcher that raises fails the in-flight work typed, journals
`serve_dispatcher_crash` and re-enters its loop. The fault site
`serve_dispatch_stall` sleeps inside the dispatch section.

The dispatcher runs under its own `torch.inference_mode()`: the mode is
thread-local, so the caller's does not reach it.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future, InvalidStateError
from dataclasses import dataclass, field

import numpy as np
import torch

from ..utils.resilience import FAULTS
from .errors import (DeadlineError, EngineClosedError, EngineUnhealthyError,
                     ShedError)
from .plan import bucket_for

log = logging.getLogger(__name__)

_MAX_RECORDS = 10000  # telemetry ring: enough for p99 at serving rates


@dataclass
class _Request:
    model: str
    data: np.ndarray
    t_enqueue: float
    future: Future = field(default_factory=Future)
    # True while `data` is a raw decoded image ((3, h, w) BGR uint8) whose
    # preprocessing is deferred to the window close
    raw: bool = False


def _unhealthy() -> EngineUnhealthyError:
    return EngineUnhealthyError(
        "serving engine unhealthy (dispatch stall breaker open); "
        "request shed")


class Batcher:
    """One dispatcher thread + one harvest thread around the engine."""

    def __init__(self, engine):
        self._engine = engine
        self._pending: deque[_Request] = deque()
        # per-model pending counts (guarded by _cv): the window wait asks
        # them on every submit's notify
        self._pending_by_model: dict[str, int] = {}
        self._cv = threading.Condition()
        self._harvest_q: queue.Queue = queue.Queue()
        self._records: deque[dict] = deque(maxlen=_MAX_RECORDS)
        self._rec_lock = threading.Lock()
        # (model, real_images, bucket) per dispatch, in dispatch order;
        # dispatch_count is the all-time total
        self.dispatches: deque[tuple[str, int, int]] = deque(
            maxlen=_MAX_RECORDS)
        self.dispatch_count = 0
        self._outstanding = 0
        self._idle = threading.Event()
        self._idle.set()
        self._stop = False
        self._draining = False
        self._threads: list[threading.Thread] = []
        self.shed_count = 0
        self.deadline_count = 0
        self.max_queue_depth = 0
        # dispatched-but-unresolved groups, for the stall breaker
        self._inflight: dict[int, list[_Request]] = {}
        self._inflight_next = 0

    # -- lifecycle ------------------------------------------------------
    def _targets(self):
        return (("serve-dispatch", self._dispatch_loop),
                ("serve-harvest", self._harvest_loop))

    def start(self) -> None:
        with self._cv:
            if self._threads or self._stop:
                return
            for name, target in self._targets():
                t = threading.Thread(target=target, name=name, daemon=True)
                t.start()
                self._threads.append(t)

    def close(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()
            threads, self._threads = self._threads, []
        # join the DISPATCHER before the harvest sentinel, so an in-flight
        # dispatch's item is enqueued ahead of None and its futures resolve
        for t in threads[:1]:
            t.join(timeout=60)
            if t.is_alive():
                log.warning("serving: dispatcher still busy at close; "
                            "in-flight futures may be abandoned")
        self._harvest_q.put(None)
        for t in threads[1:]:
            t.join(timeout=60)
        # a dispatch that outlived the join enqueued after the sentinel
        while True:
            try:
                item = self._harvest_q.get_nowait()
            except queue.Empty:
                break
            if item is None:
                continue
            self._done_inflight(item[-1])
            self._engine.note_retire(item[1])
            for r in item[0]:
                self._resolve(r.future,
                              exc=EngineClosedError("serving engine closed"))
            self._retire(len(item[0]))
        with self._cv:
            while self._pending:
                self._pending.popleft().future.cancel()
                self._outstanding -= 1
            self._pending_by_model.clear()
            if self._outstanding <= 0:
                self._idle.set()  # cancelled requests never harvest

    def shutdown(self, timeout: float = 60.0) -> None:
        """Graceful drain: stop accepting new requests, make the dispatcher
        flush its open window immediately, wait for every accepted request
        to resolve, then close. Nothing admitted before the drain began
        is cancelled."""
        with self._cv:
            self._draining = True
            self._cv.notify_all()  # wake the window wait to flush now
        try:
            self.drain(timeout)
        except TimeoutError:
            log.warning("serving: graceful drain timed out after %.0fs; "
                        "cancelling the stragglers", timeout)
        self.close()

    def ensure_threads(self) -> None:
        """Recovery: respawn worker threads that died. Live threads, even
        ones stuck in a hung device call, are left alone: a second
        dispatcher would pop the queue twice."""
        with self._cv:
            if self._stop or not self._threads:
                return
            for i, (name, target) in enumerate(self._targets()):
                if self._threads[i].is_alive():
                    continue
                t = threading.Thread(target=target, name=name, daemon=True)
                t.start()
                self._threads[i] = t
                log.warning("serving: respawned dead %s thread", name)

    # -- submission -----------------------------------------------------
    def submit(self, model: str, data: np.ndarray,
               raw_mode: bool = False) -> Future:
        with self._cv:
            if self._stop or self._draining:
                raise EngineClosedError("serving engine is closed")
            if not self._engine.healthy:
                # re-checked under _cv: a request that lands in _pending
                # after fail_inflight drained it would wait forever behind
                # a stuck dispatcher
                self._engine.note_unhealthy_shed()
                raise _unhealthy()
            limit = self._engine.queue_limit
            if limit and len(self._pending) >= limit:
                self.shed_count += 1
                raise ShedError(
                    f"serving backlog at serve_queue_limit={limit}; "
                    "request shed")
            if not self._threads:
                # lint: ok(lock-order) — Condition() wraps an RLock:
                # start() re-enters _cv on this thread, which cannot block
                self.start()
            # the request (and its Future) is made only after every
            # refusal above, so a refused submit strands no future
            req = _Request(model, data, time.perf_counter(), raw=raw_mode)
            self._pending.append(req)
            self.max_queue_depth = max(self.max_queue_depth,
                                       len(self._pending))
            self._pending_by_model[model] = \
                self._pending_by_model.get(model, 0) + 1
            self._outstanding += 1
            self._idle.clear()
            self._cv.notify_all()
        return req.future

    def drain(self, timeout: float = 60.0) -> None:
        """Block until every submitted request has been harvested."""
        if not self._idle.wait(timeout):
            raise TimeoutError(
                f"serving drain: requests still in flight after {timeout}s")

    # -- dispatcher -----------------------------------------------------
    def _take_group(self, model: str, max_bucket: int) -> list[_Request]:
        """Pop up to max_bucket head-of-line requests for `model`,
        preserving the arrival order of every other model. Caller holds
        _cv."""
        group, keep = [], deque()
        while self._pending and len(group) < max_bucket:
            # lint: ok(thread-shared-mutation) — caller holds _cv: the
            # dispatcher pops the queue inside its condition-variable span
            # (_dispatch_loop)
            req = self._pending.popleft()
            (group if req.model == model else keep).append(req)
        keep.extend(self._pending)
        # lint: ok(thread-shared-mutation) — caller holds _cv (as above)
        self._pending = keep
        if group:
            left = self._pending_by_model.get(model, 0) - len(group)
            if left > 0:
                # lint: ok(thread-shared-mutation) — caller holds _cv
                self._pending_by_model[model] = left
            else:
                # lint: ok(thread-shared-mutation) — caller holds _cv
                self._pending_by_model.pop(model, None)
        return group

    def _expire(self, group: list[_Request]) -> list[_Request]:
        """Deadline check at window close: requests that can no longer
        dispatch within `serve_deadline_ms` of their arrival fail with a
        typed DeadlineError instead of riding a batch whose result they
        would discard. Free when the knob is off."""
        dl_ms = self._engine.deadline_ms
        if not dl_ms:
            return group
        now = time.perf_counter()
        live = []
        for r in group:
            aged = (now - r.t_enqueue) * 1e3
            if aged > dl_ms:
                self.deadline_count += 1
                self._resolve(r.future, exc=DeadlineError(
                    f"request aged {aged:.0f}ms past "
                    f"serve_deadline_ms={dl_ms:g} before dispatch"))
                self._retire(1)
            else:
                live.append(r)
        return live

    def _dispatch_loop(self) -> None:
        """Crash containment: a dispatcher that died silently would park
        the whole backlog behind a thread that no longer exists. A crash
        fails the in-flight work typed, journals, and re-enters the loop
        (fail_inflight drained the backlog, so a poison request cannot
        spin it)."""
        with torch.inference_mode():
            while True:
                try:
                    self._dispatch_forever()
                    return  # clean _stop exit
                except Exception as e:  # the worker must not die silently
                    log.exception("serving: dispatcher crashed; failing "
                                  "in-flight requests and re-entering")
                    self.fail_inflight(EngineUnhealthyError(
                        f"serving dispatcher crashed: {e}"))
                    self._engine._journal("serve_dispatcher_crash",
                                          error=str(e))

    def _dispatch_forever(self) -> None:
        while True:
            with self._cv:
                while not self._pending and not self._stop:
                    self._cv.wait()
                if self._stop:
                    return
                head = self._pending[0]
                try:
                    max_bucket = self._engine.model(head.model).fwd.ladder[-1]
                except KeyError:
                    max_bucket = len(self._pending)  # _dispatch fails them
                # the window is clamped to half of the deadline, so a batch
                # closes with dispatch margin in hand
                window_s = self._engine.window_ms / 1e3
                if self._engine.deadline_ms:
                    window_s = min(window_s, self._engine.deadline_ms / 2e3)
                deadline = head.t_enqueue + window_s
                while not self._stop and not self._draining:
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0 or self._pending_by_model.get(
                            head.model, 0) >= max_bucket:
                        break
                    self._cv.wait(timeout=remaining)
                if self._stop:
                    return
                group = self._take_group(head.model, max_bucket)
            group = self._expire(group)
            if group:
                self._dispatch(group)

    @staticmethod
    def _resolve(future: Future, value=None, exc: Exception | None = None
                 ) -> bool:
        """Resolve a request future, tolerating a caller-side cancel() and
        an earlier resolution (the stall breaker may have failed it from
        the monitor thread: the first resolution wins). Returns True iff
        this call resolved it."""
        if future.done() and not future.cancelled():
            return False
        try:
            if future.set_running_or_notify_cancel():
                if exc is not None:
                    future.set_exception(exc)
                else:
                    future.set_result(value)
                return True
        except (InvalidStateError, RuntimeError):
            pass  # resolved by the breaker or a racing peer
        return False

    def _fail(self, group: list[_Request], exc: Exception) -> None:
        for r in group:
            self._resolve(r.future, exc=exc)
        self._retire(len(group))

    def fail_inflight(self, exc: Exception) -> int:
        """Stall-breaker path: fail every dispatched-but-unresolved
        request future with `exc`, and the whole queued backlog, whose
        dispatcher is the very thread that is stuck. Called from the
        watchdog's monitor thread. In-flight counts are not retired here
        (if the stuck call returns, the harvest retires them and its own
        resolves do nothing); the drained backlog has no other owner, so
        it retires here."""
        with self._cv:
            groups = [list(g) for g in self._inflight.values()]
            backlog = list(self._pending)
            self._pending.clear()
            self._pending_by_model.clear()
        failed = 0
        for r in [r for g in groups for r in g] + backlog:
            if self._resolve(r.future, exc=exc):
                failed += 1
        if backlog:
            self._retire(len(backlog))
        return failed

    def _note_inflight(self, group: list[_Request]) -> int:
        with self._cv:
            token = self._inflight_next
            self._inflight_next += 1
            self._inflight[token] = group
        return token

    def _done_inflight(self, token: int) -> None:
        with self._cv:
            self._inflight.pop(token, None)

    def _dispatch(self, group: list[_Request]) -> None:
        if not self._engine.healthy:
            # breaker open: a live dispatcher must not feed work into a
            # stuck device
            self._fail(group, _unhealthy())
            return
        try:
            # re-resolve by name: a reload during the open window
            # dispatches on the current model
            model = self._engine.model(group[0].model)
        except Exception as e:  # noqa: BLE001 — failures go to callers
            self._fail(group, e)
            return
        maxb = model.fwd.ladder[-1]
        for start in range(0, len(group), maxb):
            self._dispatch_one(model, group[start:start + maxb])

    def _materialize(self, model, group: list[_Request]) -> list[_Request]:
        """Window-fused preprocessing: deferred raw-decoded requests become
        net input rows here, one GIL-released native call for the window
        (serving/ingest.py), outside every lock. A record whose
        preprocessing fails fails only its own future."""
        idx = [i for i, r in enumerate(group) if r.raw]
        if not idx:
            return group
        from . import ingest as _ingest
        rows, errs = _ingest.preprocess_rows(
            model, [group[i].data for i in idx], self._engine.ingest)
        dead = set()
        for j, i in enumerate(idx):
            if errs[j] is not None:
                self._resolve(group[i].future, exc=errs[j])
                self._retire(1)
                dead.add(i)
            else:
                group[i].data = rows[j]
                group[i].raw = False
        if not dead:
            return group
        return [r for i, r in enumerate(group) if i not in dead]

    def _dispatch_one(self, model, group: list[_Request]) -> None:
        group = self._materialize(model, group)
        if not group:
            return
        name = group[0].model
        t0 = time.perf_counter()
        noted = False
        # registered BEFORE the device call: a stall inside it is exactly
        # when the breaker needs these futures
        token = self._note_inflight(group)
        if not self._engine.healthy:
            # re-checked after registration: a trip between _dispatch's
            # check and _note_inflight snapshotted _inflight without it
            self._done_inflight(token)
            self._fail(group, _unhealthy())
            return
        try:
            batch = np.stack([r.data for r in group]).astype(
                np.float32, copy=False)
            bucket = bucket_for(len(group), model.fwd.ladder)
            padded = model.fwd.pad(batch, bucket)
            # residency per dispatch: a spilled model uploads its weights
            # and recaptures its graphs here (LRU may spill another);
            # mark_in_flight pins it until the harvest retires the bucket
            with self._engine.dispatch_section(f"dispatch:{name}"):
                FAULTS.maybe_stall("serve_dispatch_stall")
                self._engine._make_resident(model, mark_in_flight=True)
                noted = True
                host, done = model.fwd.run_bucket_to_host(padded)
        except Exception as e:  # noqa: BLE001 — failures go to callers
            self._done_inflight(token)
            if noted:
                self._engine.note_retire(model)
            log.exception("serving: dispatch failed for model %r", name)
            self._fail(group, e)
            return
        with self._rec_lock:  # stats() iterates this deque concurrently
            self.dispatches.append((name, len(group), bucket))
            self.dispatch_count += 1
        self._harvest_q.put((group, model, host, done, t0, token))

    # -- harvester ------------------------------------------------------
    def _harvest_loop(self) -> None:
        while True:
            # lint: ok(deadline-discipline) — a sentinel-woken idle park:
            # close() enqueues None
            item = self._harvest_q.get()
            if item is None:
                return
            group, model, host, done, t_dispatch, token = item
            try:
                with self._engine.dispatch_section(
                        f"harvest:{group[0].model}"):
                    if done is not None:
                        done.synchronize()
                    # lint: ok(host-sync) — `host` is the pinned copy the
                    # harvest already waited on
                    scores = host.numpy()
            except Exception as e:  # noqa: BLE001 — failures go to callers
                self._done_inflight(token)
                self._engine.note_retire(model)
                log.exception("serving: harvest failed")
                self._fail(group, e)
                continue
            self._done_inflight(token)
            self._engine.note_retire(model)
            t_done = time.perf_counter()
            with self._rec_lock:
                for r in group:
                    self._records.append({
                        "model": r.model,
                        "t_enqueue": r.t_enqueue,
                        "t_done": t_done,
                        "queue_ms": (t_dispatch - r.t_enqueue) * 1e3,
                        "infer_ms": (t_done - t_dispatch) * 1e3,
                        "total_ms": (t_done - r.t_enqueue) * 1e3,
                    })
            # resolve OUTSIDE _rec_lock: set_result runs done-callbacks
            # in this thread, and one reading stats() takes the lock
            for i, r in enumerate(group):
                self._resolve(r.future, scores[i].copy())
            self._retire(len(group))

    def _retire(self, n: int) -> None:
        with self._cv:
            self._outstanding -= n
            if self._outstanding <= 0:
                self._idle.set()

    def records(self) -> list[dict]:
        with self._rec_lock:
            return list(self._records)

    def dispatch_snapshot(self) -> list[tuple[str, int, int]]:
        with self._rec_lock:
            return list(self.dispatches)
