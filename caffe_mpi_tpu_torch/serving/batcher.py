"""Continuous batching — request queue, batching window, async harvest.

Port of the JAX package's caffe_mpi_tpu/serving/batcher.py, without the
stall breaker, deadlines and deferred ingest. Arrivals land in a queue; one
dispatcher thread closes a batch when either the batching window (measured
from the batch's FIRST request) expires or a full max-size bucket is
waiting, takes that model's head-of-line requests, pads them to the
smallest ladder bucket and dispatches WITHOUT waiting for the result: the
forward and the device->host copy of its scores are enqueued on the card,
and a separate harvest thread waits for the copy and resolves the futures.
The assembly of batch k+1 thus overlaps the device work of batch k.

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

from .errors import EngineClosedError, ShedError
from .plan import bucket_for

log = logging.getLogger(__name__)

_MAX_RECORDS = 10000  # telemetry ring: enough for p99 at serving rates


@dataclass
class _Request:
    model: str
    data: np.ndarray
    t_enqueue: float
    future: Future = field(default_factory=Future)


class Batcher:
    """One dispatcher thread + one harvest thread around the engine."""

    def __init__(self, engine):
        self._engine = engine
        self._pending: deque[_Request] = deque()
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
        self.max_queue_depth = 0

    # -- lifecycle ------------------------------------------------------
    def start(self) -> None:
        with self._cv:
            if self._threads or self._stop:
                return
            for name, target in (("serve-dispatch", self._dispatch_loop),
                                 ("serve-harvest", self._harvest_loop)):
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
        to resolve, then close."""
        with self._cv:
            self._draining = True
            self._cv.notify_all()  # wake the window wait to flush now
        try:
            self.drain(timeout)
        except TimeoutError:
            log.warning("serving: graceful drain timed out after %.0fs; "
                        "cancelling the stragglers", timeout)
        self.close()

    # -- submission -----------------------------------------------------
    def submit(self, model: str, data: np.ndarray) -> Future:
        with self._cv:
            if self._stop or self._draining:
                raise EngineClosedError("serving engine is closed")
            limit = self._engine.queue_limit
            if limit and len(self._pending) >= limit:
                self.shed_count += 1
                raise ShedError(
                    f"serving backlog at serve_queue_limit={limit}; "
                    "request shed")
            req = _Request(model, data, time.perf_counter())
            self._pending.append(req)
            self.max_queue_depth = max(self.max_queue_depth,
                                       len(self._pending))
            self._pending_by_model[model] = \
                self._pending_by_model.get(model, 0) + 1
            self._outstanding += 1
            self._idle.clear()
            self._cv.notify_all()
        if not self._threads:
            self.start()
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
            req = self._pending.popleft()
            (group if req.model == model else keep).append(req)
        keep.extend(self._pending)
        self._pending = keep
        left = self._pending_by_model.get(model, 0) - len(group)
        if left > 0:
            self._pending_by_model[model] = left
        else:
            self._pending_by_model.pop(model, None)
        return group

    def _dispatch_loop(self) -> None:
        with torch.inference_mode():
            while True:
                with self._cv:
                    while not self._pending and not self._stop:
                        self._cv.wait()
                    if self._stop:
                        return
                    head = self._pending[0]
                    try:
                        fwd = self._engine.model(head.model).fwd
                    except KeyError as e:
                        # unknown model: fail its queued requests, not the loop
                        group, err = self._take_group(
                            head.model, len(self._pending)), e
                    else:
                        max_bucket = fwd.ladder[-1]
                        # batching window: measured from the BATCH's first
                        # request; a full max bucket closes it early
                        deadline = head.t_enqueue + self._engine.window_ms / 1e3
                        while not self._stop and not self._draining:
                            remaining = deadline - time.perf_counter()
                            if remaining <= 0 or self._pending_by_model.get(
                                    head.model, 0) >= max_bucket:
                                break
                            self._cv.wait(timeout=remaining)
                        if self._stop:
                            return
                        group, err = self._take_group(head.model, max_bucket), None
                if err is not None:
                    self._fail(group, err)
                else:
                    self._dispatch(group)

    @staticmethod
    def _resolve(future: Future, value=None, exc: Exception | None = None
                 ) -> bool:
        """Resolve a request future, tolerating a caller-side cancel();
        returns True iff this call resolved it."""
        try:
            if future.set_running_or_notify_cancel():
                if exc is not None:
                    future.set_exception(exc)
                else:
                    future.set_result(value)
                return True
        except (InvalidStateError, RuntimeError):
            pass  # already resolved
        return False

    def _fail(self, group: list[_Request], exc: Exception) -> None:
        for r in group:
            self._resolve(r.future, exc=exc)
        self._retire(len(group))

    def _dispatch(self, group: list[_Request]) -> None:
        name = group[0].model
        t0 = time.perf_counter()
        try:
            fwd = self._engine.model(name).fwd
            batch = np.stack([r.data for r in group]).astype(
                np.float32, copy=False)
            bucket = bucket_for(len(group), fwd.ladder)
            out = fwd.run_bucket(fwd.pad(batch, bucket))
            host, done = fwd.to_host_async(out)
        except Exception as e:  # noqa: BLE001 — failures go to callers
            log.exception("serving: dispatch failed for model %r", name)
            self._fail(group, e)
            return
        with self._rec_lock:  # stats() iterates this deque concurrently
            self.dispatches.append((name, len(group), bucket))
            self.dispatch_count += 1
        self._harvest_q.put((group, host, done, t0))

    # -- harvester ------------------------------------------------------
    def _harvest_loop(self) -> None:
        while True:
            item = self._harvest_q.get()
            if item is None:
                return
            group, host, done, t_dispatch = item
            try:
                if done is not None:
                    done.synchronize()
                scores = host.numpy()
            except Exception as e:  # noqa: BLE001 — failures go to callers
                log.exception("serving: harvest failed")
                self._fail(group, e)
                continue
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
            # synchronously in this thread, and a callback reading
            # stats()/records() would re-acquire the lock
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
