"""Verified hot swap — the train-to-serve loop.

The port's copy of the JAX package's `caffe_mpi_tpu/serving/watch.py`.
Reference Caffe has no online model update: a retrained net reaches its
server by a restart with new weights (examples/web_demo/app.py reads
--pretrained_model once). Training here publishes verified snapshots
(utils/resilience.py: the crc32c manifest written last is the commit
record), so a serving engine can take them as a swap feed.

`SnapshotWatcher` tails a training run's snapshot prefix (a directory
listing of its manifests; no file is read until a new iteration appears)
and hot-swaps each newly verified snapshot into a serving engine:

1. verify first: `resilience.verify_snapshot` checks every crc32c before
   a byte reaches the engine; a torn or rotten snapshot is journaled as a
   rejection and skipped, never served (the `swap_corrupt` fault site);
2. the canary: `ServingEngine.swap_weights` copies the candidate into
   the live tensors and replays the smallest bucket's graph; non-finite
   or wrong-shaped scores roll the swap back (`swap_canary_bad`);
3. no capture: the weights are copied into the tensors the CUDA graphs
   address, so the graphs stay valid and `compile_count` does not move.
   A model the LRU has spilled is made resident first (the engine pins
   it for the swap), so a swap never writes into freed storage.

Sharded (.orbax) snapshot sets carry no flat `.caffemodel`: the watcher
skips them with one warning.
"""

from __future__ import annotations

import json
import logging
import os
import threading

from ..utils import resilience
from ..utils.resilience import FAULTS
from .errors import SwapError

log = logging.getLogger(__name__)


class SnapshotWatcher:
    """Tail `<prefix>`'s verified snapshots and hot-swap them into
    `engine`'s model `name`. `min_iter` skips snapshots at or below it.
    Rejected iterations (corrupt bytes, a failed canary) are remembered,
    so bitrot, which never heals, is not rejected again at every poll."""

    def __init__(self, engine, name: str, prefix: str, *,
                 poll_s: float = 2.0, min_iter: int = 0):
        self.engine = engine
        self.name = name
        self.prefix = prefix
        self.poll_s = float(poll_s)
        self._last_iter = int(min_iter)
        self._rejected: set[int] = set()
        self._warned_orbax = False
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- lifecycle ------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="serve-snapshot-watch")
        self._thread.start()
        log.info("serving: watching snapshot prefix %r for model %r "
                 "(poll %.1fs)", self.prefix, self.name, self.poll_s)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * self.poll_s + 5.0)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.poll_s):
            try:
                self.check_once()
            # lint: ok(typed-failure) — the watcher surviving a failed poll is
            # the design; the next poll retries, logged with its traceback
            except Exception:  # noqa: BLE001 — the watcher must survive
                log.exception("serving: snapshot watch poll failed "
                              "(continuing)")

    # -- one poll -------------------------------------------------------
    def check_once(self) -> bool:
        """One poll: swap in the NEWEST verified snapshot past the last
        swapped iteration (an older one is stale once a newer one has
        committed). Returns True iff a swap happened."""
        for it, mpath in resilience.iter_snapshot_manifests(self.prefix):
            if it <= self._last_iter:
                return False  # newest first: nothing new
            if it in self._rejected:
                continue  # rot persists: try the next older one
            return self._try_swap(it, mpath)
        return False

    def _try_swap(self, it: int, mpath: str) -> bool:
        # test-only (swap_corrupt): rot the candidate's model file after
        # its manifest; the verify below must catch it
        weights_guess = self._model_file(mpath)
        if weights_guess:
            FAULTS.corrupt_file("swap_corrupt", weights_guess)
        doc = resilience.verify_snapshot(mpath)
        if doc is None:
            self._rejected.add(it)
            self.engine.note_swap_rejected(
                self.name, f"snapshot iter {it} failed crc verification "
                f"({mpath})", source=f"iter_{it}")
            return False
        if doc.get("kind") == "orbax":
            self._last_iter = it  # not considered again at every poll
            if not self._warned_orbax:
                self._warned_orbax = True
                log.warning("serving: snapshot prefix %r publishes "
                            "sharded (.orbax) sets; the watcher serves "
                            "flat .caffemodel snapshots only — skipping",
                            self.prefix)
            return False
        ent = doc.get("files", {}).get("model")
        if not ent:
            self._rejected.add(it)
            self.engine.note_swap_rejected(
                self.name, f"snapshot iter {it} manifest has no model "
                "entry", source=f"iter_{it}")
            return False
        weights = os.path.join(os.path.dirname(os.path.abspath(mpath)),
                               ent["file"])
        try:
            self.engine.swap_weights(self.name, weights,
                                     source=f"iter_{it}")
        except SwapError:
            # swap_weights has journaled and counted the rejection
            self._rejected.add(it)
            return False
        self._last_iter = it
        return True

    @staticmethod
    def _model_file(mpath: str) -> str | None:
        """The manifest's model file, unverified: only the fault site
        needs it before the verify."""
        try:
            with open(mpath) as f:
                doc = json.load(f)
            ent = doc["files"]["model"]["file"]
        except (OSError, ValueError, KeyError, TypeError):
            return None
        return os.path.join(os.path.dirname(os.path.abspath(mpath)), ent)
