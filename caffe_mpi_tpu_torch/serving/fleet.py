"""Serving fleet: replica processes behind a typed-retry router, heartbeat
death and respawn, and the rolling canary swap.

Port of the JAX package's caffe_mpi_tpu/serving/fleet.py. Reference:
parallel.cpp:166-229 (P2PSync: one worker a device under a root that owns
recovery) and examples/web_demo/app.py (a single-process deployment that
dies with its process). Serving replicas are worker processes behind a
thin router, so a replica's death, overload or a bad deploy are
survivable:

- **Replicas are processes.** Each is a full `cli serve` process with its
  own ServingEngine (its own CUDA context and bucket graphs), so a wedged
  runtime or a crash takes down one replica, never the fleet.
- **Typed-retry routing.** The router spreads requests least-loaded and
  retries only failures a sibling can absorb: a 429 shed, a 503
  unhealthy or closed engine, or a dead replica's connection error, on
  up to `serve_retry_budget` other replicas. A 504 deadline is never
  retried (the deadline is spent), nor a 400 (the bytes are bad on every
  sibling). Failures stay typed end to end (serving/errors.py kinds, and
  `replica_lost` for a connection-level death).
- **Replica death is host death.** Each replica publishes heartbeats
  over `resilience.DirBeatTransport` under the fleet directory; the
  supervisor drains a silent replica from rotation (its in-flight
  requests resolve typed through the retry path), journals
  `replica_dead`, terminates what is left of it, respawns it, and
  re-admits it only after its /readyz gate, `HostHeartbeat.revive`
  re-arming the monitor first.
- **Rolling canary swap.** The router has the engine's two-method facade
  that `SnapshotWatcher` drives (`swap_weights`, `note_swap_rejected`),
  so `-watch` drives fleet swaps unmodified: a verified snapshot is
  staged (one immutable copy the whole rollout reads), canaried on one
  replica, then propagated with `canary=False`; a rejection anywhere
  rolls every swapped replica back to the previous weights file, the
  same bytes, so the fleet serves bitwise what it served before.

Fault sites: `replica_dead` (kill a replica at a beat boundary) and
`fleet_swap_canary_bad` (rot the staged candidate before the canary),
both in resilience.FAULT_SITES.

Two departures from the JAX module:

- `FleetSupervisor._replica_cmd` spawns `python -m
  caffe_mpi_tpu_torch.tools.cli serve`, forwards the port's `-device`,
  and passes no `-serve_program_bank`: the port has no program bank (a
  CUDA graph has no file form; ROADMAP.md §1 item 5), so every replica
  and every respawn warms by capture.
- The module imports no torch, as the JAX router half imports no jax: the
  router and supervisor move bytes between sockets, so their process
  never creates a CUDA context and takes no memory on card 0.
"""

from __future__ import annotations

import http.client
import json
import logging
import os
import shutil
import socket
import subprocess
import sys
import threading
import time

from ..utils import resilience
from ..utils.resilience import FAULTS
from .errors import SwapError

log = logging.getLogger(__name__)

# failure kinds a SIBLING can absorb: a shed or unhealthy/closed engine
# is replica-local backpressure, and a connection-level death means the
# request never ran. deadline (504) and bad_request (400) are terminal
# by definition — see the module docstring.
RETRYABLE_KINDS = frozenset({"shed", "unhealthy", "closed", "replica_lost"})


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class HttpReplicaClient:
    """One replica's HTTP surface as (status, json-doc) pairs. A
    connection-level failure (refused, reset mid-response, timeout)
    raises OSError/http.client.HTTPException — the router folds those
    into the typed `replica_lost` kind; everything that produced a
    response comes back typed by the replica itself."""

    def __init__(self, host: str, port: int, timeout: float = 60.0):
        self.host = host
        self.port = int(port)
        self.timeout = float(timeout)

    def _request(self, method: str, path: str, body: bytes | None = None,
                 content_type: str = "") -> tuple[int, dict]:
        conn = http.client.HTTPConnection(self.host, self.port,
                                          timeout=self.timeout)
        try:
            headers = {}
            if body is not None:
                headers["Content-Type"] = (content_type
                                           or "application/octet-stream")
            conn.request(method, path, body=body, headers=headers)
            resp = conn.getresponse()
            data = resp.read()
            try:
                doc = json.loads(data)
            except ValueError:
                doc = {"error": data[:200].decode("utf-8", "replace"),
                       "kind": "error"}
            if not isinstance(doc, dict):
                doc = {"error": "non-object response", "kind": "error"}
            return resp.status, doc
        finally:
            conn.close()

    def classify(self, body: bytes, content_type: str = "") \
            -> tuple[int, dict]:
        return self._request("POST", "/classify", body, content_type)

    def get(self, path: str) -> tuple[int, dict]:
        return self._request("GET", path)

    def swap(self, payload: dict) -> tuple[int, dict]:
        return self._request("POST", "/swap",
                             json.dumps(payload).encode(),
                             "application/json")


class ReplicaHandle:
    """One replica's routing state. Mutable fields (`in_rotation`,
    `in_flight`, `port`, `client`, `proc`) are only ever read or
    written under the owning FleetRouter's `_lock` — the handle itself
    is a dumb record, the router is its monitor."""

    def __init__(self, rid: int, client=None, port: int = 0, proc=None):
        self.rid = int(rid)
        self.client = client
        self.port = int(port)
        self.proc = proc
        self.in_rotation = True
        self.in_flight = 0
        self.conn_errors = 0

    def __repr__(self) -> str:  # log lines
        return (f"ReplicaHandle({self.rid}, port={self.port}, "
                f"rotation={self.in_rotation}, inflight={self.in_flight})")


class FleetRouter:
    """Least-loaded request router + rolling-swap front over a set of
    replica handles. Pure HTTP plumbing — no engine, no torch — so the
    contract is testable with fake clients.

    Lock discipline (serving/locks.py): `_lock` guards rotation flags,
    in-flight counts, and counters — held only for those touches, never
    across an HTTP call, a file copy, or a journal write. `_swap_lock`
    serializes rolling swaps end-to-end (a second watcher poll must
    queue behind the in-progress rollout, not interleave with its
    rollback) and nests `_lock` only for the brief rotation snapshot
    and counter bumps."""

    def __init__(self, handles, *, retry_budget: int = 1,
                 journal: str = "", current_weights: str = "",
                 stage_dir: str = ""):
        self._handles = list(handles)
        self._lock = threading.Lock()
        self._swap_lock = threading.Lock()
        self.retry_budget = max(0, int(retry_budget))
        self.journal_prefix = journal
        self.stage_dir = stage_dir
        self._swap_seq = 0
        # current/previous fleet weights files — what a respawn serves
        # and what a rollback restores. "" = the replicas' spawn-time
        # weights (no fleet swap has landed yet).
        self.current_weights = current_weights
        self.previous_weights = ""
        # fleet counters (all bumped under _lock)
        self.routed = 0
        self.retries = 0
        self.sheds_absorbed = 0
        self.conn_errors = 0
        self.replica_deaths = 0
        self.respawns = 0
        self.swaps = 0
        self.swap_rejections = 0
        self.rollbacks = 0

    # -- rotation (supervisor + router both call these) -----------------
    def handle(self, rid: int) -> ReplicaHandle:
        for h in self._handles:
            if h.rid == rid:
                return h
        raise KeyError(f"no replica {rid}")

    def mark_down(self, rid: int, reason: str = "") -> None:
        with self._lock:
            h = self.handle(rid)
            was = h.in_rotation
            h.in_rotation = False
        if was:
            log.warning("fleet: replica %d OUT of rotation (%s)", rid,
                        reason or "marked down")

    def mark_up(self, rid: int) -> None:
        with self._lock:
            self.handle(rid).in_rotation = True
        log.info("fleet: replica %d re-admitted to rotation", rid)

    # -- routing --------------------------------------------------------
    def _pick(self, tried: set[int]) -> ReplicaHandle | None:
        """Least-loaded in-rotation replica not yet tried for this
        request; ties broken by replica id rotated through a fleet-wide
        cursor so idle fleets still spread. Bumps the pick's in-flight
        count — the caller MUST release via _done()."""
        with self._lock:
            cands = [h for h in self._handles
                     if h.in_rotation and h.rid not in tried]
            if not cands:
                return None
            base = self.routed + self.retries
            h = min(cands,
                    key=lambda h: (h.in_flight,
                                   (h.rid - base) % max(
                                       len(self._handles), 1)))
            h.in_flight += 1
            return h

    def _done(self, h: ReplicaHandle) -> None:
        with self._lock:
            h.in_flight = max(0, h.in_flight - 1)

    def classify(self, body: bytes, content_type: str = "") \
            -> tuple[int, dict]:
        """Route one classify request: least-loaded dispatch, typed
        sibling retry under the budget. Always returns a (status, doc)
        pair — a connection-level replica death becomes the typed
        `replica_lost` kind, never an exception to the client."""
        with self._lock:
            self.routed += 1
        tried: set[int] = set()
        last: tuple[int, dict] = (503, {
            "error": "no replica in rotation", "kind": "unhealthy"})
        while True:
            h = self._pick(tried)
            if h is None:
                return last
            tried.add(h.rid)
            try:
                status, doc = h.client.classify(body, content_type)
            except (OSError, http.client.HTTPException) as e:
                # connection-level death: the replica is gone mid-flight
                # — resolve TYPED and let the heartbeat/supervisor own
                # the respawn; dropping it from rotation now keeps the
                # next requests off a corpse the beat hasn't mourned yet
                status, doc = 503, {"error": f"replica {h.rid} "
                                    f"unreachable: {e}",
                                    "kind": "replica_lost"}
                with self._lock:
                    h.conn_errors += 1
                    self.conn_errors += 1
                self.mark_down(h.rid, f"connection error: {e}")
            finally:
                self._done(h)
            if status == 200:
                if tried and len(tried) > 1 and \
                        last[1].get("kind") == "shed":
                    with self._lock:
                        self.sheds_absorbed += 1
                return status, doc
            last = (status, doc)
            kind = doc.get("kind", "")
            if kind not in RETRYABLE_KINDS:
                return last  # 504 deadline / 400 bad_request / 500
            if len(tried) > self.retry_budget:
                return last  # budget spent: typed to the client
            with self._lock:
                self.retries += 1

    # -- fleet telemetry ------------------------------------------------
    def health(self) -> dict:
        """Fleet /healthz: healthy iff at least one replica is in
        rotation. Router-local — no replica round-trips, so the probe
        stays cheap and dead replicas cannot stall it."""
        with self._lock:
            n_rot = sum(1 for h in self._handles if h.in_rotation)
            doc = {
                "healthy": n_rot > 0,
                "replicas": len(self._handles),
                "in_rotation": n_rot,
                "replica_deaths": self.replica_deaths,
                "respawns": self.respawns,
            }
        return doc

    def ready(self) -> tuple[bool, dict]:
        """Fleet /readyz: ready iff EVERY replica is in rotation and
        reports its own /readyz — the gate the smoke polls to know a
        respawned replica was fully re-admitted."""
        with self._lock:
            handles = list(self._handles)
        per = {}
        ok = len(handles) > 0
        for h in handles:
            with self._lock:
                in_rot = h.in_rotation
            if not in_rot:
                per[str(h.rid)] = {"ready": False, "in_rotation": False}
                ok = False
                continue
            try:
                status, doc = h.client.get("/readyz")
            except (OSError, http.client.HTTPException) as e:
                status, doc = 503, {"ready": False, "error": str(e)}
            per[str(h.rid)] = doc
            ok = ok and status == 200
        return ok, {"ready": ok, "replicas": per}

    def stats(self) -> dict:
        """Fleet-wide /stats: the router's own accounting plus every
        reachable replica's engine.stats() keyed by replica id."""
        with self._lock:
            fleet = {
                "replicas": len(self._handles),
                "in_rotation": sum(1 for h in self._handles
                                   if h.in_rotation),
                "routed": self.routed,
                "retries": self.retries,
                "sheds_absorbed": self.sheds_absorbed,
                "conn_errors": self.conn_errors,
                "replica_deaths": self.replica_deaths,
                "respawns": self.respawns,
                "swaps": self.swaps,
                "swap_rejections": self.swap_rejections,
                "rollbacks": self.rollbacks,
                "retry_budget": self.retry_budget,
                "current_weights": self.current_weights,
            }
            handles = list(self._handles)
        per = {}
        for h in handles:
            try:
                _, doc = h.client.get("/stats")
            except (OSError, http.client.HTTPException) as e:
                doc = {"error": f"unreachable: {e}"}
            per[str(h.rid)] = doc
        return {"fleet": fleet, "replicas": per}

    # -- rolling canary swap (the SnapshotWatcher engine facade) --------
    def _journal(self, reason: str, **extra) -> None:
        """Fleet run journal (`<journal>.serve.run.json`) — reasons
        replica_dead / replica_respawned / fleet_swap /
        fleet_swap_rejected / fleet_swap_rollback; every write carries
        the cumulative counters so the latest record alone proves what
        the fleet survived. Best-effort, never fleet-fatal."""
        if not self.journal_prefix:
            return
        with self._lock:
            counters = {"replica_deaths": self.replica_deaths,
                        "respawns": self.respawns,
                        "fleet_swaps": self.swaps,
                        "swap_rejections": self.swap_rejections,
                        "rollbacks": self.rollbacks}
        try:
            resilience.write_run_manifest(
                self.journal_prefix + ".serve", reason=reason,
                **counters, **extra)
        except OSError:
            log.exception("fleet: run journal failed (continuing)")

    def _stage(self, weights: str, source: str) -> str:
        """Copy the verified candidate into the fleet's stage directory:
        one immutable file every replica of this rollout — and any
        rollback or respawn after it commits — reads. Staging decouples
        the fleet's serving truth from the training run's snapshot GC
        (`snapshot_keep` may delete the original mid-rollout)."""
        with self._lock:
            self._swap_seq += 1
            seq = self._swap_seq
        stage_dir = self.stage_dir or os.path.dirname(
            os.path.abspath(weights))
        os.makedirs(stage_dir, exist_ok=True)
        staged = os.path.join(
            stage_dir, f"fleet_w{seq}_{os.path.basename(weights)}")
        shutil.copyfile(weights, staged)
        return staged

    def note_swap_rejected(self, name: str, reason: str, *,
                           source: str = "") -> None:
        """Count + journal a rejected fleet-swap candidate (the watcher
        calls this directly for pre-swap verification failures). The
        fleet keeps serving the previous weights."""
        with self._lock:
            self.swap_rejections += 1
        log.warning("fleet: rolling swap for model %r REJECTED (%s); "
                    "previous weights keep serving fleet-wide",
                    name, reason)
        self._journal("fleet_swap_rejected", model=name,
                      swap_reason=reason, source=source)

    def _swap_on(self, h: ReplicaHandle, name: str, weights: str,
                 canary: bool, source: str) -> tuple[int, dict]:
        try:
            return h.client.swap({"model": name, "weights": weights,
                                  "canary": canary, "source": source})
        except (OSError, http.client.HTTPException) as e:
            return 503, {"error": f"replica {h.rid} unreachable: {e}",
                         "kind": "replica_lost"}

    def swap_weights(self, name: str, weights: str, *,
                     canary: bool = True, source: str = "") -> None:
        """Rolling fleet swap: stage the verified candidate, canary it
        on ONE replica, then propagate. Any rejection raises SwapError
        with the fleet unchanged: a canary rejection touches nothing,
        and a mid-rollout failure rolls every already-swapped replica
        back to the previous weights FILE — the same bytes, so the
        fleet serves bitwise what it served before the attempt.

        This method is the `ServingEngine.swap_weights` facade
        `SnapshotWatcher` drives, which is what turns `-watch` into a
        fleet-wide rollout with zero watcher changes."""
        with self._swap_lock:
            staged = self._stage(weights, source)
            # test-only: rot the staged candidate pre-canary — the
            # canary replica must reject it and the fleet stay bitwise
            FAULTS.corrupt_file("fleet_swap_canary_bad", staged)
            with self._lock:
                targets = [h for h in self._handles if h.in_rotation]
            if not targets:
                reason = "no replica in rotation to canary the swap"
                self.note_swap_rejected(name, reason, source=source)
                raise SwapError(reason)
            canary_h, rest = targets[0], targets[1:]
            status, doc = self._swap_on(canary_h, name, staged,
                                        canary, source)
            if status != 200:
                reason = (f"canary replica {canary_h.rid} rejected the "
                          f"candidate: {doc.get('error', status)}")
                self.note_swap_rejected(name, reason, source=source)
                raise SwapError(reason)
            swapped = [canary_h]
            for h in rest:
                # the canary gate already ran on the canary replica;
                # propagation re-imports the same staged bytes, so a
                # second canary per replica would only re-prove it
                status, doc = self._swap_on(h, name, staged, False,
                                            source)
                if status != 200:
                    self._rollback(name, swapped, source)
                    reason = (f"replica {h.rid} rejected mid-rollout: "
                              f"{doc.get('error', status)}; fleet "
                              f"rolled back to previous weights")
                    self.note_swap_rejected(name, reason, source=source)
                    raise SwapError(reason)
                swapped.append(h)
            with self._lock:
                self.previous_weights = self.current_weights
                self.current_weights = staged
                self.swaps += 1
                n = self.swaps
        log.info("fleet: rolling swap %d landed on %d replicas "
                 "(model %r, %s)", n, len(swapped), name,
                 source or "manual")
        self._journal("fleet_swap", model=name, weights=staged,
                      source=source, swapped=len(swapped))

    def _rollback(self, name: str, swapped, source: str) -> None:
        """Restore the previous weights file on every already-swapped
        replica (no canary: these bytes were serving a moment ago). A
        replica the rollback cannot reach leaves rotation — its
        supervised respawn comes back up on `current_weights`, which a
        failed rollout never advances, so convergence is bitwise either
        way."""
        with self._lock:
            prev = self.current_weights
            self.rollbacks += 1
        for h in swapped:
            if not prev:
                # no fleet swap ever landed: the replicas' spawn-time
                # weights are still their previous state — nothing was
                # overwritten on disk, but the engine params were; a
                # respawn-free rollback needs the spawn weights path,
                # which the supervisor records as current_weights at
                # start. Reaching here with prev == "" means the router
                # was built without it; drop the replica for respawn.
                self.mark_down(h.rid, "rollback without a previous "
                                      "weights file")
                continue
            status, doc = self._swap_on(h, name, prev, False,
                                        source + ":rollback")
            if status != 200:
                self.mark_down(h.rid, f"rollback failed: "
                                      f"{doc.get('error', status)}")
        self._journal("fleet_swap_rollback", model=name,
                      weights=prev, source=source)


class ReplicaBeat:
    """Replica-side heartbeat publisher (the replica half of the host
    heartbeat): a daemon thread beats `replica_id`'s sequence
    into the fleet directory every `interval`. The `replica_dead`
    fault site fires AT a beat boundary — the supervisor must mourn
    the silence, drain, respawn, and re-admit."""

    def __init__(self, fleet_dir: str, replica_id: int,
                 deadline: float = 5.0):
        self.transport = resilience.DirBeatTransport(
            os.path.join(fleet_dir, "hb"))
        self.rid = int(replica_id)
        self.interval = min(max(float(deadline) / 4.0, 0.05), 1.0)
        self._seq = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=f"replica-beat-{self.rid}")
        self._thread.start()

    # a dead beat thread is the failure signal: the supervisor mourns
    # the silence within one deadline and respawns the whole replica
    # lint: ok(thread-crash) — a dead beat thread is the failure signal: the
    # supervisor mourns the silence within one deadline and respawns the
    # replica
    def _loop(self) -> None:
        while True:
            try:
                self.transport.publish(self.rid, self._seq)
            except OSError:
                pass  # silence IS the signal; the supervisor decides
            # test-only: die AT a beat boundary (beat seq >= arg) — the
            # fleet supervisor must detect, drain, respawn, re-admit
            FAULTS.maybe_exit("replica_dead", key=self._seq)
            self._seq += 1
            if self._stop.wait(self.interval):
                return

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * self.interval + 1.0)
            self._thread = None
        try:
            self.transport.farewell(self.rid)
        except OSError:
            pass


class FleetSupervisor:
    """Spawn + supervise N `cli serve` replica processes behind a
    FleetRouter: readyz-gated admission, heartbeat death detection,
    journaled respawn (each replica warms by capture). The serving
    spelling of the training supervisor's restart loop, except that a
    replica respawns in place (revive) instead of the whole job
    restarting. `replica_env` adds environment variables to one
    replica's (e.g. `CUDA_VISIBLE_DEVICES`, one card a replica);
    `base_env` replaces this process's environment as their base."""

    def __init__(self, model: str, weights: str,
                 n_replicas: int | None = None,
                 fleet_dir: str = "", *, serving_param=None,
                 retry_budget: int | None = None,
                 replica_deadline: float | None = None,
                 base_env: dict | None = None,
                 replica_env: dict[int, dict] | None = None,
                 spawn_timeout: float = 300.0, max_respawns: int = 10,
                 python: str = sys.executable, device: str = "cuda"):
        sp = serving_param
        if n_replicas is None:  # the serve_replicas knob is the default
            n_replicas = getattr(sp, "serve_replicas", 0)
        if int(n_replicas) < 1:
            raise ValueError("a fleet needs at least 1 replica")
        if not fleet_dir:
            raise ValueError("a fleet needs a fleet_dir")
        self.model = model
        self.weights = weights or ""
        self.n = int(n_replicas)
        self.fleet_dir = os.path.abspath(fleet_dir)
        os.makedirs(self.fleet_dir, exist_ok=True)
        self.sp = sp
        self.device = str(device)
        self.deadline = float(
            replica_deadline if replica_deadline is not None
            else getattr(sp, "replica_deadline", 5.0))
        budget = (retry_budget if retry_budget is not None
                  else getattr(sp, "serve_retry_budget", 1))
        self.base_env = dict(base_env) if base_env is not None else None
        self.replica_env = dict(replica_env or {})
        self.spawn_timeout = float(spawn_timeout)
        self.max_respawns = int(max_respawns)
        self.python = python
        self.router = FleetRouter(
            [], retry_budget=budget,
            journal=os.path.join(self.fleet_dir, "fleet"),
            current_weights=self.weights,
            stage_dir=os.path.join(self.fleet_dir, "weights"))
        self._hb: resilience.HostHeartbeat | None = None
        self._stop = threading.Event()
        self._monitor: threading.Thread | None = None
        self._respawn_count = 0

    # -- spawning -------------------------------------------------------
    def _replica_cmd(self, rid: int, port: int, weights: str) -> list:
        cmd = [self.python, "-m", "caffe_mpi_tpu_torch.tools.cli", "serve",
               "-model", self.model, "-port", str(port),
               "-replica_id", str(rid), "-fleet_dir", self.fleet_dir,
               "-replica_deadline", str(self.deadline),
               "-device", self.device]
        if weights:
            cmd += ["-weights", weights]
        sp = self.sp
        if sp is not None:
            # forward the serving knobs the fleet's operator pinned —
            # same flag spellings cmd_serve parses
            for flag, attr in [("-serve_window_ms", "serve_window_ms"),
                               ("-serve_hbm_mb", "serve_hbm_mb"),
                               ("-serve_queue_limit", "serve_queue_limit"),
                               ("-serve_deadline_ms", "serve_deadline_ms"),
                               ("-serve_stall_s", "serve_stall_s"),
                               ("-serve_decoded_cache_mb",
                                "serve_decoded_cache_mb")]:
                cmd += [flag, str(getattr(sp, attr))]
            if sp.serve_buckets:
                cmd += ["-serve_buckets", sp.serve_buckets]
            if sp.serve_dtype and sp.serve_dtype != "f32":
                cmd += ["-serve_dtype", sp.serve_dtype]
        return cmd

    def _spawn(self, rid: int, weights: str) -> tuple:
        port = free_port()
        env = dict(self.base_env if self.base_env is not None
                   else os.environ)
        env.update(self.replica_env.get(rid, {}))
        log_path = os.path.join(self.fleet_dir, f"replica_{rid}.log")
        logf = open(log_path, "ab")
        try:
            proc = subprocess.Popen(
                self._replica_cmd(rid, port, weights),
                stdout=logf, stderr=subprocess.STDOUT,
                stdin=subprocess.DEVNULL, env=env)
        finally:
            logf.close()  # the child holds its own fd now
        return proc, port

    def _await_ready(self, client: HttpReplicaClient, proc,
                     rid: int) -> bool:
        """Poll the replica's /readyz until 200 (admission gate), its
        process dies, or the spawn timeout lapses."""
        deadline = time.monotonic() + self.spawn_timeout
        while time.monotonic() < deadline:
            if proc.poll() is not None:
                log.error("fleet: replica %d exited rc=%s before its "
                          "readyz gate (see %s/replica_%d.log)", rid,
                          proc.returncode, self.fleet_dir, rid)
                return False
            try:
                status, _ = client.get("/readyz")
                if status == 200:
                    return True
            except (OSError, http.client.HTTPException):
                pass  # not listening yet
            time.sleep(0.2)
        log.error("fleet: replica %d missed its readyz gate (%.0fs)",
                  rid, self.spawn_timeout)
        return False

    def start(self) -> None:
        """Spawn all replicas, gate each on /readyz, arm the heartbeat.
        Replica 0 is spawned and admitted alone first, then each sibling
        in turn: one replica warms (captures its bucket graphs) at a
        time, so N warms never race for one card's memory."""
        for rid in range(self.n):
            proc, port = self._spawn(rid, self.weights)
            client = HttpReplicaClient("127.0.0.1", port)
            if not self._await_ready(client, proc, rid):
                self.stop()
                raise RuntimeError(f"fleet replica {rid} failed its "
                                   f"readyz admission gate")
            h = ReplicaHandle(rid, client=client, port=port, proc=proc)
            self.router._handles.append(h)
            log.info("fleet: replica %d admitted on port %d", rid, port)
        transport = resilience.DirBeatTransport(
            os.path.join(self.fleet_dir, "hb"))
        # the supervisor is "host N" of an N+1 cluster: its peers are
        # exactly the replicas; its own published beat is unread
        self._hb = resilience.HostHeartbeat(
            transport, host_id=self.n, n_hosts=self.n + 1,
            deadline=self.deadline, hard_exit=False,
            grace=max(2.0 * self.deadline, 10.0))
        self._monitor = threading.Thread(target=self._monitor_loop,
                                         daemon=True,
                                         name="fleet-supervisor")
        self._monitor.start()

    # -- death detection + respawn --------------------------------------
    def _monitor_loop(self) -> None:
        poll = min(max(self.deadline / 8.0, 0.05), 1.0)
        while not self._stop.wait(poll):
            try:
                self._hb.tick()
                if self._hb.lost is not None:
                    peer, elapsed = self._hb.lost
                    # lint: ok(host-sync) — a heartbeat age, a host float
                    self._handle_loss(int(peer), float(elapsed))
            # the supervisor must survive a failed poll; the next tick
            # retries, and a dead replica keeps failing the heartbeat
            # lint: ok(typed-failure) — the supervisor surviving a failed poll
            # is the design; the next tick retries and a dead replica keeps
            # failing its heartbeat
            except Exception:  # noqa: BLE001 — the supervisor survives
                log.exception("fleet: supervisor poll failed "
                              "(continuing)")

    def _handle_loss(self, rid: int, elapsed: float) -> None:
        self.router.mark_down(rid, f"heartbeat silent {elapsed:.1f}s")
        with self.router._lock:
            self.router.replica_deaths += 1
        log.error("fleet: replica %d DEAD (silent %.1fs, deadline "
                  "%.1fs) — draining, respawning", rid, elapsed,
                  self.deadline)
        self.router._journal("replica_dead", replica=rid,
                             elapsed_s=round(elapsed, 3),
                             deadline_s=self.deadline)
        h = self.router.handle(rid)
        proc = h.proc
        if proc is not None and proc.poll() is None:
            # silent but not dead (wedged runtime): make it dead so the
            # respawned incarnation is the only one holding resources
            proc.terminate()
            try:
                proc.wait(timeout=5.0)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=5.0)
        if self._respawn_count >= self.max_respawns:
            log.error("fleet: replica %d stays down — respawn budget "
                      "(%d) spent", rid, self.max_respawns)
            self._hb.revive(rid)
            self.router.mark_down(rid, "respawn budget spent")
            return
        self._respawn_count += 1
        with self.router._lock:
            weights = self.router.current_weights or self.weights
        proc, port = self._spawn(rid, weights)
        client = HttpReplicaClient("127.0.0.1", port)
        admitted = self._await_ready(client, proc, rid)
        with self.router._lock:
            h.proc, h.port, h.client = proc, port, client
        # revive BEFORE re-admission either way: the other replicas
        # must be monitored again, and a respawn that failed its gate
        # will simply be mourned and retried on the next silence
        self._hb.revive(rid)
        if admitted:
            with self.router._lock:
                self.router.respawns += 1
            self.router.mark_up(rid)
            self.router._journal("replica_respawned", replica=rid,
                                 port=port)
        else:
            self.router._journal("replica_respawn_failed", replica=rid)

    def stop(self) -> None:
        self._stop.set()
        if self._monitor is not None:
            self._monitor.join(timeout=10.0)
            self._monitor = None
        for h in list(self.router._handles):
            proc = h.proc
            if proc is None or proc.poll() is not None:
                continue
            proc.terminate()
            try:
                proc.wait(timeout=10.0)
            except subprocess.TimeoutExpired:
                proc.kill()
                try:
                    proc.wait(timeout=5.0)
                except subprocess.TimeoutExpired:
                    pass


# ---------------------------------------------------------------------------
# Router HTTP front — the fleet's public surface
# ---------------------------------------------------------------------------

def make_router_server(router: FleetRouter, port: int = 5000,
                       host: str = "127.0.0.1"):
    """HTTP front over a FleetRouter (port=0 picks an ephemeral port):
    POST /classify routes + retries, GET /stats //healthz //readyz
    aggregate fleet-wide. The handler forwards bodies verbatim — all
    decode/preprocess work happens replica-side, so the router process
    stays a byte pump. Its accept backlog is the replicas' front's (256):
    socketserver's default of 5 resets the connections of a burst."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class _RouterServer(ThreadingHTTPServer):
        request_queue_size = 256

    class _RouterHandler(BaseHTTPRequestHandler):
        def _json(self, code: int, obj) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/stats":
                return self._json(200, router.stats())
            if self.path == "/healthz":
                h = router.health()
                return self._json(200 if h["healthy"] else 503, h)
            if self.path == "/readyz":
                ok, doc = router.ready()
                return self._json(200 if ok else 503, doc)
            self._json(404, {"error": f"no route {self.path}",
                             "kind": "not_found"})

        def do_POST(self):
            if self.path != "/classify":
                return self._json(404, {"error": "POST /classify",
                                        "kind": "not_found"})
            try:
                length = int(self.headers.get("Content-Length", 0))
            except ValueError:
                return self._json(400, {"error": "bad Content-Length",
                                        "kind": "bad_request"})
            body = self.rfile.read(length)
            status, doc = router.classify(
                body, self.headers.get("Content-Type", ""))
            self._json(status, doc)

        def log_message(self, fmt, *args):  # quiet by default
            if os.environ.get("WEB_DEMO_VERBOSE"):
                sys.stderr.write(fmt % args + "\n")

    return _RouterServer((host, port), _RouterHandler)
