"""Resilience: verified snapshots, the fault plane, the dispatch watchdog,
the supervisor, and the data plane's integrity errors and quarantine
journal.

The port's copy of the single-host half of the JAX package's
`caffe_mpi_tpu/utils/resilience.py`, name for name, with its exit codes,
journal reasons, manifest fields and fault-site names:

- exit codes: EXIT_WATCHDOG 86 (a watchdog trip), EXIT_FAULT 87 (an
  injected fault; as EXIT_CLUSTER, a cluster that failed to form or to
  agree, ClusterError), EXIT_NUMERIC 88 (the skip-step guard's
  divergence, NumericAnomalyError);
- RecordIntegrityError (one record failed its crc32c, its page structure
  or its parse) and DataIntegrityError (corruption past the quarantine
  bound: systematic, not record-level);
- the fault plane `FAULTS`, configured from `CAFFE_TPU_FAULTS`
  (`site:count:skip:arg`; a count <= 0 is sticky) and, across process
  restarts, `CAFFE_TPU_FAULTS_DIR` (a site that has fired leaves a
  `<site>.done` file there, and a later process loads it disabled); free
  when unset;
- verified snapshots: `atomic_output`, `crc32c_file` (the native
  library's crc32c, a chunk at a time), the snapshot manifest
  `<prefix>_iter_<N>.manifest.json` written last (the snapshot's commit
  point), `verify_snapshot`, `iter_snapshot_manifests`,
  `verified_snapshots`, `latest_verified_snapshot`, `gc_snapshots` (never the newest verified
  snapshot), and the single-file manifests;
- the run journal `<prefix>.run.json` and the quarantine journal;
- `DispatchWatchdog`: a monitor thread that bounds device waits; the
  solver's journals the run state and exits EXIT_WATCHDOG, the serving
  stall breaker's (`hard_exit=False`) calls back and stays up;
- `supervise`: a training child under `subproc.run_contained`, restarted
  with exponential backoff up to a crash-loop guard, its exit 88 routed
  through `anomaly_action` (rewind, rewind_lr, abort).

The multi-host half, name for name, in the JAX file formats (beat files
`hb_<host>` holding `<incarnation token>:<seq>`, farewell markers
`bye_<host>`, generation records `cluster_gen.json` and `gen_<g>.json`,
the `done` marker, merged quarantine journals):

- the cross-host heartbeat: `DirBeatTransport` (a shared directory) and
  `HostHeartbeat`, which the solver's watchdog thread ticks as its
  `pulse`; a peer silent past `host_deadline` is journaled and the
  worker exits EXIT_CLUSTER (the KV transport over the group's store is
  `parallel/mesh.py` `KVBeatTransport`);
- degraded-mode elasticity (`min_hosts`): the generation protocol on a
  `<prefix>.cluster/` directory beside the snapshots (`cluster_dir`,
  `read_generation`, `write_generation`, `observe_live_hosts`,
  `SupervisorBeat`, `_rejoin_wait`) and `supervise_elastic`, which
  re-forms the cluster around the survivors after a permanent host loss
  and grows it back when the host returns;
- the host-keyed quarantine journals and `merge_quarantine_journals`.

A sharded (.orbax) snapshot is committed by `write_sharded_manifest`
(one crc32c entry a shard file, kind "orbax", the `.orbax` infix kept),
and `verify_snapshot` and `gc_snapshots` read such a manifest as the JAX
ones do, so a mixed directory scans the same under both packages.
"""

from __future__ import annotations

import glob
import json
import logging
import os
import shutil
import sys
import threading
import time
from contextlib import contextmanager, nullcontext

log = logging.getLogger("caffe_mpi_tpu_torch.resilience")

# distinct exit codes, so a supervisor (and an operator reading a log)
# tells a watchdog trip from an injected fault from a numeric divergence,
# which is rewound rather than restarted
EXIT_WATCHDOG = 86
EXIT_FAULT = 87
EXIT_NUMERIC = 88
# a cluster that failed to form or to agree (the JAX EXIT_CLUSTER): the
# journal's `reason` (cluster_init_failed, cluster_resume_failed) says which
EXIT_CLUSTER = EXIT_FAULT
_BACKOFF_CAP_S = 60.0  # the supervisor's longest wait between attempts

_JOURNAL_SCHEMA = 1
_MANIFEST_SCHEMA = 1
_STATE_SUFFIXES = (".solverstate", ".solverstate.h5")
_MANIFEST_SUFFIX = ".manifest.json"


class NumericAnomalyError(RuntimeError):
    """Training declared numeric divergence: `guard_max_skips`
    consecutive steps were skipped by the skip-step guard (non-finite
    values, or a loss spike). The solver journals it to
    `<prefix>.run.json` before raising; the CLI exits EXIT_NUMERIC, which
    the supervisor routes through `anomaly_action`."""

    def __init__(self, it: int, consec: int, skipped: int, last_bad: int):
        self.iter = it
        self.consec = consec
        self.skipped = skipped
        self.last_bad = last_bad
        super().__init__(
            f"numeric divergence at iteration {it}: {consec} consecutive "
            f"skipped step(s) ({skipped} total; last bad iteration "
            f"{last_bad})")


class ClusterError(RuntimeError):
    """Cluster formation or agreement failed in a bounded way:
    `init_distributed` ran out of attempts against a missing coordinator,
    or a barrier or KV exchange timed out. The CLI journals `reason` to
    the run journal (`<prefix>.run.json`, `.r<k>` on rank k > 0) and exits
    EXIT_CLUSTER, instead of hanging in a collective."""

    def __init__(self, msg: str, reason: str = "cluster_init_failed"):
        super().__init__(msg)
        self.reason = reason


class CollectiveError(RuntimeError):
    """A collective (or the wait on one) failed where it ran: gloo raises
    at once when a peer process dies. Only this error waits for the
    heartbeat to name a lost peer (`Solver.await_host_loss`); a guard
    trip, a data error or an OOM keeps its own exit code."""


class RecordIntegrityError(RuntimeError):
    """A record failed its crc32c, its page structure, or its parse.
    Deterministic: not retried like a transient read error; the Feeder
    quarantines the record instead."""

    def __init__(self, source: str, index: int, reason: str):
        super().__init__(f"{source}: record {index}: {reason}")
        self.source, self.index, self.reason = source, index, reason


class DataIntegrityError(RuntimeError):
    """The quarantine bound was exceeded: corruption is systematic
    (dataset-level), not record-level — a hard, named failure instead of
    silently training on substitutes."""


class SnapshotCorruptError(RuntimeError):
    """A snapshot file failed its manifest's crc32c check."""


# ---------------------------------------------------------------------------
# Fault sites (test-only; environment-keyed; free when off)
# ---------------------------------------------------------------------------

# the sites the port honours, as the JAX package's FAULT_SITES names and
# describes them
FAULT_SITES = {
    "feeder_read": "transient dataset read error (Feeder retry budget)",
    "snapshot_kill": "hard-exit mid-snapshot-write (torn checkpoint)",
    "snapshot_corrupt": "flip a byte of the model file post-manifest",
    "snapshot_shard_corrupt": "flip a byte in one orbax shard "
                              "post-manifest (sharded-snapshot bitrot)",
    "snapshot_sync": "force interval snapshots to write blocking",
    "dispatch_stall": "sleep inside a train dispatch (watchdog trip)",
    "train_abort": "hard-exit at an iteration boundary (crash sim)",
    "nan_grad": "poison float feeds with NaN for iterations "
                "[arg, arg+count) — non-finite loss/gradients",
    "loss_spike": "scale float feeds 1e3x for iterations "
                  "[arg, arg+count) — finite loss explosion",
    "record_corrupt": "flip a byte of record values [arg, arg+count) "
                      "after fetch (bitrot the crc check must catch)",
    "record_decode": "truncate record values [arg, arg+count) so the "
                     "Datum parse fails",
    "serve_dispatch_stall": "sleep inside a serving dispatch (stall "
                            "breaker trip — the dead-tunnel shape)",
    "swap_corrupt": "flip a byte of a hot-swap candidate's model file "
                    "post-manifest (verify must reject the swap)",
    "swap_canary_bad": "poison a hot-swap candidate's loaded weights "
                       "with NaN (canary gate must roll back)",
    "replica_dead": "kill a serving replica at a heartbeat boundary "
                    "(beat seq >= arg) — a fleet replica dying "
                    "mid-traffic",
    "fleet_swap_canary_bad": "flip a byte of the fleet's staged swap "
                             "candidate pre-canary (the rolling swap "
                             "must reject and roll back)",
    "coordinator_down": "fail distributed init for the first `count` "
                        "attempts (missing/unreachable coordinator)",
    "host_loss": "kill the local worker at a heartbeat boundary "
                 "(beat seq >= arg) — a peer host dying mid-run",
    "host_perma_loss": "go dark at supervisor level for `arg` seconds "
                       "after the worker dies — the whole host (worker "
                       "AND supervisor) is gone, so the survivors must "
                       "degrade instead of waiting for a restart-all",
}


class FaultPlane:
    """Injects failures at named sites, configured from the
    `CAFFE_TPU_FAULTS` environment variable: comma-separated
    `site:count:skip:arg` entries (count defaults 1, skip 0, arg empty).
    `fire()` fires on the (skip+1)-th .. (skip+count)-th eligible calls,
    then never again; a count <= 0 is sticky: every eligible call, for
    the rest of this process. `fire(site, key=)` with a numeric arg is
    eligible only once key >= arg. `fire_at()` fires for keys in [arg,
    arg + count) without using the count up, so a record's fate is a pure
    function of its index.

    `CAFFE_TPU_FAULTS_DIR` makes firing durable across processes: a site
    that has fired its whole count (a sticky site: fired at all) writes
    `<dir>/<site>.done`, and a later process (the supervised restart)
    loads it disabled, so "crash once, then succeed" ends. With no sites
    configured each check is one falsy dict test."""

    def __init__(self):
        self._sites: dict[str, dict] = {}
        self._dir = ""
        self._lock = threading.Lock()
        # bumped at every configure: a cache of a derived value (the
        # solver's wrapped feed fn) keys on it
        self.generation = 0

    def load_env(self) -> None:
        self.configure(os.environ.get("CAFFE_TPU_FAULTS", ""),
                       once_dir=os.environ.get("CAFFE_TPU_FAULTS_DIR", ""))

    def configure(self, spec: str, once_dir: str = "") -> None:
        sites = {}
        for entry in (spec or "").split(","):
            entry = entry.strip()
            if not entry:
                continue
            parts = entry.split(":")
            site = parts[0]
            done = os.path.join(once_dir, f"{site}.done") if once_dir \
                else ""
            if done and os.path.exists(done):
                log.info("fault site %r already fired in a previous "
                         "process; disabled", site)
                continue
            sites[site] = {
                "count": int(parts[1]) if len(parts) > 1 and parts[1] else 1,
                "skip": int(parts[2]) if len(parts) > 2 and parts[2] else 0,
                "arg": parts[3] if len(parts) > 3 else ""}
        with self._lock:
            self._dir = once_dir
            self._sites = sites
            self.generation += 1

    def _mark_done(self, site: str) -> None:
        if not self._dir:
            return
        try:
            with open(os.path.join(self._dir, f"{site}.done"), "w") as f:
                f.write(f"{time.time()}\n")
        except OSError:
            pass

    def active(self, site: str) -> bool:
        """Is `site` configured (without using up a firing)?"""
        return bool(self._sites) and site in self._sites

    def fire(self, site: str, key: float | None = None) -> str | None:
        """The site's arg when this call should fail, else None. With
        `key` (an iteration) a numeric arg is a threshold: the site is
        eligible only once key >= arg."""
        if not self._sites:
            return None
        with self._lock:
            st = self._sites.get(site)
            if st is None:
                return None
            arg = st["arg"]
            if key is not None and arg:
                try:
                    if key < float(arg):
                        return None
                except ValueError:
                    pass  # a non-numeric arg gates nothing
            if st["skip"] > 0:
                st["skip"] -= 1
                return None
            if st["count"] <= 0:  # sticky: every call, this process
                if not st.get("fired"):
                    st["fired"] = True
                    self._mark_done(site)
                return arg
            st["count"] -= 1
            if st["count"] <= 0:
                del self._sites[site]
                self._mark_done(site)
            return arg

    def fire_at(self, site: str, key: float, *,
                durable_done: bool = True) -> str | None:
        """Fires iff arg <= key < arg + count (every key from arg on when
        count <= 0), using nothing up. durable_done=False writes no done
        file: simulated bitrot persists across a restart, a NaN burst
        does not."""
        if not self._sites:
            return None
        with self._lock:
            st = self._sites.get(site)
            if st is None:
                return None
            try:
                lo = float(st["arg"] or 0)
            except ValueError:
                return None
            n = st["count"]
            if key < lo or (n > 0 and key >= lo + n):
                return None
            if durable_done and not st.get("fired"):
                st["fired"] = True
                self._mark_done(site)
            return st["arg"]

    def wrap_feeds(self, feed_fn):
        """`feed_fn` with the `nan_grad` / `loss_spike` sites applied: the
        float feeds of micro-iterations [arg, arg+count) become NaN
        (nan_grad) or are scaled 1e3x (loss_spike). Returns `feed_fn`
        itself when neither site is configured (the solver caches the
        wrapper, so identity matters)."""
        if not (self.active("nan_grad") or self.active("loss_spike")):
            return feed_fn

        def poison(feeds, fn):
            out, hit = {}, False
            for k, v in feeds.items():
                if v.is_floating_point():
                    v = fn(v)
                    hit = True
                out[k] = v
            if not hit:
                # a uint8 feed (the device transform's staging) has no
                # float to poison: say so rather than pass vacuously
                log.warning("fault plane: batch has no float feed to "
                            "poison (device-transform staging? use "
                            "transform_param { use_gpu_transform: "
                            "false } in the test net)")
            return out

        def wrapped(it):
            import torch
            feeds = {k: torch.as_tensor(v) for k, v in feed_fn(it).items()}
            if self.fire_at("nan_grad", it) is not None:
                log.warning("fault plane: NaN-poisoning feeds for "
                            "micro-iteration %d", it)
                feeds = poison(feeds, lambda t: torch.full_like(
                    t, float("nan")))
            if self.fire_at("loss_spike", it) is not None:
                log.warning("fault plane: 1e3x-scaling feeds for "
                            "micro-iteration %d", it)
                feeds = poison(feeds, lambda t: t * 1e3)
            return feeds

        return wrapped

    def corrupt_bytes(self, site: str, raw, key: float):
        """Record-level injection on FETCHED bytes: `record_corrupt` flips
        one mid-record byte, `record_decode` truncates the record. Keyed
        by record index and durable across restarts (bitrot does not heal
        on a resume)."""
        if self.fire_at(site, key, durable_done=False) is None:
            return raw
        if site == "record_decode":
            return bytes(raw[:max(len(raw) // 2, 1)])
        b = bytearray(raw)
        if b:
            b[len(b) // 2] ^= 0xFF
        return bytes(b)

    # -- one-line call-site helpers -------------------------------------
    def maybe_raise(self, site: str, exc_type=OSError, msg: str = "",
                    key: float | None = None) -> None:
        if self.fire(site, key=key) is not None:
            raise exc_type(msg or f"injected fault at site {site!r}")

    def maybe_stall(self, site: str, key: float | None = None) -> None:
        arg = self.fire(site, key=key)
        if arg is not None:
            secs = float(arg or 30.0)
            log.warning("fault plane: stalling %.1fs at site %r", secs, site)
            time.sleep(secs)

    def maybe_exit(self, site: str, key: float | None = None) -> None:
        if self.fire(site, key=key) is not None:
            log.warning("fault plane: hard exit at site %r", site)
            sys.stderr.flush()
            os._exit(EXIT_FAULT)

    def corrupt_file(self, site: str, path: str) -> None:
        """Flip one mid-file byte (bitrot, a torn write)."""
        if self.fire(site) is None:
            return
        with open(path, "r+b") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            f.seek(max(size // 2, 0))
            b = f.read(1)
            f.seek(max(size // 2, 0))
            f.write(bytes([(b[0] ^ 0xFF) if b else 0xFF]))
        log.warning("fault plane: corrupted %s at site %r", path, site)


FAULTS = FaultPlane()
FAULTS.load_env()


# ---------------------------------------------------------------------------
# Bounded retry
# ---------------------------------------------------------------------------

def retrying(fn, *, attempts: int = 4, base_delay: float = 0.05,
             max_delay: float = 2.0, exc_types=(OSError,), desc: str = ""):
    """Call `fn()` with bounded exponential backoff on transient errors.
    The LAST failure propagates unchanged (bounded, not infinite — a
    truly dead dataset must surface)."""
    delay = base_delay
    for attempt in range(attempts):
        try:
            return fn()
        except exc_types as e:
            if attempt == attempts - 1:
                raise
            log.warning("transient failure%s (attempt %d/%d): %r; "
                        "retrying in %.2fs", f" in {desc}" if desc else "",
                        attempt + 1, attempts, e, delay)
            time.sleep(delay)
            delay = min(delay * 2, max_delay)


# ---------------------------------------------------------------------------
# Atomic publication and crc32c
# ---------------------------------------------------------------------------

@contextmanager
def atomic_output(path: str):
    """Yield a temp path for the caller to write; on clean exit fsync it
    and `os.replace` onto `path`, so readers only ever see an absent or a
    complete file. Stale temps of a killed writer are swept first."""
    for stale in glob.glob(f"{glob.escape(path)}.tmp*"):
        try:
            os.unlink(stale)
        except OSError:
            pass
    tmp = f"{path}.tmp{os.getpid()}"
    try:
        yield tmp
        fd = os.open(tmp, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def crc32c_file(path: str, chunk: int = 1 << 22) -> int:
    """crc32c of a file, read a chunk at a time through the native
    library's crc32c (csrc/native: SSE4.2 where the CPU has it)."""
    from ..native import crc32c_extend
    crc = 0
    with open(path, "rb") as f:
        while True:
            buf = f.read(chunk)
            if not buf:
                return crc
            crc = crc32c_extend(crc, buf)


def _file_entry(path: str, name: str | None = None) -> dict:
    return {"file": name or os.path.basename(path),
            "size": os.path.getsize(path),
            "crc32c": f"{crc32c_file(path):08x}"}


def _entry_ok(path: str, ent: dict) -> bool:
    try:
        return (os.path.getsize(path) == ent["size"]
                and f"{crc32c_file(path):08x}" == ent["crc32c"])
    except (OSError, KeyError, TypeError):
        return False


def _write_json_atomic(path: str, doc: dict) -> None:
    with atomic_output(path) as tmp:
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)


# ---------------------------------------------------------------------------
# Single-file manifests
# ---------------------------------------------------------------------------

def write_file_manifest(path: str, **meta) -> str:
    """Publish `<path>.manifest.json`, the crc32c commit record of one
    standalone file (the snapshot scheme for a single file, no
    iteration): written last, after the file itself landed through
    atomic_output. Extra keyword fields are stored beside it."""
    mpath = path + _MANIFEST_SUFFIX
    doc = {"schema": _MANIFEST_SCHEMA, "time": time.time(),
           "files": {"artifact": _file_entry(path)}}
    doc.update(meta)
    _write_json_atomic(mpath, doc)
    return mpath


def verify_file_manifest(path: str) -> dict | None:
    """The manifest of `path` if the file's size and crc32c still match
    it, else None (a missing, unreadable or torn manifest, a missing
    file, a mismatch): None means "regenerate", never an error."""
    try:
        with open(path + _MANIFEST_SUFFIX) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    ent = (doc.get("files") or {}).get("artifact")
    if not isinstance(ent, dict) or ent.get("file") != os.path.basename(path):
        return None
    return doc if _entry_ok(path, ent) else None


# ---------------------------------------------------------------------------
# Snapshot manifests: write / verify / scan / GC
# ---------------------------------------------------------------------------

def manifest_for_state(state_path: str) -> str | None:
    """The manifest of a .solverstate[.h5] or of a sharded .orbax
    directory (`s_iter_N.orbax.manifest.json`, the infix kept); None for
    a format without one."""
    state_path = state_path.rstrip("/")
    if state_path.endswith(".orbax"):
        return state_path + _MANIFEST_SUFFIX
    for suf in _STATE_SUFFIXES:
        if state_path.endswith(suf):
            return state_path[: -len(suf)] + _MANIFEST_SUFFIX
    return None


def write_snapshot_manifest(state_path: str, it: int,
                            files: dict[str, str]) -> str:
    """Publish one snapshot's manifest, written last (after every file it
    covers) and atomically, so its existence is the snapshot's commit
    point. `files` maps a role (model, state) to a path; each is stored
    by basename with its size and crc32c."""
    mpath = manifest_for_state(state_path)
    if mpath is None:
        raise ValueError(f"no manifest scheme for {state_path!r}")
    doc = {"schema": _MANIFEST_SCHEMA, "iteration": int(it),
           "time": time.time(),
           "files": {role: _file_entry(path) for role, path in files.items()}}
    _write_json_atomic(mpath, doc)
    return mpath


def sharded_snapshot_files(orbax_dir: str) -> list[str]:
    """Every regular file under a sharded (.orbax) snapshot directory,
    by descending size then path: index 0 is the `snapshot_shard_corrupt`
    site's victim (the biggest file is a shard, not the index)."""
    out = []
    for root, _dirs, names in os.walk(orbax_dir):
        for name in names:
            out.append(os.path.join(root, name))
    out.sort(key=lambda p: (-os.path.getsize(p), p))
    return out


def write_sharded_manifest(orbax_dir: str, it: int) -> str:
    """The commit record of a sharded (.orbax) snapshot: a size and
    crc32c entry for every file under the directory (paths relative to
    it), written last, after every rank's files and the write barrier,
    by rank 0 alone, so a torn or bit-rotted set fails as a unit."""
    orbax_dir = os.path.abspath(orbax_dir.rstrip("/"))
    mpath = manifest_for_state(orbax_dir)
    if mpath is None:
        raise ValueError(f"no manifest scheme for {orbax_dir!r}")
    entries = {}
    for path in sharded_snapshot_files(orbax_dir):
        rel = os.path.relpath(path, orbax_dir)
        entries[rel] = _file_entry(path, rel)
    if not entries:
        raise ValueError(f"sharded snapshot {orbax_dir!r} is empty")
    doc = {"schema": _MANIFEST_SCHEMA, "kind": "orbax",
           "iteration": int(it), "time": time.time(),
           "dir": os.path.basename(orbax_dir), "files": entries}
    _write_json_atomic(mpath, doc)
    return mpath


def verify_snapshot(manifest_path: str) -> dict | None:
    """Check every file the manifest covers against its size and crc32c.
    Returns the manifest with `state` (the resolved state path; a sharded
    set's directory) and `manifest` added, or None on any mismatch, a
    missing file or an unreadable manifest: None means "fall back to an
    older snapshot"."""
    try:
        with open(manifest_path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    base = os.path.dirname(os.path.abspath(manifest_path))
    if doc.get("kind") == "orbax":
        root = os.path.join(base, doc.get("dir") or "")
        if not doc.get("dir") or not os.path.isdir(root) \
                or not doc.get("files"):
            return None
        if not all(_entry_ok(os.path.join(root, ent["file"]), ent)
                   for ent in doc["files"].values()):
            return None
        doc["state"] = root
        doc["manifest"] = os.path.abspath(manifest_path)
        return doc
    state_path = None
    for role, ent in doc.get("files", {}).items():
        path = os.path.join(base, ent["file"])
        if not _entry_ok(path, ent):
            return None
        if role == "state":
            state_path = path
    if state_path is None:
        return None
    doc["state"] = state_path
    doc["manifest"] = os.path.abspath(manifest_path)
    return doc


def iter_snapshot_manifests(prefix: str) -> list[tuple[int, str]]:
    """Every `<prefix>_iter_<N>[.orbax].manifest.json`, newest iteration
    first: a directory listing, nothing read or verified."""
    d = os.path.dirname(prefix) or "."
    stem = os.path.basename(prefix) + "_iter_"
    try:
        names = os.listdir(d)
    except OSError:
        return []
    out = []
    for name in names:
        if not (name.startswith(stem) and name.endswith(_MANIFEST_SUFFIX)):
            continue
        mid = name[len(stem):-len(_MANIFEST_SUFFIX)]
        if mid.endswith(".orbax"):
            mid = mid[: -len(".orbax")]
        if mid.isdigit():
            out.append((int(mid), os.path.join(d, name)))
    out.sort(key=lambda p: p[0], reverse=True)
    return out


def verified_snapshots(prefix: str):
    """Yield the verified manifests of `prefix`, newest first; a corrupt
    or incomplete one is logged and skipped."""
    for it, mpath in iter_snapshot_manifests(prefix):
        doc = verify_snapshot(mpath)
        if doc is not None:
            yield doc
            continue
        log.warning("snapshot at iter %d failed crc verification (corrupt "
                    "or incomplete); falling back to an older snapshot", it)


def latest_verified_snapshot(prefix: str) -> dict | None:
    """The newest snapshot whose manifest verifies, or None."""
    return next(verified_snapshots(prefix), None)


def gc_snapshots(prefix: str, keep: int,
                 assume_verified: str | None = None) -> list[str]:
    """Delete the snapshot sets past the newest `keep` manifests, never
    the newest VERIFIED one (if the newest `keep` are all corrupt, the
    last good one survives, so a resume has somewhere to land).
    `assume_verified` names a manifest the caller knows is good (the one
    it just wrote), which the scan does not read again. Returns the
    removed paths."""
    if keep <= 0:
        return []
    manifests = iter_snapshot_manifests(prefix)
    if len(manifests) <= keep:
        return []
    assumed = os.path.abspath(assume_verified) if assume_verified else None
    newest_verified = None
    for _it, mpath in manifests:  # newest first; stop at the first good
        if os.path.abspath(mpath) == assumed \
                or verify_snapshot(mpath) is not None:
            newest_verified = mpath
            break
    removed = []
    base = os.path.dirname(prefix) or "."
    for _it, mpath in manifests[keep:]:
        if mpath == newest_verified:
            continue
        victims, dirs = [], []
        try:
            with open(mpath) as f:
                doc = json.load(f)
            if doc.get("kind") == "orbax":
                if doc.get("dir"):  # a sharded set goes as one directory
                    dirs = [os.path.join(base, doc["dir"])]
            else:
                victims = [os.path.join(base, ent["file"])
                           for ent in doc.get("files", {}).values()]
        except (OSError, ValueError):
            victims = []
        for d in dirs:  # the directory first: a crash leaves a manifest
            try:        # that fails to verify, never an orphan directory
                shutil.rmtree(d)
                removed.append(d)
            except OSError:
                pass
        for path in victims + [mpath]:
            try:
                os.unlink(path)
                removed.append(path)
            except OSError:
                pass
    if removed:
        log.info("snapshot GC (keep=%d): removed %d file(s)", keep,
                 len(removed))
    return removed


# ---------------------------------------------------------------------------
# Quarantine journal
# ---------------------------------------------------------------------------

class QuarantineLog:
    """Journals quarantined dataset records to `<prefix>.quarantine.json`.
    The Feeder substitutes a corrupt record deterministically (a pure
    function of the record index), so the journal is an audit record:
    the operator learns WHICH records are rotting. Writes are one atomic
    rewrite per newly bad record (debounced past 64 entries), never per
    iteration. Unconfigured (no path), entries stay in memory and only
    log."""

    def __init__(self):
        self.path: str | None = None
        self.entries: list[dict] = []
        self._seen: set[tuple] = set()
        self._warned: set[tuple] = set()
        self._lock = threading.Lock()
        self._last_flush = 0.0
        self._dirty = False

    def configure(self, path: str | None) -> None:
        """Bind the journal file; entries an earlier run wrote there are
        loaded, so a resumed run appends to one record."""
        with self._lock:
            self.path = path
            self.entries = []
            self._seen = set()
            self._warned = set()
            if not path:
                return
            try:
                with open(path) as f:
                    doc = json.load(f)
                self.entries = list(doc.get("records", []))
                self._seen = {(e.get("source"), e.get("index"))
                              for e in self.entries}
            except (OSError, ValueError):
                pass

    def record(self, source: str, index: int, substitute: int,
               reason: str, key: str = "") -> None:
        with self._lock:
            if (source, index) in self._seen:
                # a probe casualty's placeholder (substitute -1) takes the
                # substitute when the record is later substituted itself
                upgraded = False
                if substitute >= 0:
                    for ent in self.entries:
                        if (ent.get("source"), ent.get("index")) == \
                                (source, index) \
                                and ent.get("substitute", -1) < 0:
                            ent["substitute"] = int(substitute)
                            ent["reason"] = reason
                            upgraded = True
                            break
                if (source, index) not in self._warned:
                    self._warned.add((source, index))
                    log.warning(
                        "quarantined record %d of %s (-> substitute %d; "
                        "already journaled by a previous attempt): %s",
                        index, source or "dataset", substitute, reason)
                if upgraded:
                    self._flush_locked()
                return
            self._seen.add((source, index))
            self._warned.add((source, index))
            self.entries.append({
                "source": source, "index": int(index), "key": key,
                "substitute": int(substitute), "reason": reason,
                "time": time.time()})
            log.warning("quarantined record %d of %s (-> substitute %d): "
                        "%s", index, source or "dataset", substitute,
                        reason)
            self._flush_locked()

    def _flush_locked(self) -> None:
        """Rewrite the journal (the caller holds the lock); past 64
        entries at most once a second, flush() drains the tail."""
        if not self.path:
            return
        self._dirty = True
        now = time.monotonic()
        if len(self.entries) > 64 and now - self._last_flush < 1.0:
            return
        self._last_flush = now
        self._dirty = False
        doc = {"schema": _JOURNAL_SCHEMA, "records": self.entries}
        try:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            with atomic_output(self.path) as tmp:
                with open(tmp, "w") as f:
                    json.dump(doc, f, indent=1, sort_keys=True)
        except OSError:
            log.exception("quarantine journal write failed (continuing)")

    def flush(self) -> None:
        """Write any debounced tail (the CLI calls it when training
        ends, on every exit path)."""
        with self._lock:
            if self._dirty:
                self._last_flush = 0.0
                self._flush_locked()

    def count(self) -> int:
        with self._lock:
            return len(self.entries)


QUARANTINE = QuarantineLog()


def quarantine_journal_path(prefix: str, rank: int = 0, world: int = 1,
                            host: int | None = None) -> str:
    """The journal of one host's quarantine decisions. One host:
    `<prefix>.quarantine.json`; in a multi-host run each host journals
    its own stripe to `<prefix>.quarantine.r<rank>.json` (N hosts
    rewriting one file would drop entries), or, when the elastic
    supervisor names the host's stable identity `host` (a generation
    remaps ranks), to `<prefix>.quarantine.h<host>.json`; rank 0 merges
    them at snapshot time (`merge_quarantine_journals`)."""
    if host is not None and world > 1:
        return prefix + f".quarantine.h{int(host)}.json"
    if world <= 1:
        return prefix + ".quarantine.json"
    return prefix + f".quarantine.r{int(rank)}.json"


def merge_quarantine_journals(prefix: str) -> int:
    """Merge the per-host journals (`<prefix>.quarantine.r*.json` and the
    host-keyed `.quarantine.h*.json`) into `<prefix>.quarantine.json`,
    deduplicated by (source, index) and sorted. Returns the merged
    record count; 0 when there is no per-host journal."""
    d = os.path.dirname(prefix) or "."
    base = os.path.basename(prefix) + ".quarantine."
    parts = sorted(
        p for stem in (base + "r", base + "h")
        for p in glob.glob(
            os.path.join(glob.escape(d), glob.escape(stem) + "*.json")))
    if not parts:
        return 0
    merged: dict[tuple, dict] = {}
    for path in parts:
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            continue
        for ent in doc.get("records", []):
            merged.setdefault((ent.get("source"), ent.get("index")), ent)
    records = sorted(merged.values(),
                     key=lambda e: (e.get("source") or "",
                                    e.get("index") or 0))
    out = {"schema": _MANIFEST_SCHEMA, "records": records,
           "merged_from": [os.path.basename(p) for p in parts]}
    with atomic_output(prefix + ".quarantine.json") as tmp:
        with open(tmp, "w") as f:
            json.dump(out, f, indent=1, sort_keys=True)
    return len(records)


# ---------------------------------------------------------------------------
# Run journal
# ---------------------------------------------------------------------------

def run_manifest_path(prefix: str) -> str:
    return prefix + ".run.json"


# concurrent same-process writers (a watchdog's monitor thread and the
# thread it interrupts) would sweep each other's pid-named temp file
_RUN_MANIFEST_LOCK = threading.Lock()


def write_run_manifest(prefix: str, **fields) -> str:
    """Journal the run state (a reason and its fields) to
    `<prefix>.run.json`. Atomic: a crash mid-journal leaves the previous
    journal intact."""
    path = run_manifest_path(prefix)
    doc = {"schema": _MANIFEST_SCHEMA, "time": time.time(),
           "pid": os.getpid(), **fields}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with _RUN_MANIFEST_LOCK:
        with atomic_output(path) as tmp:
            with open(tmp, "w") as f:
                json.dump(doc, f, indent=1, sort_keys=True)
    return path


def read_run_manifest(prefix: str) -> dict | None:
    try:
        with open(run_manifest_path(prefix)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


# ---------------------------------------------------------------------------
# Dispatch watchdog
# ---------------------------------------------------------------------------

class DispatchWatchdog:
    """Monitor thread that bounds device dispatch and harvest time.

    Callers wrap each device-blocking region in `section(label)`; the
    monitor wakes every quarter of `deadline` (within [0.05, 5] s) and,
    when the oldest open section has been
    open longer than `deadline`, calls `on_timeout(label, elapsed)` and
    ends. A call hung in the CUDA runtime cannot be interrupted from
    Python, but this thread is already in Python:

    - `hard_exit=True` (the solver's, the default): after `on_timeout`
      (the run journal, written under its lock before anything else) the
      process exits EXIT_WATCHDOG with `os._exit`, which runs no atexit
      hook and no `finally`, so a supervisor restarts it;
    - `hard_exit=False` (the serving stall breaker): the process stays
      up; the caller arms a new watchdog after recovery.

    The deadline must exceed the longest legitimate wait inside a
    section: the solver's first dispatch includes a CUDA graph capture,
    cuDNN's algorithm search and the first load of each kernel library.

    `pulse`: called once a poll from the monitor thread, before the
    deadline check (the cross-host heartbeat's `HostHeartbeat.tick`: a
    dead peer in a collective and a stuck device wait are bounded by the
    same thread). A pulse that raises is logged; a deadline of `inf`
    arms the thread for the heartbeat alone. `poll` overrides the wake
    interval."""

    def __init__(self, deadline: float, on_timeout=None, *,
                 poll: float | None = None, hard_exit: bool = True,
                 pulse=None):
        self.deadline = float(deadline)
        self.on_timeout = on_timeout
        self.pulse = pulse
        self.poll = poll if poll is not None else min(
            max(self.deadline / 4.0, 0.05), 5.0)
        self.hard_exit = hard_exit
        self._lock = threading.Lock()
        self._open: dict[int, tuple[str, float]] = {}
        self._next = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="dispatch-watchdog")
        self._thread.start()

    @contextmanager
    def section(self, label: str):
        with self._lock:
            token = self._next
            self._next += 1
            self._open[token] = (label, time.monotonic())
        try:
            yield
        finally:
            with self._lock:
                self._open.pop(token, None)

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2 * self.poll + 1.0)

    def open_sections(self) -> list[str]:
        """Labels of the open sections, oldest first (the serving
        breaker's recovery probe asks whether the stalled call retired)."""
        with self._lock:
            entries = sorted(self._open.values(), key=lambda lt: lt[1])
        return [label for label, _t0 in entries]

    def _run(self) -> None:
        while not self._stop.wait(self.poll):
            if self.pulse is not None:
                try:
                    self.pulse()
                except Exception:  # noqa: BLE001 — the deadline check runs on
                    log.exception("watchdog: pulse callback failed "
                                  "(continuing)")
            now = time.monotonic()
            with self._lock:
                oldest = min(self._open.values(), key=lambda lt: lt[1],
                             default=None)
            if oldest is None:
                continue
            label, t0 = oldest
            elapsed = now - t0
            if elapsed <= self.deadline:
                continue
            action = (f"journaling run state and hard-exiting "
                      f"{EXIT_WATCHDOG}" if self.hard_exit else
                      "journaling and tripping the breaker (process "
                      "stays up)")
            log.error("watchdog: device %s exceeded %.1fs deadline "
                      "(%.1fs elapsed) — %s", label, self.deadline,
                      elapsed, action)
            try:
                if self.on_timeout is not None:
                    self.on_timeout(label, elapsed)
            except Exception:  # noqa: BLE001 — the trip goes on regardless
                log.exception("watchdog: on_timeout callback failed")
            if self.hard_exit:
                logging.shutdown()
                sys.stderr.flush()
                os._exit(EXIT_WATCHDOG)
            return


NULL_SECTION = nullcontext()


# ---------------------------------------------------------------------------
# Cross-host heartbeat: host-loss detection
# ---------------------------------------------------------------------------

class DirBeatTransport:
    """Heartbeat transport over a shared directory (`CAFFE_TPU_HB_DIR`, and
    the elastic supervisors' `<prefix>.cluster/hb`): one atomically
    rewritten file `hb_<host>` a host, `<incarnation token>:<seq>`.
    Readers compare monotone sequence numbers only. The directory outlives
    a process, so each record carries its process's incarnation token: a
    restarted publisher's seq 0 reads as an advance (the token change is
    folded into a monotone surrogate sequence), and a farewell marker
    `bye_<host>` counts only for the incarnation whose beats are being
    read. The JAX `DirBeatTransport`'s format: either package reads what
    the other writes."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(path, exist_ok=True)
        self._nonce = f"{os.getpid()}.{int(time.time() * 1e6)}"
        self._token: dict[int, str] = {}  # each peer's current token
        self._base: dict[int, int] = {}   # its surrogate offset
        self._hi: dict[int, int] = {}     # the highest surrogate returned

    def _beat_file(self, host: int) -> str:
        return os.path.join(self.path, f"hb_{int(host)}")

    def publish(self, host: int, seq: int) -> None:
        with atomic_output(self._beat_file(host)) as tmp:
            with open(tmp, "w") as f:
                f.write(f"{self._nonce}:{int(seq)}")

    def _read(self, host: int) -> tuple[str, int] | None:
        try:
            with open(self._beat_file(host)) as f:
                token, _, seq = f.read().strip().rpartition(":")
            return (token, int(seq)) if token else None
        except (OSError, ValueError):
            return None

    def latest_seq(self, host: int) -> int:
        """The newest beat `host` has published, as a sequence monotone
        across incarnations; -1 when none. Non-blocking, and the latest,
        not an exact one: a reader that armed late catches up."""
        rec = self._read(host)
        if rec is None:
            return -1
        token, seq = rec
        if self._token.get(host) != token:
            # a new incarnation restarts at seq 0: past all the old one's
            self._base[host] = self._hi.get(host, -1) + 1
            self._token[host] = token
        val = self._base.get(host, 0) + seq
        self._hi[host] = max(self._hi.get(host, -1), val)
        return val

    def farewell(self, host: int) -> None:
        with atomic_output(os.path.join(self.path,
                                        f"bye_{int(host)}")) as tmp:
            with open(tmp, "w") as f:
                f.write(self._nonce)

    def is_bye(self, host: int) -> bool:
        try:
            with open(os.path.join(self.path, f"bye_{int(host)}")) as f:
                bye_token = f.read().strip()
        except OSError:
            return False
        # a stale marker, or one for a peer never heard, does not count
        return bool(bye_token) and bye_token == self._token.get(host)


class HostHeartbeat:
    """Cross-host liveness: a peer that dies leaves every survivor blocked
    in a collective it cannot interrupt, so detection runs on the
    watchdog's monitor thread (`DispatchWatchdog(pulse=hb.tick)`).

    Every `interval` seconds (default a quarter of the deadline, within
    [0.1, 5] s) this host publishes a sequenced beat; each tick drains
    the peers' newest beats. A peer silent past `deadline` (host-local
    receipt time, no clock sync) is lost: `on_lost(peer, elapsed)`
    journals it and the process exits EXIT_CLUSTER (87) for the
    supervisor. A peer that published its farewell is done, not mourned.
    First contact gets `grace` (default max(3 x deadline, 30 s)): peers
    arm after their own start-up. The `host_loss` fault site exits this
    process at a beat boundary (seq >= its arg)."""

    def __init__(self, transport, host_id: int, n_hosts: int,
                 deadline: float, *, on_lost=None, interval=None,
                 grace: float | None = None, hard_exit: bool = True):
        self.transport = transport
        self.host = int(host_id)
        self.peers = [p for p in range(int(n_hosts)) if p != self.host]
        self.deadline = float(deadline)
        self.interval = float(interval) if interval else min(
            max(self.deadline / 4.0, 0.1), 5.0)
        self.grace = float(grace) if grace is not None else max(
            3.0 * self.deadline, 30.0)
        self.hard_exit = hard_exit
        self.on_lost = on_lost
        self.lost: tuple[int, float] | None = None
        self.lost_event = threading.Event()
        now = time.monotonic()
        self._last_pub = 0.0
        self._seq = 0
        self._first = {p: True for p in self.peers}
        self._last_seen = {p: now for p in self.peers}
        self._last_seq = {p: -1 for p in self.peers}
        self._done: set[int] = set()
        self._pub_warned = False

    def beats_seen(self, peer: int) -> int:
        """Beats observed from `peer` so far."""
        return self._last_seq.get(peer, -1) + 1

    def tick(self) -> None:
        """One round: publish when due, drain the peers, mourn the
        silent."""
        now = time.monotonic()
        if now - self._last_pub >= self.interval:
            self._last_pub = now
            try:
                self.transport.publish(self.host, self._seq)
            except Exception as e:  # noqa: BLE001 — failure is silence
                if not self._pub_warned:
                    self._pub_warned = True
                    log.warning("heartbeat: publish failed (%s); peers "
                                "will see this host as silent", e)
            # test-only: this host dies at a beat boundary
            FAULTS.maybe_exit("host_loss", key=self._seq)
            self._seq += 1
        for p in self.peers:
            if p in self._done or self.lost is not None:
                continue
            got = False
            try:
                seq = self.transport.latest_seq(p)
                if seq > self._last_seq[p]:
                    self._last_seq[p] = seq
                    got = True
            except Exception:  # noqa: BLE001 — errors are silence
                pass
            now = time.monotonic()
            if got:
                self._first[p] = False
                self._last_seen[p] = now
                continue
            try:
                if self.transport.is_bye(p):
                    log.info("heartbeat: host %d finished cleanly", p)
                    self._done.add(p)
                    continue
            except Exception:  # noqa: BLE001 — not a clean departure
                pass
            allowance = self.deadline + (self.grace if self._first[p]
                                         else 0.0)
            if now - self._last_seen[p] > allowance:
                self._trip(p, now - self._last_seen[p])

    def _trip(self, peer: int, elapsed: float) -> None:
        log.error("heartbeat: host %d silent for %.1fs (deadline %.1fs) "
                  "— peer lost; journaling and exiting %d for the "
                  "supervisor's coordinated restart", peer, elapsed,
                  self.deadline, EXIT_CLUSTER)
        self.lost = (peer, elapsed)
        self.lost_event.set()
        try:
            if self.on_lost is not None:
                self.on_lost(peer, elapsed)
        except Exception:  # noqa: BLE001 — the trip goes on regardless
            log.exception("heartbeat: host-lost journal failed")
        if self.hard_exit:
            logging.shutdown()
            sys.stderr.flush()
            os._exit(EXIT_CLUSTER)

    def revive(self, peer: int) -> None:
        """Resume monitoring after `peer` was mourned and brought back up
        in place (the serving fleet's respawn). `tick()` latches `lost`
        and then monitors no peer; clearing the latch re-arms them all,
        and the respawned incarnation gets a fresh first-contact grace (it
        beats from seq 0 under a new incarnation token, which the
        transport reads as an advance)."""
        self.lost = None
        self.lost_event.clear()
        self._first[peer] = True
        self._last_seen[peer] = time.monotonic()
        self._done.discard(peer)

    def farewell(self) -> None:
        """Publish the clean-departure marker (after the end-of-training
        barrier): peers stop expecting beats."""
        try:
            self.transport.farewell(self.host)
        except Exception:  # noqa: BLE001 — best effort, the barrier held
            pass


# ---------------------------------------------------------------------------
# Supervisor: a contained child, exponential backoff, a crash-loop guard
# ---------------------------------------------------------------------------

def _failure_reason(rc) -> str:
    """A failed child's exit code as the failure log names it."""
    return ("deadline" if rc is None else
            "watchdog" if rc == EXIT_WATCHDOG else
            "numeric divergence" if rc == EXIT_NUMERIC else
            "fault/cluster" if rc == EXIT_FAULT else f"exit {rc}")


def supervise(first_cmd: list[str], resume_cmd: list[str],
              max_restarts: int, *, failure_log: str,
              env: dict | None = None, backoff_base: float = 1.0,
              anomaly_action: str = "rewind",
              anomaly_lr_mult: float = 0.1,
              journal_prefix: str | None = None) -> int:
    """Run a training child to completion, restarting it on failure.

    Attempt 0 runs `first_cmd`, every restart `resume_cmd` (which carries
    `-resume auto`: the newest verified snapshot). Each child runs under
    `subproc.run_contained`, in its own process group, killed on every
    exit path of the supervisor. Restarts back off exponentially from
    `backoff_base` seconds, at most _BACKOFF_CAP_S. After `max_restarts` failed restarts the
    crash-loop guard gives up; `failure_log` keeps a line for each failed
    attempt (its reason: watchdog, numeric divergence, fault/cluster or
    `exit N`, and the tail of its output). Returns the last child's exit
    code.

    Exit EXIT_NUMERIC goes through `anomaly_action`: `rewind` restarts
    like any failure; `rewind_lr` also appends `-lr_scale
    anomaly_lr_mult**k`, k the numeric restarts so far; `abort` returns
    88 without a restart.

    `journal_prefix` names the run journal: when every attempt from the
    first has ended with a fresh `cluster_init_failed` journal, the
    cluster never formed, and two such failures give up early. On one
    host nothing journals that reason, so the check stays inert."""
    from .subproc import run_contained
    os.makedirs(os.path.dirname(failure_log) or ".", exist_ok=True)
    rc = 1
    numeric_restarts = 0
    never_formed = True
    for attempt in range(max_restarts + 1):
        cmd = first_cmd if attempt == 0 else list(resume_cmd)
        if attempt > 0 and numeric_restarts and anomaly_action == "rewind_lr":
            cmd = cmd + ["-lr_scale",
                         repr(anomaly_lr_mult ** numeric_restarts)]
        log.info("supervisor: attempt %d/%d: %s", attempt + 1,
                 max_restarts + 1, " ".join(cmd))
        t0 = time.time()
        rc, out, err = run_contained(cmd, None, env=env, echo=True)
        dt = time.time() - t0
        if rc == 0:
            if attempt > 0:
                log.info("supervisor: recovered after %d restart(s)",
                         attempt)
            return 0
        reason = _failure_reason(rc)
        with open(failure_log, "a") as f:
            f.write(f"[{time.ctime()}] attempt {attempt + 1}: {reason} "
                    f"after {dt:.1f}s: {' '.join(cmd)}\n")
            tail = (out or "").strip().splitlines()[-20:] \
                + (err or "").strip().splitlines()[-20:]
            for line in tail:
                f.write(f"    {line}\n")
        if rc == EXIT_NUMERIC:
            if anomaly_action == "abort":
                log.error("supervisor: numeric divergence with "
                          "anomaly_action 'abort'; not restarting "
                          "(log: %s)", failure_log)
                return EXIT_NUMERIC
            numeric_restarts += 1
        # only a journal written during this attempt counts: a stale one
        # of an earlier run must not condemn this one
        init_fail = None
        if journal_prefix and rc == EXIT_FAULT:
            man = read_run_manifest(journal_prefix)
            if (man and man.get("reason") == "cluster_init_failed"
                    and float(man.get("time", 0) or 0) >= t0):
                init_fail = man.get("error", "")
        if init_fail is None:
            never_formed = False
        elif never_formed and attempt >= 1:
            log.error(
                "supervisor: cluster formation failed on every attempt "
                "(%d of them) — %s; the peer is unreachable, so the "
                "remaining %d restart(s) would only replay the same "
                "init timeout. Giving up (log: %s)", attempt + 1,
                init_fail or "distributed init failed",
                max_restarts - attempt, failure_log)
            break
        if attempt >= max_restarts:
            log.error("supervisor: crash-loop guard: %d failure(s); "
                      "giving up (log: %s)", attempt + 1, failure_log)
            break
        delay = min(backoff_base * (2 ** attempt), _BACKOFF_CAP_S)
        verb = ("rewinding to" if rc == EXIT_NUMERIC
                else "restarting from")
        log.warning("supervisor: child failed (%s); %s the newest "
                    "verified snapshot in %.1fs", reason, verb, delay)
        time.sleep(delay)
    return rc


# ---------------------------------------------------------------------------
# Degraded-mode elasticity: the generation protocol
# ---------------------------------------------------------------------------
# A host lost for good defeats the restart-all recovery: every survivor
# would wait in the group's formation at the old world size until its
# restarts run out. The generation protocol reshapes the cluster around
# the survivors instead. It runs at supervisor level on shared storage
# (the assumption `-resume auto` already makes of the snapshots): the
# group's store dies with rank 0's worker, so the durable channel is a
# `<prefix>.cluster/` directory of supervisor beats (DirBeatTransport,
# keyed on the ORIGINAL host ids, which survive every rank remap) and an
# atomically published generation record. Rank 0's worker mirrors the
# live record onto the store (`mesh.publish_generation`); the directory
# stays the source of truth.

_GEN_FILE = "cluster_gen.json"
_GEN_DONE = "done"


def cluster_dir(prefix: str) -> str:
    """The generation protocol's directory for a run, beside its
    snapshots."""
    return prefix + ".cluster"


def generation_path(cdir: str) -> str:
    return os.path.join(cdir, _GEN_FILE)


def initial_generation(world: int, coordinator: str) -> dict:
    """Generation 1, the operator's launch: what every supervisor assumes
    while no record exists (a run without a failure writes none)."""
    return {"generation": 1, "hosts": list(range(int(world))),
            "world": int(world), "world_full": int(world),
            "coordinator": coordinator, "reason": "cluster_formed"}


def read_generation(cdir: str) -> dict | None:
    """The current generation record, or None (generation 1). A torn or
    invalid record reads as None: the next membership round republishes."""
    try:
        with open(generation_path(cdir)) as f:
            doc = json.load(f)
        if int(doc.get("generation", 0)) >= 1 and doc.get("hosts"):
            doc["hosts"] = [int(h) for h in doc["hosts"]]
            return doc
    except (OSError, ValueError, TypeError):
        pass
    return None


def write_generation(cdir: str, gen: dict) -> str:
    """Publish a generation record: the history file `gen_<g>.json`
    first, then the live `cluster_gen.json` every parked or restarting
    supervisor polls. A new generation clears an earlier run's `done`
    marker."""
    os.makedirs(cdir, exist_ok=True)
    g = int(gen["generation"])
    doc = dict(gen, time=time.time())
    for path in (os.path.join(cdir, f"gen_{g}.json"),
                 generation_path(cdir)):
        with atomic_output(path) as tmp:
            with open(tmp, "w") as f:
                json.dump(doc, f, indent=1, sort_keys=True)
    try:
        os.unlink(os.path.join(cdir, _GEN_DONE))
    except OSError:
        pass
    return generation_path(cdir)


def observe_live_hosts(cdir: str, world_full: int, self_host: int,
                       window: float, *, min_beats: int = 2) -> list[int]:
    """One membership round: watch the supervisor beats for `window`
    seconds and return the original host ids seen alive, sorted. Each
    host's current beat is read first and only advances count, so a
    frozen file of a dead incarnation is not liveness; `min_beats`
    advances are needed. The observer is always alive."""
    tr = DirBeatTransport(os.path.join(cdir, "hb"))
    hosts = range(int(world_full))
    base = {h: tr.latest_seq(h) for h in hosts}
    advances = {h: 0 for h in hosts}
    t_end = time.monotonic() + max(window, 0.2)
    while time.monotonic() < t_end:
        time.sleep(min(0.1, window / 4))
        for h in hosts:
            seq = tr.latest_seq(h)
            if seq > base[h]:
                advances[h] += seq - base[h]
                base[h] = seq
    live = {h for h in hosts if advances[h] >= min_beats}
    live.add(int(self_host))
    return sorted(live)


class SupervisorBeat:
    """A daemon thread publishing this supervisor's beats (original host
    id) to the cluster directory. Unlike the worker's HostHeartbeat it
    outlives the worker: a host whose supervisor beats is a candidate to
    rejoin while its worker is down. pause() and resume() serve the
    `host_perma_loss` fault site (the whole host dark)."""

    def __init__(self, cdir: str, host_id: int, interval: float):
        self.transport = DirBeatTransport(os.path.join(cdir, "hb"))
        self.host = int(host_id)
        self.interval = max(float(interval), 0.05)
        self._stop = threading.Event()
        self._paused = threading.Event()
        self._seq = 0
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"sup-beat-{self.host}")

    def start(self) -> None:
        self._thread.start()

    def _run(self) -> None:
        # a beat thread that dies is a silent supervisor: the peers'
        # membership round decides, as for a dead one
        while not self._stop.is_set():
            if not self._paused.is_set():
                try:
                    self.transport.publish(self.host, self._seq)
                    self._seq += 1
                except OSError as e:
                    log.warning("supervisor beat publish failed: %s", e)
            self._stop.wait(self.interval)

    def pause(self) -> None:
        self._paused.set()

    def resume(self) -> None:
        self._paused.clear()

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)


def _wait_generation_advance(cdir: str, beyond: int,
                             timeout: float) -> dict | None:
    """Poll for a generation newer than `beyond` (a survivor waiting out
    the lowest survivor's membership round)."""
    t_end = time.monotonic() + timeout
    while time.monotonic() < t_end:
        gen = read_generation(cdir)
        if gen and gen["generation"] > beyond:
            return gen
        time.sleep(0.2)
    return None


def _rejoin_wait(cdir: str, host_id: int, beyond: int,
                 park_deadline: float) -> dict | str | None:
    """Park a host the current generation excludes: its supervisor beats
    on (rank 0's check at a snapshot boundary sees it), and this polls
    until a generation re-admits it (returned), the run finishes
    ("done"), or `park_deadline` passes (None)."""
    log.info("rejoin-wait: generation %d excludes host %d; parking, "
             "publishing beats until rank 0 re-admits this host at a "
             "snapshot boundary", beyond, host_id)
    t_end = time.monotonic() + park_deadline
    while time.monotonic() < t_end:
        if os.path.exists(os.path.join(cdir, _GEN_DONE)):
            return "done"
        gen = read_generation(cdir)
        if gen and gen["generation"] > beyond \
                and int(host_id) in gen["hosts"]:
            return gen
        time.sleep(0.25)
    return None


def supervise_elastic(build_cmd, *, prefix: str, host_id: int,
                      world_full: int, min_hosts: int,
                      host_deadline: float, coordinator_host: str,
                      coordinator: str, max_restarts: int,
                      failure_log: str, env: dict | None = None,
                      backoff_base: float = 1.0,
                      anomaly_action: str = "rewind",
                      anomaly_lr_mult: float = 0.1,
                      park_deadline: float = 900.0) -> int:
    """The degraded-mode supervisor: `supervise` plus the generation
    protocol. `build_cmd(gen, rank, resume)` returns the worker argv of a
    generation (the remapped `-hosts W' -host_id k' -coordinator <addr>`,
    `-resume auto` on a restart). The child's environment names the
    generation (CAFFE_TPU_CLUSTER_DIR, _GEN, _HOSTS, _SELF,
    CAFFE_TPU_WORLD_FULL, CAFFE_TPU_CLUSTER_DEADLINE).

    After a child fails, in order:
    1. the `host_perma_loss` fault site: this supervisor goes dark (its
       beats paused) for `arg` seconds, the whole host gone, then
       revives into step 2;
    2. a newer generation exists (a peer reshaped the cluster): one that
       includes this host is joined with a fresh restart budget; one that
       excludes it parks this host in rejoin-wait until rank 0 re-admits
       it at a snapshot boundary, or the run finishes;
    3. exit 87 (a cluster event): a membership round over the supervisor
       beats for ~host_deadline; a changed host set of at least
       `min_hosts` is published as generation g+1 by the lowest survivor
       (the new rank 0, which serves the new store on a fresh port of
       `coordinator_host`), the others wait for that record. The run
       journal and `gen_<g>.json` record `cluster_degraded:<g>` or
       `cluster_regrown:<g>`;
    4. otherwise a plain restart with exponential backoff, at most
       `max_restarts` within the generation.

    A clean exit of a reshaped run writes the `done` marker, so parked
    hosts return 0."""
    from .subproc import run_contained
    os.makedirs(os.path.dirname(failure_log) or ".", exist_ok=True)
    cdir = cluster_dir(prefix)
    os.makedirs(cdir, exist_ok=True)
    interval = min(max(float(host_deadline) / 4.0, 0.1), 2.0)
    beat = SupervisorBeat(cdir, host_id, interval)
    beat.start()
    cur = read_generation(cdir) or initial_generation(world_full,
                                                      coordinator)
    attempt = 0
    resume = cur["generation"] > 1
    numeric_restarts = 0
    rc: int | None = 1
    try:
        while True:
            if int(host_id) not in cur["hosts"]:
                got = _rejoin_wait(cdir, host_id, cur["generation"],
                                   park_deadline)
                if got == "done":
                    log.info("rejoin-wait: run finished without this "
                             "host; exiting clean")
                    return 0
                if got is None:
                    log.error("rejoin-wait: no generation re-admitted "
                              "host %d within %.0fs; giving up",
                              host_id, park_deadline)
                    return 1
                cur, attempt, resume = got, 0, True
                continue
            rank = cur["hosts"].index(int(host_id))
            cmd = list(build_cmd(cur, rank, resume))
            if resume and numeric_restarts \
                    and anomaly_action == "rewind_lr":
                cmd += ["-lr_scale",
                        repr(anomaly_lr_mult ** numeric_restarts)]
            child_env = dict(env if env is not None else os.environ)
            child_env.update(
                CAFFE_SUPERVISED_CHILD="1",
                CAFFE_TPU_CLUSTER_DIR=cdir,
                CAFFE_TPU_CLUSTER_GEN=str(cur["generation"]),
                CAFFE_TPU_CLUSTER_HOSTS=",".join(
                    str(h) for h in cur["hosts"]),
                CAFFE_TPU_CLUSTER_SELF=str(int(host_id)),
                CAFFE_TPU_WORLD_FULL=str(cur.get("world_full", world_full)),
                CAFFE_TPU_CLUSTER_DEADLINE=repr(float(host_deadline)))
            log.info("supervisor[gen %d]: attempt %d/%d as rank %d/%d: "
                     "%s", cur["generation"], attempt + 1,
                     max_restarts + 1, rank, cur["world"], " ".join(cmd))
            t0 = time.time()
            rc, out, err = run_contained(cmd, None, env=child_env,
                                         echo=True)
            dt = time.time() - t0
            if rc == 0:
                if cur["generation"] > 1:
                    # release a parked host; every finishing supervisor
                    # may write it, and only its existence signals
                    try:
                        with open(os.path.join(cdir, _GEN_DONE), "w") as f:
                            f.write(f"{time.time()}\n")
                    except OSError as e:
                        log.warning("done-marker write failed: %s", e)
                if attempt > 0 or cur["generation"] > 1:
                    log.info("supervisor: recovered (generation %d, %d "
                             "restart(s) in it)", cur["generation"],
                             attempt)
                return 0
            reason = _failure_reason(rc)
            with open(failure_log, "a") as f:
                f.write(f"[{time.ctime()}] gen {cur['generation']} "
                        f"attempt {attempt + 1}: {reason} after "
                        f"{dt:.1f}s: {' '.join(cmd)}\n")
                tail = (out or "").strip().splitlines()[-20:] \
                    + (err or "").strip().splitlines()[-20:]
                for line in tail:
                    f.write(f"    {line}\n")
            if rc == EXIT_NUMERIC:
                if anomaly_action == "abort":
                    log.error("supervisor: numeric divergence with "
                              "anomaly_action 'abort'; not restarting "
                              "(log: %s)", failure_log)
                    return EXIT_NUMERIC
                numeric_restarts += 1
            # test-only: the whole host (supervisor too) goes dark
            dark = FAULTS.fire("host_perma_loss")
            if dark is not None:
                park = float(dark) if dark else 8.0
                log.warning("fault host_perma_loss: host %d supervisor "
                            "dark for %.1fs", host_id, park)
                beat.pause()
                time.sleep(park)
                beat.resume()
                log.warning("fault host_perma_loss: host %d supervisor "
                            "revived", host_id)
            newer = read_generation(cdir)
            if newer and newer["generation"] > cur["generation"]:
                log.info("supervisor: generation %d -> %d (published "
                         "by a peer while this host was down)",
                         cur["generation"], newer["generation"])
                cur, attempt, resume = newer, 0, True
                continue
            if rc == EXIT_CLUSTER:
                window = max(float(host_deadline), 8 * interval)
                live = observe_live_hosts(cdir, world_full, host_id, window)
                if sorted(live) != sorted(cur["hosts"]) \
                        and len(live) >= max(int(min_hosts), 1):
                    if min(live) == int(host_id):
                        g = cur["generation"] + 1
                        event = ("cluster_degraded"
                                 if len(live) < len(cur["hosts"])
                                 else "cluster_regrown")
                        newgen = {
                            "generation": g, "hosts": live,
                            "world": len(live),
                            "world_full": int(world_full),
                            "coordinator":
                                f"{coordinator_host}:{_free_port()}",
                            "reason": event, "prev_hosts": cur["hosts"]}
                        write_generation(cdir, newgen)
                        try:
                            write_run_manifest(
                                prefix, reason=f"{event}:{g}",
                                generation=g, hosts=live, world=len(live),
                                world_full=int(world_full))
                        except OSError:
                            log.exception("generation journal failed "
                                          "(continuing)")
                        log.warning(
                            "supervisor: published generation %d (%s): "
                            "hosts %s -> %s, world %d", g, event,
                            cur["hosts"], live, len(live))
                        cur, attempt, resume = newgen, 0, True
                        continue
                    got = _wait_generation_advance(
                        cdir, cur["generation"], window + 15.0)
                    if got is not None:
                        cur, attempt, resume = got, 0, True
                        continue
                    log.warning("supervisor: membership changed (%s -> "
                                "%s) but host %d never published a "
                                "generation; falling back to a plain "
                                "restart", cur["hosts"], live, min(live))
            attempt += 1
            if attempt > max_restarts:
                log.error("supervisor: crash-loop guard: %d failure(s) "
                          "in generation %d; giving up (log: %s)",
                          attempt, cur["generation"], failure_log)
                return 1 if rc is None else rc
            delay = min(backoff_base * (2 ** (attempt - 1)),
                        _BACKOFF_CAP_S)
            verb = ("rewinding to" if rc == EXIT_NUMERIC
                    else "restarting from")
            log.warning("supervisor: child failed (%s); %s the newest "
                        "verified snapshot in %.1fs", reason, verb, delay)
            time.sleep(delay)
            resume = True
    finally:
        beat.stop()


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]
