"""Resilience: numeric divergence, and the data plane's integrity errors,
fault sites, bounded retry and quarantine journal.

The port's copy of what it needs of the JAX package's
`caffe_mpi_tpu/utils/resilience.py`:

- EXIT_NUMERIC and NumericAnomalyError (the skip-step guard's exit);
- RecordIntegrityError (one record failed its crc32c, its page structure
  or its parse) and DataIntegrityError (corruption past the quarantine
  bound: systematic, not record-level);
- the fault sites the data plane reads (`FAULTS`: `feeder_read`,
  `record_corrupt`, `record_decode`), configured from the
  `CAFFE_TPU_FAULTS` environment variable and free when it is unset;
- `retrying`, the bounded backoff of a dataset read;
- the quarantine journal `QUARANTINE`, bound by the CLI to
  `quarantine_journal_path(<snapshot_prefix>)` (one host);
- the serving plane's fault sites (`serve_dispatch_stall`,
  `swap_canary_bad`), the run journal (`run_manifest_path`,
  `write_run_manifest`, `read_run_manifest`: the serving journal
  `<model>.serve.run.json`) and the `DispatchWatchdog` behind the serving
  stall breaker.

The snapshot manifests, the supervisor and its `anomaly_action` policy
are not ported (ROADMAP.md section 1 item 4), nor the multi-host journal
merge (item 6).
"""

from __future__ import annotations

import glob
import json
import logging
import os
import threading
import time
from contextlib import contextmanager

log = logging.getLogger("caffe_mpi_tpu_torch.resilience")

# the CLI's exit code for a numeric divergence, which a supervisor maps
# to a rewind (the JAX package's EXIT_NUMERIC)
EXIT_NUMERIC = 88

_JOURNAL_SCHEMA = 1
_MANIFEST_SCHEMA = 1


class NumericAnomalyError(RuntimeError):
    """Training declared numeric divergence: `guard_max_skips`
    consecutive steps were skipped by the skip-step guard (non-finite
    values, or a loss spike). The CLI exits EXIT_NUMERIC on it."""

    def __init__(self, it: int, consec: int, skipped: int, last_bad: int):
        self.iter = it
        self.consec = consec
        self.skipped = skipped
        self.last_bad = last_bad
        super().__init__(
            f"numeric divergence at iteration {it}: {consec} consecutive "
            f"skipped step(s) ({skipped} total; last bad iteration "
            f"{last_bad})")


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


# ---------------------------------------------------------------------------
# Fault sites (test-only; environment-keyed; free when off)
# ---------------------------------------------------------------------------

# the sites of the data plane, as the JAX package's FAULT_SITES names them
FAULT_SITES = {
    "feeder_read": "transient dataset read error (Feeder retry budget)",
    "record_corrupt": "flip a byte of record values [arg, arg+count) "
                      "after fetch (bitrot the crc check must catch)",
    "record_decode": "truncate record values [arg, arg+count) so the "
                     "Datum parse fails",
    "serve_dispatch_stall": "sleep arg seconds (default 30) inside a "
                            "serving dispatch (stall breaker trip)",
    "swap_canary_bad": "poison a hot-swap candidate's loaded weights "
                       "with NaN (the canary gate must roll back)",
}


class FaultPlane:
    """Injects failures at named sites, configured from the
    `CAFFE_TPU_FAULTS` environment variable: comma-separated
    `site:count:skip:arg` entries (count defaults 1, skip 0, arg empty).
    `fire()` fires on the (skip+1)-th .. (skip+count)-th calls, then never
    again (count <= 0: on every call); `fire_at()` fires for keys in
    [arg, arg + count) without using the count up, so a record's fate is a
    pure function of its index. With no sites configured each check is
    one falsy dict test."""

    def __init__(self):
        self._sites: dict[str, dict] = {}
        self._lock = threading.Lock()

    def load_env(self) -> None:
        self.configure(os.environ.get("CAFFE_TPU_FAULTS", ""))

    def configure(self, spec: str) -> None:
        sites = {}
        for entry in (spec or "").split(","):
            entry = entry.strip()
            if not entry:
                continue
            parts = entry.split(":")
            site = parts[0]
            if site not in FAULT_SITES:
                continue  # a site of a plane not ported yet
            sites[site] = {
                "count": int(parts[1]) if len(parts) > 1 and parts[1] else 1,
                "skip": int(parts[2]) if len(parts) > 2 and parts[2] else 0,
                "arg": parts[3] if len(parts) > 3 else ""}
        with self._lock:
            self._sites = sites

    def active(self, site: str) -> bool:
        """Is `site` configured (without using up a firing)?"""
        return bool(self._sites) and site in self._sites

    def fire(self, site: str) -> str | None:
        """The site's arg when this call should fail, else None."""
        if not self._sites:
            return None
        with self._lock:
            st = self._sites.get(site)
            if st is None:
                return None
            if st["skip"] > 0:
                st["skip"] -= 1
                return None
            if st["count"] > 0:
                st["count"] -= 1
                if st["count"] == 0:
                    del self._sites[site]
            return st["arg"]

    def fire_at(self, site: str, key: float) -> str | None:
        """Fires iff arg <= key < arg + count (every key from arg on when
        count <= 0), using nothing up."""
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
            return st["arg"]

    def corrupt_bytes(self, site: str, raw, key: float):
        """Record-level injection on FETCHED bytes: `record_corrupt` flips
        one mid-record byte, `record_decode` truncates the record."""
        if self.fire_at(site, key) is None:
            return raw
        if site == "record_decode":
            return bytes(raw[:max(len(raw) // 2, 1)])
        b = bytearray(raw)
        if b:
            b[len(b) // 2] ^= 0xFF
        return bytes(b)

    def maybe_raise(self, site: str, exc_type=OSError, msg: str = "") -> None:
        if self.fire(site) is not None:
            raise exc_type(msg or f"injected fault at site {site!r}")

    def maybe_stall(self, site: str) -> None:
        arg = self.fire(site)
        if arg is not None:
            secs = float(arg or 30.0)
            log.warning("fault plane: stalling %.1fs at site %r", secs, site)
            time.sleep(secs)


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
# Quarantine journal
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


def quarantine_journal_path(prefix: str) -> str:
    """The journal of one host's quarantine decisions,
    `<prefix>.quarantine.json` (the JAX package's single-host path)."""
    return prefix + ".quarantine.json"


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
    """Monitor thread that bounds device dispatch and harvest time: the
    serving stall breaker (the JAX package's watchdog in its
    `hard_exit=False` mode).

    Callers wrap each device-blocking region in `section(label)`; the
    monitor wakes a quarter of `deadline` apart and, when the oldest open
    section has been open longer than `deadline`, calls `on_timeout(label,
    elapsed)` and ends: a call hung in the CUDA runtime cannot be
    interrupted from Python, but this thread is already in Python. The
    process stays up; the caller arms a new watchdog after recovery."""

    def __init__(self, deadline: float, on_timeout):
        self.deadline = float(deadline)
        self.on_timeout = on_timeout
        self.poll = min(max(self.deadline / 4.0, 0.05), 5.0)
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
            log.error("watchdog: device %s exceeded %.1fs deadline "
                      "(%.1fs elapsed) — journaling and tripping the "
                      "breaker (process stays up)", label, self.deadline,
                      elapsed)
            try:
                self.on_timeout(label, elapsed)
            except Exception:  # noqa: BLE001 — the trip goes on regardless
                log.exception("watchdog: on_timeout callback failed")
            return
