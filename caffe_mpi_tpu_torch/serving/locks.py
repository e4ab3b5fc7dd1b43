"""Declared lock-nesting order for the port's threaded planes.

Port of the JAX package's caffe_mpi_tpu/serving/locks.py. `LOCK_ORDER`
is the declared partial order over the port's lock ids, and the lint's
`lock-order` pass (tools/lint/concurrency.py) checks every nesting in the
tree against it: direct `with` nesting, `.acquire()` under a held lock,
and lock acquisitions reachable through resolvable calls. A pair that is
neither declared here nor waived in the code is a finding; an inverted
pair (the declared order run backwards) is a louder one. A pair absent
from this order is therefore forbidden by default.

Lock ids are `ClassName.attr` for instance locks and `module_stem.NAME`
for module-level locks, as the pass discovers them from
`self.X = threading.Lock()/RLock()/Condition()` and `NAME =
threading.Lock()` assignments. The pass also holds this file to the tree:
an id naming a lock that does not exist is itself a finding.
"""

from __future__ import annotations

# Allowed nesting edges, outer -> inner, each with its reason. The pass
# takes the transitive closure, so a->b and b->c also permit a->c.
LOCK_ORDER: tuple[tuple[str, str], ...] = (
    # as in the JAX package: swap_weights commits the candidate under the
    # engine lock while holding the model's upload lock; a concurrent
    # ensure_resident holding _upload_lock for an upload only delays the
    # commit. The reverse (engine._lock held while waiting on an upload
    # lock) is the swap-against-spill deadlock and is not declared: the
    # LRU only try-acquires a victim's upload lock (a waiver in engine.py)
    ("InferenceModel._upload_lock", "ServingEngine._lock"),
    # as in the JAX package: the dispatcher resolves models and counts
    # unhealthy sheds (engine.model, note_unhealthy_shed -> engine._lock)
    # while holding the batching condition variable; the engine never
    # touches batcher state under its own lock
    ("Batcher._cv", "ServingEngine._lock"),
    # as in the JAX package: probe_recovery respawns dead worker threads
    # (ensure_threads -> Batcher._cv), reads the tripped watchdog
    # (open_sections -> DispatchWatchdog._lock) and journals the recovery
    # (write_run_manifest serializes its own writers) while serializing
    # recovery probes
    ("ServingEngine._probe_lock", "Batcher._cv"),
    ("ServingEngine._probe_lock", "DispatchWatchdog._lock"),
    ("ServingEngine._probe_lock", "resilience._RUN_MANIFEST_LOCK"),
    # the port's: an upload recaptures the graphs a spill dropped
    # (ensure_resident -> build_bucket) under the model's upload lock;
    # build_bucket takes the run lock (the static buffers) and, through
    # net_for, the bucket-net lock. Neither is ever held while taking an
    # upload lock: dispatches take the run lock only after the model is
    # resident
    ("InferenceModel._upload_lock", "BucketedForward._run_lock"),
    # the port's: a bucket forward under the run lock builds its bucket
    # net on first use (net_for -> BucketedForward._lock), which guards
    # only the net table and takes no other lock
    ("BucketedForward._run_lock", "BucketedForward._lock"),
    # as in the JAX package (the warm's compile count): build_bucket
    # counts a capture (CompileCounter.bump) while it holds the run lock,
    # and the counter's lock is a leaf
    ("BucketedForward._run_lock", "CompileCounter._lock"),
    # as in the JAX package: the fleet router's rolling swap. _swap_lock
    # serializes a rollout end to end (stage, canary, propagate, roll
    # back) and nests _lock only for rotation snapshots and counter
    # bumps; every replica HTTP call and file copy runs with _lock
    # released. The reverse (holding _lock across a swap) would park
    # every routed request behind a rollout and is not declared
    ("FleetRouter._swap_lock", "FleetRouter._lock"),
    # as in the JAX package: the rollout journals rejections and rollbacks
    # while still serialized (write_run_manifest serializes its writers)
    ("FleetRouter._swap_lock", "resilience._RUN_MANIFEST_LOCK"),
)

# Attribute types the AST cannot infer (constructor parameters stored as
# attributes), so that the pass resolves `self._engine.model(...)`-style
# calls to the class whose locks they take; both sides of each entry are
# held to the tree.
ATTR_TYPES: dict[str, str] = {
    "Batcher._engine": "ServingEngine",
    "BucketedForward.counter": "CompileCounter",
    "InferenceModel.fwd": "BucketedForward",
    "ServingEngine._batcher": "Batcher",
    "ServingEngine._watchdog": "DispatchWatchdog",
}
