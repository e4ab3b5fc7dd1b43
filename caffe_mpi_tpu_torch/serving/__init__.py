"""Inference serving plane: bucketed device-resident models (a CUDA graph
per bucket on the card) behind a continuous batcher, the request-ingest
plane, a stdlib HTTP front, the snapshot watcher that hot-swaps a
training run's verified snapshots, and the fleet of replica processes
behind a typed-retry router. See engine.py and fleet.py for the design
notes.

The names below load on first use: the fleet's router and supervisor
(fleet.py) and the watcher import no torch, so a process that only routes
never imports the engine.
"""

from importlib import import_module

_HOMES = {
    "BucketedForward": "engine", "CompileCounter": "engine",
    "InferenceModel": "engine", "ServingEngine": "engine",
    "bucket_for": "plan", "declared_batch": "plan",
    "plan_admission": "plan", "plan_ladder": "plan", "plan_model": "plan",
    "ServingError": "errors", "ShedError": "errors",
    "EngineClosedError": "errors", "EngineUnhealthyError": "errors",
    "DeadlineError": "errors", "SwapError": "errors",
    "SnapshotWatcher": "watch",
    "FleetRouter": "fleet", "FleetSupervisor": "fleet",
    "HttpReplicaClient": "fleet", "ReplicaHandle": "fleet",
    "make_router_server": "fleet",
}

__all__ = list(_HOMES)


def __getattr__(name):
    home = _HOMES.get(name)
    if home is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(import_module(f".{home}", __name__), name)
    globals()[name] = value
    return value
