"""Inference serving plane: bucketed device-resident models (a CUDA graph
per bucket on the card) behind a continuous batcher, the request-ingest
plane, a stdlib HTTP front and the snapshot watcher that hot-swaps a
training run's verified snapshots. See engine.py for the design notes."""

from .engine import (BucketedForward, CompileCounter, InferenceModel,
                     ServingEngine)
from .errors import (DeadlineError, EngineClosedError, EngineUnhealthyError,
                     ServingError, ShedError, SwapError)
from .plan import (bucket_for, declared_batch, plan_admission, plan_ladder,
                   plan_model)
from .watch import SnapshotWatcher

__all__ = [
    "BucketedForward", "CompileCounter", "InferenceModel", "ServingEngine",
    "bucket_for", "declared_batch", "plan_admission", "plan_ladder",
    "plan_model", "ServingError", "ShedError", "EngineClosedError",
    "EngineUnhealthyError", "DeadlineError", "SwapError", "SnapshotWatcher",
]
