"""Inference serving plane: bucketed device-resident models behind a
continuous batcher. See engine.py for the design notes."""

from .engine import BucketedForward, InferenceModel, ServingEngine
from .errors import EngineClosedError, ServingError, ShedError
from .plan import bucket_for, plan_ladder

__all__ = [
    "BucketedForward", "InferenceModel", "ServingEngine", "bucket_for",
    "plan_ladder", "ServingError", "ShedError", "EngineClosedError",
]
