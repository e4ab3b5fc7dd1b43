"""Typed serving-plane failures.

Own copy of the JAX package's caffe_mpi_tpu/serving/errors.py. Every class
carries a machine-readable `kind` and the `http_status` the HTTP front
maps it to, so a client can tell a shed request (429: retry with backoff)
from a missed deadline (504: the answer is stale anyway) and from a closed
or unhealthy engine (503: find another replica).
"""

from __future__ import annotations


class ServingError(RuntimeError):
    """Base class for typed serving-plane failures."""

    kind = "error"
    http_status = 500


class ShedError(ServingError):
    """Load-shedding admission control (serve_queue_limit): the
    per-engine backlog is at its bound and this request was refused at
    submit time — fail fast instead of growing an unbounded queue."""

    kind = "shed"
    http_status = 429


class EngineUnhealthyError(ShedError):
    """The dispatch stall breaker is open (a device call blew past
    `serve_stall_s`): requests shed at once instead of queueing behind a
    hung dispatch. A recovery probe that closes the breaker clears it."""

    kind = "unhealthy"
    http_status = 503


class DeadlineError(ServingError):
    """The request could not dispatch before its `serve_deadline_ms`
    deadline (checked at window close), or its in-flight dispatch was
    declared stalled by the breaker: the caller gets a bounded failure
    instead of an unbounded wait."""

    kind = "deadline"
    http_status = 504


class EngineClosedError(ServingError):
    """The engine is shut down (or draining for shutdown): no new
    requests are accepted."""

    kind = "closed"
    http_status = 503


class SwapError(ServingError):
    """A hot-swap candidate was rejected: unloadable or shape-mismatched
    weights, or a failed canary forward (non-finite or wrong-shaped
    scores). The previous weights keep serving; the rejection is
    journaled."""

    kind = "swap"
    http_status = 500
