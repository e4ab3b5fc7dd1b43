"""Typed serving-plane failures.

Own copy of the JAX package's caffe_mpi_tpu/serving/errors.py, cut to the
failures the port's engine raises. Every class carries a machine-readable
`kind` and the `http_status` an HTTP front would map it to, so a client can
tell a shed request (retry with backoff) from a closed engine (find another
replica).
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


class EngineClosedError(ServingError):
    """The engine is shut down (or draining for shutdown): no new
    requests are accepted."""

    kind = "closed"
    http_status = 503
