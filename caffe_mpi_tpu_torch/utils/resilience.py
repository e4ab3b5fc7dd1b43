"""Numeric divergence: the error the skip-step guard raises, and its exit
code.

The port's copy of the JAX package's `caffe_mpi_tpu/utils/resilience.py`
EXIT_NUMERIC and NumericAnomalyError. The run-manifest journal, the
supervisor and its `anomaly_action` policy are not ported (ROADMAP.md
section 1 item 4).
"""

# the CLI's exit code for a numeric divergence, which a supervisor maps
# to a rewind (the JAX package's EXIT_NUMERIC)
EXIT_NUMERIC = 88


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
