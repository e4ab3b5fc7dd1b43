"""Training: the solver, its update rules and its LR schedules (the JAX
package's caffe_mpi_tpu/solver/__init__.py)."""

from .solver import Solver

__all__ = ["Solver"]
