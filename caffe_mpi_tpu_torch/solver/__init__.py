"""Training: the solver, its update rules and its LR schedules."""

from .solver import Solver

__all__ = ["Solver"]
