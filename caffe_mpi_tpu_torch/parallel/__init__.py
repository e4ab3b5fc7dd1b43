"""Data-parallel training: the process group and the gradient reduction
(the JAX package's caffe_mpi_tpu/parallel/mesh.py and reduction.py)."""

from .mesh import MeshPlan  # noqa: F401
