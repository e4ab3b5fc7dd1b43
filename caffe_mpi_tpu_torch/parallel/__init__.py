"""Multi-device training: the process group and the gradient reduction
(the JAX package's caffe_mpi_tpu/parallel/mesh.py and reduction.py), the
model axis's pipeline (pipeline.py) and GPipe over heterogeneous stages
(gpipe.py)."""

from .mesh import MeshPlan  # noqa: F401
