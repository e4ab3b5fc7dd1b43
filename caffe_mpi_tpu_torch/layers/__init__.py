"""Layer zoo. Importing this package registers every ported layer type
(the JAX package's caffe_mpi_tpu/layers/__init__.py)."""

from . import (activations, composite, data_layers,  # noqa: F401
               dense, detection, extension, losses, norm, sequence,
               shape_ops, vision)
from .base import LAYER_REGISTRY, Layer, ParamDecl, create_layer, register

__all__ = ["LAYER_REGISTRY", "Layer", "ParamDecl", "create_layer",
           "register"]
