"""Layer zoo. Importing this package registers every ported layer type."""

from . import (activations, data_layers, dense, extension,  # noqa: F401
               losses, norm, sequence, shape_ops, vision)
from .base import LAYER_REGISTRY, Layer, ParamDecl, create_layer, register

__all__ = ["LAYER_REGISTRY", "Layer", "ParamDecl", "create_layer",
           "register"]
