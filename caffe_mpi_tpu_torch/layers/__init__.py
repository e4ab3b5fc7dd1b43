"""Layer zoo. Importing this package registers every ported layer type."""

from . import activations, data_layers, dense, losses, vision  # noqa: F401
from .base import LAYER_REGISTRY, Layer, ParamDecl, create_layer, register

__all__ = ["LAYER_REGISTRY", "Layer", "ParamDecl", "create_layer",
           "register"]
