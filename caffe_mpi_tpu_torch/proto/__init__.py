"""Config layer: prototxt text-format parsing + typed Caffe parameter schema.

Reference: src/caffe/proto/caffe.proto (compiled with protoc there;
dataclasses coerced from the text-format tree here — see config.py and
text_format.py for the per-message mapping).

The port keeps its own copy of the JAX package's `caffe_mpi_tpu/proto/`
(text_format, config, upgrade): it imports nothing of that package, so a
schema change there has to be mirrored here by hand.
"""

from .text_format import PbEnum, PbNode, PrototxtError, parse, parse_file
from .config import (
    AccuracyParameter,
    BatchNormParameter,
    BiasParameter,
    BlobShape,
    ConcatParameter,
    ConvolutionParameter,
    DataParameter,
    DropoutParameter,
    DummyDataParameter,
    EltwiseParameter,
    FillerParameter,
    InnerProductParameter,
    InputParameter,
    LayerParameter,
    LossParameter,
    LRNParameter,
    Message,
    NetParameter,
    NetState,
    NetStateRule,
    ParamSpec,
    PoolingParameter,
    ReLUParameter,
    ScaleParameter,
    SliceParameter,
    SoftmaxParameter,
    SolverParameter,
    TransformationParameter,
    solver_type,
)
from .upgrade import filter_net, layer_included, normalize_net, state_meets_rule

__all__ = [
    "AccuracyParameter", "BatchNormParameter", "BiasParameter", "BlobShape",
    "ConcatParameter", "ConvolutionParameter", "DataParameter",
    "DropoutParameter", "DummyDataParameter", "EltwiseParameter",
    "FillerParameter", "InnerProductParameter", "InputParameter",
    "LayerParameter", "LossParameter", "LRNParameter", "Message",
    "NetParameter", "NetState", "NetStateRule", "ParamSpec", "PbEnum",
    "PbNode", "PoolingParameter", "PrototxtError", "ReLUParameter",
    "ScaleParameter", "SliceParameter", "SoftmaxParameter", "SolverParameter",
    "TransformationParameter", "filter_net", "layer_included", "normalize_net",
    "parse", "parse_file", "solver_type", "state_meets_rule",
]
