"""Which layer types may compute in bfloat16.

The port's copy of the two registries of the JAX package's
`caffe_mpi_tpu/proto/netshape.py` (BF16_INELIGIBLE, BF16_ELIGIBLE), which
that package's net-dtype lint and its `Net` build read. An ineligible
layer re-enters Python through a host callback or does host I/O with
float32 buffers, so a FLOAT16 request on it is not honoured: `Net` warns
at build. Every layer type the JAX package registers is in exactly one
of the two sets.
"""

BF16_INELIGIBLE = frozenset({
    "Python", "DetectNetTransformation", "HDF5Output",
})
BF16_ELIGIBLE = frozenset({
    "AbsVal", "Accuracy", "ArgMax", "Attention", "BNLL", "BatchNorm",
    "BatchReindex", "Bias", "Concat", "ContrastiveLoss", "Convolution",
    "Crop", "Data", "Deconvolution", "Dropout", "DummyData", "ELU",
    "Eltwise", "Embed", "EuclideanLoss", "Exp", "Filter", "Flatten",
    "HDF5Data", "HingeLoss", "Im2col", "ImageData", "InfogainLoss",
    "InnerProduct", "Input", "L1Loss", "LRN", "LayerNorm", "Log", "MVN",
    "MemoryData", "MoE", "MultinomialLogisticLoss", "PReLU", "Parameter",
    "Pipeline", "Pooling", "Power", "ReLU", "Reduction", "Reshape",
    "SPP", "Scale", "Sigmoid", "SigmoidCrossEntropyLoss", "Silence",
    "Slice", "Softmax", "SoftmaxWithLoss", "Split", "TanH", "Threshold",
    "Tile", "WindowData",
})
