"""Net normalization + phase/stage/level filtering.

Mirrors the reference's legacy-migration and rule-evaluation behavior:
- `upgrade_proto.cpp` migrates V0/V1 nets on every load; here `normalize_net`
  folds the legacy `layers:`/`input:`/`input_dim:` fields into the modern
  `layer:` form and maps V1 ALL-CAPS type enums to modern type names.
- `net.cpp:407-498` (FilterNet/StateMeetsRule) selects which layers are live
  for a given NetState (phase/level/stages); `filter_net` reproduces those
  rules so one prototxt serves train/test/deploy.
"""

from __future__ import annotations

import dataclasses

from .config import (
    BlobShape,
    ConvolutionParameter,
    DataParameter,
    DropoutParameter,
    FillerParameter,
    HDF5DataParameter,
    ImageDataParameter,
    InfogainLossParameter,
    InnerProductParameter,
    InputParameter,
    LayerParameter,
    LRNParameter,
    NetParameter,
    NetState,
    NetStateRule,
    ParamSpec,
    PoolingParameter,
    TransformationParameter,
    WindowDataParameter,
)

# V1LayerParameter ALL-CAPS enum -> modern type string
# (reference upgrade_proto.cpp UpgradeV1LayerType)
_V1_TYPE_NAMES = {
    "ABSVAL": "AbsVal", "ACCURACY": "Accuracy", "ARGMAX": "ArgMax",
    "BNLL": "BNLL", "CONCAT": "Concat", "CONTRASTIVE_LOSS": "ContrastiveLoss",
    "CONVOLUTION": "Convolution", "DATA": "Data", "DECONVOLUTION": "Deconvolution",
    "DROPOUT": "Dropout", "DUMMY_DATA": "DummyData",
    "EUCLIDEAN_LOSS": "EuclideanLoss", "ELTWISE": "Eltwise", "EXP": "Exp",
    "FLATTEN": "Flatten", "HDF5_DATA": "HDF5Data", "HDF5_OUTPUT": "HDF5Output",
    "HINGE_LOSS": "HingeLoss", "IM2COL": "Im2col", "IMAGE_DATA": "ImageData",
    "INFOGAIN_LOSS": "InfogainLoss", "INNER_PRODUCT": "InnerProduct",
    "LRN": "LRN", "MEMORY_DATA": "MemoryData",
    "MULTINOMIAL_LOGISTIC_LOSS": "MultinomialLogisticLoss", "MVN": "MVN",
    "POOLING": "Pooling", "POWER": "Power", "RELU": "ReLU",
    "SIGMOID": "Sigmoid", "SIGMOID_CROSS_ENTROPY_LOSS": "SigmoidCrossEntropyLoss",
    "SILENCE": "Silence", "SOFTMAX": "Softmax", "SOFTMAX_LOSS": "SoftmaxWithLoss",
    "SPLIT": "Split", "SLICE": "Slice", "TANH": "TanH",
    "WINDOW_DATA": "WindowData", "THRESHOLD": "Threshold",
}


def normalize_net(net: NetParameter) -> NetParameter:
    """Fold legacy fields into modern form, in place; returns the net."""
    if net.layers and net.layer:
        raise ValueError(
            "net mixes legacy 'layers' and modern 'layer' fields; migrate "
            "the legacy entries (reference upgrade_proto.cpp errors here too)"
        )
    if net.layers:
        net.layer = net.layers
        net.layers = []
    for lp in net.layer:
        _migrate_v0_layer(lp)
        if lp.type in _V1_TYPE_NAMES:
            lp.type = _V1_TYPE_NAMES[lp.type]
        _migrate_v1_blob_multipliers(lp)
    # Legacy net-level inputs -> synthetic Input layer at the front
    # (reference upgrade_proto.cpp UpgradeNetInput).
    if net.input:
        shapes: list[BlobShape] = []
        if net.input_shape:
            shapes = list(net.input_shape)
        elif net.input_dim:
            if len(net.input_dim) != 4 * len(net.input):
                raise ValueError(
                    f"input_dim count {len(net.input_dim)} != 4 * inputs"
                )
            for i in range(len(net.input)):
                shape = BlobShape()
                shape.dim = list(net.input_dim[4 * i : 4 * i + 4])
                shapes.append(shape)
        if len(shapes) not in (0, len(net.input)):
            raise ValueError("input_shape count must match input count")
        lp = LayerParameter(name="input", type="Input", top=list(net.input))
        lp.input_param = InputParameter(shape=shapes)
        net.layer.insert(0, lp)
        net.input, net.input_shape, net.input_dim = [], [], []
    return net


# V0 string type -> modern type name (upgrade_proto.cpp UpgradeV0LayerType)
_V0_TYPE_NAMES = {
    "accuracy": "Accuracy", "bnll": "BNLL", "concat": "Concat",
    "conv": "Convolution", "data": "Data", "dropout": "Dropout",
    "euclidean_loss": "EuclideanLoss", "flatten": "Flatten",
    "hdf5_data": "HDF5Data", "hdf5_output": "HDF5Output",
    "im2col": "Im2col", "images": "ImageData",
    "infogain_loss": "InfogainLoss", "innerproduct": "InnerProduct",
    "lrn": "LRN", "multinomial_logistic_loss": "MultinomialLogisticLoss",
    "pool": "Pooling", "relu": "ReLU", "sigmoid": "Sigmoid",
    "softmax": "Softmax", "softmax_loss": "SoftmaxWithLoss",
    "split": "Split", "tanh": "TanH", "window_data": "WindowData",
}


def _migrate_v0_layer(lp: LayerParameter) -> None:
    """V0 'layers { layer { ... } bottom: ... }' -> modern LayerParameter
    (reference upgrade_proto.cpp UpgradeV0LayerParameter ~1.2k LoC; the
    V0LayerParameter schema is caffe.proto:1473-1559). V0 keeps every
    hyperparameter flat inside the nested `layer` message; this expands
    them into today's typed *_param sub-messages in place."""
    node = getattr(lp, "_node", None)
    if node is None or "layer" not in node:
        return
    v0 = node.get("layer")
    v0_type = str(v0.get("type", ""))
    if v0_type == "padding":
        raise ValueError(
            "V0 'padding' layers are not supported: fold the pad into the "
            "following conv layer (reference UpgradeV0PaddingLayers)")
    if v0_type not in _V0_TYPE_NAMES:
        raise ValueError(f"unknown V0 layer type {v0_type!r}")
    lp.name = str(v0.get("name", ""))
    lp.type = _V0_TYPE_NAMES[v0_type]

    def filler(key):
        n = v0.get(key)
        return FillerParameter.from_node(n) if n is not None else None

    if v0_type == "conv":
        lp.convolution_param = ConvolutionParameter(
            num_output=int(v0.get("num_output", 0)),
            bias_term=bool(v0.get("biasterm", True)),
            pad=[int(v0.get("pad"))] if "pad" in v0 else [],
            kernel_size=[int(v0.get("kernelsize", 0))],
            stride=[int(v0.get("stride"))] if "stride" in v0 else [],
            group=int(v0.get("group", 1)),
            weight_filler=filler("weight_filler"),
            bias_filler=filler("bias_filler"))
    elif v0_type == "innerproduct":
        lp.inner_product_param = InnerProductParameter(
            num_output=int(v0.get("num_output", 0)),
            bias_term=bool(v0.get("biasterm", True)),
            weight_filler=filler("weight_filler"),
            bias_filler=filler("bias_filler"))
    elif v0_type == "pool":
        pool = v0.get("pool", "MAX")
        pool = {0: "MAX", 1: "AVE", 2: "STOCHASTIC"}.get(pool, str(pool))
        lp.pooling_param = PoolingParameter(
            pool=pool,
            kernel_size=int(v0.get("kernelsize", 0)),
            stride=int(v0.get("stride", 1)),
            pad=int(v0.get("pad", 0)))
    elif v0_type == "dropout":
        lp.dropout_param = DropoutParameter(
            dropout_ratio=float(v0.get("dropout_ratio", 0.5)))
    elif v0_type == "lrn":
        lp.lrn_param = LRNParameter(
            local_size=int(v0.get("local_size", 5)),
            alpha=float(v0.get("alpha", 1.0)),
            beta=float(v0.get("beta", 0.75)),
            k=float(v0.get("k", 1.0)))
    elif v0_type == "infogain_loss":
        lp.infogain_loss_param = InfogainLossParameter(
            source=str(v0.get("source", "")))
    elif v0_type in ("data", "images", "window_data", "hdf5_data"):
        _migrate_v0_data_fields(lp, v0, v0_type)

    # per-blob multipliers live on the V0 node (fields 51/52)
    # lint: ok(host-sync) — prototxt text
    lrs = [float(x) for x in v0.get_list("blobs_lr")]
    # lint: ok(host-sync) — prototxt text
    wds = [float(x) for x in v0.get_list("weight_decay")]
    for i in range(max(len(lrs), len(wds))):
        spec = ParamSpec()
        if i < len(lrs):
            spec.lr_mult = lrs[i]
        if i < len(wds):
            spec.decay_mult = wds[i]
        lp.param.append(spec)
    # consume the node so downstream V1 migration doesn't re-run on it
    del node.fields["layer"]
    if hasattr(lp, "_unknown") and "layer" in lp._unknown:
        lp._unknown.remove("layer")


def _migrate_v0_data_fields(lp: LayerParameter, v0, v0_type: str) -> None:
    """V0 data layers keep source/batchsize + transform fields flat; the
    modern schema splits them into data-source params + transform_param
    (the reference does this over two upgrades: V0->V1 then
    UpgradeNetDataTransformation)."""
    tp = TransformationParameter(
        scale=float(v0.get("scale", 1.0)),
        mean_file=str(v0.get("meanfile", "")),
        crop_size=int(v0.get("cropsize", 0)),
        mirror=bool(v0.get("mirror", False)))
    if (tp.scale != 1.0 or tp.mean_file or tp.crop_size or tp.mirror):
        lp.transform_param = tp
    src = str(v0.get("source", ""))
    batch = int(v0.get("batchsize", 0))
    if v0_type == "data":
        lp.data_param = DataParameter(
            source=src, batch_size=batch,
            rand_skip=int(v0.get("rand_skip", 0)))
    elif v0_type == "images":
        lp.image_data_param = ImageDataParameter(
            source=src, batch_size=batch,
            rand_skip=int(v0.get("rand_skip", 0)),
            shuffle=bool(v0.get("shuffle_images", False)),
            new_height=int(v0.get("new_height", 0)),
            new_width=int(v0.get("new_width", 0)))
    elif v0_type == "window_data":
        lp.window_data_param = WindowDataParameter(
            source=src, batch_size=batch,
            fg_threshold=float(v0.get("det_fg_threshold", 0.5)),
            bg_threshold=float(v0.get("det_bg_threshold", 0.5)),
            fg_fraction=float(v0.get("det_fg_fraction", 0.25)),
            context_pad=int(v0.get("det_context_pad", 0)),
            crop_mode=str(v0.get("det_crop_mode", "warp")))
    elif v0_type == "hdf5_data":
        lp.hdf5_data_param = HDF5DataParameter(source=src, batch_size=batch)


def _migrate_v1_blob_multipliers(lp: LayerParameter) -> None:
    """V1LayerParameter's per-blob `blobs_lr`/`weight_decay` repeated fields
    become param { lr_mult/decay_mult } specs (reference upgrade_proto.cpp
    UpgradeV1LayerParameter). Without this, a legacy net freezing a layer
    with blobs_lr: 0 would silently train it."""
    node = getattr(lp, "_node", None)
    if node is None:
        return
    lrs = node.get_list("blobs_lr")
    wds = node.get_list("weight_decay")
    if not lrs and not wds:
        return
    if lp.param:
        raise ValueError(
            f"layer {lp.name!r} mixes legacy blobs_lr/weight_decay with "
            "modern param specs"
        )
    n = max(len(lrs), len(wds))
    for i in range(n):
        spec = ParamSpec()
        if i < len(lrs):
            # lint: ok(host-sync) — prototxt values
            spec.lr_mult = float(lrs[i])
        if i < len(wds):
            # lint: ok(host-sync) — prototxt values
            spec.decay_mult = float(wds[i])
        lp.param.append(spec)
    # consume the node fields so a second normalize_net over the same
    # object (netlint analyzes one parse for both phases) does not
    # misread its own migration as "mixes legacy and modern specs"
    node.fields.pop("blobs_lr", None)
    node.fields.pop("weight_decay", None)
    for name in ("blobs_lr", "weight_decay"):
        if hasattr(lp, "_unknown") and name in lp._unknown:
            lp._unknown.remove(name)


def state_meets_rule(state: NetState, rule: NetStateRule) -> bool:
    """Reference Net::StateMeetsRule (net.cpp:461-498)."""
    if rule.has("phase") and rule.phase != state.phase:
        return False
    if rule.has("min_level") and state.level < rule.min_level:
        return False
    if rule.has("max_level") and state.level > rule.max_level:
        return False
    for stage in rule.stage:
        if stage not in state.stage:
            return False
    for stage in rule.not_stage:
        if stage in state.stage:
            return False
    return True


def layer_included(lp: LayerParameter, state: NetState) -> bool:
    """Reference Net::FilterNet (net.cpp:407-433): a layer with `include`
    rules is in iff some rule matches; otherwise it is in unless some
    `exclude` rule matches. The layer's own `phase` field is NOT a filter —
    the reference inherits/uses it post-filtering (net.cpp:125-127)."""
    if lp.include and lp.exclude:
        raise ValueError(
            f"layer {lp.name!r}: specify include or exclude rules, not both"
        )
    if lp.include:
        return any(state_meets_rule(state, r) for r in lp.include)
    return not any(state_meets_rule(state, r) for r in lp.exclude)


def filter_net(net: NetParameter, state: NetState) -> NetParameter:
    """Return a shallow-copied net containing only layers live under `state`."""
    filtered = dataclasses.replace(net)
    filtered.layer = [lp for lp in net.layer if layer_included(lp, state)]
    if hasattr(net, "_node"):
        filtered._node = net._node  # preserve presence info
        if getattr(net, "_unknown", None) is not None:
            # copy only a COMPUTED cache — unknown_fields is lazy now,
            # and seeding [] here would mask real unknown fields
            filtered._unknown = net._unknown
    return filtered
