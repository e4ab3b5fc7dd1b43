"""netshape — static shape, dtype, parameter and MAC inference over a
NetParameter, with neither torch nor jax imported.

The port's own copy of the JAX package's `caffe_mpi_tpu/proto/netshape.py`
(the port imports nothing of that package). It replaces the *analysis
half* of reference Net::Init (net.cpp:815-818 runs insert_splits,
per-layer Reshape/shape checks and AppendParam at construction time;
net.cpp:100-156 resolves per-layer dtypes) without building anything: the
reference validates a model graph only by constructing it, so a broken
prototxt surfaces only once it is built on the card. Here the whole Caffe
shape semantics — ceil-mode+clip pooling (pooling_layer.cpp:96-108), conv
output arithmetic (base_conv_layer.cpp), BatchNorm's [mean, var,
correction, scale?, bias?] blob layout (batch_norm_layer.cpp:39-60),
phase filtering (net.cpp:407-498), in-place and param-sharing rules
(net.cpp:501-667) — are encoded as pure-Python rules over the parsed
`NetParameter`, so a net can be checked, summarized and priced on a
machine with no card and no torch.

This module is the port's single spelling of model-graph structure:
- `analyze_net()` drives the netlint passes (tools/lint/netlint.py)
- `tools/summarize.py` renders its per-layer records
- `utils/flops.py::layer_macs_per_image` delegates to `macs_per_image`
  here, so `cli time`'s MFU uses the same MAC model
- `serving/plan.py::plan_model` sizes a deploy net's buckets and params
  before the engine builds anything
- `net.py` consumes `BF16_INELIGIBLE` (the bf16-eligibility registry)

Every rule mirrors the corresponding layer's `setup()` in layers/: the
two spellings are held equal for the whole model zoo by
tests/test_torch_cli_tools.py's engine-against-built-net check (and on the
card by chip_smoke.py's `shapes` phase), and `RULES`' key set is held
equal to `LAYER_REGISTRY` by tests/test_torch_netshape.py, so a new layer
type cannot ship without a shape rule.

Unknown dimensions (Data layers without a dataset probe, Python layers)
propagate as None; checks only fire on dims that are statically known.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

from .config import (
    BatchNormParameter,
    ConvolutionParameter,
    LayerParameter,
    LRNParameter,
    MVNParameter,
    NetParameter,
    NetState,
)
from .upgrade import filter_net, normalize_net

# Dims are ints or None (statically unknown); a whole shape may be None
# (unknown rank, e.g. a Python layer's top).

# ---------------------------------------------------------------------------
# bf16 eligibility registry: one place, shared by the net-dtype lint pass
# and net.py's build-time warning. An ineligible layer re-enters Python
# through a host callback or does host I/O with float32 buffers, so a
# FLOAT16 request on it is not honoured: `Net` warns at build. Every
# registered layer type is in exactly one of the two sets
# (tests/test_torch_netshape.py holds the union equal to LAYER_REGISTRY).
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

# layer types whose first top defaults to loss_weight 1 (losses.py
# LossBase.default_loss_weight / reference layer.hpp SetLossWeights)
LOSS_TYPES = frozenset({
    "SoftmaxWithLoss", "EuclideanLoss", "L1Loss",
    "SigmoidCrossEntropyLoss", "HingeLoss", "MultinomialLogisticLoss",
    "InfogainLoss", "ContrastiveLoss",
})
# sink layers: tops legitimately unconsumed / no tops at all
SINK_TYPES = LOSS_TYPES | {"Accuracy", "Silence", "HDF5Output"}
# layers with non-learnable running state (norm.py init_state) — the one
# thing a Pipeline block must not contain (composite.py setup)
STATEFUL_TYPES = frozenset({"BatchNorm"})
# graph-input layers (data_layers.py InputLayerBase + DummyData, which
# generates its tops in-graph): no bottoms, tops come from feeds/fillers
INPUT_TYPES = frozenset({
    "Input", "DummyData", "MemoryData", "Data", "ImageData", "WindowData",
    "HDF5Data",
})

_VALID_TYPE_NAMES = ("", "FLOAT", "FLOAT16", "DOUBLE", "INT", "UINT")


# ---------------------------------------------------------------------------
# analysis records

@dataclass
class ParamInfo:
    """One learnable blob declaration (layers/base.py ParamDecl, shapes
    possibly containing None)."""
    name: str
    shape: tuple
    lr_mult: float = 1.0
    decay_mult: float = 1.0
    shared_name: str = ""


@dataclass
class Problem:
    """One statically-detected defect. `kind` routes it to a netlint
    pass: wiring | shape | params | dtype. `index` is the layer's
    position in the NORMALIZED (pre-filter) layer list, so problems on
    distinct unnamed layers stay distinct; None for net-level
    problems."""
    layer: str
    kind: str
    message: str
    index: "int | None" = None


@dataclass
class LayerInfo:
    """Static record of one live (phase-filtered) layer."""
    index: int
    name: str
    type: str
    lp: LayerParameter
    in_shapes: list = field(default_factory=list)
    out_shapes: list = field(default_factory=list)
    params: dict = field(default_factory=dict)  # name -> ParamInfo
    fwd_type: str = "FLOAT"
    bwd_type: str = "FLOAT"
    loss_weights: list = field(default_factory=list)  # per top


@dataclass
class NetAnalysis:
    """Whole-net static analysis for one phase."""
    name: str
    phase: str
    layers: list = field(default_factory=list)
    blob_shapes: dict = field(default_factory=dict)  # final version
    problems: list = field(default_factory=list)
    loss_blobs: list = field(default_factory=list)  # (blob, weight)


# ---------------------------------------------------------------------------
# Dim arithmetic (None = unknown, propagates)

def _known(*dims) -> bool:
    return all(d is not None for d in dims)


def _prod(dims) -> "int | None":
    out = 1
    for d in dims:
        if d is None:
            return None
        out *= d
    return out


def conv_output_dim(size, kernel, pad, stride, dilation):
    """ops/conv.py conv_output_dim, None-propagating."""
    if size is None:
        return None
    kernel_ext = dilation * (kernel - 1) + 1
    return (size + 2 * pad - kernel_ext) // stride + 1


def pool_output_dim(size, kernel, pad, stride, any_pad=None):
    """ops/pool.py pool_output_dim (ceil mode + last-window clip,
    pooling_layer.cpp:96-108), None-propagating."""
    if size is None:
        return None
    out = int(math.ceil((size + 2 * pad - kernel) / stride)) + 1
    if any_pad is None:
        any_pad = pad > 0
    if any_pad and (out - 1) * stride >= size + pad:
        out -= 1
    return out


def _fmt(shape) -> str:
    if shape is None:
        return "?"
    return "x".join("?" if d is None else str(d) for d in shape)


# ---------------------------------------------------------------------------
# rule context

class _Ctx:
    """Per-layer rule context: the static analogue of a Layer instance
    during setup() — in_shapes, param declaration, problem reporting."""

    def __init__(self, analysis: NetAnalysis, lp: LayerParameter,
                 in_shapes: list, phase: str, index: "int | None" = None):
        self.analysis = analysis
        self.lp = lp
        self.in_shapes = in_shapes
        self.phase = phase
        self.index = index
        self.params: dict[str, ParamInfo] = {}

    @property
    def name(self) -> str:
        return self.lp.name

    def problem(self, kind: str, message: str) -> None:
        self.analysis.problems.append(
            Problem(self.lp.name, kind, message, index=self.index))

    def declare(self, name: str, shape, param_idx=None) -> None:
        """Mirror Layer.declare (layers/base.py): prototxt param {}
        specs bind positionally."""
        idx = len(self.params) if param_idx is None else param_idx
        info = ParamInfo(name, tuple(shape))
        if idx < len(self.lp.param):
            spec = self.lp.param[idx]
            info.lr_mult = spec.lr_mult
            info.decay_mult = spec.decay_mult
            info.shared_name = spec.name
        self.params[name] = info

    def in4(self, i=0):
        """Bottom i as (n, c, h, w); unknown-rank bottoms become all-None."""
        s = self.in_shapes[i] if i < len(self.in_shapes) else None
        if s is None or len(s) != 4:
            if s is not None and len(s) != 4:
                self.problem("shape",
                             f"expects a 4-D (N,C,H,W) bottom, got {_fmt(s)}")
            return (None, None, None, None)
        return s


# ---------------------------------------------------------------------------
# per-type rules — each mirrors the layer's setup() in layers/

RULES: dict[str, "callable"] = {}


def _run_rule(fn, ctx) -> list:
    """Invoke one shape rule, converting any crash into a problem: the
    engine's contract is to COLLECT defects, and a malformed layer (a
    ReLU with no bottom, a zero stride the dedicated checks missed)
    must become a finding — never abort the whole-tree lint with a
    traceback. The zoo-clean tier-1 gate keeps genuine rule bugs from
    hiding here: they surface as spurious findings, not silence."""
    try:
        return fn(ctx)
    except Exception as e:  # noqa: BLE001 — see docstring
        ctx.problem("wiring",
                    f"invalid layer configuration breaks shape "
                    f"inference: {e!r} (bottoms: {len(ctx.lp.bottom)}, "
                    f"tops: {len(ctx.lp.top)})")
        return [None] * len(ctx.lp.top)


def rule(*type_names):
    def deco(fn):
        for t in type_names:
            assert t not in RULES, t
            RULES[t] = fn
        return fn
    return deco


def _spatial_params(ctx, p) -> tuple:
    """vision.py _spatial_params (base_conv_layer.cpp LayerSetUp)."""
    def resolve(rep, h, w, default):
        if h or w:
            return (h, w)
        if not rep:
            return (default, default)
        if len(rep) == 1:
            return (rep[0], rep[0])
        return (rep[0], rep[1])

    kernel = resolve(p.kernel_size, p.kernel_h, p.kernel_w, 0)
    stride = resolve(p.stride, p.stride_h, p.stride_w, 1)
    pad = resolve(p.pad, p.pad_h, p.pad_w, 0)
    dil = tuple(p.dilation) * (2 // max(len(p.dilation), 1)) \
        if p.dilation else (1, 1)
    if len(dil) == 1:
        dil = (dil[0], dil[0])
    if len(dil) != 2:
        ctx.problem("shape",
                    f"{len(p.dilation)} dilation values (expected 1 or 2)")
        dil = (1, 1)
    if kernel[0] <= 0 or kernel[1] <= 0:
        ctx.problem("shape", "convolution kernel_size must be positive")
    if stride[0] <= 0 or stride[1] <= 0:
        # classic prototxt typo: `stride: 0` divides the output-dim
        # arithmetic; report and continue at the schema default
        ctx.problem("shape", f"stride {stride} must be positive")
        stride = (max(stride[0], 1), max(stride[1], 1))
    return kernel, stride, pad, dil


def _check_spatial_out(ctx, what, oh, ow):
    for label, d in (("height", oh), ("width", ow)):
        if d is not None and d <= 0:
            ctx.problem("shape",
                        f"{what} output {label} is {d} (non-positive): "
                        "kernel/stride/pad shrink the input away")


@rule("Convolution")
def _conv(ctx):
    p = ctx.lp.convolution_param or ConvolutionParameter()
    kernel, stride, pad, dil = _spatial_params(ctx, p)
    if kernel[0] <= 0 or kernel[1] <= 0:
        return [None]
    n, cin, h, w = ctx.in4()
    if p.num_output <= 0:
        ctx.problem("shape", "convolution num_output must be positive")
        return [None]
    if cin is not None and (cin % p.group or p.num_output % p.group):
        ctx.problem("shape",
                    f"channels ({cin} in, {p.num_output} out) not "
                    f"divisible by group {p.group}")
    ctx.declare("weight", (p.num_output,
                           None if cin is None else cin // p.group,
                           *kernel))
    if p.bias_term:
        ctx.declare("bias", (p.num_output,))
    oh = conv_output_dim(h, kernel[0], pad[0], stride[0], dil[0])
    ow = conv_output_dim(w, kernel[1], pad[1], stride[1], dil[1])
    _check_spatial_out(ctx, "convolution", oh, ow)
    return [(n, p.num_output, oh, ow)]


@rule("Deconvolution")
def _deconv(ctx):
    p = ctx.lp.convolution_param or ConvolutionParameter()
    kernel, stride, pad, dil = _spatial_params(ctx, p)
    if kernel[0] <= 0 or kernel[1] <= 0:
        return [None]
    n, cin, h, w = ctx.in4()
    if p.num_output <= 0:
        ctx.problem("shape", "deconvolution num_output must be positive")
        return [None]
    # Caffe deconv weight: (Cin, Cout/group, kh, kw) (deconv_layer.cpp)
    ctx.declare("weight", (cin, p.num_output // max(p.group, 1), *kernel))
    if p.bias_term:
        ctx.declare("bias", (p.num_output,))
    kh_ext = dil[0] * (kernel[0] - 1) + 1
    kw_ext = dil[1] * (kernel[1] - 1) + 1
    oh = None if h is None else stride[0] * (h - 1) + kh_ext - 2 * pad[0]
    ow = None if w is None else stride[1] * (w - 1) + kw_ext - 2 * pad[1]
    _check_spatial_out(ctx, "deconvolution", oh, ow)
    return [(n, p.num_output, oh, ow)]


@rule("Pooling")
def _pool(ctx):
    p = ctx.lp.pooling_param
    n, c, h, w = ctx.in4()
    if p is None:
        ctx.problem("shape", "pooling_param required")
        return [(n, c, None, None)]
    if p.global_pooling:
        kernel, stride, pad = (h, w), (1, 1), (0, 0)
    else:
        kh = p.kernel_h or p.kernel_size
        kw = p.kernel_w or p.kernel_size
        if kh <= 0 or kw <= 0:
            ctx.problem("shape", "pooling kernel_size required")
            return [(n, c, None, None)]
        kernel = (kh, kw)
        stride = (p.stride_h or p.stride, p.stride_w or p.stride)
        pad = (p.pad_h or p.pad, p.pad_w or p.pad)
        if stride[0] <= 0 or stride[1] <= 0:
            ctx.problem("shape", f"stride {stride} must be positive")
            stride = (max(stride[0], 1), max(stride[1], 1))
    # reference pooling_layer.cpp CHECK_LT(pad, kernel): a pad as large
    # as the window yields windows made entirely of padding
    for label, pd, kn in (("h", pad[0], kernel[0]), ("w", pad[1], kernel[1])):
        if kn is not None and pd >= max(kn, 1) and pd > 0:
            ctx.problem("shape",
                        f"pooling pad_{label} {pd} >= kernel_{label} {kn} "
                        "(reference CHECK_LT(pad, kernel))")
    method = str(p.pool).upper()
    if method == "STOCHASTIC" and (pad[0] or pad[1]):
        ctx.problem("shape", "STOCHASTIC pooling does not support padding "
                             "(reference pooling_layer.cpp CHECKs the same)")
    any_pad = pad[0] > 0 or pad[1] > 0
    oh = pool_output_dim(h, kernel[0], pad[0], stride[0], any_pad)
    ow = pool_output_dim(w, kernel[1], pad[1], stride[1], any_pad)
    _check_spatial_out(ctx, "pooling", oh, ow)
    return [(n, c, oh, ow)]


@rule("LRN")
def _lrn(ctx):
    p = ctx.lp.lrn_param or LRNParameter()
    if p.local_size % 2 != 1:
        ctx.problem("shape", "LRN local_size must be odd")
    return [ctx.in_shapes[0]]


@rule("Im2col")
def _im2col(ctx):
    p = ctx.lp.convolution_param or ConvolutionParameter()
    kernel, stride, pad, dil = _spatial_params(ctx, p)
    n, c, h, w = ctx.in4()
    oh = conv_output_dim(h, kernel[0], pad[0], stride[0], dil[0])
    ow = conv_output_dim(w, kernel[1], pad[1], stride[1], dil[1])
    _check_spatial_out(ctx, "im2col", oh, ow)
    cols = None if c is None else c * kernel[0] * kernel[1]
    return [(n, cols, oh, ow)]


@rule("Crop")
def _crop(ctx):
    p = ctx.lp.crop_param
    axis = p.axis if p else 2
    offsets = list(p.offset) if p else []
    a, b = ctx.in_shapes[0], ctx.in_shapes[1]
    if a is None or b is None:
        return [None]
    out = list(a)
    for i in range(axis, len(a)):
        off = 0
        if offsets:
            off = offsets[i - axis] if len(offsets) > 1 else offsets[0]
        if i >= len(b):
            ctx.problem("shape",
                        f"crop reference bottom has no axis {i}")
            continue
        if _known(a[i], b[i]) and off + b[i] > a[i]:
            ctx.problem("shape",
                        f"crop exceeds bottom size on axis {i} "
                        f"({off}+{b[i]} > {a[i]})")
        out[i] = b[i]
    return [tuple(out)]


@rule("SPP")
def _spp(ctx):
    p = ctx.lp.spp_param
    n, c, h, w = ctx.in4()
    if p is None or p.pyramid_height <= 0:
        ctx.problem("shape", "spp_param.pyramid_height required")
        return [(n, None)]
    total = 0
    for lvl in range(p.pyramid_height):
        bins = 2 ** lvl
        if c is None:
            total = None
            break
        total += c * bins * bins
    return [(n, total)]


# -- shape/structure layers (shape_ops.py) ----------------------------------

def _legacy_axis(p, modern, legacy, default):
    axis = getattr(p, modern) if p else default
    if p and not p.has(modern) and p.has(legacy):
        axis = getattr(p, legacy)
    return axis


@rule("Concat")
def _concat(ctx):
    p = ctx.lp.concat_param
    axis = _legacy_axis(p, "axis", "concat_dim", 1)
    base = ctx.in_shapes[0]
    if base is None:
        return [None]
    axis = axis % len(base) if axis < 0 else axis
    if axis >= len(base):
        ctx.problem("shape", f"concat axis {axis} out of range for "
                             f"{_fmt(base)}")
        return [None]
    total = 0
    out = list(base)
    for i, s in enumerate(ctx.in_shapes):
        if s is None:
            total = None
            continue
        if len(s) != len(base):
            ctx.problem("shape",
                        f"concat bottom {i} rank {len(s)} != {len(base)}")
            continue
        for d in range(len(base)):
            if d != axis and _known(s[d], base[d]) and s[d] != base[d]:
                ctx.problem("shape",
                            f"concat bottom {i} shape {_fmt(s)} mismatches "
                            f"{_fmt(base)} on non-concat axis {d}")
        if total is not None:
            total = None if s[axis] is None else total + s[axis]
    out[axis] = total
    return [tuple(out)]


@rule("Slice")
def _slice(ctx):
    p = ctx.lp.slice_param
    axis = _legacy_axis(p, "axis", "slice_dim", 1)
    base = ctx.in_shapes[0]
    if base is None:
        return [None] * len(ctx.lp.top)
    axis = axis % len(base) if axis < 0 else axis
    total = base[axis] if axis < len(base) else None
    n_top = len(ctx.lp.top)
    points = list(p.slice_point) if p else []
    outs = []
    if points:
        if len(points) != n_top - 1:
            ctx.problem("shape",
                        f"slice needs {n_top - 1} slice points, has "
                        f"{len(points)}")
            return [None] * n_top
        bounds = [0] + points + [total]
    else:
        if total is not None and n_top and total % n_top:
            ctx.problem("shape",
                        f"slice axis size {total} not divisible by "
                        f"{n_top} tops")
            return [None] * n_top
        step = None if total is None else total // max(n_top, 1)
        bounds = [None if step is None else i * step
                  for i in range(n_top + 1)]
    for i in range(n_top):
        s = list(base)
        lo, hi = bounds[i], bounds[i + 1]
        size = None if not _known(lo, hi) else hi - lo
        if size is not None and size <= 0:
            ctx.problem("shape",
                        f"slice top {i} has non-positive size {size}")
        s[axis] = size
        outs.append(tuple(s))
    return outs


@rule("Split")
def _split(ctx):
    return [ctx.in_shapes[0]] * len(ctx.lp.top)


@rule("Flatten")
def _flatten(ctx):
    p = ctx.lp.flatten_param
    s = ctx.in_shapes[0]
    if s is None:
        return [None]
    nd = len(s)
    axis = (p.axis if p else 1) % nd
    end = (p.end_axis if p else -1) % nd
    mid = _prod(s[axis:end + 1])
    return [(*s[:axis], mid, *s[end + 1:])]


@rule("Reshape")
def _reshape(ctx):
    p = ctx.lp.reshape_param
    spec = list(p.shape.dim) if (p and p.shape) else []
    in_shape = ctx.in_shapes[0]
    if in_shape is None:
        return [None]
    nd = len(in_shape)
    start = (p.axis if p else 0) % (nd + 1)
    num_axes = p.num_axes if p else -1
    end = nd if num_axes == -1 else start + num_axes
    head, mid_in, tail = in_shape[:start], in_shape[start:end], in_shape[end:]
    mid = []
    infer = -1
    for i, d in enumerate(spec):
        if d == 0:
            if i >= len(mid_in):
                ctx.problem("shape",
                            f"reshape dim {i} copies a bottom axis that "
                            "does not exist")
                mid.append(None)
            else:
                mid.append(mid_in[i])
        elif d == -1:
            infer = i
            mid.append(-1)
        else:
            mid.append(d)
    total_mid = _prod(mid_in)
    if infer >= 0:
        known = _prod([d for d in mid if d != -1])
        if known is None or total_mid is None:
            mid[infer] = None
        elif known == 0 or total_mid % known:
            ctx.problem("shape", "cannot infer -1 reshape dimension")
            mid[infer] = None
        else:
            mid[infer] = total_mid // known
    out_mid = _prod(mid)
    if _known(out_mid, total_mid) and out_mid != total_mid:
        ctx.problem("shape",
                    f"reshape count mismatch {_fmt(tuple(mid_in))} -> "
                    f"{_fmt(tuple(mid))}")
    return [(*head, *mid, *tail)]


@rule("Tile")
def _tile(ctx):
    p = ctx.lp.tile_param
    s = ctx.in_shapes[0]
    if s is None:
        return [None]
    axis = (p.axis if p else 1) % len(s)
    tiles = p.tiles if p else 1
    if tiles < 1:
        ctx.problem("shape", f"tile_param.tiles must be >= 1, got {tiles}")
    out = list(s)
    out[axis] = None if out[axis] is None else out[axis] * tiles
    return [tuple(out)]


@rule("Eltwise")
def _eltwise(ctx):
    p = ctx.lp.eltwise_param
    coeff = list(p.coeff) if p else []
    if coeff and len(coeff) != len(ctx.lp.bottom):
        ctx.problem("shape",
                    f"eltwise coeff count {len(coeff)} != bottom count "
                    f"{len(ctx.lp.bottom)}")
    base = ctx.in_shapes[0]
    for i, s in enumerate(ctx.in_shapes[1:], 1):
        if base is None or s is None:
            continue
        if len(s) != len(base) or any(
                _known(a, b) and a != b for a, b in zip(s, base)):
            ctx.problem("shape",
                        f"eltwise bottom {i} shape {_fmt(s)} != bottom 0 "
                        f"shape {_fmt(base)} (reference CHECKs equal "
                        "shapes)")
    return [base]


@rule("Reduction")
def _reduction(ctx):
    p = ctx.lp.reduction_param
    s = ctx.in_shapes[0]
    if s is None:
        return [None]
    axis = (p.axis if p else 0) % len(s)
    return [s[:axis]]


@rule("ArgMax")
def _argmax(ctx):
    p = ctx.lp.argmax_param
    top_k = p.top_k if p else 1
    out_max_val = bool(p and p.out_max_val)
    axis = p.axis if (p and p.axis is not None) else None
    s = ctx.in_shapes[0]
    if s is None:
        return [None]
    n = s[0]
    if axis is not None:
        out = list(s)
        out[axis % len(out)] = top_k
        return [tuple(out)]
    if out_max_val:
        return [(n, 2, top_k)]
    return [(n, 1, top_k)]


@rule("Silence")
def _silence(ctx):
    return []


@rule("BatchReindex")
def _batch_reindex(ctx):
    a, b = ctx.in_shapes[0], ctx.in_shapes[1]
    if a is None or b is None:
        return [None]
    return [(b[0], *a[1:])]


# -- dense layers (dense.py) ------------------------------------------------

@rule("InnerProduct")
def _inner_product(ctx):
    p = ctx.lp.inner_product_param
    s = ctx.in_shapes[0]
    if p is None or p.num_output <= 0:
        ctx.problem("shape", "inner_product_param.num_output required")
        return [None]
    if s is None:
        ctx.declare("weight", (None, p.num_output) if p.transpose
                    else (p.num_output, None))
        if p.bias_term:
            ctx.declare("bias", (p.num_output,))
        return [None]
    axis = p.axis % len(s) if p.axis < 0 else p.axis
    if axis > len(s):
        ctx.problem("shape", f"inner product axis {axis} out of range "
                             f"for {_fmt(s)}")
        return [None]
    k = _prod(s[axis:])
    ctx.declare("weight", (k, p.num_output) if p.transpose
                else (p.num_output, k))
    if p.bias_term:
        ctx.declare("bias", (p.num_output,))
    return [(*s[:axis], p.num_output)]


@rule("Embed")
def _embed(ctx):
    p = ctx.lp.embed_param
    if p is None or p.num_output <= 0 or p.input_dim <= 0:
        ctx.problem("shape", "embed_param needs num_output and input_dim")
        return [None]
    ctx.declare("weight", (p.input_dim, p.num_output))
    if p.bias_term:
        ctx.declare("bias", (p.num_output,))
    s = ctx.in_shapes[0]
    if s is None:
        return [None]
    return [(*s, p.num_output)]


def _scale_bias(ctx, p, axis_default=1, with_bias=False):
    """dense.py _ScaleBiasBase._setup."""
    axis = p.axis if p else axis_default
    num_axes = p.num_axes if p else 1
    s = ctx.in_shapes[0]
    two_bottom = len(ctx.in_shapes) > 1
    if s is None:
        return [None]
    nd = len(s)
    axis = axis % nd if axis < 0 else axis
    if two_bottom:
        op_shape = ctx.in_shapes[1]
        if op_shape is not None:
            for i, d in enumerate(op_shape):
                j = axis + i
                if j >= nd or (_known(d, s[j]) and d != s[j]):
                    ctx.problem("shape",
                                f"operand bottom shape {_fmt(op_shape)} "
                                f"does not align with {_fmt(s)} at axis "
                                f"{axis}")
                    break
    else:
        if num_axes == -1:
            op_shape = s[axis:]
        else:
            op_shape = s[axis:axis + num_axes]
        ctx.declare("operand", tuple(op_shape))
        if with_bias:
            ctx.declare("bias", tuple(op_shape))
    return [s]


@rule("Scale")
def _scale(ctx):
    p = ctx.lp.scale_param
    return _scale_bias(ctx, p, with_bias=bool(p and p.bias_term))


@rule("Bias")
def _bias(ctx):
    return _scale_bias(ctx, ctx.lp.bias_param)


# -- norm layers (norm.py) --------------------------------------------------

@rule("BatchNorm")
def _batch_norm(ctx):
    p = ctx.lp.batch_norm_param or BatchNormParameter()
    s = ctx.in_shapes[0]
    channels = None
    if s is not None:
        channels = s[1] if len(s) > 1 else 1
    scale_bias = p.scale_bias or p.has("scale_filler") or p.has("bias_filler")
    if scale_bias:
        ctx.declare("scale", (channels,))
        ctx.declare("bias", (channels,))
    n_specs = len(ctx.lp.param)
    n_params = len(ctx.params)
    if n_specs > n_params:
        # BVLC-style `param { lr_mult: 0 }` triples pin the reference's
        # mean/var/correction blobs; here those are STATE, so the specs
        # bind positionally to scale/bias (or to nothing) — silently
        # freezing the wrong blobs (batch_norm_layer.cpp:39-60 layout)
        ctx.problem("params",
                    f"BatchNorm declares {n_specs} param specs but has "
                    f"{n_params} learnable blobs (mean/var/correction are "
                    "state, not params — NVCaffe blob layout [mean, var, "
                    "correction, scale?, bias?])")
    return [s]


@rule("MVN")
def _mvn(ctx):
    _ = ctx.lp.mvn_param or MVNParameter()
    return [ctx.in_shapes[0]]


@rule("LayerNorm")
def _layer_norm(ctx):
    from .config import LayerNormParameter
    p = ctx.lp.layer_norm_param or LayerNormParameter()
    s = ctx.in_shapes[0]
    c = None if s is None or not s else s[-1]
    if p.scale_bias:
        ctx.declare("scale", (c,))
        ctx.declare("bias", (c,))
    return [s]


# -- activations (activations.py): all elementwise passthrough --------------

@rule("ReLU", "ELU", "Sigmoid", "TanH", "BNLL", "Power", "Exp", "Log",
      "AbsVal", "Threshold", "Dropout")
def _elementwise(ctx):
    return [ctx.in_shapes[0]]


@rule("PReLU")
def _prelu(ctx):
    p = ctx.lp.prelu_param
    s = ctx.in_shapes[0]
    channels = 1
    if s is not None and len(s) > 1:
        channels = s[1]
    if p and p.channel_shared:
        channels = 1
    ctx.declare("slope", (channels,))
    return [s]


# -- losses + metrics (losses.py) -------------------------------------------

def _softmax_axis(lp, nd):
    axis = lp.softmax_param.axis if lp.softmax_param else 1
    return axis % nd if axis < 0 else axis


def _check_label_counts(ctx, axis):
    """softmax_loss/accuracy label alignment: the label blob must have
    exactly one entry per prediction position — prod(labels) ==
    prod(logits) / logits[axis] (losses.py reshapes labels to the
    logits' non-class dims; a mismatch is usually swapped bottoms)."""
    if len(ctx.in_shapes) < 2:
        return
    logits, labels = ctx.in_shapes[0], ctx.in_shapes[1]
    if logits is None or labels is None or axis >= len(logits):
        return
    n_pred = _prod([d for i, d in enumerate(logits) if i != axis])
    n_lab = _prod(labels)
    if _known(n_pred, n_lab) and n_pred != n_lab:
        ctx.problem("shape",
                    f"label bottom {_fmt(labels)} has {n_lab} entries but "
                    f"the prediction bottom {_fmt(logits)} has {n_pred} "
                    f"positions (class axis {axis}) — swapped bottoms?")


@rule("Softmax")
def _softmax(ctx):
    s = ctx.in_shapes[0]
    if s is not None:
        axis = _softmax_axis(ctx.lp, len(s))
        if axis >= len(s):
            ctx.problem("shape",
                        f"softmax axis {axis} out of range for {_fmt(s)}")
    return [s]


@rule("SoftmaxWithLoss")
def _softmax_loss(ctx):
    s = ctx.in_shapes[0]
    if len(ctx.lp.bottom) < 2:
        ctx.problem("wiring", "SoftmaxWithLoss needs (scores, labels) "
                              "bottoms")
    if s is not None:
        axis = _softmax_axis(ctx.lp, len(s))
        if axis >= len(s):
            ctx.problem("shape",
                        f"softmax axis {axis} out of range for {_fmt(s)}")
        else:
            _check_label_counts(ctx, axis)
    tops = [()]
    if len(ctx.lp.top) > 1:
        tops.append(s)
    return tops


@rule("EuclideanLoss", "SigmoidCrossEntropyLoss")
def _paired_loss(ctx):
    a = ctx.in_shapes[0] if ctx.in_shapes else None
    b = ctx.in_shapes[1] if len(ctx.in_shapes) > 1 else None
    if len(ctx.lp.bottom) < 2:
        ctx.problem("wiring", f"{ctx.lp.type} needs two bottoms")
    elif a is not None and b is not None:
        na, nb = _prod(a), _prod(b)
        if _known(na, nb) and na != nb:
            ctx.problem("shape",
                        f"bottoms {_fmt(a)} vs {_fmt(b)} must have equal "
                        "counts (reference CHECKs count equality)")
    return [()]


@rule("L1Loss")
def _l1_loss(ctx):
    return [()]


@rule("HingeLoss", "MultinomialLogisticLoss")
def _labeled_loss(ctx):
    if len(ctx.lp.bottom) < 2:
        ctx.problem("wiring", f"{ctx.lp.type} needs (scores, labels) "
                              "bottoms")
    else:
        _check_label_counts(ctx, 1)
    return [()]


@rule("InfogainLoss")
def _infogain(ctx):
    if len(ctx.in_shapes) < 3:
        p = ctx.lp.infogain_loss_param
        if not (p and p.source):
            ctx.problem("wiring",
                        "infogain needs H as third bottom or a source file")
    return [()]


@rule("ContrastiveLoss")
def _contrastive(ctx):
    if len(ctx.lp.bottom) < 3:
        ctx.problem("wiring", "ContrastiveLoss needs (a, b, sim) bottoms")
    return [()]


@rule("Accuracy")
def _accuracy(ctx):
    p = ctx.lp.accuracy_param
    s = ctx.in_shapes[0]
    tops = [()]
    if len(ctx.lp.bottom) < 2:
        ctx.problem("wiring", "Accuracy needs (scores, labels) bottoms")
    if s is not None:
        axis = (p.axis if p else 1) % len(s)
        _check_label_counts(ctx, axis)
        if len(ctx.lp.top) > 1:
            tops.append((s[axis],))
    elif len(ctx.lp.top) > 1:
        tops.append(None)
    return tops


# -- graph inputs (data_layers.py) ------------------------------------------

@rule("Input")
def _input(ctx):
    p = ctx.lp.input_param
    if not p or not p.shape:
        ctx.problem("wiring", "input_param.shape required")
        return [None] * len(ctx.lp.top)
    shapes = [tuple(s.dim) for s in p.shape]
    if len(shapes) == 1 and len(ctx.lp.top) > 1:
        shapes = shapes * len(ctx.lp.top)
    return shapes


@rule("DummyData")
def _dummy_data(ctx):
    p = ctx.lp.dummy_data_param
    if p is None:
        ctx.problem("wiring", "dummy_data_param required")
        return [None] * len(ctx.lp.top)
    if p.shape:
        shapes = [tuple(s.dim) for s in p.shape]
    else:
        shapes = [(p.num[i], p.channels[i], p.height[i], p.width[i])
                  for i in range(len(p.num))]
    if len(shapes) == 1:
        shapes = shapes * len(ctx.lp.top)
    return shapes


@rule("MemoryData")
def _memory_data(ctx):
    p = ctx.lp.memory_data_param
    if p is None:
        ctx.problem("wiring", "memory_data_param required")
        return [None] * len(ctx.lp.top)
    return [(p.batch_size, p.channels, p.height, p.width),
            (p.batch_size,)][:len(ctx.lp.top)]


def _data_shapes(ctx, batch, channels, height, width):
    """data_layers.py PipelineDataLayer._data_shapes."""
    tp = ctx.lp.transform_param
    if tp and tp.crop_size:
        height = width = tp.crop_size
    shapes = [(batch, channels, height, width)]
    if len(ctx.lp.top) > 1:
        shapes.append((batch,))
    return shapes


@rule("Data")
def _data(ctx):
    p = ctx.lp.data_param
    if p is None or not p.batch_size:
        ctx.problem("wiring", "data_param.batch_size required")
        return [None] * len(ctx.lp.top)
    c, h, w = ctx.probe if ctx.probe is not None else (None, None, None)
    return _data_shapes(ctx, p.batch_size, c, h, w)


@rule("ImageData")
def _image_data(ctx):
    p = ctx.lp.image_data_param
    if p is None:
        ctx.problem("wiring", "image_data_param required")
        return [None] * len(ctx.lp.top)
    c = 3 if p.is_color else 1
    h, w = p.new_height, p.new_width
    if not (h and w):
        ctx.problem("shape",
                    "ImageData requires new_height/new_width for static "
                    "shapes")
        h = w = None
    return _data_shapes(ctx, p.batch_size, c, h, w)


@rule("WindowData")
def _window_data(ctx):
    p = ctx.lp.window_data_param
    if p is None:
        ctx.problem("wiring", "window_data_param required")
        return [None] * len(ctx.lp.top)
    crop = p.crop_size or (ctx.lp.transform_param.crop_size
                           if ctx.lp.transform_param else 0)
    if not crop:
        ctx.problem("shape", "WindowData requires crop_size")
        crop = None
    shapes = [(p.batch_size, 3, crop, crop)]
    if len(ctx.lp.top) > 1:
        shapes.append((p.batch_size,))
    return shapes


@rule("HDF5Data")
def _hdf5_data(ctx):
    # the dataset defines the per-record shapes (runner probe); without
    # it the tops are batch-leading but otherwise unknown rank
    return [None] * len(ctx.lp.top)


# -- extension layers (extension.py, detection.py, composite.py) -----------

@rule("Python")
def _python(ctx):
    p = ctx.lp.python_param
    if p is None or not p.module or not p.layer:
        ctx.problem("wiring", "python_param.module/layer required")
    # user code owns shape inference (infer_shapes); never executed here
    return [None] * len(ctx.lp.top)


@rule("Filter")
def _filter(ctx):
    outs = list(ctx.in_shapes[:-1])
    if len(ctx.lp.top) == len(ctx.in_shapes):
        sel = ctx.in_shapes[-1]
        outs.append(None if sel is None else (sel[0],))
    return outs


@rule("HDF5Output")
def _hdf5_output(ctx):
    p = ctx.lp.hdf5_output_param
    if p is None or not p.file_name:
        ctx.problem("wiring", "hdf5_output_param.file_name required")
    return []


@rule("Parameter")
def _parameter(ctx):
    pp = ctx.lp.parameter_param
    if pp is None or pp.shape is None or not pp.shape.dim:
        ctx.problem("wiring", "parameter_param.shape required")
        return [None]
    shape = tuple(int(d) for d in pp.shape.dim)
    ctx.declare("weight", shape)
    return [shape]


@rule("DetectNetTransformation")
def _detectnet(ctx):
    from .config import DetectNetGroundTruthParameter
    gt = (ctx.lp.detectnet_groundtruth_param
          or DetectNetGroundTruthParameter())
    if len(ctx.in_shapes) != 2:
        ctx.problem("wiring",
                    "DetectNetTransformation takes (data, label) bottoms")
        return [None] * len(ctx.lp.top)
    class_map = {m.src: m.dst for m in gt.object_class} or {1: 0}
    num_classes = max(class_map.values()) + 1
    d, lab = ctx.in_shapes[0], ctx.in_shapes[1]
    n = d[0] if d is not None else None
    if d is not None and lab is not None and _known(d[0], lab[0]) \
            and d[0] != lab[0]:
        ctx.problem("shape",
                    f"data batch {d[0]} != label batch {lab[0]} "
                    "(detectnet_transform_layer.cpp:116)")
    if d is not None and len(d) > 1 and d[1] is not None and d[1] != 3:
        ctx.problem("shape",
                    f"expects 3-channel images, got {d[1]} "
                    "(detectnet_transform_layer.cpp:115)")
    tp = ctx.lp.transform_param
    mean_values = list(tp.mean_value) if tp else []
    channels = d[1] if d is not None and len(d) > 1 else 3
    if channels is not None and len(mean_values) not in (0, 1, channels):
        ctx.problem("shape",
                    f"{len(mean_values)} mean_value entries for "
                    f"{channels} channels (expected 1 or {channels})")
    gh, gw = gt.image_size_y // gt.stride, gt.image_size_x // gt.stride
    return [(n, 3, gt.image_size_y, gt.image_size_x),
            (n, num_classes * 5, gh, gw)]


# -- sequence layers (sequence.py) ------------------------------------------

@rule("Attention")
def _attention(ctx):
    from .config import AttentionParameter
    p = ctx.lp.attention_param or AttentionParameter()
    s = ctx.in_shapes[0]
    if s is None:
        return [None]
    if len(s) != 3:
        ctx.problem("shape", f"Attention expects (N, S, C) bottom, got "
                             f"{_fmt(s)}")
        return [None]
    c = s[2]
    heads = max(p.num_heads, 1)
    if c is not None and c % heads:
        ctx.problem("shape",
                    f"channels {c} not divisible by num_heads {p.num_heads}")
    c3 = None if c is None else 3 * c
    ctx.declare("qkv_weight", (c3, c))
    ctx.declare("proj_weight", (c, c))
    if p.bias_term:
        ctx.declare("qkv_bias", (c3,))
        ctx.declare("proj_bias", (c,))
    return [s]


@rule("MoE")
def _moe(ctx):
    p = ctx.lp.moe_param
    if p is None or p.num_experts < 1 or p.hidden_dim < 1:
        ctx.problem("shape", "moe_param needs num_experts and hidden_dim")
        return [None] * len(ctx.lp.top)
    s = ctx.in_shapes[0]
    c = None if s is None or not s else s[-1]
    ctx.declare("gate", (c, p.num_experts))
    ctx.declare("w1", (p.num_experts, c, p.hidden_dim))
    ctx.declare("b1", (p.num_experts, p.hidden_dim))
    ctx.declare("w2", (p.num_experts, p.hidden_dim, c))
    ctx.declare("b2", (p.num_experts, c))
    tops = [s]
    if len(ctx.lp.top) > 1:
        tops.append(())
    return tops


@rule("Pipeline")
def _pipeline(ctx):
    p = ctx.lp.pipeline_param
    if p is None or p.num_stages < 1 or not p.layer:
        ctx.problem("wiring",
                    "pipeline_param needs num_stages >= 1 and at least "
                    "one inner layer")
        return [ctx.in_shapes[0] if ctx.in_shapes else None]
    if len(ctx.lp.bottom) != 1:
        ctx.problem("wiring", "Pipeline takes exactly one bottom")
    in_shape = ctx.in_shapes[0] if ctx.in_shapes else None
    n_micro = max(p.micro_batches, 1)
    if in_shape is not None and in_shape and in_shape[0] is not None \
            and in_shape[0] % n_micro:
        ctx.problem("shape",
                    f"batch {in_shape[0]} not divisible by micro_batches "
                    f"{n_micro}")
    # one block's layers, shapes chained through a local env
    # (composite.py PipelineLayer.setup)
    block_input = ctx.lp.bottom[0] if ctx.lp.bottom else ""
    env = {block_input: in_shape}
    out_shape = in_shape
    for ilp in p.layer:
        if ilp.type == "Dropout" and ctx.phase == "TRAIN":
            ctx.problem("wiring",
                        f"block layer {ilp.name!r}: Dropout inside a "
                        "Pipeline block is unsupported in TRAIN phase")
        if (ilp.attention_param is not None
                and ilp.attention_param.sequence_parallel):
            ctx.problem("wiring",
                        f"block layer {ilp.name!r}: sequence_parallel "
                        "attention inside a Pipeline block is unsupported")
        if ilp.type in STATEFUL_TYPES:
            ctx.problem("wiring",
                        f"block layer {ilp.name!r} ({ilp.type}) is "
                        "stateful; only stateless ops can be pipelined")
        inner = _Ctx(ctx.analysis, ilp, [], ctx.phase)
        inner.probe = None
        bad_bottom = False
        for b in ilp.bottom:
            if b not in env:
                ctx.problem("wiring",
                            f"block layer {ilp.name!r}: unknown bottom "
                            f"{b!r}")
                bad_bottom = True
                break
            inner.in_shapes.append(env[b])
        if bad_bottom:
            continue
        fn = RULES.get(ilp.type)
        if fn is None:
            ctx.problem("wiring",
                        f"block layer {ilp.name!r}: unknown type "
                        f"{ilp.type!r}")
            continue
        outs = _run_rule(fn, inner)
        for t, s in zip(ilp.top, outs):
            env[t] = None if s is None else tuple(s)
        # stacked decls: leading stage dim, inner multipliers carry over
        for pname, info in inner.params.items():
            if info.shared_name:
                ctx.problem("params",
                            f"block layer {ilp.name!r}: cross-net param "
                            "sharing inside a block is unsupported")
            stacked = ParamInfo(f"{ilp.name}.{pname}",
                                (p.num_stages, *info.shape),
                                info.lr_mult, info.decay_mult)
            ctx.params[stacked.name] = stacked
        if ilp.top:
            out_shape = env.get(ilp.top[0], None)
    if p.layer and p.layer[-1].top:
        out_shape = env.get(p.layer[-1].top[0], None)
    if out_shape is not None and in_shape is not None \
            and tuple(out_shape) != tuple(in_shape):
        ctx.problem("shape",
                    f"pipeline block must be shape-preserving, got "
                    f"{_fmt(in_shape)} -> {_fmt(out_shape)}")
    return [in_shape]


# ---------------------------------------------------------------------------
# dtype resolution (string-level DtypePolicy.resolve, core/types.py)

def resolve_layer_types(lp: LayerParameter, net: NetParameter,
                        precision: str = "") -> tuple:
    """(forward, backward) Type names for one layer — layer override >
    net default, the net default rewritten by `precision: bf16` exactly
    as net.py does (explicit prototxt defaults win over the knob)."""
    net_fwd = net.default_forward_type
    net_bwd = net.default_backward_type
    if precision == "bf16":
        if not net.has("default_forward_type"):
            net_fwd = "FLOAT16"
        if not net.has("default_backward_type"):
            net_bwd = "FLOAT16"
    return (lp.forward_type or net_fwd or "FLOAT",
            lp.backward_type or net_bwd or "FLOAT")


# ---------------------------------------------------------------------------
# MAC model (the single spelling behind utils/flops.py and summarize)

def macs_per_image(type_name: str, in_shapes: list, out_shapes: list,
                   param_shapes: dict, lp=None) -> "int | None":
    """Multiply-accumulates per image/sample for one layer; 0 for
    layers without products, None when a needed dim is unknown. The
    MAC accounting documented in utils/flops.py (convolution and product
    terms only — elementwise, pooling and norm layers are memory-bound
    noise beside them; the backward costs twice the forward)."""
    if type_name == "Convolution":
        if not out_shapes or out_shapes[0] is None or len(out_shapes[0]) != 4:
            return None
        _, _, oh, ow = out_shapes[0]
        w = _prod(param_shapes.get("weight", (None,)))
        return None if not _known(w, oh, ow) else w * oh * ow
    if type_name == "Deconvolution":
        if not in_shapes or in_shapes[0] is None or len(in_shapes[0]) != 4:
            return None
        _, _, ih, iw = in_shapes[0]
        w = _prod(param_shapes.get("weight", (None,)))
        return None if not _known(w, ih, iw) else w * ih * iw
    if type_name == "InnerProduct":
        out = out_shapes[0] if out_shapes else None
        if out is None:
            return None
        positions = _prod(out[1:-1]) if len(out) > 2 else 1
        w = _prod(param_shapes.get("weight", (None,)))
        return None if not _known(w, positions) else w * positions
    if type_name == "Attention":
        s0 = in_shapes[0] if in_shapes else None
        if s0 is None or len(s0) != 3 or not _known(*s0[1:]):
            return None
        _, s, c = s0
        return 4 * s * c * c + 2 * s * s * c
    if type_name == "MoE":
        s0 = in_shapes[0] if in_shapes else None
        w1 = param_shapes.get("w1")
        if s0 is None or w1 is None or not _known(*w1):
            return None
        tokens = _prod(s0[1:-1]) if len(s0) > 2 else 1
        c = s0[-1]
        e, _, h = w1
        k = max(getattr(getattr(lp, "moe_param", None), "top_k", 1), 1) \
            if lp is not None else 1
        return None if not _known(tokens, c) \
            else tokens * (c * e + k * 2 * c * h)
    return 0


def layer_macs(info: LayerInfo) -> "int | None":
    return macs_per_image(info.type, info.in_shapes, info.out_shapes,
                          {k: v.shape for k, v in info.params.items()},
                          info.lp)


def _dtype_bytes(type_name: str) -> int:
    return 2 if type_name == "FLOAT16" else 4


def layer_footprint(info: LayerInfo) -> dict:
    """Per-layer forward+backward traffic estimate at the layer's
    compute dtype: fwd reads bottoms + writes tops; bwd re-reads bottoms
    plus the tops' cotangents and writes bottom cotangents ~ 2x fwd;
    params at f32 master, read fwd + read/write bwd. All quantities are per
    declared batch; None where a dim is unknown."""
    act_bytes = _dtype_bytes(info.fwd_type)
    n_in = 0
    for s in info.in_shapes:
        c = _prod(s) if s is not None else None
        n_in = None if None in (n_in, c) else n_in + c
    n_out = 0
    for s in info.out_shapes:
        c = _prod(s) if s is not None else None
        n_out = None if None in (n_out, c) else n_out + c
    n_param = 0
    for p in info.params.values():
        c = _prod(p.shape)
        n_param = None if None in (n_param, c) else n_param + c
    macs = layer_macs(info)
    fwd = None if None in (n_in, n_out) \
        else (n_in + n_out) * act_bytes + (n_param or 0) * 4
    bwd = None if fwd is None else 2 * (n_in + n_out) * act_bytes \
        + (n_param or 0) * 8
    return {"macs": macs, "param_count": n_param,
            "fwd_bytes": fwd, "bwd_bytes": bwd}


# ---------------------------------------------------------------------------
# the walk over the net

def analyze_net(param: NetParameter, phase: str = "TRAIN", *,
                level: int = 0, stages=(), precision: str = "",
                data_probe=None) -> NetAnalysis:
    """Statically walk a NetParameter the way Net.__init__ (net.py)
    builds it: normalize legacy fields, filter by phase/level/stage,
    then run each live layer's shape rule in declaration order. Never
    imports torch, never opens a dataset (`data_probe(lp) -> (C, H, W)`
    supplies Data-layer record shapes when the caller has them; absent,
    those dims propagate as None). Collects problems instead of raising
    so one run surfaces every defect."""
    param = normalize_net(param)
    # original (pre-filter) declaration positions — Problem identity
    # for unnamed layers; filter_net keeps the same objects
    orig_index = {id(lp): i for i, lp in enumerate(param.layer)}
    state = NetState(phase=phase, level=level, stage=list(stages))
    param = filter_net(param, state)
    analysis = NetAnalysis(name=param.name, phase=phase)

    blob_shapes: dict[str, "tuple | None"] = {}
    shared_owner: dict[str, tuple] = {}
    feed_blobs: list[str] = []

    for idx, lp in enumerate(param.layer):
        fwd, bwd = resolve_layer_types(lp, param, precision)
        info = LayerInfo(index=idx, name=lp.name, type=lp.type, lp=lp,
                         fwd_type=fwd, bwd_type=bwd)
        for tname in (fwd, bwd):
            if tname not in _VALID_TYPE_NAMES:
                analysis.problems.append(Problem(
                    lp.name, "dtype",
                    f"unknown Type name {tname!r} (expected FLOAT / "
                    "FLOAT16 / DOUBLE / INT / UINT)"))
        ctx = _Ctx(analysis, lp, [], phase, index=orig_index.get(id(lp)))
        ctx.probe = data_probe(lp) if (data_probe is not None
                                       and lp.type == "Data") else None
        for b in lp.bottom:
            if b not in blob_shapes:
                ctx.problem("wiring",
                            f"unknown bottom blob {b!r} (layers execute "
                            "in declaration order)")
                ctx.in_shapes.append(None)
            else:
                ctx.in_shapes.append(blob_shapes[b])
        fn = RULES.get(lp.type)
        if fn is None:
            ctx.problem("wiring",
                        f"unknown layer type {lp.type!r}")
            outs = [None] * len(lp.top)
        else:
            # a missing bottom already poisoned in_shapes with None;
            # still run the rule so params declare and checks that only
            # need known dims keep firing
            outs = _run_rule(fn, ctx)
        outs = [None if s is None else tuple(s) for s in outs]
        info.in_shapes = list(ctx.in_shapes)
        info.out_shapes = outs
        info.params = ctx.params
        if len(outs) != len(lp.top) and lp.type != "Silence":
            ctx.problem("wiring",
                        f"produces {len(outs)} tops, prototxt names "
                        f"{len(lp.top)}")
        for t, s in zip(lp.top, outs):
            if t in blob_shapes and t not in lp.bottom:
                ctx.problem("wiring",
                            f"duplicate top blob {t!r} — another layer "
                            "already produces it and this one does not "
                            "consume it (not in-place)")
            blob_shapes[t] = s
        if lp.type in INPUT_TYPES:
            feed_blobs.extend(lp.top)
        # loss weights (net.py / reference layer.hpp SetLossWeights)
        for ti, t in enumerate(lp.top):
            w = (lp.loss_weight[ti] if ti < len(lp.loss_weight)
                 else (1.0 if (lp.type in LOSS_TYPES and ti == 0) else 0.0))
            info.loss_weights.append(w)
            if w:
                analysis.loss_blobs.append((t, w))
        # param sharing (net.py: shape must match the owner's)
        for pname, decl in ctx.params.items():
            if decl.shared_name:
                owner = shared_owner.get(decl.shared_name)
                if owner is None:
                    shared_owner[decl.shared_name] = (lp.name, pname,
                                                      decl.shape)
                elif owner[2] != decl.shape and _known(
                        *[d for s in (owner[2], decl.shape) for d in s]):
                    ctx.problem("params",
                                f"shared param {decl.shared_name!r}: shape "
                                f"{_fmt(decl.shape)} != owner "
                                f"{owner[0]}.{owner[1]} {_fmt(owner[2])}")
        # param-spec arity: specs beyond the declared blobs bind nothing
        # (Net::AppendParam applies them positionally); BatchNorm has its
        # own, more specific message above
        if len(lp.param) > len(ctx.params) and lp.type != "BatchNorm":
            ctx.problem("params",
                        f"{len(lp.param)} param specs for "
                        f"{len(ctx.params)} learnable blobs — extra "
                        "lr_mult/decay_mult entries bind to nothing")
        analysis.layers.append(info)

    dups = len(feed_blobs) - len(set(feed_blobs))
    if dups:
        analysis.problems.append(Problem(
            "", "wiring", "duplicate feed blob names across input layers"))
    analysis.blob_shapes = blob_shapes
    return analysis


# ---------------------------------------------------------------------------
# graph-level structural analyses consumed by netlint

def inplace_hazards(analysis: NetAnalysis) -> list:
    """Problems the reference's buffer-aliasing in-place rules would
    hit: (a) an in-place layer whose output shape differs from the blob
    it overwrites (same buffer in the reference — net.cpp requires
    matching counts), (b) an in-place rewrite of a blob VERSION that
    other layers also consume (the reference overwrites the shared
    buffer, clobbering the sibling consumer's forward/backward data;
    util/insert_splits.cpp only splits non-in-place fan-out)."""
    problems: list[Problem] = []
    # blob -> (producer index, version); consumers per (blob, version)
    version: dict[str, int] = {}
    consumers: dict[tuple, list] = {}
    for info in analysis.layers:
        lp = info.lp
        for b in dict.fromkeys(lp.bottom):
            v = version.get(b, 0)
            consumers.setdefault((b, v), []).append(
                (info, b in lp.top))
        for ti, t in enumerate(lp.top):
            if t in lp.bottom:
                bi = lp.bottom.index(t)
                old = info.in_shapes[bi] if bi < len(info.in_shapes) else None
                new = info.out_shapes[ti] if ti < len(info.out_shapes) \
                    else None
                if old is not None and new is not None and old != new \
                        and all(_known(*p) for p in zip(old, new)):
                    problems.append(Problem(
                        lp.name, "wiring",
                        f"in-place layer changes blob {t!r} from "
                        f"{_fmt(old)} to {_fmt(new)} — the reference "
                        "aliases top and bottom buffers, which requires "
                        "equal counts"))
            version[t] = version.get(t, 0) + 1
    for (blob, _v), cons in consumers.items():
        inplace = [i for i, (info, ip) in enumerate(cons) if ip]
        if inplace and len(cons) > 1:
            info = cons[inplace[0]][0]
            others = [c[0].name for j, c in enumerate(cons)
                      if j != inplace[0]]
            problems.append(Problem(
                info.name, "wiring",
                f"in-place rewrite of blob {blob!r} which "
                f"{len(others)} other layer(s) ({', '.join(others[:3])}"
                f"{', ...' if len(others) > 3 else ''}) also consume — "
                "in the reference the shared buffer is clobbered under "
                "their feet"))
    return problems


def unconsumed_tops(analysis: NetAnalysis) -> dict:
    """{blob: producing LayerInfo} for tops no later layer consumes
    (net outputs in Caffe semantics). Informational — netlint decides
    which of these are findings."""
    consumed = set()
    for info in analysis.layers:
        consumed.update(info.lp.bottom)
    out = {}
    for info in analysis.layers:
        for t in info.lp.top:
            if t not in consumed:
                out[t] = info
    return out
