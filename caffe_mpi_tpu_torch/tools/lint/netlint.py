"""netlint — model-level static analysis passes (net-*).

The port's copy of the JAX package's `caffe_mpi_tpu/tools/lint/netlint.py`.
The reference validates a model graph only by BUILDING it: Net::Init
(net.cpp:815-818) runs insert_splits, shape inference and param checks at
construction, so a broken prototxt surfaces only when it is built on the
card. These passes run the same load-bearing checks ahead of time, over
the declarative prototxt alone, through the torch-free shape/dtype engine
(proto/netshape.py — the port's one spelling of the Caffe shape
semantics, held equal to the built `Net` for the whole model zoo by
tests/test_torch_cli_tools.py and by chip_smoke.py's `shapes` phase).

Pass family (all whole-tree: they scan models/ + examples/ under the
run root):

  net-wiring    dangling bottoms, duplicate tops, illegal in-place
                (shape-changing or multi-consumer rewrite), layers
                unreachable in every phase, phase-inconsistent includes,
                top-count mismatches, malformed prototxt
  net-shape     full-graph shape inference must succeed: mismatched
                bottoms, non-positive dims, pad >= kernel, reshape
                count mismatches, swapped loss bottoms
  net-params    param-spec arity (BVLC BatchNorm lr_mult triples bind
                to the wrong blobs under the NVCaffe [mean, var,
                correction, scale?, bias?] layout), shared-param shape
                mismatches
  net-dtype     unknown Type names; FLOAT16 compute requested on a
                bf16-ineligible layer (host-callback/IO layers — the
                `BF16_INELIGIBLE` registry in proto/netshape.py, shared
                with net.py's build-time warning)
  net-serve     deploy nets that silently lose the serving fast paths:
                batch-dim-baking layers that break BucketedForward's
                bucket re-padding, and image inputs ineligible for the
                native request-ingest plan (serving/ingest.py
                build_plan)
  net-footprint a single blob/param whose byte size exceeds the device
                memory budget (CAFFE_NETLINT_HBM_MB, default one H100's
                memory from utils/flops.py CARD_RATES) — the typo'd-dim
                detector; per-layer bytes/MACs come from the same engine
                records tools/summarize.py renders

Waivers: per layer, a `# lint: ok(net-...) — reason` comment anywhere
inside the layer's `layer { ... }` block (or the comment block directly
above it) suppresses that layer's finding; net-level findings honor a
waiver above the first layer block. Generated prototxts (the
models/generate_models.py zoo) cannot carry hand comments across
regeneration — waive those through `GENERATED_WAIVERS` below instead.
These passes apply their own waivers.
"""

from __future__ import annotations

import os
import re
from typing import Iterator

from . import FileContext, Finding, LintPass, register
from ...proto.config import NetParameter, NetState
from ...proto.netshape import (
    BF16_INELIGIBLE,
    LOSS_TYPES as _LOSS_TYPES,
    NetAnalysis,
    analyze_net,
    inplace_hazards,
    layer_footprint,
    _known,
    _fmt,
    _prod,
)
from ...proto.text_format import PrototxtError, parse
from ...proto.upgrade import layer_included
from ...utils.flops import card_memory_mb

# directories under the run root scanned for model definitions
MODEL_SCAN = ("models", "examples")
PHASES = ("TRAIN", "TEST")
NET_PASSES = ("net-wiring", "net-shape", "net-params", "net-dtype",
              "net-serve", "net-footprint")

# waiver registry for GENERATED prototxts (models/generate_models.py
# output loses hand comments on regeneration): (relpath, pass, layer)
# -> reason. Layer "" = net-level finding.
GENERATED_WAIVERS: dict[tuple[str, str, str], str] = {}

# ONE spelling of the waiver syntax — the framework's regex, so the
# prototxt grammar can never drift from the documented .py grammar
from . import _WAIVER_RE  # noqa: E402

# net-footprint's default budget: one card's memory, the card the port
# runs on (utils/flops.py CARD_RATES, as nvidia-smi reports it)
DEFAULT_CARD = "NVIDIA H100 80GB HBM3"
DEFAULT_BUDGET_MB = card_memory_mb(DEFAULT_CARD)

# mini-tokenizer for layer-span discovery: both string quote forms the
# real text-format grammar accepts (text_format._TOKEN_RE), braces,
# words, comments
_TOKEN_RE = re.compile(
    r'"(?:\\.|[^"\\])*"|\'(?:\\.|[^\'\\])*\'|\{|\}|[A-Za-z_][\w./-]*|#')


# cheap net-vs-solver pre-filter: a net file declares layer blocks (the
# text format also accepts the colon message form `layer: { ... }` —
# text_format.py parse_field) or legacy net-level inputs; a solver
# prototxt has neither and skips the full parse entirely
_NETLIKE_RE = re.compile(r"(?m)^\s*(?:layers?\s*:?\s*\{|input\s*:)")


class _NetFile:
    """One parsed+analyzed prototxt net, shared by all net-* passes.
    Layer spans and waiver lines are computed lazily — most files are
    clean and never need them."""

    def __init__(self, path: str):
        self.path = path
        with open(path, encoding="utf-8") as f:
            self.src = f.read()
        self.lines = self.src.splitlines()
        self.parse_error: str | None = None
        self.is_net = False
        self.npar: NetParameter | None = None
        self.analyses: dict[str, NetAnalysis] = {}
        self._spans: list[tuple[str, int, int]] | None = None
        self._waivers: dict[int, set[str]] | None = None
        if not _NETLIKE_RE.search(self.src):
            return  # a solver (or other) prototxt — not a net
        try:
            node = parse(self.src)
        except PrototxtError as e:
            self.parse_error = str(e)
            return
        if not ("layer" in node or "layers" in node or "input" in node):
            return
        self.is_net = True
        try:
            self.npar = NetParameter.from_node(node)
            layers = self.npar.layer or self.npar.layers
            if any(l.include or l.exclude for l in layers):
                for phase in PHASES:
                    self.analyses[phase] = analyze_net(self.npar,
                                                       phase=phase)
            else:
                # no phase rules: TRAIN and TEST filter identically, so
                # one analysis serves both slots (the scan's hot path).
                # The one phase-dependent check (Dropout-in-Pipeline,
                # TRAIN-only) must not fire on a deploy-shaped net that
                # is never trained — pick the phase by whether the net
                # carries a loss at all
                train_like = any(
                    l.type in _LOSS_TYPES or l.loss_weight
                    for l in layers)
                shared = analyze_net(
                    self.npar, phase="TRAIN" if train_like else "TEST")
                self.analyses = {p: shared for p in PHASES}
        except (TypeError, ValueError) as e:
            # schema coercion / normalization error: surfaced as a
            # wiring finding, same as a file that does not parse
            self.parse_error = str(e)
            self.npar = None
            self.analyses = {}

    # -- locating + waiving -------------------------------------------------
    @property
    def spans(self) -> list[tuple[str, int, int]]:
        if self._spans is None:
            self._spans = _layer_spans(self.lines)
        return self._spans

    @property
    def waivers(self) -> dict[int, set[str]]:
        if self._waivers is None:
            self._waivers = _prototxt_waivers(self.lines)
        return self._waivers

    def line_of(self, layer_name: str) -> int:
        for name, start, _end in self.spans:
            if name == layer_name:
                return start
        m = re.search(r'name\s*:\s*"%s"' % re.escape(layer_name), self.src)
        if m:
            return self.src[: m.start()].count("\n") + 1
        return 1

    def waived(self, layer_name: str, pass_name: str, root: str) -> bool:
        rel = os.path.relpath(self.path, root)
        if (rel, pass_name, layer_name) in GENERATED_WAIVERS:
            return True
        spans = [(s, e) for n, s, e in self.spans if n == layer_name]
        if not spans:
            # net-level findings: a waiver anywhere above the first
            # layer block (the file header) binds
            first = min((s for _n, s, _e in self.spans), default=None)
            spans = [(1, (first - 1) if first else len(self.lines))]
        for lo, hi in spans:
            for ln in range(lo, hi + 1):
                if pass_name in self.waivers.get(ln, ()):
                    return True
            above = lo - 1
            while 1 <= above <= len(self.lines) and \
                    self.lines[above - 1].lstrip().startswith("#"):
                if pass_name in self.waivers.get(above, ()):
                    return True
                above -= 1
        return False


def _comment_of(line: str) -> str:
    """The comment portion of one prototxt line — the first `#` NOT
    inside a quoted string (a path like '/data/#shard' must not read
    as a comment, and waiver grammar quoted in a string value must not
    register)."""
    in_q = ""
    i = 0
    while i < len(line):
        c = line[i]
        if in_q:
            if c == "\\":
                i += 2
                continue
            if c == in_q:
                in_q = ""
        elif c in "\"'":
            in_q = c
        elif c == "#":
            return line[i:]
        i += 1
    return ""


def _prototxt_waivers(lines: list[str]) -> dict[int, set[str]]:
    out: dict[int, set[str]] = {}
    for i, line in enumerate(lines, 1):
        # the waiver grammar always spells "lint" — skip the char-wise
        # comment scan for the vast majority of lines that can't match
        if "lint" not in line:
            continue
        comment = _comment_of(line)
        if not comment:
            continue
        names: set[str] = set()
        for m in _WAIVER_RE.finditer(comment):
            names.update(n.strip() for n in m.group(1).split(",")
                         if n.strip())
        if names:
            out.setdefault(i, set()).update(names)
    return out


def _layer_spans(lines: list[str]) -> list[tuple[str, int, int]]:
    """Top-level `layer { ... }` block spans with the block's declared
    name. Brace-counting over a comment/string-aware token scan —
    nested blocks (pipeline_param's inner `layer {`) stay inside the
    outer span."""
    spans = []
    depth = 0
    last_word = ""
    start = None
    for i, raw in enumerate(lines, 1):
        for tok in _TOKEN_RE.finditer(raw):
            t = tok.group(0)
            if t == "#":
                break  # rest of the line is a comment
            if t == "{":
                if depth == 0 and last_word in ("layer", "layers"):
                    start = i
                depth += 1
            elif t == "}":
                depth = max(depth - 1, 0)
                if depth == 0 and start is not None:
                    name = ""
                    text = "\n".join(lines[start - 1: i])
                    m = re.search(r'name\s*:\s*"((?:\\.|[^"\\])*)"', text)
                    if m:
                        name = m.group(1)
                    spans.append((name, start, i))
                    start = None
            elif t[0] not in "\"'":
                last_word = t
    return spans


def _iter_prototxts(root: str) -> Iterator[str]:
    for d in MODEL_SCAN:
        base = os.path.join(root, d)
        if not os.path.isdir(base):
            continue
        for dirpath, dirnames, files in os.walk(base):
            dirnames[:] = sorted(x for x in dirnames if x != "__pycache__")
            for name in sorted(files):
                if name.endswith(".prototxt"):
                    yield os.path.join(dirpath, name)


# run-lifetime cache: every pass in a run re-walks the same files, and
# the engine analysis is the expensive part — key on mtime so edits
# between runs (tests, --changed) invalidate
_CACHE: dict[str, tuple[float, _NetFile]] = {}


def net_files(root: str) -> list[_NetFile]:
    out = []
    for path in _iter_prototxts(root):
        try:
            mtime = os.path.getmtime(path)
        except OSError:
            continue
        cached = _CACHE.get(path)
        if cached is None or cached[0] != mtime:
            cached = (mtime, _NetFile(path))
            _CACHE[path] = cached
        out.append(cached[1])
    return out


def _merged_problems(nf: _NetFile, kinds: tuple) -> list:
    """Engine problems of the given kinds across phases, deduped: a
    problem present in every phase reports once, a phase-specific one
    is tagged with its phase (the phase-inconsistent-include signal).
    Unnamed layers are identified by their declaration index so two
    unnamed layers with the same defect never merge into one report."""
    seen: dict[tuple, set] = {}
    for phase, analysis in nf.analyses.items():
        probs = list(analysis.problems)
        if "wiring" in kinds:
            probs += inplace_hazards(analysis)
        for p in probs:
            if p.kind in kinds:
                ident = p.layer or (f"#{p.index}"
                                    if p.index is not None else "")
                seen.setdefault((ident, p.layer, p.message),
                                set()).add(phase)
    out = []
    for (ident, layer, message), phases in seen.items():
        if len(phases) < len(nf.analyses):
            message += f" [phase {'/'.join(sorted(phases))}]"
        out.append((ident, layer, message))
    return out


class _NetPass(LintPass):
    """Base for the net-* family: whole-tree over models/ + examples/,
    self-applied prototxt waivers."""

    kinds: tuple = ()

    def check_tree(self, ctxs: list[FileContext],
                   root: str) -> Iterator[Finding]:
        for nf in net_files(root):
            if nf.parse_error is not None:
                # one pass owns the malformed-file finding
                if self.name == "net-wiring":
                    yield Finding(self.name, nf.path, 1,
                                  f"prototxt does not parse/coerce: "
                                  f"{nf.parse_error}", span=None)
                continue
            if not nf.is_net:
                continue
            for ident, layer, message in _merged_problems(nf, self.kinds):
                if nf.waived(ident, self.name, root):
                    continue
                where = (f"layer {layer!r}: " if layer
                         else f"layer {ident} (unnamed): " if ident
                         else "")
                yield Finding(self.name, nf.path, nf.line_of(layer),
                              where + message, span=None)
            for layer, message in self.extra(nf):
                if not nf.waived(layer, self.name, root):
                    where = f"layer {layer!r}: " if layer else ""
                    yield Finding(self.name, nf.path, nf.line_of(layer),
                                  where + message, span=None)

    def extra(self, nf: _NetFile) -> Iterator[tuple[str, str]]:
        return iter(())


@register
class NetWiringPass(_NetPass):
    name = "net-wiring"
    description = ("model graphs: dangling bottoms, duplicate tops, "
                   "illegal in-place, unreachable layers, "
                   "phase-inconsistent includes")
    kinds = ("wiring",)

    def extra(self, nf: _NetFile) -> Iterator[tuple[str, str]]:
        # a waiver naming an unknown pass suppresses nothing — fail it,
        # mirroring the framework's bad-waiver rule for .py files
        from . import REGISTRY
        for ln in sorted(nf.waivers):
            for bad in sorted(nf.waivers[ln] - set(REGISTRY)):
                yield ("", f"line {ln}: waiver names unknown pass "
                           f"{bad!r} — a misspelled waiver suppresses "
                           "nothing")
        # layers unreachable in EVERY standard phase (rules gated on
        # stages/levels are deliberate run-time switches and exempt)
        if nf.npar is None:
            return
        states = {p: NetState(phase=p) for p in PHASES}
        for lp in nf.npar.layer:
            rules = list(lp.include) + list(lp.exclude)
            if any(r.stage or r.not_stage or r.has("min_level")
                   or r.has("max_level") for r in rules):
                continue
            if not any(layer_included(lp, states[p]) for p in PHASES):
                yield (lp.name,
                       "unreachable: include/exclude rules reject the "
                       "layer in both TRAIN and TEST phases")


@register
class NetShapePass(_NetPass):
    name = "net-shape"
    description = ("model graphs: full shape inference must succeed — "
                   "mismatched bottoms, non-positive dims, pad >= kernel")
    kinds = ("shape",)


@register
class NetParamsPass(_NetPass):
    name = "net-params"
    description = ("model graphs: param-spec arity, BatchNorm blob "
                   "layout, shared-param shape agreement")
    kinds = ("params",)


@register
class NetDtypePass(_NetPass):
    name = "net-dtype"
    description = ("model graphs: unknown dtype names; FLOAT16 compute "
                   "requested on bf16-ineligible (host-callback) layers")
    kinds = ("dtype",)

    def extra(self, nf: _NetFile) -> Iterator[tuple[str, str]]:
        seen = set()
        for analysis in nf.analyses.values():
            for info in analysis.layers:
                if info.fwd_type != "FLOAT16" or \
                        info.type not in BF16_INELIGIBLE:
                    continue
                if info.name in seen:
                    continue
                seen.add(info.name)
                how = ("explicit forward_type: FLOAT16"
                       if info.lp.forward_type == "FLOAT16"
                       else "the net-level FLOAT16 default")
                yield (info.name,
                       f"{info.type} computes through a host callback "
                       f"with f32 buffers; {how} requests bf16 it cannot "
                       "honor — pin `forward_type: FLOAT` on this layer "
                       "(registry: proto/netshape.py BF16_INELIGIBLE)")


# layers that bake the batch dimension into their arithmetic — serving's
# BucketedForward re-pads the leading dim across the bucket ladder
# (serving/engine.py), so per-row outputs change with the co-batch
def _bakes_batch(info) -> str | None:
    lp = info.lp
    if info.type == "Reshape":
        p = lp.reshape_param
        spec = list(p.shape.dim) if (p and p.shape) else []
        start = p.axis if p else 0
        if spec and start == 0 and spec[0] not in (0, -1):
            return (f"Reshape pins the batch dimension to {spec[0]} "
                    "(use 0 to copy or -1 to infer)")
    if info.type == "Flatten":
        p = lp.flatten_param
        if p and p.axis == 0:
            return "Flatten with axis 0 folds the batch dimension"
    if info.type == "InnerProduct":
        p = lp.inner_product_param
        if p and p.axis == 0:
            return "InnerProduct with axis 0 contracts over the batch"
    if info.type == "Reduction":
        p = lp.reduction_param
        if p and p.axis == 0:
            return "Reduction with axis 0 sums over the batch"
    return None


@register
class NetServePass(_NetPass):
    name = "net-serve"
    description = ("deploy nets: predicts serving eligibility — "
                   "batch-baking layers break BucketedForward, non-RGB "
                   "image inputs decline the native ingest plan")
    kinds = ()

    def extra(self, nf: _NetFile) -> Iterator[tuple[str, str]]:
        analysis = nf.analyses.get("TEST")
        if analysis is None:
            return
        # deploy-shaped net: pure Input feeds, nothing loss-weighted or
        # metric-bearing in ANY phase (a train_val net whose loss is
        # TRAIN-gated must not read as a deploy under TEST filtering)
        input_layers = [i for i in analysis.layers if i.type == "Input"]
        if not input_layers or any(
                a.loss_blobs or any(
                    i.type == "Accuracy" or i.type in (
                        "Data", "ImageData", "HDF5Data", "WindowData")
                    for i in a.layers)
                for a in nf.analyses.values()):
            return
        for info in analysis.layers:
            why = _bakes_batch(info)
            if why:
                yield (info.name,
                       f"{why} — BucketedForward re-pads the batch "
                       "across the serve_buckets ladder, so this model "
                       "cannot hold row-identical scores when served")
        # native request ingest (serving/ingest.py build_plan): 4-D RGB
        # image input; anything image-LIKE that misses the C==3 gate
        # silently serves through the per-request PIL path
        first = input_layers[0]
        if first.out_shapes and first.out_shapes[0] is not None:
            s = first.out_shapes[0]
            if len(s) == 4 and _known(*s[1:]) and s[2] > 1 and s[3] > 1 \
                    and s[1] != 3:
                yield (first.name,
                       f"image-shaped input {_fmt(s)} has {s[1]} "
                       "channels; ingest.build_plan requires 3 — "
                       "requests will silently take the classic "
                       "per-request PIL path (-require_native_ingest "
                       "would fail)")


@register
class NetFootprintPass(_NetPass):
    name = "net-footprint"
    description = ("model graphs: per-layer bytes/MACs accounting; "
                   "flags any single blob larger than the HBM budget")
    kinds = ()

    def extra(self, nf: _NetFile) -> Iterator[tuple[str, str]]:
        budget_mb = int(os.environ.get("CAFFE_NETLINT_HBM_MB",
                                       DEFAULT_BUDGET_MB))
        budget = budget_mb * 2 ** 20
        seen = set()
        for analysis in nf.analyses.values():
            for info in analysis.layers:
                per_elem = 2 if info.fwd_type == "FLOAT16" else 4
                for t, s in zip(info.lp.top, info.out_shapes):
                    n = _prod(s) if s is not None else None
                    if n is not None and n * per_elem > budget and \
                            (info.name, t) not in seen:
                        seen.add((info.name, t))
                        yield (info.name,
                               f"top {t!r} {_fmt(s)} is "
                               f"{n * per_elem / 2**30:.1f} GiB — larger "
                               f"than the whole {budget_mb} MiB HBM "
                               "budget (CAFFE_NETLINT_HBM_MB); a typo'd "
                               "dim?")
                for pname, p in info.params.items():
                    n = _prod(p.shape)
                    if n is not None and n * 4 > budget and \
                            (info.name, pname) not in seen:
                        seen.add((info.name, pname))
                        yield (info.name,
                               f"param {pname!r} {_fmt(p.shape)} is "
                               f"{n * 4 / 2**30:.1f} GiB — larger than "
                               f"the {budget_mb} MiB HBM budget")
