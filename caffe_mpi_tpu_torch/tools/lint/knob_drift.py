"""knob-drift pass: performance knobs must be declared, flagged,
documented and consumed (the accepted-but-ignored detector).

Port of the JAX package's caffe_mpi_tpu/tools/lint/knob_drift.py (the
same pass name, registry and messages, the paths spelled as the
port's). A knob that parses but drives nothing is worse than a missing
one: recipes carry it, operators tune it, and nothing changes (the JAX
package's `reduce_buckets` sat parsed and unread for five PRs; the
reference consumes it in net.cpp:757-913). The port's rule is the same:
a field it has not ported is refused, never accepted and ignored. Each
registered knob is held to four legs:

  1. declared: a SolverParameter/NetParameter/ServingParameter field in
     caffe_mpi_tpu_torch/proto/config.py (read by AST, no import);
  2. flagged: spelled in caffe_mpi_tpu_torch/tools/cli.py;
  3. documented: named in caffe_mpi_tpu_torch/docs/knobs.md;
  4. consumed: read under caffe_mpi_tpu_torch/ or in chip_smoke.py
     outside the schema, the CLI plumbing and this lint package: a
     Load-context attribute `.knob` or a `"knob"` string passed as a
     call argument. Writes, docstrings and this registry do not count.
     A field the port refuses counts as consumed when it stands in a
     module-level `UNPORTED_FIELDS`/`UNPORTED_FLAGS` table that the
     same module reads (the refusal names the ROADMAP.md item that
     ports it: serving/engine.py's `serve_program_bank`); a table that
     nothing reads drives no refusal and consumes nothing.

A whole-tree pass rooted at the run root; a root without the schema,
CLI and doc gives no findings. Waive a leg on the knob's field line in
the schema with `# lint: ok(knob-drift) — reason`.
"""

from __future__ import annotations

import ast
import os
from typing import Iterator

from . import FileContext, Finding, LintPass, iter_py_files, register

# the knob registry, the JAX package's: each knob must satisfy all four
# legs. Extend this tuple when adding a knob (its line in the knob doc
# is then enforced too).
KNOBS = (
    "step_chunk",       # K-step fused training
    "test_chunk",       # fused async evaluation
    "reduce_overlap",   # overlapped bucketed reduction
    "reduce_buckets",   # bucket count
    "grad_bucket_mb",   # bucket byte budget
    "serve_window_ms",  # continuous-batching window
    "serve_buckets",    # AOT padded-batch bucket ladder
    "serve_hbm_mb",     # resident-model HBM budget (LRU spill)
    "precision",        # bf16 compute, f32 master weights
    "loss_scale",       # static/dynamic bf16 loss scaling
    "loss_scale_window",  # clean steps before scale regrowth
    "serve_dtype",      # bf16 serving bucket programs
    "decoded_cache_mb",  # bounded decoded-record cache tier
    "hosts",            # elastic multi-host cluster size
    "coordinator",      # coordination-service address
    "host_deadline",    # cross-host heartbeat deadline
    "serve_queue_limit",  # load-shedding admission control
    "serve_deadline_ms",  # per-request dispatch deadline
    "serve_stall_s",    # serving dispatch stall breaker
    "serve_decoded_cache_mb",  # hot-content request cache
    "serve_program_bank",  # persistent AOT program bank
    "serve_replicas",   # serving fleet size (replica procs)
    "serve_retry_budget",  # router sibling-retry budget
    "replica_deadline",  # replica heartbeat deadline
    "min_hosts",        # degraded-mode quorum floor
)

CONFIG_FILE = os.path.join("caffe_mpi_tpu_torch", "proto", "config.py")
CLI_FILE = os.path.join("caffe_mpi_tpu_torch", "tools", "cli.py")
DOCS_FILE = os.path.join("caffe_mpi_tpu_torch", "docs", "knobs.md")
# where a consumer read counts (schema + CLI plumbing excluded: writing
# `sp.knob = args.knob` is not consumption; the lint package excluded:
# its own KNOBS registry naming every knob must not satisfy the leg it
# enforces)
CONSUMER_SCAN = ("caffe_mpi_tpu_torch", "chip_smoke.py")
_EXCLUDED_CONSUMERS = (CONFIG_FILE, CLI_FILE)
_EXCLUDED_CONSUMER_DIRS = (
    os.path.join("caffe_mpi_tpu_torch", "tools", "lint"),)
# module-level refusal tables: ((field, ROADMAP item), ...)
_REFUSAL_TABLES = ("UNPORTED_FIELDS", "UNPORTED_FLAGS")


def _solver_fields(path: str) -> dict[str, int]:
    """{field_name: line} of SolverParameter's dataclass fields (plus
    NetParameter's net-level knobs and ServingParameter's serving-plane
    knobs, which count as declarations too), by AST — the pass must run
    without the package importable."""
    tree = ast.parse(open(path, encoding="utf-8").read(), filename=path)
    fields: dict[str, int] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and node.name in (
                "SolverParameter", "NetParameter", "ServingParameter"):
            for stmt in node.body:
                if isinstance(stmt, ast.AnnAssign) and isinstance(
                        stmt.target, ast.Name):
                    fields.setdefault(stmt.target.id, stmt.lineno)
    return fields


def _mentions(src: str, knob: str) -> bool:
    return knob in src


def _reads(attrs, calls) -> set[str]:
    """Names the AST READS: Load-context `x.attr` attribute accesses,
    plus string literals passed as call arguments (getattr(sp, "knob"),
    sp.has("knob")). Store/Del-context attributes (`sp.knob = args.knob`
    — plumbing) and bare strings outside a call (docstrings, registry
    tuples) are excluded. Takes Attribute and Call node iterables
    (ctx.by_type buckets, or filtered ast.walk); one scan per file
    serves every knob."""
    reads: set[str] = set()
    for node in attrs:
        if isinstance(node.ctx, ast.Load):
            reads.add(node.attr)
    for node in calls:
        for a in node.args:
            if isinstance(a, ast.Constant) and isinstance(a.value, str):
                reads.add(a.value)
        for kw in node.keywords:
            a = kw.value
            if isinstance(a, ast.Constant) and isinstance(a.value, str):
                reads.add(a.value)
    return reads


def _refused(tree: ast.Module, names) -> set[str]:
    """The fields a module refuses: the first strings of the rows of its
    module-level UNPORTED_* tables, where the module reads the table
    (a refusal runs over it). `names`: the Load-context Names of the
    module."""
    read = {n.id for n in names if isinstance(n.ctx, ast.Load)}
    out: set[str] = set()
    for stmt in tree.body:
        if not (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
                and isinstance(stmt.targets[0], ast.Name)
                and stmt.targets[0].id in _REFUSAL_TABLES
                and stmt.targets[0].id in read
                and isinstance(stmt.value, (ast.Tuple, ast.List))):
            continue
        for row in stmt.value.elts:
            if isinstance(row, (ast.Tuple, ast.List)) and row.elts \
                    and isinstance(row.elts[0], ast.Constant) \
                    and isinstance(row.elts[0].value, str):
                out.add(row.elts[0].value)
    return out


@register
class KnobDriftPass(LintPass):
    name = "knob-drift"
    description = ("perf knobs (step_chunk/test_chunk/reduce_*) must be "
                   "declared, CLI-flagged, documented, and CONSUMED "
                   "(or refused) — no accept-and-ignore")

    def check_tree(self, ctxs: list[FileContext],
                   root: str) -> Iterator[Finding]:
        cfg_path = os.path.join(root, CONFIG_FILE)
        cli_path = os.path.join(root, CLI_FILE)
        docs_path = os.path.join(root, DOCS_FILE)
        if not (os.path.isfile(cfg_path) and os.path.isfile(cli_path)
                and os.path.isfile(docs_path)):
            return
        fields = _solver_fields(cfg_path)
        cli_src = open(cli_path, encoding="utf-8").read()
        docs_src = open(docs_path, encoding="utf-8").read()

        # consumer scan: whole production tree, reusing parsed ctxs
        by_path = {c.path: c for c in ctxs}
        consumed: set[str] = set()
        for target in CONSUMER_SCAN:
            path = os.path.join(root, target)
            if not os.path.exists(path):
                continue
            for fp in iter_py_files([path]):
                rel = os.path.relpath(fp, root)
                if rel in _EXCLUDED_CONSUMERS or any(
                        rel == d or rel.startswith(d + os.sep)
                        for d in _EXCLUDED_CONSUMER_DIRS):
                    continue
                if consumed.issuperset(KNOBS):
                    break
                ctx = by_path.get(os.path.abspath(fp))
                if ctx is not None:
                    if ctx.tree is None:
                        continue
                    reads = _reads(ctx.by_type(ast.Attribute),
                                   ctx.by_type(ast.Call))
                    reads |= _refused(ctx.tree, ctx.by_type(ast.Name))
                else:
                    try:
                        tree = ast.parse(open(fp, encoding="utf-8").read())
                    except SyntaxError:
                        continue
                    nodes = list(ast.walk(tree))
                    reads = _reads(
                        (n for n in nodes
                         if isinstance(n, ast.Attribute)),
                        (n for n in nodes if isinstance(n, ast.Call)))
                    reads |= _refused(tree, (n for n in nodes
                                             if isinstance(n, ast.Name)))
                consumed.update(k for k in KNOBS if k in reads)

        cfg_ctx = by_path.get(os.path.abspath(cfg_path))
        waivers = cfg_ctx.waivers if cfg_ctx is not None else {}
        for knob in KNOBS:
            line = fields.get(knob, 1)

            def waived() -> bool:
                return self.name in waivers.get(line, ()) or \
                    self.name in waivers.get(line - 1, ())

            missing = []
            if knob not in fields:
                missing.append("a Solver/Net/ServingParameter field in "
                               + CONFIG_FILE)
            if not _mentions(cli_src, knob):
                missing.append("a CLI flag in " + CLI_FILE)
            if not _mentions(docs_src, knob):
                missing.append("documentation in " + DOCS_FILE)
            if knob not in consumed:
                missing.append(
                    "a consumer read under caffe_mpi_tpu_torch/ — the "
                    "knob is accepted but IGNORED")
            if missing and not waived():
                yield Finding(
                    self.name, cfg_path, line,
                    f"knob {knob!r} is missing " + "; ".join(missing),
                    span=None)
