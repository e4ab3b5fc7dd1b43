"""doc-drift pass: the fault registry, its doc and its call sites held
equal; the exit-code registry, its table and the exit calls likewise.

Port of the JAX package's caffe_mpi_tpu/tools/lint/doc_drift.py (the
same pass name and messages, the doc's path spelled as the port's). The
fault sites are operator documentation: a site fired at a call site but
missing from the registry rots the runbook, and a registry entry whose
call site is gone documents a lever that no longer exists. Three
sources are held equal:

  1. the registry: `FAULT_SITES` in caffe_mpi_tpu_torch/utils/
     resilience.py (read by AST, not import);
  2. the doc: the `Sites:` list in caffe_mpi_tpu_torch/docs/
     robustness.md (the JAX package's docs/robustness.md is its own);
  3. the code: literal site names at FAULTS helper call sites under
     caffe_mpi_tpu_torch/ and in chip_smoke.py.

The `EXIT_*` registry of the same module, the doc's exit-code table and
the literal `sys.exit`/`os._exit` calls are held equal the same way
(the reference's failure exits are `LOG(FATAL)` aborts, common.cpp; the
port's are journaled codes a supervisor reads).

A whole-tree pass (`check_tree`) rooted at the run root, whatever paths
were selected; a root without the registry and the doc gives no
findings.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Iterator

from . import (DEFAULT_SCAN, Finding, LintPass, extract_waivers,
               iter_py_files, register, span_waiver_lines)

# every FaultPlane entry point a production call site can name a site
# through (fire/fire_at and the one-line helpers)
_HELPERS = ("fire", "fire_at", "active", "maybe_raise", "maybe_stall",
            "maybe_exit", "corrupt_file", "corrupt_bytes")
_CALL_RE = re.compile(
    r"\.(?:%s)\(\s*[\"']([a-z_]+)[\"']" % "|".join(_HELPERS))

REGISTRY_FILE = os.path.join("caffe_mpi_tpu_torch", "utils",
                             "resilience.py")
DOCS_FILE = os.path.join("caffe_mpi_tpu_torch", "docs", "robustness.md")
# source trees whose FAULTS call sites are injection points (tests
# configure sites by string; they are consumers, not sites): the
# framework's default scan, so the two cannot drift apart
SCAN = DEFAULT_SCAN


def _registry_sites(path: str) -> tuple[dict[str, tuple[int, str]], int]:
    """{site: (line, description)} from the FAULT_SITES dict literal,
    plus the assignment's line (0 when absent)."""
    tree = ast.parse(open(path, encoding="utf-8").read(), filename=path)
    for node in ast.walk(tree):
        targets = []
        if isinstance(node, ast.Assign):
            targets = node.targets
            value = node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets = [node.target]
            value = node.value
        else:
            continue
        for t in targets:
            if isinstance(t, ast.Name) and t.id == "FAULT_SITES" and \
                    isinstance(value, ast.Dict):
                sites = {}
                for k, v in zip(value.keys, value.values):
                    if isinstance(k, ast.Constant) and isinstance(
                            k.value, str):
                        desc = (v.value if isinstance(v, ast.Constant)
                                and isinstance(v.value, str) else "")
                        sites[k.value] = (k.lineno, desc)
                return sites, node.lineno
    return {}, 0


def _stmt_spans(nodes) -> dict[int, tuple[int, int]]:
    """{line: (start, end) of the innermost statement covering it} —
    lets waivers honor the whole statement span for multi-line calls,
    matching FileContext.span_of. Takes a node iterable (ctx.walk() or
    ast.walk(tree)); in both, inner statements come after their parents
    and overwrite. Empty for unparseable files (nodes=())."""
    spans: dict[int, tuple[int, int]] = {}
    for node in nodes:
        if isinstance(node, ast.stmt):
            end = getattr(node, "end_lineno", node.lineno) or node.lineno
            for ln in range(node.lineno, end + 1):
                spans[ln] = (node.lineno, end)
    return spans


def _waived_at(pass_name: str, ln: int,
               spans: dict[int, tuple[int, int]],
               waivers: dict[int, set[str]], lines: list[str]) -> bool:
    """Self-applied waiver check — delegates to the framework's ONE
    binding contract (span_waiver_lines), so self-waiving passes can
    never bind differently from everyone else."""
    return bool(span_waiver_lines(spans.get(ln, (ln, ln)), pass_name,
                                  waivers, lines))


def _doc_sites(path: str) -> tuple[set[str], int]:
    text = open(path, encoding="utf-8").read()
    m = re.search(r"Sites:\s*(.*?)\.\s", text, re.DOTALL)
    if not m:
        return set(), 0
    line = text[:m.start()].count("\n") + 1
    return set(re.findall(r"`([a-z_]+)`", m.group(1))), line


# -- exit-code drift ----------------------------------------------------------
# the EXIT_* registry in utils/resilience.py, the exit-code table in the
# doc and the literal sys.exit/os._exit call sites are three spellings
# of one contract: what a dying process means by its exit code.

_EXIT_NAME_RE = re.compile(r"EXIT_[A-Z_]+")
_EXIT_ROW_RE = re.compile(r"\|\s*\*\*(\d+)\*\*\s*\|([^|]*)\|")
_EXIT_CALL_HINT = ("sys.exit", "os._exit")


def _exit_registry(path: str) -> dict[str, tuple[int, int]]:
    """{EXIT_NAME: (code, line)} from top-level assigns; aliases
    (`EXIT_CLUSTER = EXIT_FAULT`) resolve through the map."""
    try:
        tree = ast.parse(open(path, encoding="utf-8").read(),
                         filename=path)
    except SyntaxError:
        return {}
    out: dict[str, tuple[int, int]] = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id.startswith("EXIT_"):
            name, v = node.targets[0].id, node.value
            if isinstance(v, ast.Constant) and isinstance(v.value, int):
                out[name] = (v.value, node.lineno)
            elif isinstance(v, ast.Name) and v.id in out:
                out[name] = (out[v.id][0], node.lineno)
    return out


def _doc_exit_table(path: str) -> dict[str, tuple[int, int]]:
    """{EXIT_NAME: (code, line)} from docs table rows like
    `| **87** | \\`EXIT_CLUSTER\\` / \\`EXIT_FAULT\\` | ...`."""
    out: dict[str, tuple[int, int]] = {}
    for i, line in enumerate(
            open(path, encoding="utf-8").read().splitlines(), 1):
        m = _EXIT_ROW_RE.match(line.strip())
        if m:
            for name in _EXIT_NAME_RE.findall(m.group(2)):
                out[name] = (int(m.group(1)), i)
    return out


def _exit_call_violations(nodes, exits: dict,
                          codes: set[int]) -> list[tuple[int, str]]:
    """(line, message) for each sys.exit/os._exit call whose argument
    is a bare literal matching a registered code (operators grep for
    the symbol, not the number) or an EXIT_* symbol the registry no
    longer defines (a rename that missed a call site)."""
    out: list[tuple[int, str]] = []
    for node in nodes:
        if not isinstance(node, ast.Call) or not node.args:
            continue
        fn = node.func
        if not (isinstance(fn, ast.Attribute)
                and isinstance(fn.value, ast.Name)
                and (fn.value.id, fn.attr) in (("sys", "exit"),
                                               ("os", "_exit"))):
            continue
        a = node.args[0]
        if isinstance(a, ast.Constant) and isinstance(a.value, int) \
                and a.value in codes:
            names = sorted(n for n, (c, _l) in exits.items()
                           if c == a.value)
            out.append((node.lineno,
                        f"bare literal exit {a.value} — use the "
                        f"registered symbol ({' / '.join(names)} in "
                        "utils/resilience.py) so the code and the "
                        "operator runbook cannot drift"))
        else:
            name = None
            if isinstance(a, ast.Name):
                name = a.id
            elif isinstance(a, ast.Attribute):
                name = a.attr
            if name and name.startswith("EXIT_") and name not in exits:
                out.append((node.lineno,
                            f"exit call names {name}, which is not in "
                            "the EXIT_* registry in "
                            "utils/resilience.py"))
    return out


@register
class DocDriftPass(LintPass):
    name = "doc-drift"
    description = ("FAULT_SITES registry == "
                   "caffe_mpi_tpu_torch/docs/robustness.md Sites "
                   "list == FAULTS call sites; EXIT_* registry == "
                   "docs exit-code table == exit call sites")

    def check_tree(self, ctxs: list[FileContext],
                   root: str) -> Iterator[Finding]:
        reg_path = os.path.join(root, REGISTRY_FILE)
        docs_path = os.path.join(root, DOCS_FILE)
        if not (os.path.isfile(reg_path) and os.path.isfile(docs_path)):
            return
        yield from self._exit_findings(ctxs, root, reg_path, docs_path)
        registry, reg_line = _registry_sites(reg_path)
        if not reg_line:
            return
        reg_src = open(reg_path, encoding="utf-8").read()
        reg_waivers = extract_waivers(reg_src)
        reg_lines = reg_src.splitlines()

        def reg_waived(ln: int) -> bool:
            """Waiver on the registry entry's line, or on a
            comment-only line directly above — self-applied so both
            entry points (explicit paths and paths=[]) agree."""
            if self.name in reg_waivers.get(ln, ()):
                return True
            return (ln > 1 and reg_lines[ln - 2].lstrip().startswith("#")
                    and self.name in reg_waivers.get(ln - 1, ()))
        doc_sites, doc_line = _doc_sites(docs_path)
        if not doc_line:
            yield Finding(self.name, docs_path, 1,
                          "caffe_mpi_tpu_torch/docs/robustness.md lost "
                          "its 'Sites:' list",
                          span=None)
            return

        # call sites: always the full production tree under root. This
        # pass scans its files itself (not via ctxs — a partial path
        # selection must not report half the call sites as dead), so it
        # also applies waivers itself: the framework's ctx-based filter
        # only covers files the caller happened to select.
        code_sites: dict[str, tuple[str, int, bool]] = {}
        by_path = {c.path: c for c in ctxs}
        for target in SCAN:
            path = os.path.join(root, target)
            if not os.path.exists(path):
                continue
            for fp in iter_py_files([path]):
                ctx = by_path.get(os.path.abspath(fp))
                if ctx is not None:   # already read+indexed+parsed
                    src, waivers = ctx.src, ctx.waivers
                    nodes = ctx.walk() if ctx.tree is not None else ()
                else:
                    src = open(fp, encoding="utf-8").read()
                    waivers = extract_waivers(src)
                    try:
                        nodes = list(ast.walk(ast.parse(src)))
                    except SyntaxError:
                        nodes = ()
                spans = None    # built on first match — most files
                                # have no FAULTS call site at all
                lines = src.splitlines()
                # whole-text scan: `fire(\n  "site")` wraps across
                # lines and a per-line findall would miss it (the
                # regex's \s* crosses the newline)
                for m in _CALL_RE.finditer(src):
                    site = m.group(1)
                    ln = src.count("\n", 0, m.start()) + 1
                    if spans is None:
                        spans = _stmt_spans(nodes)
                    # waiver honored across the enclosing statement's
                    # span or the comment block directly above (same
                    # contract as FileContext.waiver_lines)
                    waived = _waived_at(self.name, ln, spans, waivers,
                                        lines)
                    prev = code_sites.get(site)
                    # an unwaived call site outranks a waived one
                    if prev is None or (prev[2] and not waived):
                        code_sites[site] = (fp, ln, waived)

        for site in sorted(set(code_sites) - set(registry)):
            fp, ln, waived = code_sites[site]
            if waived:
                continue
            # span=None: this pass applies waivers itself (above, with
            # full statement-span semantics); handing a (ln-1, ln) span
            # to the framework would let a trailing waiver on the
            # previous statement leak onto this finding
            yield Finding(
                self.name, fp, ln,
                f"FAULTS call site {site!r} is not in "
                "resilience.FAULT_SITES — register it and document it "
                "in caffe_mpi_tpu_torch/docs/robustness.md",
                span=None)
        for site in sorted(set(registry) - set(code_sites)):
            ln, _ = registry[site]
            if reg_waived(ln):
                continue
            yield Finding(
                self.name, reg_path, ln,
                f"FAULT_SITES entry {site!r} has no call site — delete "
                "it (and from caffe_mpi_tpu_torch/docs/robustness.md)",
                span=None)
        for site in sorted(set(registry) - doc_sites):
            ln, _ = registry[site]
            if reg_waived(ln):   # one waiver covers the entry's drift
                continue
            yield Finding(
                self.name, reg_path, ln,
                f"FAULT_SITES entry {site!r} is missing from the "
                "caffe_mpi_tpu_torch/docs/robustness.md 'Sites:' list",
                span=None)
        for site in sorted(doc_sites - set(registry)):
            yield Finding(
                self.name, docs_path, doc_line,
                "caffe_mpi_tpu_torch/docs/robustness.md documents "
                f"site {site!r} that is "
                "not in resilience.FAULT_SITES",
                span=None)
        for site, (ln, desc) in sorted(registry.items()):
            if not desc:
                yield Finding(
                    self.name, reg_path, ln,
                    f"FAULT_SITES entry {site!r} has no description",
                    span=None)

    def _exit_findings(self, ctxs: list[FileContext], root: str,
                       reg_path: str, docs_path: str) -> Iterator[Finding]:
        """EXIT_* registry vs docs exit-code table vs literal
        sys.exit/os._exit call sites, three-way. Skips entirely for
        roots that model no EXIT_ registry (fixture trees)."""
        exits = _exit_registry(reg_path)
        if not exits:
            return
        codes = {code for code, _ln in exits.values()}
        table = _doc_exit_table(docs_path)
        if not table:
            yield Finding(
                self.name, docs_path, 1,
                "caffe_mpi_tpu_torch/docs/robustness.md lost its "
                "exit-code table "
                "(`| **N** | `EXIT_NAME`` rows) while "
                f"{os.path.basename(reg_path)} registers "
                f"{sorted(exits)} — operators debug against this table",
                span=None)
            return
        for name, (code, ln) in sorted(exits.items()):
            doc = table.get(name)
            if doc is None:
                yield Finding(
                    self.name, reg_path, ln,
                    f"exit code {name} ({code}) is not in the "
                    "caffe_mpi_tpu_torch/docs/robustness.md exit-code "
                    "table", span=None)
            elif doc[0] != code:
                yield Finding(
                    self.name, docs_path, doc[1],
                    "caffe_mpi_tpu_torch/docs/robustness.md documents "
                    f"{name} as exit "
                    f"{doc[0]} but the registry says {code}", span=None)
        for name, (code, ln) in sorted(table.items()):
            if name not in exits:
                yield Finding(
                    self.name, docs_path, ln,
                    "caffe_mpi_tpu_torch/docs/robustness.md documents "
                    f"exit code {name} "
                    f"({code}) that is not registered in "
                    f"{os.path.basename(reg_path)}", span=None)
        # call sites: literal exits must use the registered symbols,
        # and exit symbols must exist in the registry. Same self-applied
        # waiver contract as the fault-site scan above.
        by_path = {c.path: c for c in ctxs}
        for target in SCAN:
            path = os.path.join(root, target)
            if not os.path.exists(path):
                continue
            for fp in iter_py_files([path]):
                ctx = by_path.get(os.path.abspath(fp))
                if ctx is not None:
                    src, tree, waivers = ctx.src, ctx.tree, ctx.waivers
                else:
                    src = open(fp, encoding="utf-8").read()
                    if not any(h in src for h in _EXIT_CALL_HINT):
                        continue
                    waivers = extract_waivers(src)
                    try:
                        tree = ast.parse(src)
                    except SyntaxError:
                        continue
                if tree is None or not any(h in src
                                           for h in _EXIT_CALL_HINT):
                    continue
                nodes = (ctx.walk() if ctx is not None
                         else list(ast.walk(tree)))
                viols = _exit_call_violations(nodes, exits, codes)
                if not viols:
                    continue
                spans = _stmt_spans(nodes)
                lines = src.splitlines()
                for viol_line, msg in viols:
                    if not _waived_at(self.name, viol_line, spans,
                                      waivers, lines):
                        yield Finding(self.name, fp, viol_line, msg,
                                      span=None)
