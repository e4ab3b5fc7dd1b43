"""lint — static analysis of the port's model definitions, with neither
torch nor jax imported.

The port's copy of the core of the JAX package's `caffe_mpi_tpu/tools/lint/`
(the port imports nothing of that package). The reference validates a
model graph only by building it (Net::Init, net.cpp:815-818); these checks
run before anything is built, so a broken prototxt is found on a machine
with no card.

Framework shape:

- every check is a `LintPass` subclass registered by `@register`; a
  pass implements `check(ctx)` (per Python file) and/or
  `check_tree(ctxs, root)` (whole run: the net-* passes of netlint.py
  scan models/ and examples/ under the run root; the concurrency passes
  of concurrency.py model the whole Python tree)
- findings are waived per statement with a `lint: ok(<pass>) — reason`
  comment on any line of the statement's span or in the comment block
  directly above it; the reason is part of the contract — the author
  claims, in the diff, that the flagged pattern is deliberate. Prototxt
  nets use the same grammar (netlint.py)
- a waiver naming an unknown pass is itself a finding (bad-waiver): a
  misspelled waiver must fail the run, never silently suppress
- CLI: `python -m caffe_mpi_tpu_torch.tools.lint [--select P,...]
  [--json] [--list] [paths...]`; the default paths are the port's tree
  (caffe_mpi_tpu_torch/, chip_smoke.py); exit 1 on any finding, 2 on a
  usage error.

Every pass name of the JAX package's lint is registered here, so a
waiver reads the same in both trees; each pass reads the port's own
files:

- netlint.py: the net-* model passes over models/ and examples/;
- concurrency.py: lock-order, blocking-under-lock, thread-shared-mutation
  (over the declared order in serving/locks.py);
- failure_path.py: future-resolution, typed-failure, thread-crash,
  deadline-discipline (on the concurrency passes' one tree model);
- doc_drift.py: `FAULT_SITES` and `EXIT_*` (utils/resilience.py) against
  caffe_mpi_tpu_torch/docs/robustness.md and the call sites;
- knob_drift.py: each performance knob declared (proto/config.py),
  flagged (tools/cli.py), documented (caffe_mpi_tpu_torch/docs/knobs.md)
  and consumed, or refused naming its ROADMAP.md item;
- host_sync.py: a card sync (`.item()`, `.cpu()`, `float()` of a
  tensor, `torch.cuda.synchronize()`, ...) inside a loop;
- gated_imports.py: h5py/tensorstore/triton/lmdb imports ungated, and
  any import of jax or caffe_mpi_tpu;
- reference_citation.py: module docstrings cite what they port;
- traced_flow.py, concrete_init.py: the torch counterparts of the JAX
  traced-body passes, over the bodies a CUDA graph captures (a Python
  branch on a card tensor; a 0-d card tensor built in a scalar slot).
"""

from __future__ import annotations

import argparse
import ast
import io
import json
import os
import re
import sys
import tokenize
from dataclasses import dataclass
from typing import Iterable, Iterator

# ---------------------------------------------------------------------------
# findings + waivers

_WAIVER_RE = re.compile(r"#\s*lint:\s*ok\(([^)]*)\)")
# the JAX package's older host-sync spelling, honoured the same way
_LEGACY_WAIVER_RE = re.compile(r"#\s*host-sync:\s*ok")


def _waivers_in_comment(text: str) -> set[str]:
    names: set[str] = set()
    for m in _WAIVER_RE.finditer(text):
        names.update(n.strip() for n in m.group(1).split(",")
                     if n.strip())
    if _LEGACY_WAIVER_RE.search(text):
        names.add("host-sync")
    return names


def extract_waivers(src: str) -> dict[int, set[str]]:
    """{line: waived pass names} from the REAL comments of `src`. Waiver
    grammar quoted inside string literals or docstrings does NOT register
    as a waiver — text that merely *mentions* the grammar cannot suppress
    a finding on its statement. The tokenizer is the arbiter."""
    waivers: dict[int, set[str]] = {}
    if "lint:" not in src and "host-sync:" not in src:
        return waivers  # fast path: no waiver grammar anywhere
    try:
        tokens = tokenize.generate_tokens(io.StringIO(src).readline)
        comments = [(t.start[0], t.string) for t in tokens
                    if t.type == tokenize.COMMENT]
    except (tokenize.TokenError, IndentationError, SyntaxError):
        comments = []  # unparseable files surface as 'syntax'
    for ln, text in comments:
        names = _waivers_in_comment(text)
        if names:
            waivers.setdefault(ln, set()).update(names)
    return waivers


@dataclass
class Finding:
    """One lint violation. `span` is the (first, last) 1-based line range
    a waiver comment is honored on (None = unwaivable); `detail` is a
    short machine tag."""
    pass_name: str
    path: str
    line: int
    message: str
    span: tuple[int, int] | None = None
    detail: str = ""

    def format(self, root: str | None = None) -> str:
        path = os.path.relpath(self.path, root) if root else self.path
        return f"{path}:{self.line}: [{self.pass_name}] {self.message}"

    def as_dict(self, root: str | None = None) -> dict:
        path = os.path.relpath(self.path, root) if root else self.path
        return {"pass": self.pass_name, "path": path, "line": self.line,
                "message": self.message, "detail": self.detail}


def _build_index(n: ast.AST, stmt: ast.stmt | None, parent: ast.AST | None,
                 order: list, info: dict) -> None:
    """Recursive DFS filling FileContext._index's (order, info)."""
    start = len(order)
    order.append(n)
    if isinstance(n, ast.stmt):
        stmt = n
    for c in ast.iter_child_nodes(n):
        _build_index(c, stmt, n, order, info)
    info[id(n)] = (start, len(order), stmt, parent)


class FileContext:
    """One parsed Python source file shared by all passes: source text,
    lines, AST (None on a syntax error) and the per-line waiver map.
    One DFS index serves every pass (`walk`, `by_type`, `parent_of`,
    `stmt_of`), as in the JAX core."""

    def __init__(self, path: str, root: str | None = None):
        self.path = os.path.abspath(path)
        self.root = root
        with open(path, encoding="utf-8") as f:
            self.src = f.read()
        self.lines = self.src.splitlines()
        self.tree: ast.Module | None = None
        self.syntax_error: SyntaxError | None = None
        try:
            self.tree = ast.parse(self.src, filename=path)
        except SyntaxError as e:
            self.syntax_error = e
        self.waivers: dict[int, set[str]] = extract_waivers(self.src)
        self._idx: tuple | None = None
        self._buckets: dict[type, list[ast.AST]] | None = None

    def _index(self) -> tuple:
        """(preorder, info): `info[id(n)] = (start, end, stmt, parent)`,
        `preorder[start:end]` being n's subtree, `stmt` its nearest
        enclosing statement and `parent` its AST parent."""
        if self._idx is None:
            order: list[ast.AST] = []
            info: dict[int, tuple] = {}
            if self.tree is not None:
                limit = sys.getrecursionlimit()
                sys.setrecursionlimit(max(limit, 20000))
                try:
                    _build_index(self.tree, None, None, order, info)
                finally:
                    sys.setrecursionlimit(limit)
            self._idx = (order, info)
        return self._idx

    def by_type(self, cls: type) -> list[ast.AST]:
        """All nodes of exact type `cls`, in preorder."""
        if self._buckets is None:
            buckets: dict[type, list[ast.AST]] = {}
            for n in self._index()[0]:
                buckets.setdefault(type(n), []).append(n)
            self._buckets = buckets
        return self._buckets.get(cls, [])

    def parent_of(self, node: ast.AST) -> ast.AST | None:
        """The AST parent of `node` (None for the root or a node outside
        this file's tree)."""
        rec = self._index()[1].get(id(node))
        return rec[3] if rec is not None else None

    def stmt_of(self, node: ast.AST) -> ast.stmt | None:
        """The nearest enclosing statement of `node` (itself if one)."""
        rec = self._index()[1].get(id(node))
        return rec[2] if rec is not None else None

    @property
    def rel(self) -> str:
        """The path relative to the run root; absolute outside it."""
        if self.root:
            r = os.path.relpath(self.path, self.root)
            if not r.startswith(".."):
                return r
        return self.path

    def walk(self, node: ast.AST | None = None) -> list[ast.AST]:
        """Every node of `node`'s subtree (default: the whole file) in
        depth-first preorder (ast.walk's order is breadth-first)."""
        order, info = self._index()
        if node is None or node is self.tree:
            return order
        rec = info.get(id(node))
        if rec is None:
            return list(ast.walk(node))
        return order[rec[0]:rec[1]]

    def span_of(self, stmt: ast.stmt | ast.expr) -> tuple[int, int]:
        """Waiver-search span for a node: its own line range. For a
        compound statement (if/while/for/with/def) the span is the header
        only: a waiver on a nested body statement must not suppress a
        finding anchored to the header."""
        end = getattr(stmt, "end_lineno", None) or stmt.lineno
        body = getattr(stmt, "body", None)
        if isinstance(body, list) and body and isinstance(body[0],
                                                          ast.stmt):
            # the header ends with its test/iter/items expression (a
            # comment line between header and body is not in the span)
            hdr = stmt.lineno
            for attr in ("test", "iter", "items"):
                v = getattr(stmt, attr, None)
                for n in (v if isinstance(v, list)
                          else [v] if v is not None else []):
                    hdr = max(hdr, getattr(n, "end_lineno", 0) or 0)
            end = min(end, hdr)
        return (stmt.lineno, end)

    def waiver_lines(self, span: tuple[int, int] | None,
                     pass_name: str) -> list[int]:
        """Lines whose waiver suppresses a finding with this span."""
        if span is None:
            return []
        return span_waiver_lines(span, pass_name, self.waivers,
                                 self.lines)

    def waived(self, span: tuple[int, int] | None, pass_name: str) -> bool:
        return bool(self.waiver_lines(span, pass_name))


def span_waiver_lines(span: tuple[int, int], pass_name: str,
                      waivers: dict[int, set[str]],
                      lines: list[str]) -> list[int]:
    """THE waiver-binding contract, in one place: a waiver binds anywhere
    in the statement's span (trailing comments included), or anywhere in
    the contiguous COMMENT-ONLY block directly above it (a multi-line
    waiver comment binds to the statement it precedes; a trailing waiver
    on the PREVIOUS statement is not comment-only and so cannot leak onto
    the next one)."""
    lo, hi = span
    out = [ln for ln in range(lo, hi + 1)
           if pass_name in waivers.get(ln, ())]
    above = lo - 1
    while 1 <= above <= len(lines) \
            and lines[above - 1].lstrip().startswith("#"):
        if pass_name in waivers.get(above, ()):
            out.append(above)
        above -= 1
    return out


# ---------------------------------------------------------------------------
# pass registry

class LintPass:
    """Base class. Subclasses set `name` + `description` and override
    `check` (per file) and/or `check_tree` (whole run). Yield `Finding`s;
    the framework applies waivers to per-file findings (the net-* passes
    apply their prototxt waivers themselves)."""

    name: str = ""
    description: str = ""

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        return iter(())

    def check_tree(self, ctxs: list[FileContext],
                   root: str) -> Iterator[Finding]:
        return iter(())


REGISTRY: dict[str, LintPass] = {}


def register(cls: type[LintPass]) -> type[LintPass]:
    inst = cls()
    if not inst.name or inst.name in REGISTRY:
        raise ValueError(f"lint pass name {inst.name!r} empty or taken")
    REGISTRY[inst.name] = inst
    return cls


def _load_passes() -> None:
    # import for side effect: each module registers its passes
    from . import (concrete_init, concurrency, doc_drift,  # noqa: F401
                   failure_path, gated_imports, host_sync, knob_drift,
                   netlint, reference_citation, traced_flow)


# ---------------------------------------------------------------------------
# tree walking + running

def repo_root() -> str:
    """The directory holding the caffe_mpi_tpu_torch package."""
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))


DEFAULT_SCAN = ("caffe_mpi_tpu_torch", "chip_smoke.py")


def iter_py_files(paths: Iterable[str]) -> Iterator[str]:
    for target in paths:
        if os.path.isdir(target):
            for dirpath, dirnames, files in os.walk(target):
                dirnames[:] = sorted(d for d in dirnames
                                     if d != "__pycache__")
                for name in sorted(files):
                    if name.endswith(".py"):
                        yield os.path.join(dirpath, name)
        elif target.endswith(".py"):
            yield target


def _bad_waiver_findings(ctx: FileContext,
                         known: set[str]) -> Iterator[Finding]:
    for ln, names in sorted(ctx.waivers.items()):
        for name in sorted(names - known):
            yield Finding(
                "bad-waiver", ctx.path, ln,
                f"waiver names unknown pass {name!r} (known: "
                f"{', '.join(sorted(known))}) — a misspelled waiver "
                "suppresses nothing", span=None)


def run_lint(paths: Iterable[str] | None = None,
             select: Iterable[str] | None = None,
             root: str | None = None) -> list[Finding]:
    """Run the selected passes (default: all) over `paths` (default: the
    port's tree under `root`). Returns waiver-filtered findings, ordered
    by path then line."""
    _load_passes()
    root = root or repo_root()
    if paths is None:
        # default-scan entries are filtered by existence (a fixture root
        # need not hold chip_smoke.py); EXPLICIT paths must exist — a
        # typo'd path silently reporting "clean" is the one failure mode
        # a tripwire cannot afford
        paths = [p for p in (os.path.join(root, t) for t in DEFAULT_SCAN)
                 if os.path.exists(p)]
    else:
        paths = list(paths)
        bad = [p for p in paths
               if not os.path.exists(p)
               or (os.path.isfile(p) and not p.endswith(".py"))]
        if bad:
            raise FileNotFoundError(
                f"lint path(s) do not exist or are not .py: {bad}")
    if select is None:
        passes = list(REGISTRY.values())
    else:
        unknown = [s for s in select if s not in REGISTRY]
        if unknown:
            raise ValueError(
                f"unknown pass(es) {unknown}; known: {sorted(REGISTRY)}")
        passes = [REGISTRY[s] for s in select]

    ctxs: list[FileContext] = []
    findings: list[Finding] = []
    for path in iter_py_files(paths):
        ctx = FileContext(path, root=root)
        if ctx.syntax_error is not None:
            e = ctx.syntax_error
            findings.append(Finding(
                "syntax", ctx.path, e.lineno or 0,
                f"SYNTAX ERROR: {e.msg}", span=None,
                detail=f"SYNTAX ERROR: {e.msg}"))
            continue
        ctxs.append(ctx)
        findings.extend(_bad_waiver_findings(ctx, set(REGISTRY)))
        for p in passes:
            findings.extend(f for f in p.check(ctx)
                            if not ctx.waiver_lines(f.span, p.name))
    for p in passes:
        findings.extend(p.check_tree(ctxs, root))
    # a whole-tree finding in a scanned file honours its waivers too
    by_path = {c.path: c for c in ctxs}
    findings = [f for f in findings
                if f.path not in by_path
                or not by_path[f.path].waiver_lines(f.span, f.pass_name)]
    findings.sort(key=lambda f: (f.path, f.line, f.pass_name))
    return findings


# ---------------------------------------------------------------------------
# shared AST helpers

def attr_root(node: ast.expr) -> str | None:
    """The base name of a dotted chain: `torch.cuda.graph` -> 'torch'.
    None for anything not Name-rooted."""
    while isinstance(node, ast.Attribute):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def dotted_name(node: ast.expr) -> str | None:
    """Full dotted spelling of a Name/Attribute chain, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(node.id)
    return ".".join(reversed(parts))


# ---------------------------------------------------------------------------
# CLI

def main(argv: list[str] | None = None) -> int:
    _load_passes()
    ap = argparse.ArgumentParser(
        prog="python -m caffe_mpi_tpu_torch.tools.lint",
        description="static analysis of the port's model definitions")
    ap.add_argument("paths", nargs="*",
                    help="files/dirs to scan (default: the port's tree)")
    ap.add_argument("--select", default=None,
                    help="comma-separated pass names (default: all)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit findings as a JSON array")
    ap.add_argument("--list", action="store_true", dest="list_passes",
                    help="list registered passes and exit")
    args = ap.parse_args(argv)
    if args.list_passes:
        for name in sorted(REGISTRY):
            print(f"{name:22s} {REGISTRY[name].description}")
        return 0
    select = ([s.strip() for s in args.select.split(",") if s.strip()]
              if args.select else None)
    root = repo_root()
    try:
        findings = run_lint(args.paths or None, select=select, root=root)
    except (ValueError, FileNotFoundError) as e:
        print(e.args[0], file=sys.stderr)
        return 2
    if args.as_json:
        print(json.dumps([f.as_dict(root) for f in findings], indent=1))
    else:
        for f in findings:
            print(f.format(root))
    if findings:
        print(f"{len(findings)} lint finding(s)", file=sys.stderr)
        return 1
    return 0
