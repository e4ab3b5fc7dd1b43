"""reference-citation pass: module docstrings must cite what the module
ports.

Port of the JAX package's caffe_mpi_tpu/tools/lint/reference_citation.py
(the same pass name and messages). The repo's convention: a module
docstring names the source it replaces, `file:line` where it can. Under
caffe_mpi_tpu_torch/ that is the JAX counterpart (caffe_mpi_tpu/...py)
or the reference's own files (src/caffe/...cpp): the docstring must
hold at least one source-file token (a path with a known source
extension, brace groups like `{cpp,cu}` included, `:line` ranges
encouraged). A module with no counterpart says so in a waiver,
`# lint: ok(reference-citation) — reason`, above the docstring.

Scope: files under the caffe_mpi_tpu_torch package (and anything scanned
from outside the run root, such as test fixtures). Trivial modules, with
no docstring and no function or class definitions (re-export
`__init__` shims), are exempt.
"""

from __future__ import annotations

import ast
import re
from typing import Iterator

from . import Finding, FileContext, LintPass, register

_EXT = r"(?:cpp|cc|cu|cuh|hpp|hh|h|py|proto|prototxt|sh|md)"
# a path-ish token ending in a source extension; `{cpp,cu}` brace
# alternation is the repo's multi-file idiom, and no trailing \b — a
# closing brace has no word boundary against the following space
CITATION_RE = re.compile(
    r"[\w/{},\.\-]*\.(?:%s|\{%s(?:,%s)*\})(?::\d[\d\-,]*)?" % (
        _EXT, _EXT, _EXT))


@register
class ReferenceCitationPass(LintPass):
    name = "reference-citation"
    description = ("module docstrings under caffe_mpi_tpu_torch/ must "
                   "cite the file(:line) they port")

    def _in_scope(self, ctx: FileContext) -> bool:
        rel = ctx.rel
        if rel == ctx.path:      # outside the repo root: fixture mode
            return True
        return rel.split("/")[0] == "caffe_mpi_tpu_torch"

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        if not self._in_scope(ctx):
            return
        tree = ctx.tree
        doc = ast.get_docstring(tree, clean=False)
        has_defs = any(isinstance(s, (ast.FunctionDef,
                                      ast.AsyncFunctionDef, ast.ClassDef))
                       for s in tree.body)
        if doc is None:
            if not has_defs:
                return           # trivial re-export shim
            yield Finding(
                self.name, ctx.path, 1,
                "module has no docstring — add one citing the "
                "reference file(:line) it replaces and the port's "
                "design choice (the repo's convention), or waive with "
                "`# lint: ok(reference-citation) — reason`",
                span=(1, 2))
            return
        if CITATION_RE.search(doc):
            return
        stmt = tree.body[0]
        end = getattr(stmt, "end_lineno", stmt.lineno) or stmt.lineno
        # the docstring is the first statement: a leading comment block
        # (anywhere above it) is the natural waiver placement
        yield Finding(
            self.name, ctx.path, stmt.lineno,
            "module docstring cites no reference file — name the "
            "reference source (`file:line`) this module replaces "
            "(the repo's convention); if it is port-only with no "
            "analogue, waive with `# lint: ok(reference-citation) — "
            "reason`",
            span=(1, end + 1))
