"""gated-imports pass: imports the card's machine may lack, and the
port's one import rule.

Port of the JAX package's caffe_mpi_tpu/tools/lint/gated_imports.py
(the same pass name and message). The reference gates its optional
dependencies at build time (Makefile.config's USE_LMDB/USE_LEVELDB,
compiled into `#ifdef` guards in src/caffe/util/db.cpp); here the gate
is a `try/except ImportError` around the import. The gated modules are
the ones the port may reach for and the card's machine may not ship:
`h5py` (absent there: the HDF5 parts are refused, ROADMAP.md §1 items 3,
4 and 7), `tensorstore`, `triton` (a kernel that uses it imports it
inside the function that launches it) and `lmdb` (the port reads LMDB
files with its own code, data/lmdb_io.py).

One finding the JAX pass lacks: any import of `jax` or of the JAX
package `caffe_mpi_tpu` in a scanned file (the port's tree,
caffe_mpi_tpu_torch/ and chip_smoke.py), gated or not. The port imports
torch and nothing of the JAX package; only the tests import both.

Files under a `tests/` directory are exempt.
"""

from __future__ import annotations

import ast
from typing import Iterator

from . import Finding, FileContext, LintPass, register

GATED_MODULES = {"h5py", "tensorstore", "triton", "lmdb"}
# the JAX side of the repo: never imported by the port
FORBIDDEN_MODULES = {"jax", "jaxlib", "caffe_mpi_tpu"}


def _handles_import_error(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:           # bare except
        return True
    names = [t] if not isinstance(t, ast.Tuple) else list(t.elts)
    for n in names:
        leaf = n.attr if isinstance(n, ast.Attribute) else getattr(
            n, "id", "")
        if leaf in ("ImportError", "ModuleNotFoundError", "Exception",
                    "BaseException"):
            return True
    return False


@register
class GatedImportsPass(LintPass):
    name = "gated-imports"
    description = ("h5py/tensorstore/triton/lmdb imports outside tests/ "
                   "must sit under try/except ImportError; jax and "
                   "caffe_mpi_tpu are never imported")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        parts = ctx.path.split("/")
        if "tests" in parts:
            return
        # a finding requires an import naming a gated module, so its
        # name appears literally in the source — skip the tree walk for
        # the vast majority of files that never mention one
        if not any(m in ctx.src
                   for m in GATED_MODULES | FORBIDDEN_MODULES):
            return

        def visit(node: ast.AST, gated: bool) -> Iterator[Finding]:
            """Check `node` itself, then its children with the gate
            state the runtime would actually see."""
            g = gated
            if isinstance(node, ast.Try):
                # only the try BODY is protected by the handler; an
                # import inside the except/else/finally blocks raises
                # uncaught at runtime
                body_gated = gated or any(_handles_import_error(h)
                                          for h in node.handlers)
                for part in node.body:
                    yield from visit(part, body_gated)
                for part in (*node.handlers, *node.orelse,
                             *node.finalbody):
                    yield from visit(part, gated)
                return
            elif isinstance(node, ast.If):
                t = node.test
                name = (t.attr if isinstance(t, ast.Attribute)
                        else getattr(t, "id", ""))
                if name == "TYPE_CHECKING":
                    # `if TYPE_CHECKING:` never executes at runtime —
                    # but its `else:` branch ALWAYS does, so only the
                    # body inherits the gate
                    for part in node.body:
                        yield from visit(part, True)
                    for part in node.orelse:
                        yield from visit(part, gated)
                    return
            mods: list[str] = []
            if isinstance(node, ast.Import):
                mods = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [(node.module or "").split(".")[0]]
            for mod in mods:
                if mod in FORBIDDEN_MODULES:
                    yield Finding(
                        self.name, ctx.path, node.lineno,
                        f"`import {mod}` in the port: it imports torch "
                        "and nothing of jax or the JAX package "
                        "(caffe_mpi_tpu); keep a copy of what it needs",
                        span=ctx.span_of(node))
                elif mod in GATED_MODULES and not gated:
                    yield Finding(
                        self.name, ctx.path, node.lineno,
                        f"`import {mod}` is not gated — the image "
                        "may not ship it; wrap in try/except "
                        "ImportError with a fallback or a clear "
                        "named error (the card's machine, "
                        "ROADMAP.md)",
                        span=ctx.span_of(node))
            for child in ast.iter_child_nodes(node):
                yield from visit(child, g)

        for child in ast.iter_child_nodes(ctx.tree):
            yield from visit(child, False)
