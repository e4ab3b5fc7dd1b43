"""concrete-init pass: a 0-d card tensor built in a scalar slot of an op
inside a body a CUDA graph captures, where a Python scalar serves.

The torch counterpart of the JAX package's
caffe_mpi_tpu/tools/lint/concrete_init.py (the same pass name). There
the hazard is a traced `jnp.zeros(())` as a `lax.reduce_window` or
`lax.scan` init value, which breaks reverse-mode (the JAX fix,
ops/pool.py:73-76, is a concrete numpy scalar). The reference has no
analogue: its pooling backward is a hand-written kernel
(src/caffe/layers/pooling_layer.cu) with no autodiff to break.

The torch shape is a 0-d constructor that copies a host value to the
card, `torch.tensor(v, device=d)` (or `torch.scalar_tensor`,
`torch.as_tensor`), in an operand slot of another op inside a captured
body (the reachability of traced_flow.py):
`x * torch.tensor(2.0, device=d)`,
`x.clamp(min=torch.tensor(0.0, device=d))`. A Python scalar in that
slot gives the same result with nothing to copy. `chip_smoke.py`'s lint
phase captures each form once on the card (`concrete_init_probe`; NVIDIA
H100 80GB HBM3, 700.00 W): `torch.where(x > 0, x, 0.0) * torch.tensor(
2.0, device="cuda")` is refused by the capture ("Cannot copy between CPU
and CUDA tensors during CUDA graph capture unless the CPU tensor is
pinned"), so it is flagged. `torch.zeros((), device=...)` in the same
slot captures and replays equal to the Python scalar, at 11.21-11.34 us
a replay of a 2^20-element op against the scalar's 10.67-12.17 us in two
runs (its fill kernel within the runs' spread): harmless, so a fill
constructor (`zeros`, `ones`, `full`, `empty`) is not flagged.

Approximate by design: a 0-d tensor held in a bare name is invisible,
and a constructor on its own line (an allocation kept for later) is not
flagged.
"""

from __future__ import annotations

import ast
from typing import Iterator

from . import Finding, FileContext, LintPass, dotted_name, register
from .traced_flow import captured_bodies, scan_captured

_VALUE_CTORS = {"torch.tensor", "torch.scalar_tensor", "torch.as_tensor"}


def zero_d_card_ctor(node: ast.AST) -> str | None:
    """The spelling of a 0-d constructor of a host value given a
    `device=`, else None."""
    if not (isinstance(node, ast.Call) and node.args
            and any(kw.arg == "device" for kw in node.keywords)):
        return None
    name = dotted_name(node.func) or ""
    first = node.args[0]
    if name in _VALUE_CTORS and (
            isinstance(first, ast.Constant) or (
                isinstance(first, ast.UnaryOp)
                and isinstance(first.operand, ast.Constant))):
        return name
    return None


def _in_scalar_slot(ctx: FileContext, node: ast.Call) -> bool:
    """An operand of another op: an argument of a call (not its callee),
    or a side of an arithmetic or comparison."""
    parent = ctx.parent_of(node)
    if isinstance(parent, ast.keyword):
        parent = ctx.parent_of(parent)
        return isinstance(parent, ast.Call)
    if isinstance(parent, ast.Call):
        return node is not parent.func
    return isinstance(parent, (ast.BinOp, ast.Compare))


@register
class ConcreteInitPass(LintPass):
    name = "concrete-init"
    description = ("a 0-d card tensor copied from the host "
                   "(torch.tensor(v, device=...)) in a scalar slot of an "
                   "op under a CUDA-graph capture, where a Python scalar "
                   "serves")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        if "cuda.graph" not in ctx.src or "device" not in ctx.src:
            return
        findings: list[Finding] = []

        def visit(node: ast.AST, stmt) -> None:
            kind = zero_d_card_ctor(node)
            if kind is None or not _in_scalar_slot(ctx, node):
                return
            findings.append(Finding(
                self.name, ctx.path, node.lineno,
                f"a 0-d card tensor `{kind}(..., device=...)` in a "
                "scalar slot under a CUDA-graph capture — a Python "
                "scalar serves: the constructor copies from the host, "
                "and the capture refuses a copy from pageable memory",
                span=ctx.span_of(stmt) if stmt is not None else None))

        scan_captured(captured_bodies(ctx), visit)
        seen: set[int] = set()
        for f in sorted(findings, key=lambda f: f.line):
            if id(f) not in seen:
                seen.add(id(f))
                yield f
