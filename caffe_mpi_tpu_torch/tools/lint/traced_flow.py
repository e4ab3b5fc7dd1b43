"""traced-control-flow pass: Python branching on a card value inside a
body that a CUDA graph captures.

The torch counterpart of the JAX package's
caffe_mpi_tpu/tools/lint/traced_flow.py (the same pass name). There a
traced body is a jit/scan body, and a Python `if` on a traced value
raises or bakes one branch into the program. Here the traced body is
the code that runs under `torch.cuda.graph(...)`: the solver's captured
iteration (solver/solver.py `Solver._capture` through `_graph_of`) and
the serving engine's bucket forward (serving/engine.py
`BucketedForward.build_bucket`). A Python branch on a tensor there reads
the value back to the host: a sync, which fails the capture, or, where
the value happens to be ready, one branch frozen into the graph and
replayed whatever the value becomes. The reference has no capture and no
such failure mode: its solver loop runs layer code directly
(src/caffe/solver.cpp:187-351).

Reachability is a per-module over-approximation:

- roots: the body of a `with torch.cuda.graph(...)` statement, and the
  functions it calls; a function whose captured body calls one of its
  own parameters (`_graph_of(fn)`: `fn()` under the capture) is a
  capture wrapper, and the functions and lambdas handed to it are
  roots;
- edges: bare-name calls and `self.method(...)` calls to functions
  defined in the same module (cross-module calls are not chased).

Flagged in reachable bodies:

- `if`/`while`/ternary tests holding a card-value expression: a
  `torch.` call (minus metadata helpers that return Python values:
  `torch.is_tensor`, `torch.cuda.is_current_stream_capturing`, ...) or a
  tensor method that returns a tensor (`.any()`, `.sum()`, `.item()`,
  comparisons, ...);
- `bool(x)`/`int(x)` where x holds one.

Both directions are approximate: a tensor held in a bare local name is
invisible, and a host helper that shares a name with a captured one is
over-flagged; waive the latter with
`# lint: ok(traced-control-flow) — reason`.
"""

from __future__ import annotations

import ast
from typing import Iterator

from . import Finding, FileContext, LintPass, attr_root, dotted_name, register

# torch functions that return Python metadata, not card tensors:
# branching on them is normal and safe
_CONCRETE_ATTRS = {
    "is_tensor", "is_floating_point", "is_complex", "is_grad_enabled",
    "is_inference_mode_enabled", "is_autocast_enabled",
    "get_default_dtype", "finfo", "iinfo", "is_available", "device_count",
    "current_device", "get_device_name", "get_device_capability",
    "is_current_stream_capturing", "device", "dtype", "Size",
    "are_deterministic_algorithms_enabled", "is_scripting", "is_compiling",
    "is_initialized", "get_rank", "get_world_size", "current_stream",
    "Stream", "Event", "CUDAGraph", "no_grad", "inference_mode"}
# tensor methods that return a tensor (a card value on a card tensor)
_TENSOR_METHODS = {
    "any", "all", "sum", "max", "min", "mean", "norm", "item", "argmax",
    "argmin", "count_nonzero", "prod", "isfinite", "isnan", "isinf", "eq",
    "ne", "gt", "ge", "lt", "le", "equal", "allclose", "nonzero",
    "is_nonzero"}

_FUNC_DEFS = (ast.FunctionDef, ast.AsyncFunctionDef)
_SCOPES = _FUNC_DEFS + (ast.Lambda,)


def card_value_call(node: ast.expr) -> ast.Call | None:
    """The first call in the subtree that yields a card tensor: a
    `torch.` call (metadata helpers excluded) or a tensor method."""
    for sub in ast.walk(node):
        if not (isinstance(sub, ast.Call)
                and isinstance(sub.func, ast.Attribute)):
            continue
        fn = sub.func
        if attr_root(fn) == "torch":
            full = dotted_name(fn) or ""
            if fn.attr not in _CONCRETE_ATTRS \
                    and not full.startswith("torch.backends."):
                return sub
        elif fn.attr in _TENSOR_METHODS:
            return sub
    return None


def _is_capture(expr: ast.expr) -> bool:
    """`torch.cuda.graph(...)` (any spelling ending in `cuda.graph`)."""
    return isinstance(expr, ast.Call) and (
        dotted_name(expr.func) or "").endswith("cuda.graph")


def _callee_name(call: ast.Call) -> str | None:
    """A bare-name call's name, or a `self.method(...)` call's method."""
    fn = call.func
    if isinstance(fn, ast.Name):
        return fn.id
    if isinstance(fn, ast.Attribute) and isinstance(fn.value, ast.Name) \
            and fn.value.id == "self":
        return fn.attr
    return None


def _ref_name(expr: ast.expr) -> str | None:
    """A function reference handed as an argument: a bare name or
    `self.method`."""
    if isinstance(expr, ast.Name):
        return expr.id
    if isinstance(expr, ast.Attribute) and isinstance(expr.value, ast.Name) \
            and expr.value.id == "self":
        return expr.attr
    return None


def captured_bodies(ctx: FileContext) -> list[tuple[list, ast.stmt | None]]:
    """The bodies a CUDA graph captures in this module: each `with
    torch.cuda.graph(...)` body, and the body of each function reachable
    from one (module docstring); (statements, waiver anchor for a lambda
    body's findings) pairs."""
    funcs: list[dict] = []
    by_name: dict[str, list[dict]] = {}
    regions: list[ast.With] = []

    def collect(node: ast.AST, current: dict | None, stmt) -> None:
        for child in ast.iter_child_nodes(node):
            s = child if isinstance(child, ast.stmt) else stmt
            if isinstance(child, _SCOPES):
                info = {"node": child, "calls": set(), "idx": len(funcs),
                        "name": getattr(child, "name", "<lambda>"),
                        "stmt": s, "regions": []}
                funcs.append(info)
                by_name.setdefault(info["name"], []).append(info)
                collect(child, info, s)
                continue
            if isinstance(child, (ast.With, ast.AsyncWith)) and any(
                    _is_capture(i.context_expr) for i in child.items):
                regions.append(child)
                if current is not None:
                    current["regions"].append(child)
            if isinstance(child, ast.Call) and current is not None:
                name = _callee_name(child)
                if name:
                    current["calls"].add(name)
            collect(child, current, s)

    collect(ctx.tree, None, None)
    if not regions:
        return []
    roots: set[int] = set()

    def refs_of(call: ast.Call) -> None:
        """The functions a call under capture reaches: its callee, and
        the lambdas and function references it is handed."""
        name = _callee_name(call)
        for info in by_name.get(name or "", []):
            roots.add(info["idx"])
        for a in list(call.args) + [kw.value for kw in call.keywords]:
            if isinstance(a, ast.Lambda):
                roots.update(f["idx"] for f in funcs if f["node"] is a)
            else:
                for info in by_name.get(_ref_name(a) or "", []):
                    roots.add(info["idx"])

    wrappers: set[str] = set()
    for region in regions:
        for stmt in region.body:
            for sub in ast.walk(stmt):
                if isinstance(sub, ast.Call):
                    refs_of(sub)
    for f in funcs:
        if not isinstance(f["node"], _FUNC_DEFS) or not f["regions"]:
            continue
        params = {a.arg for a in f["node"].args.args
                  + f["node"].args.kwonlyargs}
        for region in f["regions"]:
            if any(isinstance(sub, ast.Call)
                   and isinstance(sub.func, ast.Name)
                   and sub.func.id in params
                   for stmt in region.body for sub in ast.walk(stmt)):
                wrappers.add(f["name"])
    # a call handing work to a capture wrapper: its arguments are roots
    for sub in ctx.walk():
        if isinstance(sub, ast.Call) and _callee_name(sub) in wrappers:
            for a in list(sub.args) + [kw.value for kw in sub.keywords]:
                if isinstance(a, ast.Lambda):
                    roots.update(f["idx"] for f in funcs
                                 if f["node"] is a)
                else:
                    for info in by_name.get(_ref_name(a) or "", []):
                        roots.add(info["idx"])
    reachable, stack = set(), list(roots)
    while stack:
        i = stack.pop()
        if i in reachable:
            continue
        reachable.add(i)
        for callee in funcs[i]["calls"]:
            stack.extend(t["idx"] for t in by_name.get(callee, [])
                         if t["idx"] not in reachable)
    out = [(list(region.body), None) for region in regions]
    for i in sorted(reachable):
        node = funcs[i]["node"]
        body = node.body if isinstance(node.body, list) else [node.body]
        out.append((body, funcs[i]["stmt"]))
    return out


def scan_captured(bodies, visit) -> None:
    """Call `visit(node, anchor statement)` on every node of the captured
    bodies, nested defs and lambdas aside (each is judged as its own
    body when reachable)."""
    def walk(node, stmt):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, _SCOPES):
                continue
            s = child if isinstance(child, ast.stmt) else stmt
            visit(child, s)
            walk(child, s)

    for body, anchor in bodies:
        for stmt in body:
            s = stmt if isinstance(stmt, ast.stmt) else anchor
            visit(stmt, s)
            walk(stmt, s)


@register
class TracedControlFlowPass(LintPass):
    name = "traced-control-flow"
    description = ("Python if/while/bool()/int() on a card tensor inside "
                   "a body a CUDA graph captures")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        if "cuda.graph" not in ctx.src:
            return
        bodies = captured_bodies(ctx)
        findings: list[Finding] = []
        consumed: set[int] = set()

        def flag(node: ast.expr, what: str, stmt) -> None:
            hit = card_value_call(node)
            if hit is None:
                return
            spelled = dotted_name(hit.func) or f".{hit.func.attr}()"
            findings.append(Finding(
                self.name, ctx.path, node.lineno,
                f"{what} on a card value `{spelled}` "
                "inside a body a CUDA graph captures — the branch reads "
                "the value back (a sync that fails the capture) or bakes "
                "one branch into the replayed graph; use torch.where, or "
                "decide on the host before the capture",
                span=ctx.span_of(stmt) if stmt is not None else None))

        def visit(node: ast.AST, s) -> None:
            if isinstance(node, (ast.If, ast.While, ast.IfExp)):
                what = ("ternary `if`" if isinstance(node, ast.IfExp)
                        else f"Python `{type(node).__name__.lower()}`")
                flag(node.test, what, s)
                consumed.update(id(n) for n in ast.walk(node.test))
            elif (isinstance(node, ast.Call)
                  and id(node) not in consumed
                  and isinstance(node.func, ast.Name)
                  and node.func.id in ("bool", "int")
                  and len(node.args) == 1):
                flag(node.args[0], f"`{node.func.id}()`", s)

        scan_captured(bodies, visit)
        seen: set[tuple] = set()
        for f in sorted(findings, key=lambda f: f.line):
            if (f.line, f.message) not in seen:
                seen.add((f.line, f.message))
                yield f
