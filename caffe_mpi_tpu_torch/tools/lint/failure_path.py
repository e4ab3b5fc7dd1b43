"""failure-path passes: liveness lint for the failure edges, with
neither torch nor jax imported.

Port of the JAX package's caffe_mpi_tpu/tools/lint/failure_path.py (the
same four pass names, so a waiver reads the same in both trees; the same
messages). The reference's failure paths are process-fatal by
construction (`CHECK`/`LOG(FATAL)` in caffe.cpp and common.cpp abort the
rank), so a swallowed error or a silently dead worker thread cannot
exist there. The port keeps processes alive through failure (typed
serving errors, journaled exits, the fleet's supervisor), which opens
four leak shapes:

  * `future-resolution`: a `concurrent.futures.Future` created on a
    serving/solver path must, on every exit path of its function, be
    resolved or escape into something a drain site owns;
  * `typed-failure`: `except Exception:`/bare `except` under
    caffe_mpi_tpu_torch/serving/, solver/, parallel/ and
    utils/resilience.py must re-raise, convert to a typed error, resolve
    a future, keep the exception object as data, or journal;
    log-and-continue fails unless surviving is the design (waived with
    its reason);
  * `thread-crash`: a `threading.Thread` target (or a pool `.submit()`
    callee whose future is discarded) that can raise out the top with no
    catch-all dies silently;
  * `deadline-discipline`: `subprocess.run`/`check_output`/
    `.communicate()`/`.wait()` without `timeout=`, and unbounded
    `.join()`/`.result()`/`.get()`, on the card-adjacent paths
    (caffe_mpi_tpu_torch/tools/, serving/, solver/ and chip_smoke.py):
    a wedged card or child turns them into a hang no signal interrupts.

All four ride the concurrency passes' whole-tree model (concurrency.py
`tree_model`, one build a run). They are approximate by design:
linear-order escape analysis, not a CFG; structural handler rules, not
dataflow. Deliberate sites are waived in the code with written reasons.
"""

from __future__ import annotations

import ast
import os
from typing import Iterator

from . import FileContext, Finding, LintPass, dotted_name, register
from .concurrency import (_FUTURE_CTORS, _emit, deadline_kind,
                          tree_model)

_RESOLVERS = ("set_result", "set_exception", "cancel")


def _norm_rel(ctx: FileContext, root: str) -> str:
    return os.path.relpath(ctx.path, root).replace(os.sep, "/")


def _broad_handler(handler: ast.ExceptHandler) -> str | None:
    """The spelling of a broad handler ('bare except', 'Exception',
    'BaseException'), or None for a typed one."""
    t = handler.type
    if t is None:
        return "bare except"
    names = [t] if not isinstance(t, ast.Tuple) else list(t.elts)
    for n in names:
        d = (dotted_name(n) or "").rsplit(".", 1)[-1]
        if d in ("Exception", "BaseException"):
            return d
    return None


def _has_broad_handler(fn_node) -> bool:
    """True when the function body contains a try with a broad handler
    at any depth OUTSIDE nested defs — the catch-all that keeps a
    worker thread from dying silently."""
    stack = list(fn_node.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        if isinstance(node, ast.Try):
            for h in node.handlers:
                if _broad_handler(h):
                    return True
        stack.extend(ast.iter_child_nodes(node))
    return False


# ---------------------------------------------------------------------------
# future-resolution

_FUTURE_SCOPES = ("caffe_mpi_tpu_torch/serving/",
                  "caffe_mpi_tpu_torch/solver/")


class _FutureFlow:
    """Linear-order escape analysis for one function: track locals
    holding a Future (or an instance of a Future-bearing class) from
    creation until they resolve, escape, or leak. Statements are
    visited in source order through compound bodies (shared pending
    set — an escape in ANY branch clears the name, the optimistic
    reading that keeps false positives out of real code)."""

    def __init__(self, pass_name, fn, future_fields, selected):
        self.pass_name = pass_name
        self.fn = fn
        self.future_fields = future_fields
        self.selected = selected
        self.pending: dict[str, tuple] = {}   # name -> (stmt, detail)
        self.findings: list[Finding] = []

    def run(self) -> list[Finding]:
        for s in self.fn.node.body:
            self._stmt(s)
        for name, (stmt, detail) in self.pending.items():
            self._flag(stmt,
                       f"local {name!r} ({detail}) is created here but "
                       "never resolved, returned, or registered — no "
                       "drain site can ever own it, so any waiter "
                       "blocks forever")
        return self.findings

    # -- statement dispatch ---------------------------------------------
    def _stmt(self, s) -> None:
        if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef)):
            self._escape_uses(s)    # closure capture = escape
            return
        if isinstance(s, (ast.If, ast.For, ast.AsyncFor, ast.While,
                          ast.With, ast.AsyncWith, ast.Try)):
            for attr in ("test", "iter", "items"):
                v = getattr(s, attr, None)
                for n in (v if isinstance(v, list)
                          else [v] if v is not None else []):
                    self._escape_uses(n)
            for block in ("body", "orelse", "finalbody"):
                for c in getattr(s, block, None) or []:
                    self._stmt(c)
            for h in getattr(s, "handlers", None) or []:
                for c in h.body:
                    self._stmt(c)
            return
        self._simple(s)

    def _simple(self, s) -> None:
        if isinstance(s, ast.Raise):
            for name in list(self.pending):
                stmt0, detail = self.pending.pop(name)
                self._flag(s,
                           f"raise with {name!r} ({detail}, created at "
                           f"line {stmt0.lineno}) still local and "
                           "PENDING — the pending-forever shape: "
                           "the waiter blocks on a future nobody will "
                           "resolve; resolve it (set_exception/cancel) "
                           "or create it after the raise paths")
            return
        if isinstance(s, ast.Return):
            if s.value is not None:
                self._escape_uses(s.value)
            for name in list(self.pending):
                stmt0, detail = self.pending.pop(name)
                self._flag(s,
                           f"returning with {name!r} ({detail}, created "
                           f"at line {stmt0.lineno}) still local and "
                           "pending — this exit path strands the "
                           "future")
            return
        created = self._creation(s)
        self._resolutions(s)
        self._escape_uses(s, skip=created)
        if created:
            name, detail = created
            self.pending[name] = (s, detail)

    # -- the events ------------------------------------------------------
    def _creation(self, s) -> tuple[str, str] | None:
        if not (isinstance(s, ast.Assign) and len(s.targets) == 1
                and isinstance(s.targets[0], ast.Name)
                and isinstance(s.value, ast.Call)):
            return None
        d = dotted_name(s.value.func) or ""
        if d in _FUTURE_CTORS:
            return (s.targets[0].id, "a concurrent.futures.Future")
        cls = d.rsplit(".", 1)[-1]
        if cls in self.future_fields:
            return (s.targets[0].id,
                    f"an instance of {cls} holding a Future in "
                    f".{self.future_fields[cls]}")
        return None

    def _resolutions(self, s) -> None:
        for node in self.fn.ctx.walk(s):
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _RESOLVERS:
                base = node.func.value
                while isinstance(base, ast.Attribute):
                    base = base.value
                if isinstance(base, ast.Name):
                    self.pending.pop(base.id, None)

    def _escape_uses(self, node, skip=None) -> None:
        """Any OTHER use of a pending name — call argument, container,
        attribute/subscript store, alias, yield — counts as an escape
        into something a drain site can own. Generous by design."""
        if not self.pending:
            return
        skip_name = skip[0] if skip else None
        for n in self.fn.ctx.walk(node):
            if isinstance(n, ast.Name) and n.id != skip_name \
                    and n.id in self.pending:
                self.pending.pop(n.id, None)

    def _flag(self, stmt, message: str) -> None:
        f = _emit(self.pass_name, self.fn.ctx, stmt, stmt.lineno,
                  message + "; waive with `# lint: ok(future-"
                  "resolution) — reason` only when ownership is "
                  "provably elsewhere", self.selected)
        if f:
            self.findings.append(f)


@register
class FutureResolutionPass(LintPass):
    name = "future-resolution"
    description = ("a Future created on a serving/solver path must be "
                   "resolved or escape to a drain-site owner on every "
                   "exit path (raise-after-create = the "
                   "pending-forever shape)")

    def check_tree(self, ctxs: list[FileContext],
                   root: str) -> Iterator[Finding]:
        model = tree_model(ctxs, root)
        selected = {c.path: c for c in ctxs}
        for key, fn in model.funcs.items():
            rel = _norm_rel(fn.ctx, root)
            if not rel.startswith(_FUTURE_SCOPES):
                continue
            if "Future" not in fn.ctx.src \
                    and not any(c in fn.ctx.src
                                for c in model.future_fields):
                continue
            flow = _FutureFlow(self.name, fn, model.future_fields,
                               selected)
            yield from flow.run()


# ---------------------------------------------------------------------------
# typed-failure

_TYPED_SCOPES = ("caffe_mpi_tpu_torch/serving/", "caffe_mpi_tpu_torch/solver/",
                 "caffe_mpi_tpu_torch/parallel/")
_TYPED_FILES = ("caffe_mpi_tpu_torch/utils/resilience.py",)

_LOG_ROOTS = {"log", "logging", "logger"}
_LOG_METHODS = {"debug", "info", "warning", "error", "exception",
                "critical", "fatal", "log"}


def _is_log_call(call: ast.Call) -> bool:
    func = call.func
    if not isinstance(func, ast.Attribute):
        return False
    base = func.value
    while isinstance(base, ast.Attribute):
        base = base.value
    if isinstance(base, ast.Name) and base.id in _LOG_ROOTS:
        return True
    return func.attr in _LOG_METHODS and isinstance(base, ast.Name) \
        and base.id in _LOG_ROOTS


def _handler_converts(handler: ast.ExceptHandler) -> bool:
    """Structural OK-rules: the handler re-raises, resolves a future
    with the error, journals, exits through the registered EXIT_*
    path, replies with a typed HTTP status, or captures the exception
    OBJECT (not its str()) as data something downstream consumes."""
    caught = handler.name
    for node in ast.walk(ast.Module(body=handler.body,
                                    type_ignores=[])):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if isinstance(node, ast.Raise):
            return True
        if isinstance(node, (ast.Assign, ast.AugAssign)):
            value = getattr(node, "value", None)
            elts = [value] if value is not None else []
            if isinstance(value, (ast.Tuple, ast.List, ast.Set)):
                elts += list(value.elts)
            elif isinstance(value, ast.Dict):
                elts += [v for v in value.values if v is not None]
            if caught and any(isinstance(e, ast.Name) and e.id == caught
                              for e in elts):
                return True     # the exception object stored as data
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        d = dotted_name(func) or ""
        if isinstance(func, ast.Attribute) and func.attr in (
                "set_exception", "cancel"):
            return True
        if any(kw.arg == "exc" for kw in node.keywords):
            return True         # the `_resolve(fut, exc=e)` idiom
        if "journal" in d.lower():
            return True
        if d in ("sys.exit", "os._exit"):
            return True
        if node.args and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, int) \
                and 400 <= node.args[0].value < 600:
            return True         # typed HTTP reply (4xx/5xx + kind)
        if caught and not _is_log_call(node) \
                and any(isinstance(a, ast.Name) and a.id == caught
                        for a in node.args):
            return True         # exception object handed onward
    return False


@register
class TypedFailurePass(LintPass):
    name = "typed-failure"
    description = ("broad `except Exception`/bare except under serving/"
                   "solver/parallel/resilience must re-raise, convert "
                   "to a typed error, resolve a future, or journal — "
                   "silent swallow fails")

    def check_tree(self, ctxs: list[FileContext],
                   root: str) -> Iterator[Finding]:
        model = tree_model(ctxs, root)
        selected = {c.path: c for c in ctxs}
        for ctx in model.ctxs:
            rel = _norm_rel(ctx, root)
            if not (rel.startswith(_TYPED_SCOPES)
                    or rel in _TYPED_FILES):
                continue
            for node in ctx.walk():
                if not isinstance(node, ast.Try):
                    continue
                for h in node.handlers:
                    spelled = _broad_handler(h)
                    if spelled is None or _handler_converts(h):
                        continue
                    f = _emit(
                        self.name, ctx, h, h.lineno,
                        f"broad `{spelled}` handler swallows the "
                        "failure UNTYPED (log-and-continue included): "
                        "re-raise, convert to a typed ServingError/"
                        "registered EXIT_*, resolve a future with the "
                        "error, or journal via the run-manifest path; "
                        "waive with `# lint: ok(typed-failure) — "
                        "reason` when surviving is the design",
                        selected)
                    if f:
                        yield f


# ---------------------------------------------------------------------------
# thread-crash

def _has_worker_loop(fn_node) -> bool:
    """A `while` loop outside nested defs — the shape of a long-running
    worker body (dispatcher, harvester, monitor, beat publisher)."""
    stack = list(fn_node.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        if isinstance(node, ast.While):
            return True
        stack.extend(ast.iter_child_nodes(node))
    return False


@register
class ThreadCrashPass(LintPass):
    name = "thread-crash"
    description = ("a Thread target (or discarded pool-submit callee) "
                   "that can raise out the top without a journaling "
                   "catch-all is a silently-dying worker")

    def check_tree(self, ctxs: list[FileContext],
                   root: str) -> Iterator[Finding]:
        model = tree_model(ctxs, root)
        selected = {c.path: c for c in ctxs}
        guarded: dict[tuple, bool] = {}

        def _guarded(key) -> bool:
            if key not in guarded:
                fn = model.funcs[key]
                ok = _has_broad_handler(fn.node)
                if not ok:
                    # one-level delegation: a pure wrapper whose every
                    # resolvable callee is itself guarded
                    callees = [c for c in fn.callees if c in model.funcs]
                    ok = bool(callees) and all(
                        _has_broad_handler(model.funcs[c].node)
                        for c in callees)
                guarded[key] = ok
            return guarded[key]

        seen: set[tuple] = set()
        targets = list(model.thread_targets)
        direct = {t["target"] for t in targets}
        # an escaping `self.method` reference whose body runs a worker
        # loop is a thread entry even when the Thread(...) call spells
        # its target through a local (the dispatcher/harvest wiring
        # passes (name, target) tuples): a wedged dispatcher worker
        # must not escape this pass on spelling
        for key in sorted(model.entries):
            if key in model.funcs and key not in direct \
                    and _has_worker_loop(model.funcs[key].node):
                fn = model.funcs[key]
                targets.append({
                    "target": key, "ctx": fn.ctx, "stmt": fn.node,
                    "line": fn.node.lineno,
                    "via": "escaping worker-loop reference",
                    "discarded": False})
        for t in targets:
            key = t["target"]
            if key not in model.funcs or _guarded(key):
                continue
            if t["via"] == ".submit(...)" and not t["discarded"]:
                continue    # the kept future carries the exception
            fn = model.funcs[key]
            label = f"{key[0]}.{key[1]}" if isinstance(key[0], str) \
                else key[1]
            if t["discarded"]:
                dkey = (t["ctx"].path, t["stmt"].lineno, label)
                if dkey in seen:
                    continue
                seen.add(dkey)
                f = _emit(
                    self.name, t["ctx"], t["stmt"], t["line"],
                    f"pool .submit({label}, ...) discards its future: "
                    "an exception in the callee vanishes with it — "
                    "keep the future (a drain site must .result() it) "
                    "or wrap the callee in a journaling catch-all; "
                    "waive with `# lint: ok(thread-crash) — reason`",
                    selected)
                if f:
                    yield f
                continue
            dkey = (fn.ctx.path, fn.node.lineno)
            if dkey in seen:
                continue
            seen.add(dkey)
            how = ("a worker loop handed out as a thread entry"
                   if t["via"] == "escaping worker-loop reference"
                   else "spawned at "
                   f"{_norm_rel(t['ctx'], root)}:{t['line']}")
            f = _emit(
                self.name, fn.ctx, fn.node, fn.node.lineno,
                f"{label} runs as a thread target ({how}) "
                "with no catch-all: an exception "
                "here kills the worker SILENTLY — wrap the body in a "
                "try/except that journals/resolves/respawns, or waive "
                "with `# lint: ok(thread-crash) — reason` when dying "
                "is the designed failure signal", selected)
            if f:
                yield f


# ---------------------------------------------------------------------------
# deadline-discipline

_DEADLINE_DIRS = ("caffe_mpi_tpu_torch/tools/", "caffe_mpi_tpu_torch/serving/",
                  "caffe_mpi_tpu_torch/solver/")
_DEADLINE_FILES = ("chip_smoke.py",)


def _deadline_scope(rel: str) -> bool:
    return rel.startswith(_DEADLINE_DIRS) or rel in _DEADLINE_FILES


@register
class DeadlineDisciplinePass(LintPass):
    name = "deadline-discipline"
    description = ("subprocess.run/check_output/.communicate()/.wait() "
                   "without timeout=, and unbounded .join()/.result()/"
                   ".get() on device-adjacent paths (tools/, serving/, "
                   "solver/) — even outside locks")

    def check_tree(self, ctxs: list[FileContext],
                   root: str) -> Iterator[Finding]:
        model = tree_model(ctxs, root)
        selected = {c.path: c for c in ctxs}
        seen: set[tuple] = set()
        events = list(model.deadline_events)
        # module-level statements run outside any function walk (smoke
        # scripts calling subprocess at import / __main__ level)
        for ctx in model.ctxs:
            if not _deadline_scope(_norm_rel(ctx, root)):
                continue
            for stmt in ctx.tree.body:
                if isinstance(stmt, (ast.FunctionDef,
                                     ast.AsyncFunctionDef,
                                     ast.ClassDef)):
                    continue
                for node in ctx.walk(stmt):
                    if isinstance(node, ast.Call):
                        kind = deadline_kind(node)
                        if kind:
                            events.append({"kind": kind, "ctx": ctx,
                                           "stmt": stmt,
                                           "line": node.lineno})
        for ev in events:
            if not _deadline_scope(_norm_rel(ev["ctx"], root)):
                continue
            key = (ev["ctx"].path, ev["line"], ev["kind"])
            if key in seen:
                continue
            seen.add(key)
            f = _emit(
                self.name, ev["ctx"], ev["stmt"], ev["line"],
                f"{ev['kind']} on a device-adjacent path: a dead "
                "tunnel (or wedged child) turns this into a hang no "
                "Python signal can interrupt — bound it with timeout= "
                "and handle the expiry, or waive with `# lint: "
                "ok(deadline-discipline) — reason` (e.g. a sentinel-"
                "woken idle park)", selected)
            if f:
                yield f
