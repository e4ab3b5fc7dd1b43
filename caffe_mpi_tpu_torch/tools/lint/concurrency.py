"""concurrency passes: static race detection for the port's threaded
planes, with neither torch nor jax imported.

Port of the JAX package's caffe_mpi_tpu/tools/lint/concurrency.py. The
reference stack's threading bugs (DataReader's blocking queue pairs,
data_reader.hpp:28-53; BasePrefetchingDataLayer's prefetch threads,
base_data_layer.hpp:100-159) were caught by review and crash dumps. Three
bug classes recur in the threaded planes (serving/engine.py,
serving/batcher.py, serving/fleet.py, data/feeder.py,
utils/resilience.py):

  * a Future resolved under a non-reentrant lock: done-callbacks run
    synchronously in the resolving thread, so a callback that re-enters
    the lock deadlocks;
  * a device sync (`Tensor.cpu()`, `.item()`, `torch.cuda.synchronize`,
    an event's `.synchronize()`) or an unbounded wait under a held lock:
    every other thread touching the lock stalls until the card drains,
    and the serving stall breaker trips on a healthy card;
  * an undeclared lock-nesting order.

Three passes encode the discipline over ONE whole-tree model (lock
aliases, attribute types, a resolvable call graph, one AST walk per
function) built once per run:

  * `lock-order` — every observed nesting pair (direct `with` nesting,
    `.acquire()` under a held lock, and lock acquisitions reachable
    through resolvable calls, transitively) must be declared in the
    `LOCK_ORDER` partial order (caffe_mpi_tpu_torch/serving/locks.py);
    inverted pairs and re-acquiring a non-reentrant lock are findings,
    and the registry itself is drift-held (unknown lock ids, cycles,
    dead ATTR_TYPES entries).
  * `blocking-under-lock` — calls that must never run inside a held
    lock span: `Future.set_result`/`set_exception`, the device syncs
    `.cpu()`/`.item()`/`.tolist()`/`.numpy()`/`torch.cuda.synchronize`/
    `.synchronize()`, `np.asarray`/`np.array`, `time.sleep`, and
    unbounded `.join()`/`.get()`/`.result()`/`.wait()` (a Condition's
    own `.wait()` under its lock is the sanctioned pattern and is
    exempt).
  * `thread-shared-mutation` — an attribute mutated both inside a
    thread-entry function (a `threading.Thread(target=...)` body, a
    pool `.submit(...)` callee, a registered callback — any escaping
    `self.method` reference counts) and from a public method, where the
    two sides share no covering lock.

All three are approximate by design (they see syntax, not dynamic
ownership): deliberate patterns — caller-holds-lock helpers, a copy
whose serialization is the lock's very purpose — are waived in the code
with written reasons (`# lint: ok(<pass>) — reason`).

The failure-path passes (failure_path.py) ride the same model: the walk
also collects resolvable `threading.Thread(target=...)` and pool
`.submit()` targets, unbounded deadline-family calls (held-lock aware,
so a Condition's own `.wait()` stays sanctioned) and the classes whose
instances carry a Future.
"""

from __future__ import annotations

import ast
import os
from typing import Iterator

from . import (DEFAULT_SCAN, FileContext, Finding, LintPass, dotted_name,
               iter_py_files, register)

REGISTRY_FILE = os.path.join("caffe_mpi_tpu_torch", "serving", "locks.py")

_LOCK_CTORS = {"threading.Lock": "Lock", "threading.RLock": "RLock",
               "threading.Condition": "Condition",
               "Lock": "Lock", "RLock": "RLock", "Condition": "Condition"}

# container mutator methods: `self.x.append(...)` mutates self.x
_MUTATORS = {"append", "appendleft", "extend", "insert", "add", "update",
             "remove", "discard", "pop", "popleft", "popitem", "clear",
             "setdefault", "move_to_end"}

# the calls that wait for the card (or copy from it): a device sync
_DEVICE_KINDS = {".cpu()", ".item()", ".tolist()", ".numpy()",
                 "torch.cuda.synchronize", ".synchronize()", "np.asarray",
                 "np.array", "numpy.asarray", "numpy.array"}

_FUTURE_CTORS = {"Future", "futures.Future", "concurrent.futures.Future"}

_THREAD_CTORS = {"threading.Thread", "Thread"}

_SUBPROCESS_CALLS = {"subprocess.run", "subprocess.check_output",
                     "subprocess.check_call", "subprocess.call"}


def deadline_kind(node: ast.Call, held: tuple = (),
                  lock_id=None) -> str | None:
    """The deadline-discipline call shapes (failure_path.py), held-lock
    aware so a Condition's own `.wait()` under its lock stays the
    sanctioned pattern; shared with the module-level walk (held=())."""
    func = node.func
    dotted = dotted_name(func)
    has_timeout = any(kw.arg == "timeout" for kw in node.keywords)
    if dotted in _SUBPROCESS_CALLS:
        return None if has_timeout else f"{dotted}(...) without timeout="
    if not isinstance(func, ast.Attribute):
        return None
    attr = func.attr
    if attr == "communicate":
        return None if has_timeout else ".communicate() without timeout="
    if attr in ("join", "result") and not node.args and not has_timeout:
        return f".{attr}() without timeout"
    if attr == "get" and not node.args and not node.keywords:
        return ".get() without timeout"
    if attr == "wait" and not node.args and not has_timeout:
        if lock_id is not None and lock_id(func.value) in held:
            return None     # Condition.wait under its own lock
        return ".wait() without timeout"
    return None


class _Func:
    """One function/method: AST + file + class, and the facts one walk
    extracts (direct lock acquisitions, resolvable callees)."""

    def __init__(self, ctx, node, cls, stem):
        self.ctx = ctx
        self.node = node
        self.cls = cls          # class name, or None for module funcs
        self.stem = stem        # module stem (basename sans .py)
        self.direct_locks: set[str] = set()
        self.callees: set[tuple] = set()


class _Model:
    """Whole-tree concurrency facts shared by the three passes."""

    def __init__(self):
        self.locks: dict[str, tuple[str, str, int]] = {}
        self.lock_attrs: dict[str, set[str]] = {}
        self.attr_types: dict[tuple[str, str], str] = {}
        self.classes: dict[str, str] = {}
        self.funcs: dict[tuple, _Func] = {}
        self.acquired: dict[tuple, set[str]] = {}
        self.order: list[tuple[str, str, int]] = []
        self.order_path = ""
        self.attr_hints: dict[str, tuple[str, int]] = {}
        self.nestings: list[dict] = []
        self.call_events: list[dict] = []
        self.blocking: list[dict] = []
        self.mutations: list[dict] = []
        self.entries: set[tuple[str, str]] = set()
        self.properties: set[tuple[str, str]] = set()
        self.thread_closure: set[tuple] = set()
        # the failure-path facts (failure_path.py): resolvable Thread
        # targets and pool submit callees, deadline-family call events,
        # and the classes whose instances carry a Future field
        self.thread_targets: list[dict] = []
        self.deadline_events: list[dict] = []
        self.future_fields: dict[str, str] = {}
        self.ctxs: list[FileContext] = []
        # keys claimed by two different files — dropped before analysis
        # (no resolution beats wrong resolution)
        self._ambiguous: set[tuple] = set()

    # -- phase 1: declarations -----------------------------------------
    def scan_decls(self, ctx: FileContext) -> None:
        stem = os.path.splitext(os.path.basename(ctx.path))[0]
        for node in ctx.tree.body:
            if isinstance(node, ast.ClassDef):
                self.classes.setdefault(node.name, ctx.path)
                for item in ctx.walk(node):
                    if isinstance(item, ast.Assign):
                        self._class_assign(ctx, node.name, item)
                    elif isinstance(item, ast.AnnAssign):
                        self._class_ann(node.name, item)
            elif isinstance(node, ast.Assign):
                kind = self._lock_ctor(node.value)
                if kind:
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            self.locks[f"{stem}.{t.id}"] = (
                                kind, ctx.path, node.lineno)

    def _class_assign(self, ctx, cls: str, node: ast.Assign) -> None:
        value = node.value
        for t in node.targets:
            if not (isinstance(t, ast.Attribute)
                    and isinstance(t.value, ast.Name)
                    and t.value.id == "self"):
                continue
            kind = self._lock_ctor(value)
            if kind:
                self.locks[f"{cls}.{t.attr}"] = (kind, ctx.path,
                                                 node.lineno)
                self.lock_attrs.setdefault(t.attr, set()).add(cls)
            elif isinstance(value, ast.Call) and (
                    dotted_name(value.func) or "") in _FUTURE_CTORS:
                # `self.x = Future()`: instances of this class carry a
                # future a drain site must own
                self.future_fields.setdefault(cls, t.attr)
            elif isinstance(value, ast.Call) and isinstance(value.func,
                                                            ast.Name):
                # `self.x = ClassName(...)` pins the attribute's type
                self.attr_types.setdefault((cls, t.attr), value.func.id)

    def _class_ann(self, cls: str, node: ast.AnnAssign) -> None:
        """`future: Future = field(default_factory=Future)` or an
        annotated `self.x: Future = ...`: the class is future-bearing."""
        is_future = (dotted_name(node.annotation) or "") in _FUTURE_CTORS \
            or self._future_factory(node.value)
        if not is_future:
            return
        t = node.target
        if isinstance(t, ast.Name):
            self.future_fields.setdefault(cls, t.id)
        elif isinstance(t, ast.Attribute) and isinstance(
                t.value, ast.Name) and t.value.id == "self":
            self.future_fields.setdefault(cls, t.attr)

    @staticmethod
    def _future_factory(value) -> bool:
        if not isinstance(value, ast.Call):
            return False
        if (dotted_name(value.func) or "").rsplit(".", 1)[-1] != "field":
            return False
        return any(kw.arg == "default_factory"
                   and (dotted_name(kw.value) or "") in _FUTURE_CTORS
                   for kw in value.keywords)

    @staticmethod
    def _lock_ctor(value) -> str | None:
        if isinstance(value, ast.Call):
            return _LOCK_CTORS.get(dotted_name(value.func) or "")
        return None

    def collect_funcs(self, ctx: FileContext) -> None:
        stem = os.path.splitext(os.path.basename(ctx.path))[0]
        for node in ctx.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # keys are basename stems (that is what a call site
                # spells) — two files with the same stem (__init__.py
                # packages) could otherwise mis-resolve each other's
                # functions, so a cross-file collision poisons the key:
                # no resolution beats wrong resolution
                key = (("mod", stem), node.name)
                prev = self.funcs.get(key)
                if prev is not None and prev.ctx.path != ctx.path:
                    self._ambiguous.add(key)
                self.funcs[key] = _Func(ctx, node, None, stem)
            elif isinstance(node, ast.ClassDef):
                if self.classes.get(node.name) not in (None, ctx.path):
                    # same class name in two files: method resolution
                    # would conflate them — poison every method key
                    for k in list(self.funcs):
                        if k[0] == node.name:
                            self._ambiguous.add(k)
                for item in node.body:
                    if isinstance(item, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                        key = (node.name, item.name)
                        if self.classes.get(node.name) not in (
                                None, ctx.path):
                            self._ambiguous.add(key)
                        self.funcs[key] = _Func(ctx, item, node.name,
                                                stem)
                        for dec in item.decorator_list:
                            name = dotted_name(dec) or ""
                            if name == "property" or \
                                    name.endswith((".setter", ".getter",
                                                   "cached_property")):
                                # a property READ is a call the AST
                                # shows as an attribute load — it must
                                # not register as an escaping method
                                # reference (thread entry)
                                self.properties.add((node.name,
                                                     item.name))

    # -- phase 2: the declared order -----------------------------------
    def load_registry(self, root: str) -> None:
        path = os.path.join(root, REGISTRY_FILE)
        if not os.path.isfile(path):
            return
        self.order_path = path
        try:
            tree = ast.parse(open(path, encoding="utf-8").read(),
                             filename=path)
        except SyntaxError:
            return
        for node in ast.walk(tree):
            if isinstance(node, ast.Assign):
                targets, value = node.targets, node.value
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                targets, value = [node.target], node.value
            else:
                continue
            for t in targets:
                if not isinstance(t, ast.Name):
                    continue
                if t.id == "LOCK_ORDER" and isinstance(
                        value, (ast.Tuple, ast.List)):
                    for pair in value.elts:
                        if isinstance(pair, (ast.Tuple, ast.List)) \
                                and len(pair.elts) == 2 and all(
                                    isinstance(e, ast.Constant)
                                    and isinstance(e.value, str)
                                    for e in pair.elts):
                            self.order.append((pair.elts[0].value,
                                               pair.elts[1].value,
                                               pair.lineno))
                elif t.id == "ATTR_TYPES" and isinstance(value, ast.Dict):
                    for k, v in zip(value.keys, value.values):
                        if isinstance(k, ast.Constant) and isinstance(
                                v, ast.Constant):
                            self.attr_hints[str(k.value)] = (
                                str(v.value), k.lineno)
        for spec, (cls2, _ln) in self.attr_hints.items():
            cls, _, attr = spec.partition(".")
            if attr:
                self.attr_types.setdefault((cls, attr), cls2)

    def reachable(self) -> dict[str, set[str]]:
        """Transitive closure of the declared order: outer -> inners."""
        edges: dict[str, set[str]] = {}
        for a, b, _ln in self.order:
            edges.setdefault(a, set()).add(b)
        closed: dict[str, set[str]] = {}
        for a in edges:
            seen: set[str] = set()
            stack = list(edges[a])
            while stack:
                b = stack.pop()
                if b not in seen:
                    seen.add(b)
                    stack.extend(edges.get(b, ()))
            closed[a] = seen
        return closed

    # -- phase 3: analysis -----------------------------------------------
    def analyze(self) -> None:
        for key in self._ambiguous:
            self.funcs.pop(key, None)
        for key, fn in self.funcs.items():
            _FuncWalk(self, key, fn).run()
        # transitive acquired-locks over the resolvable call graph
        acquired = {k: set(f.direct_locks) for k, f in self.funcs.items()}
        changed = True
        while changed:
            changed = False
            for k, f in self.funcs.items():
                for callee in f.callees:
                    extra = acquired.get(callee)
                    if extra and not acquired[k].issuperset(extra):
                        acquired[k] |= extra
                        changed = True
        self.acquired = acquired
        # nesting pairs through calls: a call made under a held lock
        # acquires (transitively) the callee's locks inside the span
        for ev in self.call_events:
            for lock in sorted(acquired.get(ev["callee"], ())):
                for h in ev["held"]:
                    self.nestings.append({
                        "outer": h, "inner": lock, "ctx": ev["ctx"],
                        "stmt": ev["stmt"], "via": ev["via"],
                        "func": ev["func"]})
        # thread-entry closure over the resolvable call graph
        stack = [e for e in self.entries if e in self.funcs]
        while stack:
            k = stack.pop()
            if k in self.thread_closure:
                continue
            self.thread_closure.add(k)
            stack.extend(c for c in self.funcs[k].callees
                         if c in self.funcs
                         and c not in self.thread_closure)


class _FuncWalk:
    """One function's single walk: lock spans, callees, nesting pairs,
    blocking calls, mutations, thread-entry method references."""

    def __init__(self, model: _Model, key, fn: _Func):
        self.m = model
        self.key = key
        self.fn = fn
        self.local_types: dict[str, str] = {}
        self.local_locks: dict[str, str] = {}

    def run(self) -> None:
        # pre-scan simple local aliases: `x = self.attr` / `x = Cls(..)`
        for node in self.fn.ctx.walk(self.fn.node):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                name = node.targets[0].id
                lock = self._lock_id(node.value)
                if lock:
                    self.local_locks.setdefault(name, lock)
                t = self._type_of(node.value)
                if t:
                    self.local_types.setdefault(name, t)
        for child in self.fn.node.body:
            self._walk(child, (), child)

    # -- resolution -----------------------------------------------------
    def _type_of(self, node) -> str | None:
        if isinstance(node, ast.Name):
            if node.id == "self":
                return self.fn.cls
            return self.local_types.get(node.id)
        if isinstance(node, ast.Attribute):
            base = self._type_of(node.value)
            return self.m.attr_types.get((base, node.attr)) \
                if base is not None else None
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                and node.func.id in self.m.classes:
            return node.func.id
        return None

    def _lock_id(self, node) -> str | None:
        if isinstance(node, ast.Name):
            mod_id = f"{self.fn.stem}.{node.id}"
            if mod_id in self.m.locks:
                return mod_id
            return self.local_locks.get(node.id)
        if isinstance(node, ast.Attribute):
            base = self._type_of(node.value)
            if base is not None and f"{base}.{node.attr}" in self.m.locks:
                return f"{base}.{node.attr}"
            owners = self.m.lock_attrs.get(node.attr)
            if owners and len(owners) == 1:
                return f"{next(iter(owners))}.{node.attr}"
        return None

    def _callee(self, func) -> tuple | None:
        if isinstance(func, ast.Attribute):
            t = self._type_of(func.value)
            if t is not None and (t, func.attr) in self.m.funcs:
                return (t, func.attr)
            if isinstance(func.value, ast.Name):
                key = (("mod", func.value.id), func.attr)
                if key in self.m.funcs:
                    return key
            return None
        if isinstance(func, ast.Name):
            key = (("mod", self.fn.stem), func.id)
            return key if key in self.m.funcs else None
        return None

    # -- the walk -------------------------------------------------------
    def _walk(self, node, held: tuple, stmt) -> None:
        if isinstance(node, ast.stmt):
            stmt = node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            # a nested def body does not run under the lock at def time
            body = node.body if isinstance(node.body, list) else [node.body]
            for child in body:
                self._walk(child, (), stmt)
            return
        if isinstance(node, (ast.With, ast.AsyncWith)):
            inner = held
            for item in node.items:
                lock = self._lock_id(item.context_expr)
                if lock:
                    self.fn.direct_locks.add(lock)
                    for h in inner:
                        self._nesting(h, lock, stmt, "with")
                    inner = inner + (lock,)
                else:
                    self._walk(item.context_expr, held, stmt)
            for child in node.body:
                self._walk(child, inner, stmt)
            return
        if isinstance(node, ast.Call):
            self._call(node, held, stmt)
            func = node.func
            # the func ATTRIBUTE itself is a call, not an escaping
            # method reference — but its base (and any nested calls in
            # a chain like jit(f).lower(...).compile()) still walk
            if isinstance(func, ast.Attribute):
                self._walk(func.value, held, stmt)
            elif not isinstance(func, ast.Name):
                self._walk(func, held, stmt)
            for child in list(node.args) + [kw.value
                                            for kw in node.keywords]:
                self._walk(child, held, stmt)
            return
        if isinstance(node, ast.Attribute) and isinstance(
                node.ctx, ast.Load) and self.fn.cls is not None \
                and isinstance(node.value, ast.Name) \
                and node.value.id == "self" \
                and (self.fn.cls, node.attr) in self.m.funcs \
                and (self.fn.cls, node.attr) not in self.m.properties:
            # an escaping `self.method` reference (Thread target, pool
            # submit arg, registered callback) marks a thread entry
            self.m.entries.add((self.fn.cls, node.attr))
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.Delete)):
            self._mutation(node, held, stmt)
        for child in ast.iter_child_nodes(node):
            self._walk(child, held, stmt)

    def _nesting(self, outer: str, inner: str, stmt, via: str) -> None:
        self.m.nestings.append({"outer": outer, "inner": inner,
                                "ctx": self.fn.ctx, "stmt": stmt,
                                "via": via, "func": self.key})

    def _call(self, node: ast.Call, held: tuple, stmt) -> None:
        func = node.func
        callee = self._callee(func)
        if callee is not None:
            self.fn.callees.add(callee)
            if held:
                label = callee[1] if isinstance(callee[0], tuple) \
                    else f"{callee[0]}.{callee[1]}"
                self.m.call_events.append({
                    "callee": callee, "held": held, "ctx": self.fn.ctx,
                    "stmt": stmt, "via": f"call to {label}",
                    "func": self.key})
        if isinstance(func, ast.Attribute) and func.attr == "acquire":
            acq = self._lock_id(func.value)
            if acq:
                self.fn.direct_locks.add(acq)
                for h in held:
                    self._nesting(h, acq, stmt, ".acquire()")
        if isinstance(func, ast.Attribute) and func.attr in _MUTATORS \
                and isinstance(func.value, ast.Attribute) \
                and isinstance(func.value.value, ast.Name) \
                and func.value.value.id == "self" \
                and self.fn.cls is not None:
            self.m.mutations.append({
                "cls": self.fn.cls, "attr": func.value.attr,
                "held": held, "ctx": self.fn.ctx, "stmt": stmt,
                "func": self.key})
        if held:
            kind = self._blocking_kind(node, held)
            if kind:
                self.m.blocking.append({
                    "kind": kind, "held": held, "ctx": self.fn.ctx,
                    "stmt": stmt, "line": node.lineno, "func": self.key})
        # failure-path facts: Thread targets, pool submit callees and
        # deadline-family events, in the same walk
        if dotted_name(func) in _THREAD_CTORS:
            for kw in node.keywords:
                if kw.arg == "target":
                    target = self._callee(kw.value)
                    if target is not None:
                        self.m.thread_targets.append({
                            "target": target, "ctx": self.fn.ctx,
                            "stmt": stmt, "line": node.lineno,
                            "via": "threading.Thread(target=...)",
                            "discarded": False})
        if isinstance(func, ast.Attribute) and func.attr == "submit" \
                and node.args:
            target = self._callee(node.args[0])
            if target is not None:
                # a discarded submit future swallows the callee's
                # exception; a kept one carries it to .result()
                discarded = isinstance(stmt, ast.Expr) \
                    and stmt.value is node
                self.m.thread_targets.append({
                    "target": target, "ctx": self.fn.ctx, "stmt": stmt,
                    "line": node.lineno, "via": ".submit(...)",
                    "discarded": discarded})
        dkind = deadline_kind(node, held, self._lock_id)
        if dkind:
            self.m.deadline_events.append({
                "kind": dkind, "ctx": self.fn.ctx, "stmt": stmt,
                "line": node.lineno, "func": self.key})
    def _blocking_kind(self, node: ast.Call, held: tuple) -> str | None:
        func = node.func
        dotted = dotted_name(func)
        if dotted in ("torch.cuda.synchronize", "time.sleep"):
            return dotted
        if dotted in ("np.asarray", "np.array", "numpy.asarray",
                      "numpy.array"):
            if node.args and isinstance(node.args[0], ast.Constant):
                return None     # constant folding, not a device sync
            return dotted
        if not isinstance(func, ast.Attribute):
            return None
        attr = func.attr
        has_timeout = any(kw.arg == "timeout" for kw in node.keywords)
        if attr in ("set_result", "set_exception"):
            return f"Future.{attr}"
        if attr in ("cpu", "item", "tolist", "numpy", "synchronize") \
                and not node.args and not node.keywords:
            return f".{attr}()"
        if attr == "join" and not node.args and not has_timeout:
            return ".join() without timeout"
        if attr == "result" and not node.args and not has_timeout:
            return ".result() without timeout"
        if attr == "get" and not node.args and not node.keywords:
            return ".get() without timeout"
        if attr == "wait":
            if self._lock_id(func.value) in held:
                return None     # Condition.wait under its own lock
            if not node.args and not has_timeout:
                return ".wait() without timeout"
        return None

    def _mutation(self, node, held: tuple, stmt) -> None:
        if self.fn.cls is None:
            return
        targets = [node.target] if isinstance(node, ast.AugAssign) \
            else node.targets
        for t in targets:
            base = t.value if isinstance(t, ast.Subscript) else t
            if isinstance(base, ast.Attribute) and isinstance(
                    base.value, ast.Name) and base.value.id == "self":
                self.m.mutations.append({
                    "cls": self.fn.cls, "attr": base.attr, "held": held,
                    "ctx": self.fn.ctx, "stmt": stmt, "func": self.key})


# ---------------------------------------------------------------------------
# shared model construction (one per run_lint call)

# identity-checked single-entry cache: the framework hands every pass
# the SAME ctxs list within one run; holding the key list strongly
# prevents id-reuse across runs (tests edit files between runs)
_CACHE: list = [None, None]     # [ctxs_list, model]

def tree_model(ctxs: list[FileContext], root: str) -> _Model:
    if _CACHE[0] is ctxs:
        return _CACHE[1]
    model = _Model()
    by_path = {c.path: c for c in ctxs}
    scan_ctxs: list[FileContext] = []
    seen: set[str] = set()
    # always model the whole tree: a partial selection must not hide
    # half the lock aliases or the call graph
    for target in DEFAULT_SCAN:
        path = os.path.join(root, target)
        if not os.path.exists(path):
            continue
        for fp in iter_py_files([path]):
            fp = os.path.abspath(fp)
            if fp in seen:
                continue
            seen.add(fp)
            ctx = by_path.get(fp)
            if ctx is None:
                try:
                    ctx = FileContext(fp, root=root)
                except OSError:
                    continue
            if ctx.tree is not None:
                scan_ctxs.append(ctx)
    for ctx in ctxs:    # explicitly selected files outside the scan
        if ctx.path not in seen and ctx.tree is not None:
            seen.add(ctx.path)
            scan_ctxs.append(ctx)
    model.ctxs = scan_ctxs
    for ctx in scan_ctxs:
        model.scan_decls(ctx)
        model.collect_funcs(ctx)
    model.load_registry(root)
    model.analyze()
    _CACHE[0], _CACHE[1] = ctxs, model
    return model


def _emit(pass_name: str, ctx: FileContext, stmt, line: int, message: str,
          selected: dict[str, FileContext]) -> Finding | None:
    """Finding with waivers honored: files in the current selection get
    a span (the framework filters them and tracks honored waivers);
    modeled-but-unselected files are self-filtered here, the way the
    doc-drift pass handles its whole-tree call-site scan."""
    span = ctx.span_of(stmt) if stmt is not None else None
    if ctx.path in selected:
        return Finding(pass_name, ctx.path, line, message, span=span)
    if ctx.waived(span, pass_name):
        return None
    return Finding(pass_name, ctx.path, line, message, span=None)


# ---------------------------------------------------------------------------
# the passes

@register
class LockOrderPass(LintPass):
    name = "lock-order"
    description = ("lock nestings must follow the declared LOCK_ORDER "
                   "partial order (serving/locks.py); inverted or "
                   "undeclared pairs are findings")

    def check_tree(self, ctxs: list[FileContext],
                   root: str) -> Iterator[Finding]:
        model = tree_model(ctxs, root)
        selected = {c.path: c for c in ctxs}
        closed = model.reachable()
        seen: set[tuple] = set()
        for n in model.nestings:
            a, b = n["outer"], n["inner"]
            key = (n["ctx"].path, n["stmt"].lineno, a, b)
            if key in seen:
                continue
            seen.add(key)
            if a == b:
                kind = model.locks.get(a, ("Lock",))[0]
                if kind == "RLock":
                    continue
                msg = (f"re-acquiring non-reentrant {a} ({kind}) while "
                       f"already holding it ({n['via']}) — "
                       "self-deadlock")
            elif b in closed.get(a, ()):
                continue
            elif a in closed.get(b, ()):
                msg = (f"INVERTED lock nesting: {a} held while "
                       f"acquiring {b} ({n['via']}), but LOCK_ORDER "
                       f"declares {b} -> {a} — this is the deadlock "
                       "shape the declared order exists to prevent")
            else:
                msg = (f"undeclared lock nesting: {a} held while "
                       f"acquiring {b} ({n['via']}) — declare the pair "
                       f"in {REGISTRY_FILE} LOCK_ORDER (with the review "
                       "reason) or restructure; waive with "
                       "`# lint: ok(lock-order) — reason` only if the "
                       "nesting is deliberate and cannot deadlock")
            f = _emit(self.name, n["ctx"], n["stmt"], n["stmt"].lineno,
                      msg, selected)
            if f:
                yield f
        if not model.order_path:
            return
        # registry drift: the declared order must name real locks, stay
        # acyclic, and ATTR_TYPES must name classes that still exist
        for a, b, ln in model.order:
            for lock_id in (a, b):
                if lock_id not in model.locks:
                    yield Finding(
                        self.name, model.order_path, ln,
                        f"LOCK_ORDER names unknown lock {lock_id!r} — "
                        "no matching threading.Lock/RLock/Condition "
                        "alias exists in the tree; sync the registry "
                        "with the code", span=None)
            if a in closed.get(b, set()) and b in closed.get(a, set()):
                yield Finding(
                    self.name, model.order_path, ln,
                    f"LOCK_ORDER contains a cycle through ({a!r}, "
                    f"{b!r}) — a partial order cannot permit both "
                    "directions", span=None)
        for spec, (cls2, ln) in sorted(model.attr_hints.items()):
            cls, _, _attr = spec.partition(".")
            if cls not in model.classes or cls2 not in model.classes:
                yield Finding(
                    self.name, model.order_path, ln,
                    f"ATTR_TYPES entry {spec!r} -> {cls2!r} names a "
                    "class that no longer exists in the tree",
                    span=None)


@register
class BlockingUnderLockPass(LintPass):
    name = "blocking-under-lock"
    description = ("Future.set_result/set_exception, device syncs "
                   "(.cpu()/.item()/.synchronize()/np.asarray), and "
                   "unbounded join/get/result/wait inside a held lock "
                   "span")

    def check_tree(self, ctxs: list[FileContext],
                   root: str) -> Iterator[Finding]:
        model = tree_model(ctxs, root)
        selected = {c.path: c for c in ctxs}
        seen: set[tuple] = set()
        for b in model.blocking:
            key = (b["ctx"].path, b["line"], b["kind"])
            if key in seen:
                continue
            seen.add(key)
            kind, held = b["kind"], ", ".join(b["held"])
            if kind.startswith("Future."):
                why = ("done-callbacks run synchronously in this "
                       "thread, and a callback re-entering the lock "
                       "deadlocks — resolve futures after releasing the "
                       "lock")
            elif kind in _DEVICE_KINDS:
                why = ("a device sync waits for all the card's queued "
                       "work and stalls every thread touching the lock "
                       "(a healthy card then trips the serving stall "
                       "breaker) — move the device work outside the "
                       "lock")
            else:
                why = ("an unbounded block while holding a lock turns "
                       "one slow thread into a plane-wide stall — "
                       "bound it or release the lock first")
            f = _emit(self.name, b["ctx"], b["stmt"], b["line"],
                      f"{kind} inside a held lock span ({held}): {why}; "
                      "waive with `# lint: ok(blocking-under-lock) — "
                      "reason` if serializing this call is the lock's "
                      "purpose", selected)
            if f:
                yield f


@register
class ThreadSharedMutationPass(LintPass):
    name = "thread-shared-mutation"
    description = ("attributes mutated both on a thread-entry path and "
                   "from public methods with no shared covering lock")

    def check_tree(self, ctxs: list[FileContext],
                   root: str) -> Iterator[Finding]:
        model = tree_model(ctxs, root)
        selected = {c.path: c for c in ctxs}
        if not model.thread_closure:
            return
        by_attr: dict[tuple[str, str], list[dict]] = {}
        for mut in model.mutations:
            if mut["func"][1] == "__init__":
                continue    # constructors run before any thread exists
            by_attr.setdefault((mut["cls"], mut["attr"]), []).append(mut)
        def _counterpart(m, others):
            return next((o for o in others
                         if not (set(m["held"]) & set(o["held"]))), None)

        def _msg(attr, m, other, side):
            return (f"self.{attr} is mutated here in "
                    f"{m['func'][0]}.{m['func'][1]} (holding "
                    f"[{', '.join(m['held']) or 'no lock'}], "
                    f"{side}) and in {other['func'][1]}() (holding "
                    f"[{', '.join(other['held']) or 'no lock'}]) with "
                    "no shared covering lock — guard both sides with "
                    "one lock, or waive with `# lint: ok(thread-"
                    "shared-mutation) — reason` (e.g. the caller "
                    "holds the lock, or ordering makes the race "
                    "benign)")

        for (cls, attr), muts in sorted(by_attr.items()):
            thread = [m for m in muts
                      if m["func"] in model.thread_closure]
            public = [m for m in muts
                      if m["func"] not in model.thread_closure]
            if not thread or not public:
                continue
            # EVERY unlocked mutation site with a disjoint-lock
            # counterpart on the other side is its own finding — one
            # waived anchor must not silence a race a later edit adds
            # at a different site of the same attribute
            sites: set[tuple] = set()
            emitted = False
            for side_name, side, others in (("thread side", thread,
                                             public),
                                            ("public side", public,
                                             thread)):
                for m in side:
                    if m["held"]:
                        continue
                    other = _counterpart(m, others)
                    if other is None:
                        continue
                    key = (m["ctx"].path, m["stmt"].lineno)
                    if key in sites:
                        continue
                    sites.add(key)
                    emitted = True
                    f = _emit(self.name, m["ctx"], m["stmt"],
                              m["stmt"].lineno,
                              _msg(attr, m, other, side_name),
                              selected)
                    if f:
                        yield f
            if not emitted:
                # both sides locked, but by DISJOINT locks — still a
                # race; anchor the thread side once
                for tm in thread:
                    pm = _counterpart(tm, public)
                    if pm is not None:
                        f = _emit(self.name, tm["ctx"], tm["stmt"],
                                  tm["stmt"].lineno,
                                  _msg(attr, tm, pm, "thread side"),
                                  selected)
                        if f:
                            yield f
                        break
