"""The port's concurrency lint passes on the CPU:
caffe_mpi_tpu_torch/tools/lint/concurrency.py against the JAX package's
caffe_mpi_tpu/tools/lint/concurrency.py.

The fixture cases of tests/test_lint.py for `lock-order`,
`blocking-under-lock` and `thread-shared-mutation` that name no `jax`
call run through both packages' `run_lint`, each in a root of its own:
the findings must be equal in pass, file, line and message. Two spellings
differ by design and are mapped before the comparison: each package's
declared order lives in a file of its own tree
(`caffe_mpi_tpu/serving/locks.py`, `caffe_mpi_tpu_torch/serving/locks.py`),
and the port's messages name no review round of the JAX project (its
"(the ... shape)" parentheses). The port's own fixtures plant each of its blocking kinds (the
torch device syncs among them) under a lock, each one found, and the
same calls outside the lock clean. The port's whole tree is clean under
the three passes, and its declared order names only locks that exist.
"""

import os
import re
import subprocess
import sys
import textwrap

import pytest

from caffe_mpi_tpu.tools import lint as jax_lint
from caffe_mpi_tpu_torch.tools import lint as port_lint
from caffe_mpi_tpu_torch.tools.lint import concurrency

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PASSES = ("lock-order", "blocking-under-lock", "thread-shared-mutation")
LINTS = {"jax": jax_lint, "port": port_lint}
REGISTRY = {"jax": os.path.join("caffe_mpi_tpu", "serving", "locks.py"),
            "port": os.path.join("caffe_mpi_tpu_torch", "serving",
                                 "locks.py")}
# the JAX messages name the review round that found a shape, in a
# parenthesis the port's messages do not carry
_JAX_ROUND = re.compile(r" \(the [^)]* shape\)")

_TWO_LOCK_CLASSES = """
    import threading

    class InferenceModel:
        def __init__(self):
            self._upload_lock = threading.Lock()

    class ServingEngine:
        def __init__(self):
            self._lock = threading.Lock()

        def swap(self, model):
            with model._upload_lock:
                with self._lock:
                    pass
"""
_UPLOAD_ORDER = """
    LOCK_ORDER = (
        ("InferenceModel._upload_lock", "ServingEngine._lock"),
    )
"""

# name -> (select, {file: source}, registry source or None, check on the
# (pass, file, line, message) findings)
CASES = {
    "blocking_set_result_under_rec_lock": ("blocking-under-lock", {
        "b.py": """
            import threading

            class Batcher:
                def __init__(self):
                    self._rec_lock = threading.Lock()
                    self._records = []

                def harvest(self, group, scores):
                    with self._rec_lock:
                        self._records.append(len(group))
                        for i, r in enumerate(group):
                            r.future.set_result(scores[i])
        """}, None, lambda f: len(f) == 1
        and "Future.set_result" in f[0][3] and "_rec_lock" in f[0][3]),
    "blocking_unbounded_waits_not_condition_wait": ("blocking-under-lock", {
        "u.py": """
            import threading

            class Pump:
                def __init__(self):
                    self._cv = threading.Condition()
                    self._q = None
                    self._t = None

                def run_ok(self):
                    with self._cv:
                        while self._q is None:
                            self._cv.wait()          # sanctioned

                def run_bad(self, fut):
                    with self._cv:
                        item = self._q.get()         # unbounded
                        self._t.join()               # unbounded
                        return fut.result(), item    # unbounded
        """}, None, lambda f: sorted(x[3].split(" inside")[0] for x in f)
        == [".get() without timeout", ".join() without timeout",
            ".result() without timeout"]),
    "blocking_outside_lock_is_clean": ("blocking-under-lock", {
        "ok.py": """
            import threading

            class Batcher:
                def __init__(self):
                    self._rec_lock = threading.Lock()
                    self._records = []

                def harvest(self, group, scores):
                    with self._rec_lock:
                        self._records.append(len(group))
                    for i, r in enumerate(group):
                        r.future.set_result(scores[i])
        """}, None, lambda f: f == []),
    "lock_order_undeclared_nesting": ("lock-order", {
        "eng.py": _TWO_LOCK_CLASSES}, None, lambda f: len(f) == 1
        and "undeclared lock nesting" in f[0][3]
        and "InferenceModel._upload_lock" in f[0][3]),
    "lock_order_declared_nesting_is_clean": ("lock-order", {
        "eng.py": _TWO_LOCK_CLASSES}, _UPLOAD_ORDER, lambda f: f == []),
    "lock_order_inverted_upload_engine_nesting": ("lock-order", {
        "eng.py": """
            import threading

            class InferenceModel:
                def __init__(self):
                    self._upload_lock = threading.Lock()

            class ServingEngine:
                def __init__(self):
                    self._lock = threading.Lock()

                def bad_swap(self, model):
                    with self._lock:
                        with model._upload_lock:
                            pass
        """}, _UPLOAD_ORDER, lambda f: len(f) == 1
        and "INVERTED" in f[0][3]),
    "lock_order_through_resolvable_calls": ("lock-order", {
        "call.py": """
            import threading

            class Engine:
                def __init__(self):
                    self._lock = threading.Lock()

                def model(self, name):
                    with self._lock:
                        return name

            class Batcher:
                def __init__(self):
                    self._cv = threading.Condition()
                    self._engine = Engine()

                def dispatch(self, name):
                    with self._cv:
                        return self._engine.model(name)
        """}, None, lambda f: len(f) == 1 and "Batcher._cv" in f[0][3]
        and "Engine._lock" in f[0][3]
        and "call to Engine.model" in f[0][3]),
    "lock_order_reacquire_nonreentrant": ("lock-order", {
        "re.py": """
            import threading

            class A:
                def __init__(self):
                    self._lock = threading.Lock()
                    self._rlock = threading.RLock()

                def bad(self):
                    with self._lock:
                        with self._lock:
                            pass

                def fine(self):
                    with self._rlock:
                        with self._rlock:
                            pass
        """}, None, lambda f: len(f) == 1 and "self-deadlock" in f[0][3]),
    "lock_order_registry_unknown_lock": ("lock-order", {
        "code.py": """
            def f():
                return 1
        """}, """
            LOCK_ORDER = (
                ("Ghost._lock", "AlsoGhost._lock"),
            )
        """, lambda f: "unknown lock 'Ghost._lock'" in str(f)
        and "unknown lock 'AlsoGhost._lock'" in str(f)),
    "lock_order_registry_cycle": ("lock-order", {
        "code.py": """
            import threading

            class A:
                def __init__(self):
                    self._lock = threading.Lock()

            class B:
                def __init__(self):
                    self._lock = threading.Lock()
        """}, """
            LOCK_ORDER = (
                ("A._lock", "B._lock"),
                ("B._lock", "A._lock"),
            )
        """, lambda f: any("cycle" in x[3] for x in f)),
    "lock_order_honors_waiver": ("lock-order", {
        "w.py": """
            import threading

            class A:
                def __init__(self):
                    self._outer = threading.Lock()
                    self._inner = threading.Lock()

                def f(self):
                    with self._outer:
                        # lint: ok(lock-order) — fixture: deliberate nesting
                        with self._inner:
                            pass
        """}, None, lambda f: f == []),
    "thread_shared_mutation_seeded_race": ("thread-shared-mutation", {
        "race.py": """
            import threading

            class Worker:
                def __init__(self):
                    self._lock = threading.Lock()
                    self._count = 0
                    threading.Thread(target=self._run, daemon=True).start()

                def _run(self):
                    self._count += 1

                def bump(self):
                    with self._lock:
                        self._count += 1
        """}, None, lambda f: len(f) == 1 and "self._count" in f[0][3]
        and "Worker._run" in f[0][3]),
    "thread_shared_mutation_both_locked_is_clean": (
        "thread-shared-mutation", {"ok.py": """
            import threading

            class Worker:
                def __init__(self):
                    self._lock = threading.Lock()
                    self._count = 0
                    threading.Thread(target=self._run, daemon=True).start()

                def _run(self):
                    with self._lock:
                        self._count += 1

                def bump(self):
                    with self._lock:
                        self._count += 1
        """}, None, lambda f: f == []),
    "thread_shared_mutation_waiver_and_init_exempt": (
        "thread-shared-mutation", {"w.py": """
            import threading

            class Worker:
                def __init__(self):
                    self._state = 0     # pre-thread: exempt
                    threading.Thread(target=self._run, daemon=True).start()

                def _run(self):
                    # lint: ok(thread-shared-mutation) — reset() is only
                    # called after join() in this fixture's lifecycle
                    self._state = 1

                def reset(self):
                    # lint: ok(thread-shared-mutation) — only called after
                    # join(), same lifecycle contract as _run above
                    self._state = 0
        """}, None, lambda f: f == []),
    "thread_shared_mutation_every_unlocked_site": (
        "thread-shared-mutation", {"two.py": """
            import threading

            class Worker:
                def __init__(self):
                    threading.Thread(target=self._run, daemon=True).start()

                def _run(self):
                    # lint: ok(thread-shared-mutation) — fixture: waived site
                    self._state = 1

                def reset(self):
                    self._state = 0
        """}, None, lambda f: len(f) == 1 and "reset" in f[0][3]),
    "thread_shared_mutation_pool_submit_is_an_entry": (
        "thread-shared-mutation", {"pool.py": """
            from concurrent.futures import ThreadPoolExecutor

            class Feeder:
                def __init__(self):
                    self.pool = ThreadPoolExecutor(2)
                    self._mode = None

                def schedule(self, it):
                    return self.pool.submit(self._build, it)

                def _build(self, it):
                    self._mode = "fused"
                    return it

                def retune(self):
                    self._mode = "classic"
        """}, None, lambda f: len(f) == 2
        and all("self._mode" in x[3] for x in f)),
}


def _write(root, name, src):
    path = os.path.join(root, name)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(textwrap.dedent(src))
    return path


def _findings(pkg, root, select, files, registry):
    """(pass, file under root, line, message) of one package's run, with
    the JAX spellings the port does not carry mapped to the port's."""
    os.makedirs(root, exist_ok=True)
    if registry is not None:
        _write(root, REGISTRY[pkg], registry)
    paths = [_write(root, name, src) for name, src in files.items()]
    out = []
    for f in LINTS[pkg].run_lint(paths=paths, select=[select], root=root):
        msg = _JAX_ROUND.sub("", f.message).replace(REGISTRY["jax"],
                                                      REGISTRY["port"])
        rel = os.path.relpath(f.path, root).replace(REGISTRY["jax"],
                                                    REGISTRY["port"])
        out.append((f.pass_name, rel, f.line, msg))
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_jax_fixture_case_gives_the_jax_findings(tmp_path, case):
    select, files, registry, check = CASES[case]
    jax = _findings("jax", str(tmp_path / "jax"), select, files, registry)
    port = _findings("port", str(tmp_path / "port"), select, files,
                     registry)
    assert port == jax
    assert check(port), port


# ---------------------------------------------------------------------------
# the port's own blocking kinds

_PLANTED = {
    ".cpu()": "x.cpu()",
    ".item()": "x.item()",
    ".tolist()": "x.tolist()",
    ".numpy()": "x.numpy()",
    "torch.cuda.synchronize": "torch.cuda.synchronize()",
    ".synchronize()": "self._done.synchronize()",
    "np.asarray": "np.asarray(x)",
    "np.array": "np.array(x)",
    "time.sleep": "time.sleep(0.1)",
    "Future.set_exception": "fut.set_exception(RuntimeError())",
    ".wait() without timeout": "self._event.wait()",
}


def _planted_src(call, locked):
    body = (f"        with self._lock:\n            return {call}\n"
            if locked else
            f"        with self._lock:\n            pass\n"
            f"        return {call}\n")
    return ("import threading\nimport time\n\nimport numpy as np\n"
            "import torch\n\n\nclass Model:\n    def __init__(self):\n"
            "        self._lock = threading.Lock()\n"
            "        self._done = None\n        self._event = None\n\n"
            "    def run(self, x, fut):\n" + body)


@pytest.mark.parametrize("kind", sorted(_PLANTED))
def test_a_planted_blocking_call_under_a_lock_is_found(tmp_path, kind):
    path = _write(str(tmp_path), "m.py", _planted_src(_PLANTED[kind], True))
    found = port_lint.run_lint(paths=[path], select=["blocking-under-lock"],
                               root=str(tmp_path))
    assert len(found) == 1, found
    assert found[0].message.startswith(f"{kind} inside a held lock span "
                                       "(Model._lock)")
    assert found[0].line == 16
    clean = _write(str(tmp_path), "ok.py",
                   _planted_src(_PLANTED[kind], False))
    assert port_lint.run_lint(paths=[clean],
                              select=["blocking-under-lock"],
                              root=str(tmp_path)) == []


def test_bounded_and_constant_calls_are_not_blocking(tmp_path):
    path = _write(str(tmp_path), "ok.py", """
        import threading

        import numpy as np

        class Model:
            def __init__(self):
                self._lock = threading.Lock()

            def run(self, t, q, ev, fut):
                with self._lock:
                    a = np.asarray(3)             # a constant
                    t.join(timeout=1.0)           # bounded
                    q.get(timeout=1.0)
                    ev.wait(1.0)
                    b = fut.result(timeout=2.0)
                    c = t.cpu(memory_format=None)  # not the sync spelling
                    return a, b, c
    """)
    assert port_lint.run_lint(paths=[path], select=["blocking-under-lock"],
                              root=str(tmp_path)) == []


def test_the_swap_journal_under_the_run_lock_shape_is_found(tmp_path):
    """The engine's repaired shape: a rejected swap journaled (which takes
    the journal's module lock) while the run lock is held is an
    undeclared nesting."""
    path = _write(str(tmp_path), "eng.py", """
        import threading

        _RUN_MANIFEST_LOCK = threading.Lock()

        def write_run_manifest(doc):
            with _RUN_MANIFEST_LOCK:
                return doc

        class BucketedForward:
            def __init__(self):
                self._run_lock = threading.RLock()

        class ServingEngine:
            def __init__(self):
                self.fwd = BucketedForward()

            def swap(self):
                with self.fwd._run_lock:
                    write_run_manifest({"reason": "swap_rejected"})
    """)
    found = port_lint.run_lint(paths=[path], select=["lock-order"],
                               root=str(tmp_path))
    assert len(found) == 1
    assert "BucketedForward._run_lock held while acquiring " \
        "eng._RUN_MANIFEST_LOCK" in found[0].message


# ---------------------------------------------------------------------------
# the port's tree

def test_the_ports_tree_is_clean_under_the_concurrency_passes():
    found = port_lint.run_lint(select=list(PASSES), root=_ROOT)
    assert found == [], [f.format(_ROOT) for f in found]


def test_the_declared_order_names_the_ports_locks():
    """Every LOCK_ORDER and ATTR_TYPES entry resolves in the port's tree,
    and the fleet's and the engine's edges are declared."""
    from caffe_mpi_tpu_torch.serving import locks
    model = concurrency.tree_model([], _ROOT)
    ids = {a for pair in locks.LOCK_ORDER for a in pair}
    assert ids <= set(model.locks), ids - set(model.locks)
    for pair in (("FleetRouter._swap_lock", "FleetRouter._lock"),
                 ("InferenceModel._upload_lock", "ServingEngine._lock"),
                 ("Batcher._cv", "ServingEngine._lock")):
        assert pair in locks.LOCK_ORDER
    assert ("ServingEngine._lock", "InferenceModel._upload_lock") \
        not in locks.LOCK_ORDER
    closed = model.reachable()
    assert not any(a in closed.get(a, ()) for a in closed)  # acyclic


def test_the_registered_passes_and_the_cli(tmp_path):
    port_lint._load_passes()
    for name in PASSES:
        assert name in port_lint.REGISTRY
    _write(str(tmp_path), "bad.py", """
        import threading

        class A:
            def __init__(self):
                self._a = threading.Lock()
                self._b = threading.Lock()

            def f(self):
                with self._a:
                    with self._b:
                        pass
    """)
    code = ("import sys\n"
            "sys.modules['torch'] = sys.modules['jax'] = None\n"
            "from caffe_mpi_tpu_torch.tools.lint import main\n"
            "sys.exit(main(sys.argv[1:]))\n")
    proc = subprocess.run(
        [sys.executable, "-c", code, "--select", "lock-order",
         str(tmp_path / "bad.py")], cwd=_ROOT, capture_output=True,
        text=True, timeout=120, env=dict(os.environ, PYTHONPATH=_ROOT))
    assert proc.returncode == 1, proc.stderr
    assert "undeclared lock nesting: A._a held while acquiring A._b" \
        in proc.stdout
