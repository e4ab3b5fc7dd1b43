"""The port's lint passes on the CPU (caffe_mpi_tpu_torch/tools/lint/:
concrete_init, doc_drift, failure_path, gated_imports, host_sync,
knob_drift, reference_citation, traced_flow) against the JAX package's
(caffe_mpi_tpu/tools/lint/).

- The fixture cases of tests/test_lint.py, tests/test_host_sync_lint.py
  and tests/test_doc_drift.py for these passes that name no `jax` call
  run through both packages' `run_lint`, each in a root of its own (or,
  as the JAX tests run them, from outside the run root): the findings
  must be equal in pass, file, line and message. Spellings are mapped
  only where a registry differs by design: the registries' paths (the
  port's tree is caffe_mpi_tpu_torch/, its fault and knob docs
  caffe_mpi_tpu_torch/docs/robustness.md and knobs.md, its scripts'
  scope caffe_mpi_tpu_torch/tools/), the gated modules (the JAX
  package gates flask, torch and pybind11, the port h5py, triton and
  tensorstore; lmdb in both) and the prose the port's messages do not
  carry (the JAX project's review rounds and its convention file).
- The port's fixtures plant each torch shape the passes look for; each
  is found, and the same code outside its scope comes out clean.
- `--list` names every JAX pass name, and the port's whole tree is clean
  under every pass (no wall-clock budget: tests/test_lint.py's 5 s one
  is the JAX package's unsteady test).
"""

import os
import re
import textwrap

import pytest

from caffe_mpi_tpu.tools import lint as jax_lint
from caffe_mpi_tpu.tools.lint.knob_drift import KNOBS as JAX_KNOBS
from caffe_mpi_tpu_torch.tools import lint as port_lint
from caffe_mpi_tpu_torch.tools.lint import gated_imports
from caffe_mpi_tpu_torch.tools.lint.knob_drift import KNOBS

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LINTS = {"jax": jax_lint, "port": port_lint}

# JAX layout -> the port's (first match wins)
PATHS = (("caffe_mpi_tpu/", "caffe_mpi_tpu_torch/"),
         ("docs/robustness.md", "caffe_mpi_tpu_torch/docs/robustness.md"),
         ("docs/benchmarks.md", "caffe_mpi_tpu_torch/docs/knobs.md"),
         ("tools/", "caffe_mpi_tpu_torch/tools/"))
# the gated-module registries: the JAX package's -> the port's
MODULES = (("flask", "h5py"), ("torch", "triton"),
           ("pybind11", "tensorstore"))
# message prose of the JAX package -> the port's (patterns: the JAX
# messages cite the JAX project's review rounds and its convention file)
PROSE = ((r"the PR \d+ pending-forever shape", "the pending-forever shape"),
         (r"\([A-Z]+\.md environment contract\)",
          "(the card's machine, ROADMAP.md)"),
         (r"the TPU-native design choice \([A-Z]+\.md convention\)",
          "the port's design choice (the repo's convention)"),
         (r"\([A-Z]+\.md convention\); if it is TPU-native",
          "(the repo's convention); if it is port-only"))


def _port_path(rel: str) -> str:
    for a, b in PATHS:
        if rel.startswith(a):
            return b + rel[len(a):]
    return rel


def _port_src(src: str) -> str:
    for a, b in MODULES:
        src = re.sub(rf"\bimport {a}\b", f"import {b}", src)
    return src


def _port_msg(msg: str) -> str:
    msg = msg.replace("caffe_mpi_tpu/", "caffe_mpi_tpu_torch/")
    for a, b in PATHS[1:3]:
        msg = msg.replace(a, b)
    for a, b in MODULES:
        msg = msg.replace(f"`import {a}`", f"`import {b}`")
    for a, b in PROSE:
        msg = re.sub(a, b, msg)
    return msg


def _write(root, rel, src):
    path = os.path.join(root, rel)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(textwrap.dedent(src))
    return path


# -- the JAX fixtures ---------------------------------------------------------

_HOT = """
    import numpy as np

    def train(losses):
        total = 0.0
        for l in losses:
            total += float(l)
        while losses:
            x = np.asarray(losses.pop())
            y = losses[0].item()
        return total, float(total)     # outside any loop: clean
"""


def _mini_tree(extra_call="", ghost_entry=False, reg_tail=""):
    ghost = '\n    "ghost_site": "never fired",' if ghost_entry else ""
    return {
        "caffe_mpi_tpu/utils/resilience.py":
            'FAULT_SITES = {\n    "feeder_read": "reader raises once",'
            + ghost + reg_tail + "\n}\n",
        "docs/robustness.md": "Fault plane. Sites: `feeder_read`. More "
                              "prose.\n",
        "caffe_mpi_tpu/runtime.py":
            "def read(faults, i):\n    faults.fire(\"feeder_read\")\n"
            f"    {extra_call}\n    return i\n"}


def _exit_tree(doc_code=86, call="os._exit(EXIT_WATCHDOG)", drop=False):
    rows = f"| **{doc_code}** | `EXIT_WATCHDOG` | watchdog trip |\n"
    if not drop:
        rows += "| **87** | `EXIT_CLUSTER` / `EXIT_FAULT` | cluster loss |\n"
    return {
        "caffe_mpi_tpu/utils/resilience.py":
            "import os\nEXIT_WATCHDOG = 86\nEXIT_FAULT = 87\n"
            f"EXIT_CLUSTER = EXIT_FAULT\n\ndef die():\n    {call}\n",
        "docs/robustness.md": "Exit codes:\n\n| code | name | meaning |\n"
                              "|---|---|---|\n" + rows}


def _knob_tree(consume_all=True, extra=None):
    fields = "\n".join(f"    {k}: int = 0" for k in KNOBS)
    reads = [k for k in KNOBS if consume_all or k != "reduce_buckets"]
    files = {
        "caffe_mpi_tpu/proto/config.py":
            f"class SolverParameter:\n{fields}\n",
        "caffe_mpi_tpu/tools/cli.py": "FLAGS = " + repr(list(KNOBS)) + "\n",
        "docs/benchmarks.md": " ".join(f"`{k}`" for k in KNOBS) + "\n",
        "caffe_mpi_tpu/solver.py": "def f(sp):\n" + "".join(
            f"    sp.{k}\n" for k in reads) + "    return sp\n"}
    files.update(extra or {})
    return files


# name -> (select, {JAX-layout path: source}, how the run is rooted:
#          "fixture" (files outside the run root, as tests/test_lint.py
#          runs the per-file passes), "files" (the files, in their own
#          root), "tree" (the root's package dir), "empty" (paths=[]),
#          and a check on the port's (pass, file, line, message) rows)
CASES = {
    # tests/test_lint.py: host-sync
    "host_sync_seeded_bug": ("host-sync", {"hot.py": _HOT}, "fixture",
                             lambda f: len(f) == 3),
    "host_sync_waiver_and_legacy": ("host-sync", {"waived.py": """
        import numpy as np

        def display(window):
            for l in window:
                s = float(l)  # lint: ok(host-sync) — display boundary
                v = np.asarray(l)  # host-sync: ok (legacy spelling)
    """}, "fixture", lambda f: f == []),
    "host_sync_scope_aware": ("host-sync", {"scopes.py": """
        import numpy as np

        def build(schedule, blobs):
            cbs = []
            for s in schedule:
                def cb(v):
                    return float(v)        # def-time: not in the loop
                cbs.append(cb)
            for row in np.asarray(blobs):  # iterable: evaluated once
                pass
            def worker(vals):
                return [v.item() for v in vals]   # still a real loop
            return cbs, worker
    """}, "fixture", lambda f: [x[2] for x in f] == [13]),
    "host_sync_comprehension_as_iterable": ("host-sync", {"itercomp.py": """
        def drain(losses):
            total = 0.0
            for l in [float(x) for x in losses]:
                total += l
            for l in sum(v.item() for v in losses):   # nested in call
                total += l
            return total
    """}, "fixture", lambda f: len(f) == 2),
    "syntax_error_surfaced": ("host-sync", {"broken.py": "def oops(:\n"},
                              "fixture", lambda f: f[0][0] == "syntax"),
    "misspelled_waiver": ("host-sync", {"typo.py": """
        def f(xs):
            out = []
            for x in xs:
                out.append(float(x))  # lint: ok(host-sink) — oops
            return out
    """}, "fixture", lambda f: sorted(x[0] for x in f)
        == ["bad-waiver", "host-sync"]),
    "waiver_for_another_pass": ("host-sync", {"wrongpass.py": """
        def f(xs):
            out = []
            for x in xs:
                out.append(float(x))  # lint: ok(gated-imports) — wrong
            return out
    """}, "fixture", lambda f: [x[0] for x in f] == ["host-sync"]),
    "waiver_inside_a_string": ("host-sync", {"quoted.py": """
        def f(losses):
            out = []
            for l in losses:
                out.append(("use # lint: ok(host-sync) to waive",
                            float(l)))
            return out
    """}, "fixture", lambda f: len(f) == 1),
    "trailing_waiver_does_not_leak": ("host-sync", {"leak.py": """
        import numpy as np

        def f(ls, ms):
            out = []
            for l, m in zip(ls, ms):
                a = float(l)  # lint: ok(host-sync) — boundary
                b = np.asarray(m)
                out.append((a, b))
            return out
    """}, "fixture", lambda f: [x[2] for x in f] == [8]),
    "multi_pass_waiver": ("host-sync", {"multi.py": """
        def f(xs):
            out = []
            for x in xs:
                # lint: ok(host-sync, traced-control-flow) — host floats
                out.append(float(x))
            return out
    """}, "fixture", lambda f: f == []),
    # tests/test_host_sync_lint.py's fixtures, through run_lint
    "host_sync_lint_comprehensions": ("host-sync", {"comp.py": """
        import numpy as np

        def gather(losses):
            a = [float(l) for l in losses]           # flagged
            b = sum(l.item() for l in losses)        # flagged
            c = {k: np.asarray(v) for k, v in losses}  # flagged
            return a, b, c, float(len(a))            # once: clean
    """}, "fixture", lambda f: len(f) == 3),
    "host_sync_lint_legacy_waivers": ("host-sync", {"waived.py": """
        import numpy as np

        def display(window):
            for l in window:
                s = float(l)  # host-sync: ok (display boundary)
                # host-sync: ok — already a host ndarray
                v = np.asarray(l)
    """}, "fixture", lambda f: f == []),
    "host_sync_lint_multiline": ("host-sync", {"multiline.py": """
        def log_line(log, window, rate):
            while window:
                log.info("loss = %.6g lr = %.6g",  # host-sync: ok
                         float(window.pop()),
                         float(rate))
    """}, "fixture", lambda f: f == []),
    # gated-imports
    "gated_imports_seeded_bug": ("gated-imports", {"db.py": """
        import lmdb

        def open_db(path):
            return lmdb.open(path)
    """}, "fixture", lambda f: len(f) == 1 and f[0][2] == 2),
    "gated_imports_gate_waiver_tests": ("gated-imports", {"gated.py": """
        try:
            import lmdb
        except ImportError:
            lmdb = None

        import flask  # lint: ok(gated-imports) — demo-only module

        def ready():
            return lmdb is not None
    """, "tests/test_oracle.py": """
        import torch

        def test_x():
            assert torch is not None
    """}, "fixture", lambda f: f == []),
    "gated_imports_type_checking_else": ("gated-imports", {"tc.py": """
        from typing import TYPE_CHECKING

        if TYPE_CHECKING:
            import lmdb          # never runs: gated
        else:
            import flask         # ALWAYS runs: must be flagged

        def f():
            return 0
    """}, "fixture", lambda f: len(f) == 1 and "h5py" in f[0][3]),
    "gated_imports_handler_and_finally": ("gated-imports", {"tp.py": """
        try:
            import lmdb                  # gated: fine
        except ImportError:
            import torch                 # NOT protected: flagged
        finally:
            import flask                 # NOT protected: flagged

        def f():
            return 0
    """}, "fixture", lambda f: [x[2] for x in f] == [5, 7]),
    # reference-citation
    "reference_citation_seeded_bug": ("reference-citation", {"mod.py": '''
        """A module docstring that cites nothing."""

        def f():
            return 1
    '''}, "fixture", lambda f: len(f) == 1 and f[0][2] == 2),
    "reference_citation_waiver_citation_trivial": ("reference-citation", {
        "native.py": '''
        # lint: ok(reference-citation) — no reference analogue
        """A genuinely new subsystem."""

        def f():
            return 1
    ''', "cited.py": '''
        """Replaces src/caffe/solver.cpp:187-351 with a fused step.

        Brace-group citations like src/caffe/layers/{relu,elu}_layer.{cpp,cu}
        count too.
        """

        def f():
            return 1
    ''', "__init__.py": """
        from os import path
        X = 1
    """}, "fixture", lambda f: f == []),
    # doc-drift (tests/test_lint.py and tests/test_doc_drift.py)
    "doc_drift_undocumented_call_site": (
        "doc-drift", _mini_tree('faults.fire("surprise_site")'), "tree",
        lambda f: len(f) == 1 and "surprise_site" in f[0][3]),
    "doc_drift_dead_registry_entry": (
        "doc-drift", _mini_tree(ghost_entry=True), "tree",
        lambda f: any("ghost_site" in x[3] for x in f)),
    "doc_drift_waiver": ("doc-drift", _mini_tree(
        'faults.fire("surprise_site")  # lint: ok(doc-drift) — staged'),
        "tree", lambda f: f == []),
    "doc_drift_registry_waiver_tree": ("doc-drift", _mini_tree(
        ghost_entry=True, reg_tail="  # lint: ok(doc-drift) — next"),
        "tree", lambda f: f == []),
    "doc_drift_registry_waiver_empty": ("doc-drift", _mini_tree(
        ghost_entry=True, reg_tail="  # lint: ok(doc-drift) — next"),
        "empty", lambda f: f == []),
    "doc_drift_clean_tree": ("doc-drift", _mini_tree(), "tree",
                             lambda f: f == []),
    "doc_drift_waiver_on_empty_selection": ("doc-drift", _mini_tree(
        'faults.fire("surprise_site")  # lint: ok(doc-drift) — staged'),
        "empty", lambda f: f == []),
    "doc_drift_finding_on_empty_selection": ("doc-drift", _mini_tree(
        'faults.fire("surprise_site")'), "empty",
        lambda f: len(f) == 1 and "surprise_site" in f[0][3]),
    "doc_drift_multiline_waiver": ("doc-drift", _mini_tree(
        'faults.fire("surprise_site",\n        0)  '
        "# lint: ok(doc-drift) — staged rollout"), "empty",
        lambda f: f == []),
    "doc_drift_unrelated_trailing_waiver": ("doc-drift", _mini_tree(
        "x = 1  # lint: ok(doc-drift) — unrelated\n"
        '    faults.fire("surprise_site")'), "tree",
        lambda f: len(f) == 1 and "surprise_site" in f[0][3]),
    "doc_drift_wrapped_call_site": ("doc-drift", _mini_tree(
        'faults.fire(\n        "surprise_site")'), "empty",
        lambda f: len(f) == 1 and "surprise_site" in f[0][3]),
    "exit_drift_clean": ("doc-drift", _exit_tree(), "empty",
                         lambda f: f == []),
    "exit_drift_docs_code_mismatch": ("doc-drift", _exit_tree(doc_code=96),
                                      "empty", lambda f: any(
                                          "EXIT_WATCHDOG" in x[3]
                                          and "96" in x[3] for x in f)),
    "exit_drift_bare_literal": ("doc-drift", _exit_tree(call="os._exit(86)"),
                                "empty", lambda f: len(f) == 1
                                and "bare literal exit 86" in f[0][3]),
    "exit_drift_unregistered_symbol": (
        "doc-drift", _exit_tree(call="os._exit(EXIT_BOGUS)"), "empty",
        lambda f: len(f) == 1 and "EXIT_BOGUS" in f[0][3]),
    "exit_drift_missing_docs_entry": ("doc-drift", _exit_tree(drop=True),
                                      "empty", lambda f: any(
                                          "EXIT_FAULT" in x[3] for x in f)),
    "exit_drift_bare_literal_waived": ("doc-drift", _exit_tree(
        call="os._exit(86)  # lint: ok(doc-drift) — pre-registry shim"),
        "empty", lambda f: f == []),
    "exit_drift_waiver_block_above": ("doc-drift", {
        "caffe_mpi_tpu/utils/resilience.py": """
            import os
            EXIT_WATCHDOG = 86

            def die():
                # lint: ok(doc-drift) — pre-registry shim kept for one
                # release so old supervisors keep matching on the number
                os._exit(86)
        """, "docs/robustness.md": """
            | **86** | `EXIT_WATCHDOG` | watchdog trip |
        """}, "empty", lambda f: f == []),
    # knob-drift
    "knob_drift_clean": ("knob-drift", _knob_tree(), "tree",
                         lambda f: f == []),
    "knob_drift_accepted_but_ignored": (
        "knob-drift", _knob_tree(consume_all=False), "tree",
        lambda f: len(f) == 1 and "reduce_buckets" in f[0][3]
        and "IGNORED" in f[0][3]),
    "knob_drift_write_is_not_consumption": ("knob-drift", _knob_tree(
        consume_all=False, extra={"caffe_mpi_tpu/plumbing.py":
                                  "def f(sp, v):\n    sp.reduce_buckets = v\n"}),
        "tree", lambda f: len(f) == 1 and "reduce_buckets" in f[0][3]),
    "knob_drift_registry_docstring_not_consumption": ("knob-drift",
        _knob_tree(consume_all=False, extra={
            "caffe_mpi_tpu/tools/lint/registry.py":
                "KNOBS = ('reduce_buckets',)\n",
            "caffe_mpi_tpu/docmention.py":
                '"""module that merely talks about reduce_buckets"""\n'}),
        "tree", lambda f: len(f) == 1 and "reduce_buckets" in f[0][3]),
    "knob_drift_getattr_is_consumption": ("knob-drift", _knob_tree(
        consume_all=False, extra={"caffe_mpi_tpu/reader.py":
                                  "def f(sp):\n    return getattr(sp, "
                                  "'reduce_buckets', 0)\n"}),
        "tree", lambda f: f == []),
    # future-resolution
    "future_create_then_raise": ("future-resolution", {
        "caffe_mpi_tpu/serving/batching.py": """
        from concurrent.futures import Future

        class Batcher:
            def submit(self, item, closed, backlog, limit):
                fut = Future()
                if closed:
                    raise RuntimeError("engine closed")
                if backlog > limit:
                    raise RuntimeError("shed")
                self._queue.append((item, fut))
                return fut
    """}, "files", lambda f: len(f) == 1 and "'fut'" in f[0][3]),
    "future_created_after_admission": ("future-resolution", {
        "caffe_mpi_tpu/serving/batching.py": """
        from concurrent.futures import Future

        class Batcher:
            def submit(self, item, closed, backlog, limit):
                if closed:
                    raise RuntimeError("engine closed")
                if backlog > limit:
                    raise RuntimeError("shed")
                fut = Future()
                self._queue.append((item, fut))
                return fut
    """}, "files", lambda f: f == []),
    "future_resolved_on_error_path": ("future-resolution", {
        "caffe_mpi_tpu/serving/batching.py": """
        from concurrent.futures import Future

        class Batcher:
            def submit(self, item):
                fut = Future()
                try:
                    self._enqueue(item, fut)
                except Exception as e:
                    fut.set_exception(e)
                    raise
                return fut
    """}, "files", lambda f: f == []),
    "future_out_of_scope": ("future-resolution", {
        "caffe_mpi_tpu/data/feeder.py": """
        from concurrent.futures import Future

        def stage(closed):
            fut = Future()
            if closed:
                raise RuntimeError("closed")
            return fut
    """}, "files", lambda f: f == []),
    "future_waiver": ("future-resolution", {
        "caffe_mpi_tpu/serving/batching.py": """
        from concurrent.futures import Future

        class Batcher:
            def submit(self, item, closed):
                fut = Future()
                if closed:
                    # lint: ok(future-resolution) — fixture: ownership
                    # is provably elsewhere in this contrived shape
                    raise RuntimeError("closed")
                self._queue.append(fut)
                return fut
    """}, "files", lambda f: f == []),
    # typed-failure
    "typed_log_and_continue": ("typed-failure", {
        "caffe_mpi_tpu/solver/loop.py": """
        import logging
        log = logging.getLogger(__name__)

        def step(net):
            try:
                net.dispatch()
            except Exception:
                log.warning("dispatch failed")
    """}, "files", lambda f: len(f) == 1 and "UNTYPED" in f[0][3]),
    "typed_bare_except_pass": ("typed-failure", {
        "caffe_mpi_tpu/serving/router.py": """
        def route(req, engine):
            try:
                return engine.submit(req)
            except:
                pass
    """}, "files", lambda f: len(f) == 1 and "bare except" in f[0][3]),
    "typed_reraise_and_journal": ("typed-failure", {
        "caffe_mpi_tpu/serving/router.py": """
        def route(req, engine):
            try:
                return engine.submit(req)
            except Exception as e:
                engine.journal("route_failed", error=str(e))

        def close(engine):
            try:
                engine.drain()
            except Exception:
                raise
    """}, "files", lambda f: f == []),
    "typed_future_with_error": ("typed-failure", {
        "caffe_mpi_tpu/serving/router.py": """
        def route(req, fut, engine):
            try:
                fut.set_result(engine.submit(req))
            except Exception as e:
                fut.set_exception(e)
    """}, "files", lambda f: f == []),
    "typed_out_of_scope": ("typed-failure", {
        "caffe_mpi_tpu/data/reader.py": """
        def read(db):
            try:
                return db.get()
            except Exception:
                return None
    """}, "files", lambda f: f == []),
    "typed_waiver": ("typed-failure", {
        "caffe_mpi_tpu/parallel/mesh_fx.py": """
        def teardown(svc):
            try:
                svc.shutdown()
            # lint: ok(typed-failure) — fixture: already-down IS the
            # goal state of a teardown
            except Exception:
                pass
    """}, "files", lambda f: f == []),
    # thread-crash
    "thread_unguarded_target": ("thread-crash", {
        "caffe_mpi_tpu/serving/monitor.py": """
        import threading

        class Monitor:
            def start(self):
                threading.Thread(target=self._loop,
                                 daemon=True).start()

            def _loop(self):
                while True:
                    self.poll()
    """}, "files", lambda f: len(f) == 1 and "_loop" in f[0][3]),
    "thread_guarded_target": ("thread-crash", {
        "caffe_mpi_tpu/serving/monitor.py": """
        import threading

        class Monitor:
            def start(self):
                threading.Thread(target=self._loop,
                                 daemon=True).start()

            def _loop(self):
                try:
                    while True:
                        self.poll()
                except Exception as e:
                    self.journal("monitor_crash", error=str(e))
    """}, "files", lambda f: f == []),
    "thread_dispatcher_via_local_tuple": ("thread-crash", {
        "caffe_mpi_tpu/serving/batching.py": """
        import threading

        class Batcher:
            def ensure_threads(self):
                specs = [("dispatch", self._dispatch_loop),
                         ("harvest", self._harvest_loop)]
                for name, target in specs:
                    t = threading.Thread(target=target, name=name,
                                         daemon=True)
                    t.start()

            def _dispatch_loop(self):
                while not self._closed:
                    self._dispatch_once()

            def _harvest_loop(self):
                try:
                    while not self._closed:
                        self._harvest_once()
                except Exception as e:
                    self._journal("harvest_crash", error=str(e))
    """}, "files", lambda f: len(f) == 1 and "_dispatch_loop" in f[0][3]),
    "thread_discarded_pool_submit": ("thread-crash", {
        "caffe_mpi_tpu/serving/workers.py": """
        def fan_out(pool, records):
            for r in records:
                pool.submit(_render, r)

        def fan_out_kept(pool, records):
            futs = [pool.submit(_render, r) for r in records]
            return futs

        def _render(r):
            return r.decode()
    """}, "files", lambda f: len(f) == 1
        and "discards its future" in f[0][3]),
    "thread_waiver": ("thread-crash", {
        "caffe_mpi_tpu/serving/beat.py": """
        import threading

        class Beat:
            def start(self):
                threading.Thread(target=self._loop,
                                 daemon=True).start()

            # lint: ok(thread-crash) — fixture: a dead beat IS the
            # failure signal; the supervisor mourns the silence
            def _loop(self):
                while True:
                    self.publish()
    """}, "files", lambda f: f == []),
    # deadline-discipline
    "deadline_unbounded_subprocess_and_result": ("deadline-discipline", {
        "tools/probe.py": """
        import subprocess

        def probe(cmd, fut):
            subprocess.run(cmd, capture_output=True)
            return fut.result()
    """}, "files", lambda f: len(f) == 2),
    "deadline_bounded_calls": ("deadline-discipline", {
        "tools/probe.py": """
        import subprocess

        def probe(cmd, fut):
            subprocess.run(cmd, capture_output=True, timeout=60)
            return fut.result(timeout=30)
    """}, "files", lambda f: f == []),
    "deadline_module_level_call": ("deadline-discipline", {
        "tools/smoke.py": """
        import subprocess

        r = subprocess.run(["python", "-c", "pass"],
                           capture_output=True)
    """}, "files", lambda f: len(f) == 1 and "subprocess.run" in f[0][3]),
    "deadline_out_of_scope": ("deadline-discipline", {
        "caffe_mpi_tpu/data/prefetch.py": """
        def drain(q):
            return q.get()
    """}, "files", lambda f: f == []),
    "deadline_waiver": ("deadline-discipline", {
        "caffe_mpi_tpu/serving/batching.py": """
        def harvest(q):
            while True:
                # lint: ok(deadline-discipline) — fixture: sentinel-
                # woken idle park; close() enqueues None
                item = q.get()
                if item is None:
                    return
    """}, "files", lambda f: f == []),
}


def _findings(pkg, root, select, files, mode):
    """(pass, file, line, message) of one package's run over the case's
    files in `root` (the port's spelled as the port's tree has them),
    with the JAX spellings mapped to the port's."""
    port = pkg == "port"
    paths = [_write(root, _port_path(rel) if port else rel,
                    _port_src(src) if port else src)
             for rel, src in files.items()]
    run_root = _ROOT if mode == "fixture" else root
    if mode == "tree":
        paths = [os.path.join(root, "caffe_mpi_tpu_torch" if port
                              else "caffe_mpi_tpu")]
    elif mode == "empty":
        paths = []
    out = []
    for f in LINTS[pkg].run_lint(paths=paths, select=[select],
                                 root=run_root):
        rel = os.path.relpath(f.path, root)
        msg = f.message
        if not port:
            rel, msg = _port_path(rel), _port_msg(msg)
        out.append((f.pass_name, rel, f.line, msg))
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_jax_fixture_case_gives_the_jax_findings(tmp_path, case):
    select, files, mode, check = CASES[case]
    jax = _findings("jax", str(tmp_path / "jax"), select, files, mode)
    port = _findings("port", str(tmp_path / "port"), select, files, mode)
    assert port == jax
    assert check(port), port


def test_the_knob_registry_is_the_jax_one():
    assert KNOBS == JAX_KNOBS


# -- the port's own shapes ---------------------------------------------------

def _port_run(tmp_path, select, files, paths=None):
    written = [_write(str(tmp_path), rel, src) for rel, src in files.items()]
    return port_lint.run_lint(paths=written if paths is None else paths,
                              select=[select], root=str(tmp_path))


_SYNCS = {".cpu()": "x.cpu()", ".tolist()": "x.tolist()",
          ".numpy()": "x.numpy()", "int": "int(x.sum())",
          "bool": "bool((x > 0).any())",
          "torch.cuda.synchronize": "torch.cuda.synchronize()"}


@pytest.mark.parametrize("kind", sorted(_SYNCS))
def test_host_sync_finds_a_torch_sync_in_a_loop(tmp_path, kind):
    call = _SYNCS[kind]
    src = f"""
        import torch

        def step(xs):
            for x in xs:
                y = {call}
            x = xs[0]
            return {call}, int(len(xs)), bool(xs)
    """
    got = _port_run(tmp_path, "host-sync",
                    {"caffe_mpi_tpu_torch/hot.py": src})
    assert [(f.line, f.detail) for f in got] == [(6, kind)]
    # chip_smoke.py is the card check: outside the pass's scope
    assert _port_run(tmp_path, "host-sync", {"chip_smoke.py": src}) == []


@pytest.mark.parametrize("src,bad", [
    ("import jax\n", True),
    ("import jax.numpy as jnp\n", True),
    ("from caffe_mpi_tpu.proto import NetParameter\n", True),
    ("try:\n    import caffe_mpi_tpu\nexcept ImportError:\n    pass\n", True),
    ("import h5py\n", True),
    ("try:\n    import h5py\nexcept ImportError:\n    h5py = None\n", False),
    ("import caffe_mpi_tpu_torch\nfrom ..proto import x\n", False),
    ("import torch\nimport numpy\n", False),
])
def test_gated_imports_finds_jax_and_ungated_modules(tmp_path, src, bad):
    got = _port_run(tmp_path, "gated-imports",
                    {"caffe_mpi_tpu_torch/mod.py": src})
    assert bool(got) == bad, got
    # the tests import both packages
    assert _port_run(tmp_path, "gated-imports",
                     {"tests/test_mod.py": src}) == []


def test_gated_imports_names_the_modules_the_card_may_lack():
    assert gated_imports.GATED_MODULES == {"h5py", "tensorstore", "triton",
                                           "lmdb"}


_CAPTURED = """
import torch

class Runner:
    def _graph_of(self, fn):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fn()
        return graph

    def capture(self, x):
        return self._graph_of(lambda: self._iteration(x))

    def _iteration(self, x):
{method}

    def host_only(self, x):
{method}

def bucket(model, x):
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        y = forward(model, x)
    return g, y

def forward(model, x):
{func}

def eager(model, x):
{func}
"""


def _captured(body: str) -> str:
    """_CAPTURED with `body` (lines at no indent) as each function's."""
    return _CAPTURED.format(method=textwrap.indent(body, " " * 8),
                            func=textwrap.indent(body, " " * 4))


@pytest.mark.parametrize("body,what", [
    ("if x.sum() > 0:\n    x = x + 1\nreturn x", "Python `if`"),
    ("while bool(torch.isfinite(x).all()):\n    x = x / 2\nreturn x",
     "Python `while`"),
    ("return x if (x > 0).any() else -x", "ternary `if`"),
    ("n = int(x.argmax())\nreturn x[n]", "`int()`"),
])
def test_traced_flow_finds_a_branch_on_a_card_value(tmp_path, body, what):
    src = _captured(body)
    got = _port_run(tmp_path, "traced-control-flow",
                    {"caffe_mpi_tpu_torch/run.py": src})
    lines = src.split("\n")
    # _iteration (through the wrapper's lambda) and forward (called
    # under the capture) are captured; host_only and eager are not
    funcs = sorted({_enclosing(lines, f.line) for f in got})
    assert funcs == ["_iteration", "forward"], funcs
    assert all(what in f.message for f in got)


def _enclosing(lines, line):
    for ln in range(line - 1, -1, -1):
        m = re.match(r"\s*def (\w+)", lines[ln])
        if m:
            return m.group(1)
    return None


def test_traced_flow_ignores_metadata_and_host_values(tmp_path):
    src = _captured("if torch.cuda.is_current_stream_capturing() and "
                    "x.dim() > 1:\n    return x\nreturn -x")
    assert _port_run(tmp_path, "traced-control-flow",
                     {"caffe_mpi_tpu_torch/run.py": src}) == []


@pytest.mark.parametrize("expr,bad", [
    # the card refuses the copy; a fill kernel captures (the lint phase's
    # probe), so only the copy is flagged
    ("torch.where(x > 0, x, torch.zeros((), device=x.device))", False),
    ("x * torch.tensor(2.0, device=x.device)", True),
    ("x.clamp(min=torch.tensor(-1.0, device=x.device))", True),
    ("torch.where(x > 0, x, 0.0)", False),
    ("x * torch.tensor(2.0)", False),
    ("x * torch.ones(3, device=x.device)", False),
])
def test_concrete_init_finds_a_zero_d_card_tensor_in_a_slot(tmp_path, expr,
                                                            bad):
    src = _captured(f"return {expr}")
    got = _port_run(tmp_path, "concrete-init",
                    {"caffe_mpi_tpu_torch/run.py": src})
    lines = src.split("\n")
    assert sorted({_enclosing(lines, f.line) for f in got}) == (
        ["_iteration", "forward"] if bad else [])
    # a 0-d constructor on a line of its own is an allocation: clean
    alloc = _captured("z = torch.tensor(2.0, device=x.device)\n"
                      "return x * z")
    assert _port_run(tmp_path, "concrete-init",
                     {"caffe_mpi_tpu_torch/alloc.py": alloc}) == []


def test_reference_citation_scope_is_the_ports_tree(tmp_path):
    bare = '"""Cites nothing."""\n\ndef f():\n    return 1\n'
    cited = ('"""Port of caffe_mpi_tpu/solver/solver.py:418."""\n\n'
             "def f():\n    return 1\n")
    got = _port_run(tmp_path, "reference-citation",
                    {"caffe_mpi_tpu_torch/a.py": bare,
                     "caffe_mpi_tpu_torch/b.py": cited,
                     "scripts/c.py": bare})
    assert [os.path.relpath(f.path, tmp_path) for f in got] == [
        os.path.join("caffe_mpi_tpu_torch", "a.py")]


def test_doc_drift_reads_the_ports_registry_doc_and_chip_smoke(tmp_path):
    files = {
        "caffe_mpi_tpu_torch/utils/resilience.py":
            'FAULT_SITES = {\n    "feeder_read": "reader raises once",\n'
            '    "replica_dead": "a replica dies",\n}\n',
        "caffe_mpi_tpu_torch/docs/robustness.md":
            "Sites: `feeder_read`, `replica_dead`.\n",
        "caffe_mpi_tpu_torch/data/read.py":
            'def read(faults):\n    faults.fire("feeder_read")\n'}
    got = _port_run(tmp_path, "doc-drift", files, paths=[])
    assert ["replica_dead" in f.message and "no call site" in f.message
            for f in got] == [True]
    # chip_smoke.py's call sites are in the scan
    _write(str(tmp_path), "chip_smoke.py",
           'def kill(faults):\n    faults.fire("replica_dead")\n')
    assert port_lint.run_lint(paths=[], select=["doc-drift"],
                              root=str(tmp_path)) == []


_REFUSING = """
UNPORTED_FIELDS = (("reduce_buckets", 2),)


def refuse(sp):
    refuse_unported(sp, UNPORTED_FIELDS, "solver")
"""


@pytest.mark.parametrize("name,files,flagged", [
    ("a refusal table a module reads",
     {"caffe_mpi_tpu/engine.py": _REFUSING}, False),
    ("a table nothing reads",
     {"caffe_mpi_tpu/engine.py":
      'UNPORTED_FIELDS = (("reduce_buckets", 2),)\n'}, True),
    ("a read table in the CLI plumbing",
     {"caffe_mpi_tpu/tools/cli.py":
      "FLAGS = " + repr(list(KNOBS)) + "\n" + _REFUSING}, True),
    ("a table of another name",
     {"caffe_mpi_tpu/engine.py": _REFUSING.replace("UNPORTED_FIELDS",
                                                   "REFUSED")}, True),
])
def test_knob_drift_counts_a_refusal_and_no_more(tmp_path, name, files,
                                                 flagged):
    """A field the port refuses (a row of a module-level UNPORTED_* table
    that the module reads) is consumed; the count does not hide a knob
    that nothing reads."""
    tree = {_port_path(rel): src for rel, src in
            _knob_tree(consume_all=False, extra=files).items()}
    got = _port_run(tmp_path, "knob-drift", tree,
                    paths=[str(tmp_path / "caffe_mpi_tpu_torch")])
    assert [("reduce_buckets" in f.message and "IGNORED" in f.message)
            for f in got] == ([True] if flagged else []), name


def test_deadline_discipline_scope_holds_chip_smoke(tmp_path):
    src = "import subprocess\n\nsubprocess.run(['true'])\n"
    got = _port_run(tmp_path, "deadline-discipline", {"chip_smoke.py": src})
    assert len(got) == 1 and "subprocess.run" in got[0].message
    assert _port_run(tmp_path / "out", "deadline-discipline",
                     {"caffe_mpi_tpu_torch/data/x.py": src}) == []


# -- the registry, the CLI and the port's tree --------------------------------

def test_list_names_every_jax_pass(capsys):
    jax_lint._load_passes()
    assert port_lint.main(["--list"]) == 0
    listed = [l.split()[0] for l in capsys.readouterr().out.split("\n")
              if l]
    assert listed == sorted(jax_lint.REGISTRY)


def test_the_ports_tree_is_clean_under_every_pass(capsys):
    assert port_lint.main([]) == 0, capsys.readouterr().out
