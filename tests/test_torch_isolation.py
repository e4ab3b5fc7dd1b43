"""The port stands alone: caffe_mpi_tpu_torch, chip_smoke.py,
flash_variants.py, resnet_variants.py, feed_variants.py and
mkl_first_call.py import no JAX and nothing of the JAX package, and entry
points never carry on quietly on the CPU.

The package name `caffe_mpi_tpu_torch` starts with `caffe_mpi_tpu`, so the
scan matches module names exactly (`caffe_mpi_tpu`, or the prefix
`caffe_mpi_tpu.`), never with a bare startswith.
"""

import ast
import os
import subprocess
import sys

import pytest
import torch

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PKG = os.path.join(_ROOT, "caffe_mpi_tpu_torch")
_FORBIDDEN = ("jax", "jaxlib", "caffe_mpi_tpu")


def _port_files():
    out = [os.path.join(_ROOT, f) for f in ("chip_smoke.py",
                                            "flash_variants.py",
                                            "resnet_variants.py",
                                            "feed_variants.py",
                                            "mkl_first_call.py",
                                            "step_variants.py")]
    for dirpath, dirnames, files in os.walk(_PKG):
        dirnames[:] = [d for d in dirnames if d not in ("__pycache__",
                                                        "_build")]
        out += [os.path.join(dirpath, f) for f in sorted(files)
                if f.endswith(".py")]
    return out


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in _FORBIDDEN)


@pytest.mark.parametrize("name,bad", [
    ("jax", True), ("jax.numpy", True), ("caffe_mpi_tpu", True),
    ("caffe_mpi_tpu.proto.config", True), ("caffe_mpi_tpu_torch", False),
    ("caffe_mpi_tpu_torch.net", False), ("jaxtyping", False),
])
def test_matcher_is_exact(name, bad):
    assert _forbidden(name) is bad


def test_ast_scan_finds_no_jax_or_reference_package_import():
    files = _port_files()
    assert len(files) > 20
    found = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            found += [(os.path.relpath(path, _ROOT), node.lineno, n)
                      for n in names if _forbidden(n)]
    assert found == []


def test_parallel_package_is_scanned():
    """The data-parallel package is among the files the scan reads (and
    the poisoned import below walks): it imports torch.distributed, never
    jax or the JAX package's parallel modules."""
    files = {os.path.relpath(p, _PKG) for p in _port_files()}
    assert {os.path.join("parallel", f) for f in
            ("__init__.py", "mesh.py", "reduction.py")} <= files


_POISONED_PARALLEL = r"""
import sys
for name in ("jax", "jaxlib", "caffe_mpi_tpu"):
    sys.modules[name] = None
from caffe_mpi_tpu_torch.parallel import MeshPlan, mesh, reduction
plan = MeshPlan.from_shape(1, devices=["cpu"])
print(plan.backend, reduction.__name__)
"""


def test_parallel_imports_and_forms_a_group_with_jax_poisoned():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", _POISONED_PARALLEL],
                          cwd=_ROOT, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "gloo" in proc.stdout and "reduction" in proc.stdout


_POISONED_IMPORT = r"""
import importlib, importlib.util, pkgutil, sys
for name in ("jax", "jaxlib", "caffe_mpi_tpu"):
    sys.modules[name] = None  # any import of them raises ImportError
import caffe_mpi_tpu_torch
mods = ["caffe_mpi_tpu_torch"]
for info in pkgutil.walk_packages(caffe_mpi_tpu_torch.__path__,
                                  "caffe_mpi_tpu_torch."):
    importlib.import_module(info.name)
    mods.append(info.name)
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = [m for m, mod in sys.modules.items() if mod is not None
       and (m in ("jax", "caffe_mpi_tpu") or m.startswith("jax.")
            or m.startswith("caffe_mpi_tpu."))]
assert not bad, bad
print(len(mods))
"""


def test_every_module_and_chip_smoke_import_with_jax_poisoned():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", _POISONED_IMPORT],
                          cwd=_ROOT, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 20


def test_serving_engine_without_card_raises(monkeypatch):
    from caffe_mpi_tpu_torch.serving import ServingEngine
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        ServingEngine()
    with pytest.raises(RuntimeError, match="is_available"):
        ServingEngine(device="cuda:0")


_POISONED_SERVING = r"""
import sys
for name in ("jax", "jaxlib", "caffe_mpi_tpu"):
    sys.modules[name] = None
from caffe_mpi_tpu_torch.serving import http_front, ingest
from caffe_mpi_tpu_torch.serving.http_front import make_server
print(http_front.__name__, ingest.__name__)
"""


def test_http_front_and_ingest_import_with_jax_poisoned():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", _POISONED_SERVING],
                          cwd=_ROOT, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "http_front" in proc.stdout and "ingest" in proc.stdout


def test_make_server_and_cli_serve_without_card_raise(monkeypatch):
    from caffe_mpi_tpu_torch.serving import ServingEngine
    from caffe_mpi_tpu_torch.serving.http_front import make_server
    from caffe_mpi_tpu_torch.tools import cli
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        make_server(ServingEngine(), port=0)
    with pytest.raises(RuntimeError, match="is_available"):
        cli.main(["serve", "-model", os.path.join(
            _ROOT, "models", "alexnet", "deploy.prototxt"), "-port", "0"])


def test_chip_smoke_without_card_fails_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=_ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_flash_variants_without_card_fails_and_times_nothing():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "flash_variants.py"], cwd=_ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"case"' not in proc.stdout


def test_resnet_variants_without_card_fails_and_times_nothing():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "resnet_variants.py"],
                          cwd=_ROOT, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0
    assert '"run"' not in proc.stdout


def test_feed_variants_without_card_fails_and_times_nothing():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "feed_variants.py"], cwd=_ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"run"' not in proc.stdout


def test_step_variants_without_card_fails_and_times_nothing():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "step_variants.py"], cwd=_ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"summary"' not in proc.stdout


def test_mkl_first_call_script_runs_and_the_port_arm_holds():
    """The witness of the first-call race in MKL's vector math runs; with
    the port imported first, no thread's first call differs."""
    import json
    import shutil
    if shutil.which("c++") is None:
        pytest.skip("no c++ to build the race helper")
    proc = subprocess.run(
        [sys.executable, "mkl_first_call.py", "--procs", "2", "--burners",
         "0", "--jobs", "2"], cwd=_ROOT, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert set(out) == {"base", "port"}
    assert out["base"]["procs"] == out["port"]["procs"] == 2
    assert out["port"]["procs_differing"] == 0
