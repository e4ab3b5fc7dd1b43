"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

Each kernel source under `caffe_mpi_tpu_torch/csrc/` has a plain C
interface. At first use it is compiled with nvcc for `sm_90a` into a shared
library under `caffe_mpi_tpu_torch/_build/` (listed in .gitignore), in a
directory keyed by a hash of the source and the flags, and loaded with
ctypes. Nothing is built when a module is imported, and nothing here falls
back: a missing nvcc or a failed build raises.

    python -m caffe_mpi_tpu_torch.ops.build      # build every kernel now
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

# every kernel source of the port; chip_smoke.py builds them all at once
SOURCES = ("lrn.cu", "flash_attention.cu")

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found (neither on PATH nor under "
                       "$CUDA_HOME/bin): the port's CUDA kernels cannot be "
                       "built")


def _lib_path(source: str) -> str:
    with open(os.path.join(CSRC_DIR, source), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"{stem}-{digest.hexdigest()[:16]}",
                        f"lib{stem}.so")


def build(source: str) -> tuple[str, float]:
    """Compile `csrc/<source>` unless its hashed library exists; returns
    (library path, seconds spent compiling — 0.0 when it was already
    built). A file lock serializes concurrent builds of one source."""
    out = _lib_path(source)
    if os.path.isfile(out):
        return out, 0.0
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.isfile(out):
            return out, 0.0
        tmp = out + f".tmp{os.getpid()}"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC_DIR, source)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {source} (exit {proc.returncode}):\n"
                f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
        return out, time.perf_counter() - t0


def load(source: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<source>`, built on first use."""
    with _LOCK:
        lib = _LIBS.get(source)
        if lib is None:
            path, _ = build(source)
            lib = ctypes.CDLL(path)
            _LIBS[source] = lib
        return lib


def build_all() -> dict[str, float]:
    """Build every kernel source in parallel (one nvcc each); returns
    {source: compile seconds}."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=len(SOURCES)) as ex:
        futs = {s: ex.submit(build, s) for s in SOURCES}
        return {s: f.result()[1] for s, f in futs.items()}


if __name__ == "__main__":
    for src, secs in build_all().items():
        print(f"{src}: {_lib_path(src)} ({secs:.1f} s)")
