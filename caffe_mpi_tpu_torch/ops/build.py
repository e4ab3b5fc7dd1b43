"""Build and load the port's native sources (compiler -> shared library ->
ctypes).

Each source under `caffe_mpi_tpu_torch/csrc/` has a plain C interface. At
first use it is compiled into a shared library under
`caffe_mpi_tpu_torch/_build/` (listed in .gitignore), in a directory keyed
by a hash of the source and the flags, and loaded with ctypes: a CUDA
kernel source (`.cu`) with nvcc for `sm_90a`, a host source (`.cc`) with
the host C++ compiler. `native` is the one library of several host
sources: the data plane's LMDB and datumfile readers, batch transform and
image decode (`csrc/native/`, bound by `caffe_mpi_tpu_torch/native`),
built with `-pthread` and, where the compiler finds libjpeg's and
libpng's headers, linked against both; where it does not, the decode
entry points are built as stubs that report "unavailable"
(`-DCAFFE_TPU_NO_CODEC`) and the record decode stays on PIL. Nothing is
built when a module is imported, and nothing here falls back: a missing
compiler or a failed build raises.

    python -m caffe_mpi_tpu_torch.ops.build      # build every source now
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
CXX_FLAGS = ("-std=c++17", "-O3", "-shared", "-fPIC")

# the host library of the data plane: its sources, and the headers they
# include (both hashed into its build key)
NATIVE = "native"
NATIVE_SOURCES = ("native/transform.cc", "native/datumdb.cc",
                  "native/lmdb_reader.cc", "native/decode.cc",
                  "native/philox_aug.cc")
NATIVE_HEADERS = ("native/transform_core.h", "native/datum_wire.h")
CODEC_HEADERS = ("jpeglib.h", "png.h")
CODEC_LIBS = ("-ljpeg", "-lpng")

# every source of the port: the kernels and the data plane's library;
# chip_smoke.py builds them all at once
SOURCES = ("lrn.cu", "flash_attention.cu", NATIVE)

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


def cxx_path() -> str:
    for name in ("c++", "g++"):
        cand = shutil.which(name)
        if cand:
            return cand
    raise RuntimeError("no host C++ compiler (c++ or g++) on PATH: the "
                       "port's host sources cannot be built")


_CODEC: dict[str, bool] | None = None


def codec_probe() -> dict[str, bool]:
    """{header: whether the host C++ compiler finds it and links its
    library}, for libjpeg's and libpng's headers; probed once a process
    by compiling an include of each."""
    global _CODEC
    if _CODEC is None:
        found = {}
        for header, lib in zip(CODEC_HEADERS, CODEC_LIBS):
            prog = ("#include <cstddef>\n#include <cstdio>\n"
                    f"#include <{header}>\nint main() {{ return 0; }}\n")
            proc = subprocess.run(
                [cxx_path(), "-x", "c++", "-", "-o", os.devnull, lib],
                input=prog, capture_output=True, text=True, timeout=120)
            found[header] = proc.returncode == 0
        _CODEC = found
    return dict(_CODEC)


def codec_built() -> bool:
    """Whether the native library is built with the codecs."""
    return all(codec_probe().values())


def _flags(source: str) -> tuple[str, ...]:
    if source == NATIVE:
        return CXX_FLAGS + ("-pthread",) + (
            () if codec_built() else ("-DCAFFE_TPU_NO_CODEC",))
    return NVCC_FLAGS if source.endswith(".cu") else CXX_FLAGS


def _link(source: str) -> tuple[str, ...]:
    return CODEC_LIBS if source == NATIVE and codec_built() else ()


def _inputs(source: str) -> tuple[str, ...]:
    """The files under csrc/ that make `source`'s library."""
    return NATIVE_SOURCES if source == NATIVE else (source,)


def _lib_path(source: str) -> str:
    digest = hashlib.sha256()
    files = _inputs(source) + (NATIVE_HEADERS if source == NATIVE else ())
    for name in files:
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            digest.update(f.read())
    digest.update(" ".join(_flags(source) + _link(source)).encode())
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
        compiler = nvcc_path() if source.endswith(".cu") else cxx_path()
        cmd = [compiler, *_flags(source), "-o", tmp,
               *(os.path.join(CSRC_DIR, f) for f in _inputs(source)),
               *_link(source)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(
                f"{os.path.basename(compiler)} failed on {source} "
                f"(exit {proc.returncode}):\n"
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
    """Build every source in parallel (one compiler each); returns
    {source: compile seconds}."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=len(SOURCES)) as ex:
        futs = {s: ex.submit(build, s) for s in SOURCES}
        return {s: f.result()[1] for s, f in futs.items()}


if __name__ == "__main__":
    for src, secs in build_all().items():
        print(f"{src}: {_lib_path(src)} ({secs:.1f} s)")
