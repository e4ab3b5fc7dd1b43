#!/usr/bin/env python3
"""Show, on the CPU, the race in the first call of MKL's vector math that
PyTorch's CPU build makes, and that importing caffe_mpi_tpu_torch repairs.

    python3 mkl_first_call.py [--procs N] [--burners N] [--jobs N]

PyTorch runs `exp` and `log` of a float32 CPU tensor of more than 2,048
elements as OpenMP chunks, each a call of MKL's `vmsExp` / `vmsLn`
(statically linked into libtorch_cpu). Each child process here makes its
first `vmsExp` call from 8 threads at once (released together from a spin
on one flag, in a helper the host C++ compiler builds), then calls it
again on one thread, and counts the threads whose first result differs
from that second one. Arms:

- base: torch imported, nothing else before the threads' calls;
- port: caffe_mpi_tpu_torch imported first (its import makes one call of
  each on one thread, `caffe_mpi_tpu_torch.__init__._first_vml_calls`).

`--burners` CPU-bound processes run beside the children: the race shows
when a thread is preempted in the middle of MKL's first-call set-up, so
it needs a loaded machine. Prints one JSON line: per arm, the processes
run, those with a differing thread, and the largest relative error.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.abspath(__file__))
THREADS, N = 8, 4096
# VML_HA | VML_FTZDAZ_OFF | VML_ERRMODE_IGNORE, as ATen passes them
MODE = 0x2 | 0x140000 | 0x100

RACE_C = r'''
#include <atomic>
#include <cstdint>
#include <pthread.h>
#include <time.h>
typedef void (*vfn)(int, const float*, float*, int64_t);
static std::atomic<int> go;
struct Arg { vfn f; int n; const float* x; float* y; int64_t mode; };
static void* run(void* p) {
  Arg* a = static_cast<Arg*>(p);
  while (!go.load()) {}
  a->f(a->n, a->x, a->y, a->mode);
  return nullptr;
}
// k threads spin on one flag, then make their first call of f together
extern "C" int race(vfn f, int k, int n, const float* x, float* ys,
                    int64_t mode) {
  pthread_t th[64];
  Arg args[64];
  go.store(0);
  for (int i = 0; i < k; ++i) {
    args[i] = Arg{f, n, x, ys + static_cast<long>(i) * n, mode};
    pthread_create(&th[i], nullptr, run, &args[i]);
  }
  timespec ts{0, 20000000};
  nanosleep(&ts, nullptr);
  go.store(1);
  for (int i = 0; i < k; ++i) pthread_join(th[i], nullptr);
  return 0;
}
'''


def child(arm: str, helper: str) -> dict:
    import numpy as np
    import torch
    if arm == "port":
        sys.path.insert(0, ROOT)
        import caffe_mpi_tpu_torch  # noqa: F401
    lib = ctypes.CDLL(os.path.join(os.path.dirname(torch.__file__), "lib",
                                   "libtorch_cpu.so"))
    f = lib.vmsExp
    f.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                  ctypes.c_int64]
    x = np.random.RandomState(1).rand(N).astype(np.float32) * 10 + 2
    ys = np.empty((THREADS, N), np.float32)
    ctypes.CDLL(helper).race(
        ctypes.cast(f, ctypes.c_void_p), THREADS, N,
        ctypes.c_void_p(x.ctypes.data), ctypes.c_void_p(ys.ctypes.data),
        ctypes.c_int64(MODE))
    ref = np.empty(N, np.float32)
    f(N, x.ctypes.data, ref.ctypes.data, MODE)
    bad = (ys != ref).any(axis=1)
    return {"arm": arm, "threads_differing": int(bad.sum()),
            "max_rel_err": float(np.max(np.abs(ys - ref) / ref))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--procs", type=int, default=200,
                    help="child processes per arm")
    ap.add_argument("--burners", type=int, default=16)
    ap.add_argument("--jobs", type=int, default=16,
                    help="child processes at a time")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--helper", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        print(json.dumps(child(args.child, args.helper)), flush=True)
        return 0
    arms = ["base", "port"]
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "race.cc")
        helper = os.path.join(tmp, "librace.so")
        with open(src, "w") as fh:
            fh.write(RACE_C)
        subprocess.run(["c++", "-O2", "-shared", "-fPIC", "-o", helper, src,
                        "-lpthread"], check=True)
        burners = [subprocess.Popen([sys.executable, "-c",
                                     "while True: pass"])
                   for _ in range(args.burners)]
        results = {a: [] for a in arms}

        def run_child(arm: str) -> dict:
            out = subprocess.run(
                [sys.executable, __file__, "--child", arm, "--helper",
                 helper], stdout=subprocess.PIPE, text=True, check=True)
            return json.loads(out.stdout.strip().splitlines()[-1])

        from concurrent.futures import ThreadPoolExecutor
        try:  # the arms interleaved, `--jobs` children at a time
            with ThreadPoolExecutor(args.jobs) as ex:
                for r in ex.map(run_child, arms * args.procs):
                    results[r["arm"]].append(r)
        finally:
            for b in burners:
                b.kill()
                b.wait()
    print(json.dumps({a: {
        "procs": len(r),
        "procs_differing": sum(1 for x in r if x["threads_differing"]),
        "max_rel_err": max(x["max_rel_err"] for x in r)}
        for a, r in results.items()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
