#!/usr/bin/env python3
"""Time CaffeNet's training step from an LMDB on one NVIDIA card under
variants of the port's host feed (caffe_mpi_tpu_torch/data/feeder.py):
the number of Feeder threads, and the transform on the host in place of
the card's.

    python3 feed_variants.py [--iters N] [--warm N] [--configs t1,t2]
                             [--pairs N]

It writes the LMDBs of chip_smoke.py's lmdb phase (1,280 raw 3x256x256
Datums from seeded clusters, a 100-record val LMDB, their mean) under
TMPDIR, builds only what CaffeNet needs (the kernels of lrn.cu and the
native data-plane library), and runs the port's Solver on a copy of
examples/imagenet/caffenet_solver.prototxt (batch 256, crop 227, mirror,
mean file; no test pass) whose train Data layer sets `threads`: `--warm`
iterations, then `--iters` more through a DeviceFeed, and reports the
median step (host wall time to the loss read back, as the CLI's `train`
reports it), img/s at the median step and over the whole window (every
step counted, stalls included) and the Feeder's median build ms.
Configurations (`--configs`, default all), each run in `--pairs` mirrored
pairs (default 1) so drift shows as the gap between a configuration's
runs:

- t1, t2, t4, t8: 1, 2, 4 or 8 Feeder threads, the device transform on;
- auto: `threads: 0`, the default: auto mode (feeder.auto_threads(),
  min(cpu_count, 8) workers, and the lookahead retuned at run time);
- host_t4, host_auto: 4 threads or auto mode with `use_gpu_transform:
  false`, the transform on the host (the native batch transform; float32
  batches, four times the bytes to upload);
- jpeg_t2, jpeg_t4, jpeg_t8, jpeg_auto: 2, 4 or 8 threads or `threads:
  0` over a 256-record JPEG-encoded LMDB of the same clusters (the native
  decode where the library has the codecs, one PIL decode a record where
  not; there `threads: 0` pins feeder.ENCODED_THREADS, as jpeg_t8);
  jpeg_host_auto: `threads: 0` with the transform on the host;
- synthetic: the same solver on one synthetic batch (no host feed), the
  step the feed is held against.

One JSON line a run on stdout, then a summary line (each configuration's
median steps and window rates, run by run) and the card's name and power
limit. Fails (exit 1) on a non-finite loss or without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402

THREADS = {"t1": 1, "t2": 2, "t4": 4, "t8": 8, "auto": 0, "host_t4": 4,
           "host_auto": 0, "jpeg_t2": 2, "jpeg_t4": 4, "jpeg_t8": 8,
           "jpeg_auto": 0, "jpeg_host_auto": 0}
CONFIGS = ("synthetic", *THREADS)


def _solver(tmp: str, files: tuple, name: str):
    """The Solver on a copy of the CaffeNet solver and net for `name`."""
    from caffe_mpi_tpu_torch.proto import SolverParameter
    from caffe_mpi_tpu_torch.solver import Solver
    train_db, jpeg_db, val_db, mean = files
    net, solver = cs._caffenet_copy(
        tmp, jpeg_db if name.startswith("jpeg") else train_db, val_db,
        mean, name)
    with open(net) as f:
        text = f.read()
    threads = THREADS.get(name, 4)  # synthetic: no Feeder runs
    train = "batch_size: 256 backend: LMDB"
    if train not in text:
        cs.fail(f"{cs.CAFFENET} no longer says {train!r}")
    text = text.replace(train, f"{train} threads: {threads}")
    if "host" in name:
        text = text.replace("mirror: true", "mirror: true "
                            "use_gpu_transform: false", 1)
    with open(net, "w") as f:
        f.write(text)
    sp = SolverParameter.from_file(solver)
    sp.test_iter, sp.test_interval, sp.display, sp.snapshot = [], 0, 0, 0
    return Solver(sp, device="cuda")


def run(tmp: str, files: tuple, name: str, warm: int, iters: int) -> dict:
    from caffe_mpi_tpu_torch.data.feeder import DeviceFeed
    from caffe_mpi_tpu_torch.tools import cli
    solver = _solver(tmp, files, name)
    data = solver.net.layers[0]
    feeder = None
    if name == "synthetic":
        feeds = cli.synthetic_feed(solver.net)
        feed = lambda it: feeds  # noqa: E731
    else:
        feeder = cli.build_feeder(solver.net, "TRAIN")
        feed = DeviceFeed(feeder, solver.device)
    try:
        solver.step(warm, feed)
        torch.cuda.synchronize()
        solver.step(iters, feed)
    finally:
        if feeder is not None:
            feed.close()
    steps = solver.iter_ms[warm:]
    if not np.all(np.isfinite(solver.losses)):
        cs.fail(f"{name}: losses not all finite: {solver.losses}")
    med = float(np.median(steps))
    return {"run": name, "median_step_ms": med,
            "img_per_s": cs.CAFFENET_BATCH / (med / 1e3),
            "window_img_per_s": cli.window_img_per_s(cs.CAFFENET_BATCH,
                                                     steps),
            "step_ms": steps,
            "device_transform": bool(data.dev_transform),
            "feed_threads": None if feeder is None else feeder.threads,
            "feed_lookahead": None if feeder is None else feeder.lookahead,
            "feed_ms_per_batch": None if feeder is None
            else feeder.feed_ms_per_batch()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--warm", type=int, default=5)
    ap.add_argument("--configs", default=",".join(CONFIGS),
                    help="comma-separated subset of " + ",".join(CONFIGS))
    ap.add_argument("--pairs", type=int, default=1,
                    help="mirrored pairs of runs of each configuration")
    args = ap.parse_args(argv)
    configs = tuple(args.configs.split(","))
    if not set(configs) <= set(CONFIGS):
        ap.error(f"--configs: unknown {set(configs) - set(CONFIGS)}")
    runs = (configs + configs[::-1]) * args.pairs
    card, _ = cs.device_phase()
    from concurrent.futures import ThreadPoolExecutor

    from caffe_mpi_tpu_torch.ops import build
    with ThreadPoolExecutor(2) as ex:
        list(ex.map(build.build, ("lrn.cu", build.NATIVE)))
    from caffe_mpi_tpu_torch.tools import compute_image_mean
    tmp = tempfile.mkdtemp(prefix="feed_variants_")
    try:
        train_db = os.path.join(tmp, "train_lmdb")
        val_db = os.path.join(tmp, "val_lmdb")
        jpeg_db = os.path.join(tmp, "jpeg_lmdb")
        cs._write_clusters(train_db, cs.LMDB_TRAIN, seed=7)
        cs._write_clusters(val_db, cs.LMDB_VAL, seed=100_000)
        cs._write_clusters(jpeg_db, cs.LMDB_JPEG, seed=7, codec="jpeg")
        mean = os.path.join(tmp, "mean.binaryproto")
        import contextlib
        with contextlib.redirect_stdout(sys.stderr):
            compute_image_mean.main([train_db, mean])
        files = (train_db, jpeg_db, val_db, mean)
        results = []
        for name in runs:
            out = run(tmp, files, name, args.warm, args.iters)
            print(json.dumps(out), flush=True)
            results.append(out)
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    summary = {key: {name: [r[key] for r in results if r["run"] == name]
                     for name in configs}
               for key in ("median_step_ms", "window_img_per_s")}
    print(json.dumps({"summary": summary, "card": card}), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
