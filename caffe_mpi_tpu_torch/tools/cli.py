"""caffe CLI for the port — serve.

Reference: tools/caffe.cpp; JAX package caffe_mpi_tpu/tools/cli.py
(`cmd_serve`, `_serve_smoke`). The port has the `serve` command only so
far, without the HTTP front: `-smoke N` drives N synthetic requests through
the engine and prints its telemetry as one JSON line.

Usage (gflags-compatible single-dash long flags accepted):
    python -m caffe_mpi_tpu_torch.tools.cli serve -model deploy.prototxt [-weights w.caffemodel] -smoke N [-serve_buckets 1,4,10] [-serve_window_ms W] [-serve_queue_limit Q] [-device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import logging
import sys

import numpy as np

log = logging.getLogger("caffe")


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="caffe", description=__doc__)
    p.add_argument("command", choices=["serve"])
    p.add_argument("-model", "--model", default="",
                   help="deploy net prototxt")
    p.add_argument("-weights", "--weights", default="",
                   help=".caffemodel to load (default: weights drawn from "
                   "torch.Generator seed 0)")
    p.add_argument("-serve_window_ms", "--serve-window-ms",
                   dest="serve_window_ms", type=float, default=-1.0,
                   help="batching window in ms (default: the "
                   "ServingParameter default)")
    p.add_argument("-serve_buckets", "--serve-buckets", dest="serve_buckets",
                   default="", help="explicit bucket ladder, e.g. '1,4,10'")
    p.add_argument("-serve_queue_limit", "--serve-queue-limit",
                   dest="serve_queue_limit", type=int, default=-1,
                   help="bound on the request backlog; over-limit submits "
                   "are shed (0 = unbounded)")
    p.add_argument("-smoke", "--smoke", type=int, default=0,
                   help="fire N synthetic requests through the engine, print "
                   "its stats as JSON and exit (the port has no HTTP front "
                   "yet, so serve needs -smoke)")
    p.add_argument("-device", "--device", default="cuda",
                   help="device to serve on (default: cuda; 'cpu' runs "
                   "on the CPU)")
    return p


def cmd_serve(args) -> int:
    """Load the deploy net into a ServingEngine — weights on the device,
    every padded batch bucket warmed — and run the smoke path."""
    from ..proto.config import ServingParameter
    from ..serving import ServingEngine
    if not args.model:
        log.error("serve requires -model (a deploy prototxt)")
        return 1
    if args.smoke <= 0:
        log.error("serve requires -smoke N: the port has no HTTP front yet")
        return 1
    sp = ServingParameter()
    if args.serve_window_ms >= 0:
        sp.serve_window_ms = args.serve_window_ms
    if args.serve_buckets:
        sp.serve_buckets = args.serve_buckets
    if args.serve_queue_limit >= 0:
        sp.serve_queue_limit = args.serve_queue_limit
    engine = ServingEngine(sp, device=args.device)
    try:
        engine.load_model("default", args.model, args.weights or None)
        return _serve_smoke(args, engine)
    finally:
        engine.close()


def _serve_smoke(args, engine) -> int:
    """`serve -smoke N`: fire N synthetic requests in mixed-size bursts,
    drain, print the stats and check that every request resolved."""
    model = engine.model("default")
    shape = model.fwd.input_shape()
    rng = np.random.RandomState(0)
    if len(shape) == 4:
        c, h, w = shape[1], shape[2], shape[3]

        def synth():  # HWC at the net's own input size (no resize)
            return rng.rand(h, w, c).astype(np.float32)
    else:
        def synth():  # non-image input: one row, preprocess reshapes
            return rng.rand(*shape[1:]).astype(np.float32)
    left = args.smoke
    rows = 0
    while left > 0:
        burst = min(int(rng.randint(1, model.fwd.ladder[-1] + 1)), left)
        out = engine.classify("default", [synth() for _ in range(burst)])
        if out.shape[0] != burst or not np.all(np.isfinite(out)):
            log.error("serve smoke: bad scores %s for a burst of %d",
                      out.shape, burst)
            return 1
        rows += burst
        left -= burst
    engine.drain()
    stats = engine.stats()
    print(json.dumps({"serve_smoke": stats}))
    if stats["requests"] != rows or \
            stats["warmed_buckets"] != len(model.fwd.ladder):
        log.error("serve smoke: %d of %d requests recorded, %d of %d "
                  "buckets warmed", stats["requests"], rows,
                  stats["warmed_buckets"], len(model.fwd.ladder))
        return 1
    return 0


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    args = _parser().parse_args(argv)
    return {"serve": cmd_serve}[args.command](args)


if __name__ == "__main__":
    sys.exit(main())
