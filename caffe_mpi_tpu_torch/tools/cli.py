"""caffe CLI for the port — train, serve.

Reference: tools/caffe.cpp; JAX package caffe_mpi_tpu/tools/cli.py
(`cmd_train`, `_synthetic_feed`, `cmd_serve`, `_serve_smoke`).

`train` runs a solver prototxt. The port has no data plane yet, so it
trains nets fed through Input layers on `-synthetic` data drawn as the JAX
CLI draws it: a numpy RandomState(seed) in the net's feed order, token
ids in [0, input_dim) for a blob an Embed consumes, class ids in [0, 10)
for the label bottom of a classification loss or accuracy, normals for
the other blobs; seed 0 for the train net, 1 for the test nets. Each feed
is uploaded to the device once and reused every iteration. At the end it
prints one JSON line {"train": {...}}: the loss and wall time of every
iteration, their median and images (batch items) per second.

`serve` has no HTTP front yet: `-smoke N` drives N synthetic requests
through the engine and prints its telemetry as one JSON line.

The JAX CLI's flags for solver and serving fields the port does not
honour yet (`-precision`, `-step_chunk`, `-serve_dtype`, ...: one flag a
field of the Solver's and the engine's UNPORTED_FIELDS) are accepted and
land on their parameter, which the Solver or the engine refuses at any
value but its default; the command then exits 1.

Usage (gflags-compatible single-dash long flags accepted):
    python -m caffe_mpi_tpu_torch.tools.cli train -solver solver.prototxt -synthetic [-max_iter N] [-test_iter T] [-snapshot_prefix P] [-weights w.caffemodel | -snapshot s.solverstate] [-device cuda|cpu]
    python -m caffe_mpi_tpu_torch.tools.cli serve -model deploy.prototxt [-weights w.caffemodel] -smoke N [-serve_buckets 1,4,10] [-serve_window_ms W] [-serve_queue_limit Q] [-device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys

import numpy as np

log = logging.getLogger("caffe")


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="caffe", description=__doc__)
    p.add_argument("command", choices=["train", "serve"])
    p.add_argument("-solver", "--solver", default="",
                   help="solver prototxt (train)")
    p.add_argument("-synthetic", "--synthetic", action="store_true",
                   help="train on random data shaped from the net's Input "
                   "layers")
    p.add_argument("-max_iter", "--max-iter", dest="max_iter", type=int,
                   default=0, help="override the solver's max_iter")
    p.add_argument("-test_iter", "--test-iter", dest="test_iter", type=int,
                   default=0, help="override the solver's test_iter")
    p.add_argument("-snapshot_prefix", "--snapshot-prefix",
                   dest="snapshot_prefix", default="",
                   help="override the solver's snapshot_prefix")
    p.add_argument("-snapshot", "--snapshot", default="",
                   help=".solverstate to resume from (train)")
    p.add_argument("-model", "--model", default="",
                   help="deploy net prototxt")
    p.add_argument("-weights", "--weights", default="",
                   help=".caffemodel to load (default: weights drawn from "
                   "a torch.Generator: seed 0 for serve, the solver's "
                   "random_seed for train)")
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
                   help="device to run on (default: cuda; 'cpu' runs "
                   "on the CPU)")
    for param, table in _unported():
        for name, item in table:
            default = getattr(param(), name)
            kind = dict(action="store_const", const=True) \
                if isinstance(default, bool) else dict(type=type(default))
            p.add_argument(f"-{name}", f"--{name.replace('_', '-')}",
                           dest=name, default=None, **kind,
                           help=f"{param.__name__}.{name}: not ported yet "
                           f"(ROADMAP.md §1 item {item}); any value but "
                           f"{default!r} is refused")
    return p


def _unported():
    """(parameter class, its UNPORTED_FIELDS) for the solver and serving."""
    from ..proto.config import ServingParameter, SolverParameter
    from ..serving import engine
    from ..solver import solver
    return ((SolverParameter, solver.UNPORTED_FIELDS),
            (ServingParameter, engine.UNPORTED_FIELDS))


def _apply_unported(args, param) -> None:
    """The unported fields' flags that were given, onto `param`."""
    for cls, table in _unported():
        if isinstance(param, cls):
            for name, _ in table:
                if getattr(args, name) is not None:
                    setattr(param, name, getattr(args, name))


# layer types whose second bottom is a class id (the JAX package's
# utils/model_shapes.py _CLASSIFICATION_CONSUMERS)
_CLASSIFICATION_CONSUMERS = frozenset((
    "SoftmaxWithLoss", "Accuracy", "MultinomialLogisticLoss",
    "InfogainLoss", "HingeLoss",
))


def synthetic_feed(net, seed: int = 0) -> dict:
    """Random feeds shaped from the net's Input layers, on the net's
    device, drawn as the JAX CLI's `_synthetic_feed` draws them: integer
    feeds are chosen by consumer, not by blob name."""
    import torch
    from ..layers.data_layers import InputLayerBase
    r = np.random.RandomState(seed)
    int_range: dict[str, int] = {}
    for layer in net.layers:
        lp = layer.lp
        if lp.type == "Embed" and lp.bottom:
            int_range[lp.bottom[0]] = lp.embed_param.input_dim
        elif lp.type in _CLASSIFICATION_CONSUMERS and len(lp.bottom) > 1:
            int_range.setdefault(lp.bottom[1], 10)
    feeds = {}
    for layer in net.layers:
        if not isinstance(layer, InputLayerBase):
            continue
        for key, shape, _kind in layer.feed_specs():
            if key in int_range:
                a = r.randint(0, max(int_range[key], 1), shape)
            else:
                a = r.randn(*shape).astype(np.float32)
            feeds[key] = torch.from_numpy(a).to(net.device)
    return feeds


def train(args):
    """Build the solver from `args`, resume or load weights, train to
    max_iter with a test pass at every test_interval and at the end, and
    snapshot after training. Returns (solver, summary dict)."""
    from ..proto import SolverParameter
    from ..solver import Solver
    if not args.solver:
        raise ValueError("train requires -solver")
    if not args.synthetic:
        raise ValueError("the port has no data plane yet: pass -synthetic "
                         "to train on random data")
    sp = SolverParameter.from_file(args.solver)
    if args.max_iter:
        sp.max_iter = args.max_iter
    if args.test_iter:
        sp.test_iter = [args.test_iter] * max(len(sp.test_iter), 1)
    if args.snapshot_prefix:
        sp.snapshot_prefix = args.snapshot_prefix
    _apply_unported(args, sp)
    # net paths in the solver are relative to the working directory, as
    # the reference's are; an inline or missing one resolves beside the
    # solver file
    model_dir = "" if (sp.net and os.path.exists(sp.net)) \
        else os.path.dirname(os.path.abspath(args.solver))
    solver = Solver(sp, model_dir=model_dir, device=args.device)
    if args.snapshot:
        solver.restore(args.snapshot)
    elif args.weights:
        for w in args.weights.split(","):
            solver.load_weights(w)
    feeds = synthetic_feed(solver.net)
    test_feed_fns = None
    if solver.test_nets:
        test_feed_fns = []
        for tnet in solver.test_nets:
            tfeeds = synthetic_feed(tnet, seed=1)
            test_feed_fns.append(lambda it, tfeeds=tfeeds: tfeeds)
    start = solver.iter
    solver.step(sp.max_iter - solver.iter, lambda it: feeds, test_feed_fns)
    scores = None
    if test_feed_fns and sp.test_interval:
        # final evaluation, as the JAX CLI runs it after the last iteration
        scores = solver.test_all(test_feed_fns)
    snapshot = None
    if sp.snapshot_prefix and solver.should_snapshot_after_train():
        snapshot = solver.snapshot()
    batch = solver._batch_images() * max(sp.iter_size, 1)
    med = float(np.median(solver.iter_ms)) if solver.iter_ms \
        else float("nan")
    summary = {
        "solver": args.solver, "device": str(solver.device),
        "start_iter": start, "iters": solver.iter - start, "batch": batch,
        "losses": list(solver.losses), "iter_ms": list(solver.iter_ms),
        "median_iter_ms": med,
        "img_per_s": batch / (med / 1e3), "test_scores": scores,
        "snapshot": snapshot,
    }
    return solver, summary


def cmd_train(args) -> int:
    try:
        _, summary = train(args)
    except (ValueError, NotImplementedError) as e:
        log.error("%s", e)
        return 1
    print(json.dumps({"train": summary}))
    losses = summary["losses"]
    if not losses or not all(np.isfinite(losses)):
        log.error("train: losses not all finite: %s", losses)
        return 1
    return 0


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
    _apply_unported(args, sp)
    try:
        engine = ServingEngine(sp, device=args.device)
    except (ValueError, NotImplementedError) as e:
        log.error("%s", e)
        return 1
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


def parse_args(argv=None) -> argparse.Namespace:
    return _parser().parse_args(argv)


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    args = parse_args(argv)
    return {"train": cmd_train, "serve": cmd_serve}[args.command](args)


if __name__ == "__main__":
    sys.exit(main())
