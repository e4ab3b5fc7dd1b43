"""caffe CLI for the port — train, test, time, device_query, serve.

Reference: tools/caffe.cpp; JAX package caffe_mpi_tpu/tools/cli.py
(`cmd_train`, `_build_feeders`, `_synthetic_feed`, `cmd_test`, `cmd_time`,
`cmd_device_query`, `cmd_serve`).

`train` runs a solver prototxt. A net with a Data layer is fed from its
dataset: a Feeder for the train net and one for each test net
(data/feeder.py), each behind a DeviceFeed that uploads its batches
through pinned memory. A net fed through Input layers trains on
`-synthetic` data drawn as the JAX CLI draws it: a numpy RandomState(seed)
in the net's feed order, token ids in [0, input_dim) for a blob an Embed
consumes, class ids in [0, 10) for the label bottom of a classification
loss or accuracy (or a Data layer's label), random bytes for a raw uint8
feed and zero decisions (the top-left crop, no mirror) for its
augmentation, normals for the other blobs; seed 0 for the train net, 1
for the test nets. Each synthetic feed is uploaded once and reused every
iteration. At the end `train` prints one JSON line {"train": {...}}: the
loss and wall time of every iteration, their median, images (batch items)
per second at the median step and over the whole window (the summed
steps, the first left out), whether the batches came from a dataset and
went through the device transform, and the host ms to build one batch.

`test` runs the TEST-phase net of `-model` from `-weights` over
`-iterations` batches of its Data layer (or of synthetic feeds seeded by
the iteration) and prints each terminal blob's mean over the batches,
averaged in float64, as `name = %.5g`, as the JAX `cmd_test` does.

`time` times each layer's forward and its isolated backward (the
gradients of the sum of its squared float tops with respect to its params
and float bottoms, the graph kept and the backward alone repeated), then
the whole forward and the whole forward+backward, over `-iterations` runs
each after one warm run, with CUDA events on the card. It prints the
table, the model GFLOPs (utils/flops.py), the TFLOP/s reached and the MFU
against the card's dense peak for the precision the products run at
(naming the card and the rate), the peak memory the card's allocator saw,
and one JSON line {"time": {...}}; `-profile DIR` writes a torch.profiler
trace of the two whole-net passes there.

`device_query` prints each card's properties (tools/device_query.py); it
raises without a card.

`serve` has no HTTP front yet: `-smoke N` drives N synthetic requests
through the engine and prints its telemetry as one JSON line.

`train` takes the JAX CLI's mixed-precision, guard and chunk flags:
`-precision f32|bf16`, `-loss_scale` (0 dynamic, > 0 static; -1 keeps
the prototxt's), `-loss_scale_window`, `-train_guard`,
`-guard_max_skips` (-1 keeps the prototxt's) and `-step_chunk` (0 keeps
the prototxt's); a numeric divergence the guard declares exits 88
(EXIT_NUMERIC). Its summary adds the precision, the chunk length, the
guard's skips, overflows and loss scale, and the chunks run (one
dispatch and one host sync each).

The JAX CLI's flags for solver and serving fields the port does not
honour yet (`-test_chunk`, `-anomaly_action`, `-serve_dtype`, ...: one
flag a field of the Solver's and the engine's UNPORTED_FIELDS) are
accepted and land on their parameter, which the Solver or the engine
refuses at any value but its default; the command then exits 1.

Usage (gflags-compatible single-dash long flags accepted):
    python -m caffe_mpi_tpu_torch.tools.cli train -solver solver.prototxt [-synthetic] [-max_iter N] [-test_iter T] [-snapshot_prefix P] [-weights w.caffemodel | -snapshot s.solverstate] [-precision bf16] [-loss_scale S] [-step_chunk K] [-train_guard] [-device cuda|cpu]
    python -m caffe_mpi_tpu_torch.tools.cli test -model train_val.prototxt [-weights w.caffemodel] [-iterations N] [-device cuda|cpu]
    python -m caffe_mpi_tpu_torch.tools.cli time -model train_val.prototxt [-iterations N] [-phase TRAIN|TEST] [-profile DIR] [-device cuda|cpu]
    python -m caffe_mpi_tpu_torch.tools.cli device_query
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
    p.add_argument("command", choices=["train", "test", "time",
                                        "device_query", "serve"])
    p.add_argument("-solver", "--solver", default="",
                   help="solver prototxt (train)")
    p.add_argument("-synthetic", "--synthetic", action="store_true",
                   help="train a net without a Data layer on random data "
                   "shaped from its Input layers")
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
                   help="net prototxt (test, time; serve: a deploy net)")
    p.add_argument("-iterations", "--iterations", type=int, default=50,
                   help="batches (test) or timed runs (time)")
    p.add_argument("-phase", "--phase", default="TEST",
                   choices=["TRAIN", "TEST"], help="net phase (time)")
    p.add_argument("-profile", "--profile", default="",
                   help="write a torch.profiler trace to this directory "
                   "(time)")
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
    p.add_argument("-step_chunk", "--step_chunk", "--step-chunk",
                   dest="step_chunk", type=int, default=0,
                   help="run up to K iterations a chunk, one host sync "
                   "each; on the card a chunk replays a CUDA graph of one "
                   "iteration (overrides solver step_chunk; 0 = the "
                   "prototxt's, default 1). Chunks stop at display, "
                   "test_interval and snapshot boundaries")
    p.add_argument("-precision", "--precision", default="",
                   help="train: compute precision f32 or bf16 (overrides "
                   "solver precision; '' = the prototxt's, default f32). "
                   "bf16 computes activations and gradients in bfloat16 "
                   "with float32 master params and slots, loss scaling "
                   "per -loss_scale")
    p.add_argument("-loss_scale", "--loss-scale", dest="loss_scale",
                   type=float, default=-1.0,
                   help="bf16 loss scale: 0 = dynamic (an overflow step is "
                   "skipped and the scale halves, regrowing 2x after "
                   "loss_scale_window clean steps), > 0 = that static "
                   "scale (overrides solver loss_scale; -1 = the "
                   "prototxt's, default dynamic)")
    p.add_argument("-loss_scale_window", "--loss-scale-window",
                   dest="loss_scale_window", type=int, default=0,
                   help="clean steps before the dynamic loss scale grows "
                   "2x (overrides solver loss_scale_window; 0 = the "
                   "prototxt's, default 200)")
    p.add_argument("-train_guard", "--train-guard", dest="train_guard",
                   action="store_true",
                   help="arm the skip-step guard: a step with a non-finite "
                   "loss or update keeps params, slots and statistics; "
                   "guard_max_skips consecutive skips exit 88")
    p.add_argument("-guard_max_skips", "--guard-max-skips",
                   dest="guard_max_skips", type=int, default=-1,
                   help="consecutive skipped steps before exit 88; 0 = "
                   "never (overrides solver guard_max_skips; -1 = the "
                   "prototxt's, default 3)")
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
    """Random feeds shaped from the net's feed specs, on the net's device,
    drawn as the JAX CLI's `_synthetic_feed` draws them: integer feeds are
    chosen by consumer, not by blob name."""
    import torch
    r = np.random.RandomState(seed)
    int_range: dict[str, int] = {}
    for layer in net.layers:
        lp = layer.lp
        if lp.type == "Embed" and lp.bottom:
            int_range[lp.bottom[0]] = lp.embed_param.input_dim
        elif lp.type in _CLASSIFICATION_CONSUMERS and len(lp.bottom) > 1:
            int_range.setdefault(lp.bottom[1], 10)
    feeds = {}
    for key, (shape, kind) in net.feed_specs.items():
        if kind == "uint8":
            a = r.randint(0, 256, shape).astype(np.uint8)
        elif kind == "aug":
            # zeros = the top-left crop, no mirror: always valid offsets
            a = np.zeros(shape, np.int32)
        elif key in int_range or kind == "int":
            a = r.randint(0, max(int_range.get(key, 10), 1), shape)
        else:
            a = r.randn(*shape).astype(np.float32)
        feeds[key] = torch.from_numpy(a).to(net.device)
    return feeds


def build_feeder(net, phase: str):
    """The Feeder of the net's Data layer, or None for a net fed through
    Input layers (the JAX CLI's `_build_feeders`, on one device)."""
    from ..data.feeder import feeder_from_layer
    for layer in net.layers:
        if layer.lp.type in ("Data", "ImageData", "HDF5Data", "WindowData"):
            return feeder_from_layer(
                layer.lp, phase, model_dir=net.model_dir,
                device_transform=getattr(layer, "dev_transform", False))
    return None


def _feed_fns(solver, synthetic: bool):
    """(train feed fn, test feed fns, the DeviceFeeds to close, the train
    Feeder or None)."""
    from ..data.feeder import DeviceFeed
    opened = []
    feeder = build_feeder(solver.net, "TRAIN")
    if feeder is None:
        if not synthetic:
            raise ValueError("net has no Data layer; pass -synthetic to "
                             "train on random data or use a Data net")
        feeds = synthetic_feed(solver.net)
        feed_fn = lambda it: feeds  # noqa: E731
    else:
        feed_fn = DeviceFeed(feeder, solver.device)
        opened.append(feed_fn)
    test_fns = None
    if solver.test_nets:
        test_fns = []
        for tnet in solver.test_nets:
            f = build_feeder(tnet, "TEST")
            if f is None:
                tfeeds = synthetic_feed(tnet, seed=1)
                test_fns.append(lambda it, tfeeds=tfeeds: tfeeds)
            else:
                test_fns.append(DeviceFeed(f, solver.device))
                opened.append(test_fns[-1])
    return feed_fn, test_fns, opened, feeder


def window_img_per_s(batch: int, step_ms: list[float]) -> float:
    """Images a second over a window of steps: every step's batch over
    their summed time. Unlike a median step it counts each stall."""
    return batch * len(step_ms) / (sum(step_ms) / 1e3) if step_ms \
        else float("nan")


def train(args):
    """Build the solver from `args`, resume or load weights, train to
    max_iter with a test pass at every test_interval and at the end, and
    snapshot after training. Returns (solver, summary dict)."""
    from ..proto import SolverParameter
    from ..solver import Solver
    if not args.solver:
        raise ValueError("train requires -solver")
    sp = SolverParameter.from_file(args.solver)
    if args.max_iter:
        sp.max_iter = args.max_iter
    if args.test_iter:
        sp.test_iter = [args.test_iter] * max(len(sp.test_iter), 1)
    if args.snapshot_prefix:
        sp.snapshot_prefix = args.snapshot_prefix
    if args.step_chunk:
        sp.step_chunk = args.step_chunk
    if args.precision:
        sp.precision = args.precision
    if args.loss_scale >= 0:  # 0 is dynamic; -1 keeps the prototxt's
        sp.loss_scale = args.loss_scale
    if args.loss_scale_window:
        sp.loss_scale_window = args.loss_scale_window
    if args.train_guard:
        sp.train_guard = True
    if args.guard_max_skips >= 0:  # 0 is "never exit"
        sp.guard_max_skips = args.guard_max_skips
    _apply_unported(args, sp)
    # net paths in the solver are relative to the working directory, as
    # the reference's are (and so are its Data layers' sources); an
    # inline or missing one resolves beside the solver file
    model_dir = "" if (sp.net and os.path.exists(sp.net)) \
        else os.path.dirname(os.path.abspath(args.solver))
    solver = Solver(sp, model_dir=model_dir, device=args.device)
    if args.snapshot:
        solver.restore(args.snapshot)
    elif args.weights:
        for w in args.weights.split(","):
            solver.load_weights(w)
    feed_fn, test_feed_fns, opened, feeder = _feed_fns(solver,
                                                       args.synthetic)
    start = solver.iter
    try:
        solver.step(sp.max_iter - solver.iter, feed_fn, test_feed_fns)
        scores = None
        if test_feed_fns and sp.test_interval:
            # final evaluation, as the JAX CLI runs it after the last
            # iteration
            scores = solver.test_all(test_feed_fns)
    finally:
        for f in opened:
            f.close()
    snapshot = None
    if sp.snapshot_prefix and solver.should_snapshot_after_train():
        snapshot = solver.snapshot()
    batch = solver._batch_images() * max(sp.iter_size, 1)
    med = float(np.median(solver.iter_ms)) if solver.iter_ms \
        else float("nan")
    data = next((l for l in solver.net.layers if l.lp.type == "Data"), None)
    summary = {
        "solver": args.solver, "device": str(solver.device),
        "start_iter": start, "iters": solver.iter - start, "batch": batch,
        "losses": list(solver.losses), "iter_ms": list(solver.iter_ms),
        "median_iter_ms": med,
        "img_per_s": batch / (med / 1e3),
        # the first step (its warm-up) left out
        "window_img_per_s": window_img_per_s(batch, solver.iter_ms[1:]),
        "test_scores": scores,
        "snapshot": snapshot,
        "data": "synthetic" if feeder is None else "dataset",
        "device_transform": bool(data is not None and data.dev_transform),
        "feed_ms_per_batch": None if feeder is None
        else feeder.feed_ms_per_batch(),
        "feed_threads": None if feeder is None else feeder.threads,
        "precision": solver.precision, "step_chunk": solver.step_chunk,
        "skipped_iters": list(solver.skipped_iters),
        "skipped_steps": solver.skipped_steps,
        "overflow_steps": solver.overflow_steps,
        "loss_scale": solver.loss_scale_value,
        "dispatch_count": solver.dispatch_count,
        "host_sync_count": solver.host_sync_count,
        "graph_replays": solver.graph_replays,
    }
    return solver, summary


def cmd_train(args) -> int:
    from ..utils.resilience import EXIT_NUMERIC, NumericAnomalyError
    try:
        _, summary = train(args)
    except (ValueError, NotImplementedError) as e:
        log.error("%s", e)
        return 1
    except NumericAnomalyError as e:
        log.error("%s; exiting %d", e, EXIT_NUMERIC)
        return EXIT_NUMERIC
    print(json.dumps({"train": summary}))
    # a step the guard skipped may have a non-finite loss
    skipped = set(summary["skipped_iters"])
    losses = [l for i, l in enumerate(summary["losses"])
              if summary["start_iter"] + i not in skipped]
    if not summary["losses"] or not all(np.isfinite(losses)):
        log.error("train: losses not all finite: %s", summary["losses"])
        return 1
    return 0


def test_net(args) -> dict[str, float]:
    """`test`: the TEST-phase net of args.model from args.weights over
    args.iterations batches; returns {terminal blob: mean over batches}.
    Sources and the mean file resolve against the working directory, as
    the reference's and `train`'s do (the JAX `cmd_test` resolves them
    beside the model file)."""
    import torch

    from .. import io as caffe_io
    from ..data.feeder import DeviceFeed
    from ..net import Net
    from ..proto import NetParameter
    from ..solver import Solver
    if not args.model:
        raise ValueError("test requires -model")
    net = Net(NetParameter.from_file(args.model), "TEST", device=args.device)
    net.init(0)
    if args.weights:
        net.import_weights(caffe_io.load_weights(args.weights))
    feeder = build_feeder(net, "TEST")
    feed = DeviceFeed(feeder, net.device) if feeder else None
    outputs = Solver._output_blobs(net)
    totals: dict[str, list] = {b: [] for b in outputs}
    try:
        with torch.no_grad():
            for it in range(args.iterations):
                feeds = feed(it) if feed else synthetic_feed(net, seed=it)
                blobs, _ = net(feeds)
                for b in outputs:  # per-batch means stay on the device
                    totals[b].append(blobs[b].float().mean())
    finally:
        if feed is not None:
            feed.close()
    # the average over batches in float64 on the host, as the JAX CLI
    return {b: float(np.mean(torch.stack(totals[b]).cpu().numpy(),
                             dtype=np.float64)) for b in outputs}


def cmd_test(args) -> int:
    try:
        scores = test_net(args)
    except (ValueError, NotImplementedError) as e:
        log.error("%s", e)
        return 1
    for b, avg in scores.items():
        log.info("%s = %.5g", b, avg)
        print(f"{b} = {avg:.5g}")
    return 0


class _Clock:
    """Milliseconds a call of `fn` takes over `iters` calls after one warm
    call: CUDA events on the card, the host clock on the CPU."""

    def __init__(self, device, iters: int):
        self.cuda = device.type == "cuda"
        self.iters = max(iters, 1)

    def __call__(self, fn) -> float:
        import time

        import torch
        fn()
        if self.cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            for _ in range(self.iters):
                fn()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / self.iters
        t0 = time.perf_counter()
        for _ in range(self.iters):
            fn()
        return (time.perf_counter() - t0) / self.iters * 1e3


def _layer_call(layer, bottoms, gen):
    if layer.needs_rng:
        return layer(bottoms, generator=gen, mask=None)
    return layer(bottoms)


def _isolated_backward(layer, bottoms, gen, clock, math) -> float:
    """ms of one layer's backward alone: the gradients of the sum of its
    squared float tops with respect to its params and float bottoms (the
    reference times each layer's Backward, tools/caffe.cpp:403-423);
    `math()` gives a fresh context of the net's TF32 setting a call."""
    import torch
    params = [getattr(layer, n) for n in layer.decls]
    inputs = [b.detach().requires_grad_() if b.is_floating_point() else b
              for b in bottoms]
    wrt = params + [b for b in inputs if b.requires_grad]
    if not wrt:
        return float("nan")
    saved = [p.requires_grad for p in params]
    try:
        for p in params:
            p.requires_grad_(True)
        with torch.enable_grad():
            tops = _layer_call(layer, inputs, gen)
            terms = [t.float().square().sum() for t in tops
                     if isinstance(t, torch.Tensor) and t.requires_grad]
            if not terms:
                return float("nan")
            s = sum(terms)

            def bwd():
                with math():
                    torch.autograd.grad(s, wrt, retain_graph=True,
                                        allow_unused=True)
            return clock(bwd)
    finally:
        for p, r in zip(params, saved):
            p.requires_grad_(r)


def time_net(args) -> dict:
    """`time`: prints the per-layer table and the whole-net lines; returns
    them as a dict."""
    import torch

    from ..layers.data_layers import InputLayerBase
    from ..net import Net
    from ..proto import NetParameter
    from ..utils.flops import (layer_macs_per_image, mfu_peak,
                               net_macs_per_image, train_flops_per_image)
    if not args.model:
        raise ValueError("time requires -model")
    net = Net(NetParameter.from_file(args.model), args.phase,
              device=args.device)
    net.init(0)
    dev = net.device
    precision = net.math_precision()
    policy = net.layers[0].policy
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    feeds = synthetic_feed(net)
    gen = torch.Generator(device=dev).manual_seed(0)
    clock = _Clock(dev, args.iterations)
    with torch.no_grad():
        blobs, _ = net(feeds, generator=gen)  # every layer's inputs
    rows = []
    for layer in net.layers:
        if isinstance(layer, InputLayerBase):
            continue
        bottoms = [blobs[b] for b in layer.lp.bottom]
        with torch.no_grad():
            fwd_ms = clock(lambda: _layer_call(layer, bottoms, gen))
        bwd_ms = _isolated_backward(layer, bottoms, gen, clock,
                                    lambda: policy.math(dev))
        rows.append((layer.name, layer.lp.type, fwd_ms, bwd_ms))

    params = [getattr(net.layer_by_name(l), n)
              for l, n, _ in net.learnable_param_decls()]

    def forward():
        with torch.no_grad():
            net(feeds, generator=gen)

    def forward_backward():
        for p in params:
            p.grad = None
        _, loss = net(feeds, generator=gen)
        with policy.math(dev):
            loss.backward()

    def whole():
        fwd = clock(forward)
        if not net.loss_blobs:
            return fwd, float("nan")
        saved = [p.requires_grad for p in params]
        try:
            for p in params:
                p.requires_grad_(True)
            return fwd, clock(forward_backward)
        finally:
            for p, r in zip(params, saved):
                p.requires_grad_(r)
                p.grad = None

    if args.profile:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        os.makedirs(args.profile, exist_ok=True)
        with profile(activities=acts) as prof:
            fwd_ms, total_ms = whole()
        trace = os.path.join(args.profile, "trace.json")
        prof.export_chrome_trace(trace)
        print(f"profiler trace written to {trace}")
    else:
        fwd_ms, total_ms = whole()

    batch = next((net.blob_shapes[b][0] for b in net.feed_blobs), 1)
    layer_gflops = {l.name: 2 * layer_macs_per_image(l) * batch / 1e9
                    for l in net.layers}
    print(f"{'layer':<28}{'type':<20}{'fwd ms':>12}{'bwd ms':>12}"
          f"{'GFLOPs':>10}  (isolated)")
    for name, tname, fms, bms in rows:
        bs = f"{bms:.3f}" if bms == bms else "-"
        gf = layer_gflops.get(name, 0.0)
        gfs = f"{gf:.2f}" if gf else "-"
        print(f"{name:<28}{tname:<20}{fms:>12.3f}{bs:>12}{gfs:>10}")
    print(f"\nwhole-net forward: {fwd_ms:.3f} ms")
    print(f"whole-net forward+backward: {total_ms:.3f} ms")
    print(f"sum of isolated per-layer fwd: {sum(r[2] for r in rows):.3f} ms")
    fwd_gflops = 2 * net_macs_per_image(net) * batch / 1e9
    train_gflops = train_flops_per_image(net) * batch / 1e9
    print(f"model FLOPs: fwd {fwd_gflops:.2f} GFLOPs/batch (batch {batch}); "
          f"fwd+bwd {train_gflops:.2f}")
    card = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    peak = mfu_peak(card, precision,
                    forward_bf16=policy.forward == torch.bfloat16)
    achieved = train_gflops / total_ms if total_ms == total_ms and \
        total_ms > 0 else None  # GFLOP / ms = TFLOP/s
    mfu = achieved * 1e12 / peak[0] if (achieved and peak) else None
    line = f"achieved: fwd {fwd_gflops / fwd_ms:.2f} TFLOP/s"
    if achieved is not None:
        line += f", fwd+bwd {achieved:.2f} TFLOP/s"
    if mfu is not None:
        line += (f"; MFU {mfu:.1%} of the {card} {peak[1]} peak "
                 f"{peak[0] / 1e12:.1f} TFLOP/s")
    else:
        line += f"; MFU not measured (no peak rate for {card})"
    print(line)
    peak_mib = None
    if dev.type == "cuda":
        peak_mib = torch.cuda.max_memory_allocated(dev) / 2**20
        print(f"peak memory: {peak_mib:.1f} MiB "
              "(torch.cuda.max_memory_allocated)")
    return {
        "model": args.model, "phase": args.phase, "batch": batch,
        "device": str(dev), "card": card, "iterations": clock.iters,
        "layers": [{"name": n, "type": t, "fwd_ms": f,
                    "bwd_ms": b if b == b else None}
                   for n, t, f, b in rows],
        "forward_ms": fwd_ms,
        "forward_backward_ms": total_ms if total_ms == total_ms else None,
        "fwd_gflops": fwd_gflops, "train_gflops": train_gflops,
        "tflops": achieved, "mfu": mfu,
        "peak_rate": None if peak is None else {"name": peak[1],
                                                "flops": peak[0]},
        "peak_mem_MiB": peak_mib,
    }


def cmd_time(args) -> int:
    try:
        summary = time_net(args)
    except (ValueError, NotImplementedError) as e:
        log.error("%s", e)
        return 1
    print(json.dumps({"time": summary}))
    return 0


def cmd_device_query(args) -> int:
    from . import device_query
    device_query.print_devices(device_query.query())
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
    return {"train": cmd_train, "test": cmd_test, "time": cmd_time,
            "device_query": cmd_device_query,
            "serve": cmd_serve}[args.command](args)


if __name__ == "__main__":
    sys.exit(main())
