#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (caffe_mpi_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py          # from the root of the repository

Phases, in order; any failure exits nonzero and prints no result line:

1. device  — requires torch.cuda.is_available(); prints the card's name and
             power limit as nvidia-smi reports them.
2. build   — builds every CUDA kernel of the port from csrc/ with nvcc for
             sm_90a (one nvcc per source, all started together).
3. kernels — holds each kernel against its plain PyTorch version on the card
             at the shapes the serving and training paths give it (and at
             edge shapes), in float32 and bfloat16, and times the kernel,
             the plain version and the library call that computes the same
             function: K1, the LRN forward, against F.local_response_norm;
             K2, the LRN backward, against torch.autograd.grad through
             F.local_response_norm.
4. serve   — serves AlexNet (models/alexnet/deploy.prototxt, full width,
             weights drawn from a seeded torch.Generator) through the
             port's ServingEngine: mixed bursts from several threads with
             every kernel launch count set to 0 just before and read just
             after; parity of rows served on the card (TF32 off) against
             the port's Net forward on the CPU; and a speed run of the
             prototxt as written (img/s, p50/p99 request latency).
5. train   — trains models/alexnet/solver.prototxt at full width, batch
             256, on synthetic data through the CLI's `train` entry point
             (20 iterations, a test pass of 2 batches at iteration 0 and at
             the end, a snapshot in a temporary directory), with the launch
             counts set to 0 just before and read just after: K2 must have
             launched twice an iteration and K1 twice a forward, every loss
             must be finite. Then it resumes the snapshot through the same
             entry point, checks that the weights and history came back
             bitwise, and takes one more step.
6. parity  — one SGD step of the same net cut to batch 16 (for this check
             only) on the card against the CPU, TF32 off through the
             prototxt's `default_forward_math: FLOAT`, the same weights,
             feeds and dropout masks (drawn on the CPU). Limits: the loss
             within 1e-5 of its size; each gradient within 1e-4 of its
             largest element for fc6-fc8 and 2e-2 for conv1-conv5, whose
             gradients pass through a max pool's backward (it sends each
             window's gradient to the window's arg-max, and near-ties flip
             under any change of summation order: one f32 rounding of the
             CPU's own input moves them by ~1e-3); each updated
             parameter within base_lr x lr_mult x that limit x the
             gradient's largest element, plus two f32 ulps of the largest
             weight; conv1's gradient nonzero (it sits below both LRNs, so
             it is reached only through K2). The step is repeated with the
             backward under TF32 (the switches as they stood before the
             solver set them for the backward), for the record: it moves
             the fc gradients past their limit.

It prints one {"kernels": [...]} line, one {"serving": ...} line, one
{"train": ...} line, the card line again, and last {"ok": true, ...}.
"""

from __future__ import annotations

import copy
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
MODEL = os.path.join(ROOT, "models", "alexnet", "deploy.prototxt")
SOLVER = os.path.join(ROOT, "models", "alexnet", "solver.prototxt")
TRAIN_ITERS = 20
TEST_ITER = 2
# ImageNet preprocessing of the reference Classifier recipe: BGR, 0..255,
# mean-subtracted — so the served activations are at a realistic scale
PREPROCESS = dict(raw_scale=255.0, mean=np.array([104.0, 117.0, 123.0]),
                  channel_swap=(2, 1, 0))

# (name substring, memory bytes/s, float32 flop/s outside the tensor
# cores), NVIDIA data sheets; the first match against nvidia-smi's name wins
CARD_RATES = (
    ("H100 NVL", 3.9e12, 60e12),
    ("H100 PCIe", 2.0e12, 51e12),
    ("H200", 4.8e12, 67e12),
    ("H100", 3.35e12, 67e12),  # SXM5, "NVIDIA H100 80GB HBM3"
)

LRN = dict(size=5, alpha=1e-4, beta=0.75, k=1.0)  # AlexNet norm1/norm2


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


# -- 1. device ----------------------------------------------------------------

def device_phase() -> tuple[str, tuple[float, float]]:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: no card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    name = torch.cuda.get_device_name(0)
    for key, mem_rate, f32_rate in CARD_RATES:
        if key in name:
            return card, (mem_rate, f32_rate)
    fail(f"no published rates for {name!r}; add it to CARD_RATES")


# -- 2. build -----------------------------------------------------------------

def build_phase() -> None:
    from caffe_mpi_tpu_torch.ops import build
    t0 = time.perf_counter()
    secs = build.build_all()
    log(f"build: {json.dumps(secs)} ({time.perf_counter() - t0:.1f} s "
        "wall, nvcc for sm_90a)")


# -- 3. kernels ---------------------------------------------------------------

def time_ms(fn, reps: int = 40, hold_ms: float = 25.0) -> float:
    """Median device time of one call, from CUDA events around it. A 96 MiB
    write before each call flushes the 50 MB L2, as the serving path finds
    its activations after the convolution that wrote them. The stream is
    first held by a device-side sleep of `hold_ms` while the host enqueues
    every rep, so the events time the device's work and not the host's
    launch overhead."""
    flush = torch.empty(96 * 2**20 // 4, device="cuda")
    for _ in range(3):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    torch.cuda.synchronize()
    torch.cuda._sleep(int(2e9 * hold_ms / 1e3))  # cycles at <= 2 GHz
    for s, e in zip(starts, ends):
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in zip(starts, ends)]))


def lrn_bound(shape, dtype, size, rates, tensors=2,
              ops_per_elem=None) -> tuple[float, str]:
    """Least time for the work: `tensors` full tensors moved once (K1: x
    read and y written; K2: x and dy read, dx written) over the memory
    rate, against the float32 operations an element (K1: 2*size+6 — window
    squares and adds, scale, log, exp, products; K2: 3*size+10 — the same
    scale, the ratio and its window sum, dx) over the f32 peak."""
    mem_rate, f32_rate = rates
    elems = float(np.prod(shape))
    itemsize = torch.empty((), dtype=dtype).element_size()
    t_bytes = tensors * elems * itemsize / mem_rate * 1e3
    ops = ops_per_elem if ops_per_elem is not None else 2 * size + 6
    t_ops = elems * ops / f32_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# f32 at rtol 1e-5 / atol 1e-6 as the CPU tests; bf16 at one ulp
TOL = {torch.float32: dict(rtol=1e-5, atol=1e-6),
       torch.bfloat16: dict(rtol=8e-3, atol=1e-6)}
# edge shapes of the CPU tests: C < size, 1x1 maps, HW not a multiple of
# 128; checked at every window size
EDGE_SHAPES = ((2, 96, 13, 13), (1, 3, 5, 5), (2, 16, 1, 1), (1, 8, 7, 9))


def _alexnet_lrn_shapes(batches):
    for b in batches:
        yield "norm1", (b, 96, 55, 55)
        yield "norm2", (b, 256, 27, 27)


def _kernel_entry(name, source, replaces, cases, max_err, per) -> dict:
    """The kernels-line entry: the head case is norm1 at batch 256 in f32,
    the shape the training path gives the kernel."""
    head = next(c for c in cases if c["layer"] == "norm1"
                and c["shape"][0] == 256 and c["dtype"] == "float32")
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces,
        "launches": None,  # the training path's count, filled by train_phase
        "max_abs_err": max_err,
        "shape": head["shape"], "dtype": head["dtype"],
        "ms": head["kernel_ms"], "kernel_ms": head["kernel_ms"],
        "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"], "library_ms": head["library_ms"],
        **per, "cases": cases,
    }


def kernel_phase(rates) -> dict:
    """K1, the LRN forward, at the edge shapes and at AlexNet's norm1 and
    norm2 for every serving bucket (1, 4, 10) and the training batch 256."""
    import torch.nn.functional as F
    from caffe_mpi_tpu_torch.ops import lrn as lrn_op

    gen = torch.Generator(device="cuda").manual_seed(0)

    def check(shape, dtype, size, alpha, beta, k):
        x = (torch.randn(shape, generator=gen, device="cuda") * 4).to(dtype)
        y = lrn_op.lrn_across_channels(x, size, alpha, beta, k)
        r = lrn_op.lrn_across_channels_ref(x, size, alpha, beta, k)
        torch.cuda.synchronize()
        torch.testing.assert_close(y.float(), r.float(), **TOL[dtype])
        return x, float((y.float() - r.float()).abs().max())

    max_err = 0.0
    for shape in EDGE_SHAPES:
        for size in (3, 5, 7):
            for dtype in TOL:
                _, err = check(shape, dtype, size, 1e-2, 0.75, 2.0)
                max_err = max(max_err, err)
    cases = []
    args = (LRN["size"], LRN["alpha"], LRN["beta"], LRN["k"])
    for layer, shape in _alexnet_lrn_shapes((1, 4, 10, 256)):
        for dtype in TOL:
            x, err = check(shape, dtype, **LRN)
            max_err = max(max_err, err)
            bound, by = lrn_bound(shape, dtype, LRN["size"], rates)
            ms = time_ms(lambda: lrn_op.lrn_across_channels(x, *args))
            case = {
                "layer": layer, "shape": list(shape),
                "dtype": str(dtype).replace("torch.", ""),
                "max_abs_err": err, "kernel_ms": ms,
                "plain_ms": time_ms(
                    lambda: lrn_op.lrn_across_channels_ref(x, *args)),
                "library_ms": time_ms(
                    lambda: F.local_response_norm(x, *args)),
                "bound_ms": bound, "bound_by": by,
                "kernel_GB_s": 2 * x.numel() * x.element_size()
                / (ms * 1e-3) / 1e9,
            }
            cases.append(case)
            log(f"lrn {json.dumps(case)}")
            del x
    return _kernel_entry("lrn_fwd", "caffe_mpi_tpu_torch/csrc/lrn.cu",
                         lrn_op.REPLACES, cases, max_err,
                         {"launches_per_forward": 2})


def kernel_bwd_phase(rates) -> dict:
    """K2, the LRN backward, at the edge shapes and at AlexNet's norm1 and
    norm2 for the training batch 256. The library call is the backward of
    F.local_response_norm, timed as torch.autograd.grad over a graph built
    once; each case frees its tensors before the next."""
    import torch.nn.functional as F
    from caffe_mpi_tpu_torch.ops import lrn as lrn_op

    gen = torch.Generator(device="cuda").manual_seed(1)
    args = (LRN["size"], LRN["alpha"], LRN["beta"], LRN["k"])

    def check(shape, dtype, size, alpha, beta, k):
        x = (torch.randn(shape, generator=gen, device="cuda") * 4).to(dtype)
        dy = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        dx = lrn_op.lrn_across_channels_bwd(x, dy, size, alpha, beta, k)
        r = lrn_op.lrn_across_channels_bwd_ref(x, dy, size, alpha, beta, k)
        torch.cuda.synchronize()
        torch.testing.assert_close(dx.float(), r.float(), **TOL[dtype])
        return x, dy, float((dx.float() - r.float()).abs().max())

    max_err = 0.0
    for shape in EDGE_SHAPES:
        for size in (3, 5, 7):
            for dtype in TOL:
                *_, err = check(shape, dtype, size, 1e-2, 0.75, 2.0)
                max_err = max(max_err, err)
    # autograd reaches K2: a graph through K1 on the card gives the
    # gradient the plain pair gives on the CPU
    xc = torch.randn((2, 16, 6, 6), generator=gen, device="cuda")
    xr = xc.clone().requires_grad_()
    y = lrn_op.lrn_across_channels(xr, 5, 1e-2, 0.75, 2.0)
    if y.grad_fn is None:
        fail("lrn_across_channels on the card returned no autograd graph")
    before = lrn_op.lrn_across_channels_bwd.launches
    y.square().sum().backward()
    if lrn_op.lrn_across_channels_bwd.launches != before + 1:
        fail("backward through lrn_across_channels did not launch K2")
    xh = xc.cpu().requires_grad_()
    lrn_op.lrn_across_channels(xh, 5, 1e-2, 0.75, 2.0).square().sum() \
        .backward()
    torch.testing.assert_close(xr.grad.cpu(), xh.grad, rtol=1e-5, atol=1e-6)
    cases = []
    for layer, shape in _alexnet_lrn_shapes((256,)):
        for dtype in TOL:
            x, dy, err = check(shape, dtype, **LRN)
            max_err = max(max_err, err)
            bound, by = lrn_bound(shape, dtype, LRN["size"], rates,
                                  tensors=3, ops_per_elem=3 * LRN["size"]
                                  + 10)
            ms = time_ms(lambda: lrn_op.lrn_across_channels_bwd(x, dy,
                                                                *args))
            plain = time_ms(
                lambda: lrn_op.lrn_across_channels_bwd_ref(x, dy, *args))
            xg = x.detach().requires_grad_()
            yg = F.local_response_norm(xg, *args)
            library = time_ms(lambda: torch.autograd.grad(
                yg, xg, dy, retain_graph=True))
            del xg, yg
            case = {
                "layer": layer, "shape": list(shape),
                "dtype": str(dtype).replace("torch.", ""),
                "max_abs_err": err, "kernel_ms": ms, "plain_ms": plain,
                "library_ms": library, "bound_ms": bound, "bound_by": by,
                "kernel_GB_s": 3 * x.numel() * x.element_size()
                / (ms * 1e-3) / 1e9,
            }
            cases.append(case)
            log(f"lrn_bwd {json.dumps(case)}")
            del x, dy
            torch.cuda.empty_cache()
    return _kernel_entry("lrn_bwd", "caffe_mpi_tpu_torch/csrc/lrn.cu",
                         lrn_op.REPLACES_BWD, cases, max_err,
                         {"launches_per_iteration": 2})


# -- 4. serve -----------------------------------------------------------------

def _images(rng, n):
    return [rng.rand(227, 227, 3).astype(np.float32) for _ in range(n)]


def _check_rows(rows, n):
    if rows.shape != (n, 1000) or not np.all(np.isfinite(rows)):
        fail(f"served rows {rows.shape} not finite (n={n}, 1000)")
    if np.abs(rows.sum(axis=1) - 1.0).max() > 1e-4:
        fail("served softmax rows do not sum to 1")


def serve_phase(kernel: dict, card: str) -> dict:
    from caffe_mpi_tpu_torch.net import Net
    from caffe_mpi_tpu_torch.ops.lrn import (lrn_across_channels,
                                             lrn_across_channels_bwd)
    from caffe_mpi_tpu_torch.proto import NetParameter
    from caffe_mpi_tpu_torch.serving import ServingEngine

    rng = np.random.RandomState(0)

    # main path: mixed bursts from several client threads
    with ServingEngine(device="cuda") as engine:
        model = engine.load_model("alexnet", MODEL, seed=0, **PREPROCESS)
        if model.fwd.ladder != (1, 4, 10):
            fail(f"ladder {model.fwd.ladder} != (1, 4, 10)")
        bursts = (1, 3, 10, 17, 1, 3, 10, 3)
        batches = [_images(rng, b) for b in bursts]
        lrn_across_channels.launches = 0
        lrn_across_channels_bwd.launches = 0
        with ThreadPoolExecutor(max_workers=4) as ex:
            futs = [ex.submit(engine.classify, "alexnet", imgs)
                    for imgs in batches]
            results = [f.result(timeout=600) for f in futs]
        engine.drain()
        launches = lrn_across_channels.launches
        if lrn_across_channels_bwd.launches:
            fail(f"serving launched the LRN backward "
                 f"{lrn_across_channels_bwd.launches} times")
        stats = engine.stats()
        for rows, b in zip(results, bursts):
            _check_rows(rows, b)
        if stats["requests"] != sum(bursts):
            fail(f"{stats['requests']} requests recorded, sent {sum(bursts)}")
        if launches == 0 or launches != 2 * stats["dispatches"]:
            fail(f"lrn kernel launched {launches} times for "
                 f"{stats['dispatches']} dispatched buckets (want 2 each)")
        kernel["launches_by_path"] = {"serve": launches}
        log(f"main path: {sum(bursts)} requests, {stats['dispatches']} "
            f"buckets, {launches} lrn launches")

        # parity: TF32 off through the prototxt's own math field, rows
        # served on the card against the port's Net forward on the CPU —
        # the softmax rows, and the fc8 logits (a copy of the net without
        # its Softmax layer): random weights leave the softmax rows nearly
        # uniform, so the logits are where a difference would show
        strict = NetParameter.from_file(MODEL)
        strict.default_forward_math = "FLOAT"
        logits = copy.deepcopy(strict)
        logits.layer = [lp for lp in logits.layer if lp.type != "Softmax"]
        tf32_logits = NetParameter.from_file(MODEL)
        tf32_logits.layer = [lp for lp in tf32_logits.layer
                             if lp.type != "Softmax"]
        images = _images(rng, 10)
        with ServingEngine(device="cuda") as eng2:
            par = {}
            for name, param in (("prob", strict), ("fc8", logits),
                                ("fc8_tf32", tf32_logits)):
                m2 = eng2.load_model(name, param, seed=0, **PREPROCESS)
                rows_in = np.stack([m2.preprocess(im) for im in images])
                cpu_net = Net(copy.deepcopy(param), device="cpu")
                cpu_net.import_weights(m2.fwd.net.export_weights())
                with torch.inference_mode():
                    ref = cpu_net({"data": torch.from_numpy(rows_in)})[0][
                        m2.fwd.out_blob()].numpy()
                served = eng2.classify(name, rows_in, preprocess=False)
                top2 = np.sort(ref, axis=1)[:, -2:]
                sure = (top2[:, 1] - top2[:, 0]) > 1e-4
                par[name] = {
                    "max_abs_diff": float(np.abs(served - ref).max()),
                    "ref_max_abs": float(np.abs(ref).max()),
                    "argmax_rows_checked": int(sure.sum()),
                    "argmax_equal": bool(np.all(
                        served.argmax(1)[sure] == ref.argmax(1)[sure])),
                }
        log(f"parity (TF32 off unless named): {json.dumps(par)}")
        for name in ("prob", "fc8"):
            if par[name]["max_abs_diff"] > 1e-4 or \
                    not par[name]["argmax_equal"]:
                fail(f"parity on {name}: {par[name]} (limit 1e-4)")

    # speed: the prototxt as written, closed-loop clients in mixed bursts
    with ServingEngine(device="cuda") as engine:
        model = engine.load_model("alexnet", MODEL, seed=0, **PREPROCESS)
        pool = _images(rng, 17)
        sizes = rng.choice([1, 3, 10, 17], size=(8, 40))

        def client(row):
            for b in row:
                _check_rows(engine.classify("alexnet", pool[:b]), b)

        with ThreadPoolExecutor(max_workers=8) as ex:
            for f in [ex.submit(client, row) for row in sizes]:
                f.result(timeout=900)
        engine.drain()
        st = engine.stats()
        # where a dispatch's time goes, measured apart from the traffic:
        # host preprocessing of one request; one bucket-10 forward of an
        # input already on the card, as device time (events, stream held
        # while the host enqueues) and as host wall time to completion
        t0 = time.perf_counter()
        for im in pool[:10]:
            model.preprocess(im)
        pre_ms = (time.perf_counter() - t0) * 1e3 / 10
        net10 = model.fwd.net_for(10)
        x10 = torch.zeros(net10.blob_shapes["data"], device="cuda")
        with torch.inference_mode():
            fwd_dev_ms = time_ms(lambda: net10({"data": x10}), reps=10,
                                 hold_ms=200.0)
            walls = []
            for _ in range(10):
                t0 = time.perf_counter()
                net10({"data": x10})
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
        fwd_wall_ms = float(np.median(walls))
    serving = {
        "model": "models/alexnet/deploy.prototxt", "ladder": [1, 4, 10],
        "requests": st["requests"], "dispatches": st["dispatches"],
        "img_per_s": st["img_per_s"], "p50_ms": st["p50_ms"],
        "p99_ms": st["p99_ms"], "mean_bucket_fill": st["mean_bucket_fill"],
        "mean_queue_ms": st["mean_queue_ms"],
        "clients": 8, "window_ms": st["window_ms"],
        "preprocess_ms_per_image": pre_ms,
        "forward_device_ms_bucket10": fwd_dev_ms,
        "forward_wall_ms_bucket10": fwd_wall_ms,
        "parity": par, "main_path_lrn_launches": launches,
        "main_path_dispatches": stats["dispatches"], "card": card,
    }
    return serving


# -- 5. train -----------------------------------------------------------------

def _state(solver) -> dict:
    """Every owned parameter and history slot of a solver, on the host."""
    out = {}
    for lname, pname, _, p in solver._decls:
        out[f"{lname}.{pname}"] = p.detach().cpu().clone()
        for i, h in enumerate(solver.history[(lname, pname)]):
            out[f"{lname}.{pname}.h{i}"] = h.cpu().clone()
    return out


def train_phase(k1: dict, k2: dict, card: str) -> dict:
    from caffe_mpi_tpu_torch.ops.lrn import (lrn_across_channels,
                                             lrn_across_channels_bwd)
    from caffe_mpi_tpu_torch.tools import cli

    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        prefix = os.path.join(tmp, "alexnet")
        argv = ["train", "-solver", SOLVER, "-synthetic",
                "-test_iter", str(TEST_ITER), "-snapshot_prefix", prefix,
                "-device", "cuda"]
        torch.cuda.reset_peak_memory_stats()
        lrn_across_channels.launches = 0
        lrn_across_channels_bwd.launches = 0
        solver, summary = cli.train(cli.parse_args(
            argv + ["-max_iter", str(TRAIN_ITERS)]))
        torch.cuda.synchronize()
        n_fwd, n_bwd = (lrn_across_channels.launches,
                        lrn_across_channels_bwd.launches)
        losses = summary["losses"]
        log(f"train: {json.dumps(summary)}")
        if summary["batch"] != 256 or len(losses) != TRAIN_ITERS:
            fail(f"train ran {len(losses)} iterations at batch "
                 f"{summary['batch']}, want {TRAIN_ITERS} at 256")
        if not np.all(np.isfinite(losses)):
            fail(f"train losses not all finite: {losses}")
        # forwards: every iteration, plus TEST_ITER test batches at
        # iteration 0 (test_initialization) and in the final test pass
        forwards = TRAIN_ITERS + 2 * TEST_ITER
        if n_bwd != 2 * TRAIN_ITERS or n_fwd != 2 * forwards:
            fail(f"K1 launched {n_fwd} times (want {2 * forwards}), K2 "
                 f"{n_bwd} times (want {2 * TRAIN_ITERS})")
        k1["launches"], k2["launches"] = n_fwd, n_bwd
        k1["launches_by_path"]["train"] = n_fwd
        k2["launches_by_path"] = {"train": n_bwd}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        want = _state(solver)
        feeds = cli.synthetic_feed(solver.net)
        profile = profile_steps(solver, lambda it: feeds)
        log(f"train profile: {json.dumps(profile)}")
        del feeds

        # resume the snapshot through the same entry point: weights and
        # history come back bitwise, and one more step runs
        del solver
        resumed, again = cli.train(cli.parse_args(
            argv + ["-max_iter", str(TRAIN_ITERS + 1), "-snapshot",
                    summary["snapshot"]]))
        if again["start_iter"] != TRAIN_ITERS or again["iters"] != 1 or \
                not np.isfinite(again["losses"][0]):
            fail(f"resume: {again}")
        # the resumed solver has stepped on; restore the snapshot once more
        # to hold it against the trained state
        from caffe_mpi_tpu_torch.solver import Solver
        check = Solver(resumed.sp, model_dir=resumed.model_dir,
                       device="cuda")
        check.restore(summary["snapshot"])
        resumed_state = _state(check)
        bad = [k for k in want if not torch.equal(want[k], resumed_state[k])]
        if bad:
            fail(f"restored state differs from the trained one: {bad[:5]}")
        del resumed, check
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    return {
        "solver": "models/alexnet/solver.prototxt", "batch": 256,
        "iters": TRAIN_ITERS, "losses": losses,
        "median_step_ms": summary["median_iter_ms"],
        "img_per_s": summary["img_per_s"],
        "step_ms": summary["iter_ms"],
        "test_scores": summary["test_scores"],
        "lrn_fwd_launches": n_fwd, "lrn_bwd_launches": n_bwd,
        "resumed_loss": again["losses"][0], "peak_mem_GB": peak_gb,
        "profile": profile,
        "device_busy": profile["device_ms_per_step"]
        / summary["median_iter_ms"]
        if isinstance(profile["device_ms_per_step"], float) else None,
        "card": card,
    }


def profile_steps(solver, feed_fn, n: int = 3) -> dict:
    """Where a training step's device time goes: `n` more iterations under
    torch.profiler, device time summed by kernel and by the aten op that
    launched it, beside the steps' wall time under the profiler (which
    slows the host). If the profiler sees no device time, the breakdown is
    reported as not measured."""
    from torch.profiler import ProfilerActivity, profile

    def dev(evt, self_only):
        for name in (("self_device_time_total", "self_cuda_time_total")
                     if self_only else ("device_time_total",
                                        "cuda_time_total")):
            if hasattr(evt, name):
                return float(getattr(evt, name))
        return 0.0

    solver.step(1, feed_fn)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solver.step(n, feed_fn)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    kernels = sorted(((dev(e, True) / 1e3 / n, e.key) for e in events
                      if str(e.device_type).endswith("CUDA")),
                     reverse=True)
    device_ms = sum(ms for ms, _ in kernels)
    if device_ms == 0.0:
        return {"wall_ms_per_step": wall_ms / n,
                "device_ms_per_step": "not measured"}
    ops = sorted(((dev(e, False) / 1e3 / n, e.key) for e in events
                  if e.key.startswith("aten::") and dev(e, False) > 0),
                 reverse=True)
    return {
        "wall_ms_per_step": wall_ms / n, "device_ms_per_step": device_ms,
        "device_busy_profiled": device_ms / (wall_ms / n),
        "lrn_ms_per_step": {k: sum(ms for ms, name in kernels if k in name)
                            for k in ("lrn_fwd_kernel", "lrn_bwd_kernel")},
        "top_kernels_ms": [[round(ms, 4), name[:90]]
                           for ms, name in kernels[:15]],
        "top_aten_ops_ms": [[round(ms, 4), name] for ms, name in ops[:15]],
    }


# -- 6. parity ----------------------------------------------------------------

PARITY_BATCH = 16


def _parity_solver_param():
    """models/alexnet/solver.prototxt with its net inline, the Input dims
    cut to PARITY_BATCH, TF32 off through default_forward_math: FLOAT, and
    no test net."""
    from caffe_mpi_tpu_torch.proto import NetParameter, SolverParameter
    sp = SolverParameter.from_file(SOLVER)
    net = NetParameter.from_file(os.path.join(ROOT, sp.net))
    net.default_forward_math = "FLOAT"
    for lp in net.layer:
        if lp.type == "Input":
            for shape in lp.input_param.shape:
                shape.dim[0] = PARITY_BATCH
    sp.net, sp.net_param = "", net
    sp.test_iter, sp.test_interval = [], 0
    return sp


# gradient limits, as a share of the largest element: layers above
# AlexNet's last max pool (fc6-fc8) against those at or below it (conv1-5),
# whose gradients pass through a max pool's backward: it sends each
# window's gradient to the window's arg-max, and near-ties flip under any
# change of summation order (a one-rounding change of the CPU's own input
# moves them by ~1e-3, reported as grad_cpu_perturbed)
GRAD_LIMIT = {"fc": 1e-4, "conv": 2e-2}


def parity_phase() -> dict:
    """One SGD step on the card against the CPU, TF32 off: the loss within
    1e-5 of its size; each parameter's gradient within GRAD_LIMIT of its
    largest element; each updated parameter within base_lr x lr_mult x
    that limit x the gradient's largest element, plus two f32 ulps of the
    largest weight (the update is a step of lr x gradient, rounded into
    the weight)."""
    from caffe_mpi_tpu_torch.core.types import DtypePolicy
    from caffe_mpi_tpu_torch.solver import Solver
    from caffe_mpi_tpu_torch.tools import cli

    def one_step(device, feeds_cpu, tf32_backward=False):
        solver = Solver(_parity_solver_param(), device=device)
        if tf32_backward:
            solver._math = DtypePolicy(precision="default")
        feeds = {k: v.to(device) for k, v in feeds_cpu.items()}
        masks = {k: v.to(device) for k, v in masks_cpu.items()}
        w0 = {f"{l}.{p}": t.detach().cpu().clone()
              for l, p, _, t in solver._decls}
        solver.step(1, lambda it: feeds, dropout_masks=lambda it, m: masks)
        out = {"loss": solver.losses[0], "w0": w0, "grad": {}, "w": {},
               "lr_mult": {}}
        for l, p, decl, t in solver._decls:
            key = f"{l}.{p}"
            out["w"][key] = t.detach().cpu()
            out["grad"][key] = t.grad.detach().cpu()
            out["lr_mult"][key] = decl.lr_mult
        return out

    probe = Solver(_parity_solver_param(), device="cpu")
    base_lr = probe.sp.base_lr
    feeds = cli.synthetic_feed(probe.net, seed=0)
    gen = torch.Generator().manual_seed(0)
    masks_cpu = {layer.name: torch.rand(
        probe.net.blob_shapes[layer.lp.bottom[0]], generator=gen) < 0.5
        for layer in probe.net.layers if layer.lp.type == "Dropout"}
    del probe
    perturbed = dict(feeds)
    perturbed["data"] = feeds["data"] * (1 + 1e-7 * torch.randn(
        feeds["data"].shape, generator=torch.Generator().manual_seed(1)))
    cpu = one_step("cpu", feeds)
    cpu_pert = one_step("cpu", perturbed)
    card = one_step("cuda", feeds)
    if any(not torch.equal(cpu["w0"][k], card["w0"][k]) for k in cpu["w0"]):
        fail("card and CPU solvers did not start from the same weights")
    tf32 = one_step("cuda", feeds, tf32_backward=True)

    def grad_rel(run, key):
        ref = cpu["grad"][key]
        return float((run["grad"][key] - ref).abs().max()) \
            / float(ref.abs().max())

    def w_diff(run, key):
        return float((run["w"][key] - cpu["w"][key]).abs().max())

    params, bad = {}, []
    eps = torch.finfo(torch.float32).eps
    for key in cpu["grad"]:
        limit = GRAD_LIMIT["fc" if key.startswith("fc") else "conv"]
        w_limit = (base_lr * cpu["lr_mult"][key] * limit
                   * float(cpu["grad"][key].abs().max())
                   + 2 * eps * float(cpu["w0"][key].abs().max()))
        row = {"grad": grad_rel(card, key), "grad_limit": limit,
               "grad_cpu_perturbed": grad_rel(cpu_pert, key),
               "grad_tf32_backward": grad_rel(tf32, key),
               "w": w_diff(card, key), "w_limit": w_limit,
               "w_tf32_backward": w_diff(tf32, key)}
        if not row["grad"] <= limit:
            bad.append(f"grad {key}: {row['grad']:.3g} > {limit:.3g}")
        if not row["w"] <= w_limit:
            bad.append(f"updated {key}: {row['w']:.3g} > {w_limit:.3g}")
        params[key] = row
    res = {"batch": PARITY_BATCH, "loss_cpu": cpu["loss"],
           "loss_card": card["loss"], "loss_tf32_backward": tf32["loss"],
           "conv1_grad_max_abs": float(card["grad"]["conv1.weight"].abs()
                                       .max()),
           "params": params}
    log(f"train parity: {json.dumps(res)}")
    if float(cpu["grad"]["conv1.weight"].abs().max()) == 0.0 or \
            res["conv1_grad_max_abs"] == 0.0:
        fail("conv1 got no gradient")
    if abs(card["loss"] - cpu["loss"]) > 1e-5 * abs(cpu["loss"]):
        fail(f"loss on the card {card['loss']} vs CPU {cpu['loss']}")
    if bad:
        fail(f"train parity: {bad}")
    return res


def main() -> int:
    os.chdir(ROOT)
    card, rates = device_phase()
    build_phase()
    k1 = kernel_phase(rates)
    k2 = kernel_bwd_phase(rates)
    serving = serve_phase(k1, card)
    train = train_phase(k1, k2, card)
    train["parity"] = parity_phase()
    print(json.dumps({"kernels": [k1, k2]}), flush=True)
    print(json.dumps({"serving": serving}), flush=True)
    print(json.dumps({"train": train}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
