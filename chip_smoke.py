#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (caffe_mpi_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py          # from the root of the repository
    python3 chip_smoke.py --parent DIR   # also time the parent's K1-K5

Phases, in order; any failure exits nonzero and prints no result line:

1. device  — requires torch.cuda.is_available(); prints the card's name and
             power limit as nvidia-smi reports them.
2. build   — builds every CUDA kernel of the port from csrc/ with nvcc for
             sm_90a, and the host crc32c of the LMDB sidecar with the
             host C++ compiler (one compiler per source, all started
             together).
3. kernels — holds each kernel against its plain PyTorch version on the card
             at the shapes the serving and training paths give it (and at
             edge shapes: the LRN kernels at windows 1 to 17, both sides
             of the templated windows' edge, and at 70,000 images, and at
             GoogLeNet's pool1/norm1 and conv2/norm2 at batch 128; the
             flash kernels at 70,000 batch x heads, and at head dims 160
             and 256, past the tensor-core kernels' 128, where the wrappers
             launch the wide kernels), in float32 and bfloat16, and times
             the kernel,
             the plain version and the library call that computes the same
             function: K1, the LRN forward, against F.local_response_norm;
             K2, the LRN backward, against torch.autograd.grad through
             F.local_response_norm; K3, the flash-attention forward, and
             K4 and K5, its dQ and dK/dV kernels (on the tensor cores),
             against F.scaled_dot_product_attention and torch.autograd.grad
             through it (one call for dQ, dK and dV) on 4-D views, each
             fused backend pinned alone, the fastest named, the math path
             beside it — at transformer_lm's shape (BH 32, S 64, D 32),
             non-causal, bf16, the deploy net's BH 40, S 100 with D 20,
             S = 200 padded to 256, a bias masking a whole tile, and S
             1024/2048 at D 32, 64 and 128. With `--parent DIR` (a
             checkout of the parent commit) the parent's K1-K5 are built
             and timed in turns with this tree's. Then autograd
             through flash_attention on the card against the CPU.
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

7. transformer — trains models/transformer_lm (full width, batch 8,
             sequence 64, Adam) from a temporary copy of its solver and net
             with `use_flash: true`, through the CLI's `train`: 20
             iterations and a final test pass of 2 batches, launch counts
             set to 0 just before and read just after (K3 twice a forward,
             K4 and K5 twice an iteration), finite losses, a nonzero
             gradient on blk0/attn.qkv_weight with the attention output's
             graph through the kernels' autograd Function, a torch.profiler
             breakdown, and a resume from the snapshot (weights and both
             Adam slots bitwise, one more step).
8. induction — the induction task of tests/test_sequence_layers.py with
             use_flash: 300 Adam steps on the card, held-out accuracy
             >= 0.9.
9. transformer parity — one Adam step of transformer_lm at batch 8 on the
             card against the CPU, TF32 off: MoE routes equal first, then
             the loss within 1e-5 of its size, each gradient within 1e-4 of
             its largest element, each update within Adam's sensitivity to
             that limit; and the deploy net's prob rows (batch 10, BH 40)
             within 1e-5 of the largest.
10. resnet50 — trains models/resnet50/solver.prototxt as written (batch
             32, 224x224, 53 BatchNorms with scale_bias, poly LR with
             ramp-up) through the CLI's `train`: 20 iterations, a test
             pass of 2 batches at iteration 0 and at the end through the
             statistics the test net shares, launch counts set to 0 just
             before and read just after (ResNet-50 runs none of K1-K5);
             finite losses, every running mean and variance moved from 0
             and finite, a torch.profiler split of a step (convolution
             forward and backward, BatchNorm, elementwise, the rest; the
             card's busy share). Then a resume from the snapshot (weights,
             history and running statistics bitwise, one more step), the
             deploy net served from the snapshot's caffemodel at buckets
             1, 4 and 10, every row against the TEST-phase Net's forward
             on the card, and one SGD step at batch 16 on the card against
             the CPU (limits at RESNET_SPREAD_FACTOR), with BatchNorm's
             two designs held against each other on the card.
11. googlenet — trains models/googlenet/solver.prototxt as written (batch
             128, three losses weighted 0.3, 0.3 and 1) through the CLI's
             `train`: 20 iterations, finite losses, K1 twice a forward and
             K2 twice an iteration, counts set to 0 just before and read
             just after.

12. lmdb  — trains examples/imagenet/caffenet_train_val.prototxt as written
             (batch 256, crop 227, mirror, a mean file) from a train LMDB
             of 1,280 raw 3x256x256 Datums and a val LMDB of 100, both
             written by the port's writer from seeded clusters, with the
             mean from the port's compute_image_mean, through the CLI's
             `train` without -synthetic (20 iterations, test passes of 2
             batches at iteration 10 and at the end, the device
             transform on): finite losses, test scores, K1 twice a
             forward and K2 twice an iteration (counts set to 0 just
             before, read just after). Then the card's busy share under
             the profiler, the same solver on a synthetic feed, `test`
             on the val LMDB from the snapshot's caffemodel, `time` on
             the net (whole step, MFU), `device_query`, one batch of the
             card's device transform against the host DataTransformer
             (bitwise), and 8 iterations over a JPEG-encoded LMDB of 256
             records.

13. bf16  — trains AlexNet at batch 256 from
             models/alexnet/solver_fp16.prototxt (FLOAT16 net defaults)
             and from solver.prototxt under `-precision bf16` (dynamic
             loss scale, the skip-step guard armed), 20 iterations each,
             and transformer_lm with use_flash under `-precision bf16`,
             through the CLI's `train`, launch counts set to 0 just
             before and read just after: K1/K2 (K3-K5) as many times as
             in f32, every launch's input bfloat16 (recorded at the
             kernels' launchers), finite losses, no skipped or overflow
             step; step ms and img/s beside the f32 runs; `time` on the
             fp16 net with its MFU against the dense bf16 peak; and
             ResNet-50 (b32) and GoogLeNet (b128, K1/K2 in bf16) from
             their solver_fp16.prototxt, 20 iterations each.
14. chunk — `-step_chunk 10` on AlexNet (b256), ResNet-50 (b32) and
             transformer_lm (use_flash): two eager runs (step_chunk 1)
             and one of CUDA graph replays from the same seed and feeds;
             the graph's losses and final params, slots and statistics
             within twice the eager runs' spread (each tensor's distance
             from the nearer eager run as a share of its largest
             element, the worst over all tensors, plus 1e-6), its
             Dropout masks the eager
             path's (and in the graph's static inputs), its kernel
             launches the eager run's (the captured counts added at each
             replay); then, warm, 20 iterations at K = 1 and K = 10 in
             mirrored order under the CUDA sync debugger (one host sync
             a chunk at K = 10, or the phase fails; the K = 1 count and
             every sync's source line reported), step ms, and the card's
             busy share under the profiler.
15. overflow — AlexNet b256 under bf16 and step_chunk 10 with NaN
             batches at iterations 3 and 4: both skipped (params and
             slots bitwise unchanged), counted as overflows, the scale
             2^15 -> 2^13, then regrown to 2^15 by 8 clean steps
             (loss_scale_window 4), finite losses.

It prints one {"kernels": [...]} line (K1-K5), one {"serving": ...} line,
one {"train": ...} line, one {"transformer": ...} line, one
{"resnet50": ...} line, one {"googlenet": ...} line, one {"lmdb": ...}
line, one {"bf16": ...} line, one {"chunk": ...} line (the overflow
phase inside it), the card line again, and last {"ok": true, ...}.
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


def f32_product_rate(rates) -> float:
    """The rate of an f32 matrix product held at f32 accuracy on the tensor
    cores: 3xTF32, three TF32 products (dense TF32 is half the bf16 rate)
    for each — 164.8 TFLOP/s on the H100 SXM. K4 and K5 multiply f32 that
    way, as PyTorch's own f32 attention does, so the flash bounds take this
    rate for f32 inputs; taken at the CUDA cores' 67 TFLOP/s, a 3xTF32
    kernel could read past 100% of its bound."""
    return rates[2] / 2 / 3

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
    # (memory bytes/s, float32 flop/s outside the tensor cores, dense bf16
    # tensor-core flop/s), NVIDIA data sheets: the repo's one table. The
    # LRN kernels' work is elementwise, so their bounds take the CUDA
    # cores' f32 rate.
    from caffe_mpi_tpu_torch.utils.flops import card_rates
    name = torch.cuda.get_device_name(0)
    rates = card_rates(name)
    if rates is None:
        fail(f"no published rates for {name!r}; add it to CARD_RATES in "
             "caffe_mpi_tpu_torch/utils/flops.py")
    return card, rates


# -- 2. build -----------------------------------------------------------------

def build_phase() -> None:
    from caffe_mpi_tpu_torch.ops import build
    t0 = time.perf_counter()
    secs = build.build_all()
    log(f"build: {json.dumps(secs)} ({time.perf_counter() - t0:.1f} s "
        "wall, nvcc for sm_90a, c++ for host code)")


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
    mem_rate, f32_rate = rates[:2]
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
# every templated window's edge, and past it the runtime-window kernels
EDGE_SIZES = (1, 3, 5, 7, 15, 17)
# more images than a second grid axis holds (65,535); two runs of 16
# channels, so the one-axis grid folds runs and images
MANY_IMAGES = (70000, 20, 2, 2)


def _alexnet_lrn_shapes(batches):
    for b in batches:
        yield "norm1", (b, 96, 55, 55)
        yield "norm2", (b, 256, 27, 27)


# GoogLeNet's two LRNs at its training batch, local_size 5, alpha 1e-4,
# beta 0.75, as AlexNet's (models/googlenet/train_val.prototxt
# pool1/norm1, conv2/norm2)
GOOGLENET_LRN_SHAPES = (("googlenet/pool1/norm1", (128, 64, 56, 56)),
                        ("googlenet/conv2/norm2", (128, 192, 56, 56)))


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
        **({"parent_kernel_ms": head["parent_kernel_ms"]}
           if "parent_kernel_ms" in head else {}),
        **per, "cases": cases,
    }


def _held(kind, got, want, dtype) -> tuple[float, bool]:
    """(max abs error, bitwise) of a kernel's output against its plain
    version's; fails past TOL."""
    try:
        torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    except AssertionError as e:
        fail(f"{kind} against its plain version: {str(e).splitlines()[0]}")
    return float((got.float() - want.float()).abs().max()), \
        bool(torch.equal(got, want))


def _edge_checks(kind, check) -> dict:
    """`check(shape, dtype, size, alpha, beta, k)` -> (max abs error,
    bitwise) at every edge shape and window size, and at MANY_IMAGES
    (sizes 5 and 17), in both types: the worst error and whether every
    case was bitwise."""
    out = {"max_abs_err": 0.0, "bitwise": True, "cases": 0}
    cases = [(shape, size) for shape in EDGE_SHAPES for size in EDGE_SIZES]
    cases += [(MANY_IMAGES, 5), (MANY_IMAGES, 17)]
    for shape, size in cases:
        for dtype in TOL:
            err, exact = check(shape, dtype, size, 1e-2, 0.75, 2.0)
            out["max_abs_err"] = max(out["max_abs_err"], err)
            out["bitwise"] &= exact
            out["cases"] += 1
    log(f"{kind} edges: {json.dumps(out)} (sizes {list(EDGE_SIZES)}, "
        f"{MANY_IMAGES[0]} images at 5 and 17)")
    return out


def kernel_phase(rates, parent_lrn=None) -> dict:
    """K1, the LRN forward, at the edge shapes and windows, at 70,000
    images, and at AlexNet's norm1 and norm2 for every serving bucket (1,
    4, 10) and the training batch 256, each case timed against its bound;
    with `parent_lrn` (a parent checkout's built lrn library), the
    parent's K1 is timed in turns with this tree's."""
    import torch.nn.functional as F
    from caffe_mpi_tpu_torch.ops import lrn as lrn_op

    gen = torch.Generator(device="cuda").manual_seed(0)

    def check(shape, dtype, size, alpha, beta, k):
        x = (torch.randn(shape, generator=gen, device="cuda") * 4).to(dtype)
        y = lrn_op.lrn_across_channels(x, size, alpha, beta, k)
        r = lrn_op.lrn_across_channels_ref(x, size, alpha, beta, k)
        torch.cuda.synchronize()
        return _held("lrn_fwd", y, r, dtype)

    edges = _edge_checks("lrn_fwd", check)
    max_err, bitwise = edges["max_abs_err"], edges["bitwise"]
    cases = []
    args = (LRN["size"], LRN["alpha"], LRN["beta"], LRN["k"])
    for layer, shape in (*_alexnet_lrn_shapes((1, 4, 10, 256)),
                         *GOOGLENET_LRN_SHAPES):
        for dtype in TOL:
            x = (torch.randn(shape, generator=gen, device="cuda") * 4).to(
                dtype)
            err, exact = _held(
                "lrn_fwd", lrn_op.lrn_across_channels(x, *args),
                lrn_op.lrn_across_channels_ref(x, *args), dtype)
            max_err, bitwise = max(max_err, err), bitwise and exact
            bound, by = lrn_bound(shape, dtype, LRN["size"], rates)
            ms, parent = in_turns(
                lambda: lrn_op.lrn_across_channels(x, *args),
                None if parent_lrn is None else
                lambda: call_lrn_fwd(parent_lrn, x, *args))
            case = {
                "layer": layer, "shape": list(shape),
                "dtype": str(dtype).replace("torch.", ""),
                "max_abs_err": err, "bitwise": exact, "kernel_ms": ms,
                "plain_ms": time_ms(
                    lambda: lrn_op.lrn_across_channels_ref(x, *args)),
                "library_ms": time_ms(
                    lambda: F.local_response_norm(x, *args)),
                "bound_ms": bound, "bound_by": by,
                "kernel_GB_s": 2 * x.numel() * x.element_size()
                / (ms * 1e-3) / 1e9,
                "share_of_bound": bound / ms, **parent,
            }
            if case["share_of_bound"] > 1:
                fail(f"lrn_fwd {layer} {case['dtype']}: {ms:.4g} ms under "
                     f"its bound {bound:.4g} ms")
            cases.append(case)
            log(f"lrn {json.dumps(case)}")
            del x
            torch.cuda.empty_cache()
    return _kernel_entry("lrn_fwd", "caffe_mpi_tpu_torch/csrc/lrn.cu",
                         lrn_op.REPLACES, cases, max_err,
                         {"launches_per_forward": 2, "bitwise": bitwise,
                          "edges": edges})


def kernel_bwd_phase(rates, parent_lrn=None) -> dict:
    """K2, the LRN backward, at the edge shapes and windows, at 70,000
    images, and at AlexNet's norm1 and norm2 for the training batch 256.
    The library call is the backward of F.local_response_norm, timed as
    torch.autograd.grad over a graph built once; each case frees its
    tensors before the next. With `parent_lrn` (a parent checkout's built
    lrn library), the parent's K2 is timed in turns with this tree's
    (parent, kernel, kernel, parent)."""
    import torch.nn.functional as F
    from caffe_mpi_tpu_torch.ops import lrn as lrn_op

    gen = torch.Generator(device="cuda").manual_seed(1)
    args = (LRN["size"], LRN["alpha"], LRN["beta"], LRN["k"])

    def inputs(shape, dtype):
        x = (torch.randn(shape, generator=gen, device="cuda") * 4).to(dtype)
        return x, torch.randn(shape, generator=gen, device="cuda").to(dtype)

    def check(shape, dtype, size, alpha, beta, k):
        x, dy = inputs(shape, dtype)
        dx = lrn_op.lrn_across_channels_bwd(x, dy, size, alpha, beta, k)
        r = lrn_op.lrn_across_channels_bwd_ref(x, dy, size, alpha, beta, k)
        torch.cuda.synchronize()
        return _held("lrn_bwd", dx, r, dtype)

    edges = _edge_checks("lrn_bwd", check)
    max_err, bitwise = edges["max_abs_err"], edges["bitwise"]
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
    for layer, shape in (*_alexnet_lrn_shapes((256,)),
                         *GOOGLENET_LRN_SHAPES):
        for dtype in TOL:
            x, dy = inputs(shape, dtype)
            err, exact = _held(
                "lrn_bwd", lrn_op.lrn_across_channels_bwd(x, dy, *args),
                lrn_op.lrn_across_channels_bwd_ref(x, dy, *args), dtype)
            max_err, bitwise = max(max_err, err), bitwise and exact
            bound, by = lrn_bound(shape, dtype, LRN["size"], rates,
                                  tensors=3, ops_per_elem=3 * LRN["size"]
                                  + 10)
            ms, parent = in_turns(
                lambda: lrn_op.lrn_across_channels_bwd(x, dy, *args),
                None if parent_lrn is None else
                lambda: call_lrn_bwd(parent_lrn, x, dy, *args))
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
                "max_abs_err": err, "bitwise": exact, "kernel_ms": ms,
                "plain_ms": plain,
                "library_ms": library, "bound_ms": bound, "bound_by": by,
                "kernel_GB_s": 3 * x.numel() * x.element_size()
                / (ms * 1e-3) / 1e9,
                "share_of_bound": bound / ms, **parent,
            }
            if case["share_of_bound"] > 1:
                fail(f"lrn_bwd {layer} {case['dtype']}: {ms:.4g} ms under "
                     f"its bound {bound:.4g} ms")
            cases.append(case)
            log(f"lrn_bwd {json.dumps(case)}")
            del x, dy
            torch.cuda.empty_cache()
    return _kernel_entry("lrn_bwd", "caffe_mpi_tpu_torch/csrc/lrn.cu",
                         lrn_op.REPLACES_BWD, cases, max_err,
                         {"launches_per_iteration": 2, "bitwise": bitwise,
                          "edges": edges})


# -- 3b. flash attention (K3, K4, K5) ------------------------------------------

# kernel against plain: (rtol, atol as a share of the plain output's
# largest element). f32: both sum in f32 in other orders, over up to 2048
# keys or queries; bf16: one bf16 ulp of the output, as the LRN kernels
FLASH_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (8e-3, 1e-5)}
# the training path's attention: transformer_lm at batch 8, 4 heads,
# sequence 64, head dim 32
FLASH_PATH = dict(bh=32, s=64, d=32)
# head dims past the tensor-core kernels' 128, which the wide kernels take
WIDE_HEAD_DIMS = (160, 256)


def _flash_cases():
    """(label, BH, S, D, dtype, causal, sk_valid, bias). The first is the
    path's shape; then the edge shapes: non-causal, bf16, the deploy net's
    batch 10, a ragged length with an odd head dim, S = 200 padded to 256
    as flash_attention pads it, a bias masking a whole 128-wide tile, and
    long sequences at three head dims."""
    f32, bf16 = torch.float32, torch.bfloat16
    yield "path", 32, 64, 32, f32, True, None, False
    yield "path_noncausal", 32, 64, 32, f32, False, None, False
    yield "path_bf16", 32, 64, 32, bf16, True, None, False
    yield "deploy_b10", 40, 64, 32, f32, True, None, False
    # lengths up to 128 go unpadded: ragged 64-row tiles, odd head dim
    yield "ragged_s100_d20", 8, 100, 20, f32, True, None, False
    yield "pad_s200", 32, 256, 32, f32, True, 200, False
    yield "pad_s200_noncausal", 32, 256, 32, f32, False, 200, False
    yield "bias_tile", 32, 256, 32, f32, False, None, True
    yield "bias_tile_causal_bf16", 32, 256, 64, bf16, True, None, True
    for s in (1024, 2048):
        for d in (32, 64, 128):
            yield f"s{s}_d{d}", 32, s, d, f32, True, None, False
    yield "s2048_d128_noncausal", 32, 2048, 128, f32, False, None, False
    yield "s2048_d128_bf16", 32, 2048, 128, bf16, True, None, False
    # past the tensor-core kernels' 128: the wide kernels
    for d in WIDE_HEAD_DIMS:
        yield f"wide_s1024_d{d}", 32, 1024, d, f32, True, None, False
        yield f"wide_s1024_d{d}_bf16", 32, 1024, d, bf16, True, None, False
    yield "wide_pad_s200_d160", 8, 256, 160, f32, True, 200, False
    yield "wide_bias_tile_d256_bf16", 8, 256, 256, bf16, False, None, True


def flash_bound(kind, bh, s, d, dtype, causal, sk_valid, bias, rates):
    """Least time for one kernel's work: each input read once and each
    output written once over the memory rate, against 4 (K3), 6 (K4) or 8
    (K5) flops x D for every unmasked (query, key) pair over the 3xTF32
    rate (f32 inputs, `f32_product_rate`) or the bf16 tensor-core peak
    (bf16 inputs). K5 has no sk_valid mask, so its pairs run over every
    key."""
    mem_rate, bf16_rate = rates[0], rates[2]
    isz = torch.empty((), dtype=dtype).element_size()
    mat = bh * s * d * isz                 # one (BH, S, D) tensor
    rows = bh * s * 4                      # one f32 (BH, S) vector
    extra = s * 4 if bias else 0
    nbytes = {"fwd": 4 * mat + rows, "dq": 5 * mat + 2 * rows,
              "dkv": 6 * mat + 2 * rows}[kind] + extra
    limit = s if (kind == "dkv" or sk_valid is None) else sk_valid
    per_row = np.minimum(np.arange(s) + 1, limit) if causal \
        else np.full(s, limit)
    flops = {"fwd": 4, "dq": 6, "dkv": 8}[kind] * bh * d \
        * float(per_row.sum())
    peak = f32_product_rate(rates) if dtype == torch.float32 else bf16_rate
    t_bytes, t_ops = nbytes / mem_rate * 1e3, flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _flash_close(name, got, want, dtype):
    """Max abs error of got against want; fails past FLASH_TOL."""
    rtol, share = FLASH_TOL[dtype]
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    err = float(diff.max())
    if not bool(torch.all(diff <= share * float(w.abs().max())
                          + rtol * w.abs())):
        fail(f"{name}: kernel against plain max abs error {err:.3g} "
             f"(largest plain element {float(w.abs().max()):.3g})")
    return err


# PyTorch's fused attention backends, each timed pinned alone
# (FLASH_ATTENTION takes 16-bit inputs without a mask only); MATH, the
# unfused path, is timed beside them.
FUSED_BACKENDS = ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION")


def sdpa_library(q, k, v, do, mask, causal) -> dict:
    """The library yardstick of K3 (forward) and K4 + K5 (one backward call
    computing dQ, dK and dV): F.scaled_dot_product_attention on 4-D views
    (1, BH, S, D) of the same tensors — the fused backends take only 4-D
    inputs, and a 3-D call falls back to the math path — with the mask as
    (1, 1 or BH, S, S). Each fused backend runs pinned alone under
    sdpa_kernel, so a backend that refuses the case raises and is skipped
    by name instead of falling back to math quietly. The fastest fused
    forward and backward are the library's times; the math path's stand
    beside them."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    q4, k4, v4, do4 = (t.unsqueeze(0) for t in (q, k, v, do))
    m4 = None if mask is None else mask.reshape(1, -1, *mask.shape[-2:])
    kw = dict(attn_mask=m4, is_causal=causal and mask is None)
    times, refused = {}, {}
    for name in (*FUSED_BACKENDS, "MATH"):
        backend = getattr(SDPBackend, name, None)
        if backend is None:
            refused[name] = "not in this PyTorch"
            continue
        try:
            with sdpa_kernel([backend]):
                fwd = time_ms(lambda: F.scaled_dot_product_attention(
                    q4, k4, v4, **kw))
                qg, kg, vg = (t.detach().clone().requires_grad_()
                              for t in (q4, k4, v4))
                og = F.scaled_dot_product_attention(qg, kg, vg, **kw)
            bwd = time_ms(lambda: torch.autograd.grad(
                og, (qg, kg, vg), do4, retain_graph=True))
            del qg, kg, vg, og
        except RuntimeError as e:
            refused[name] = str(e).strip().splitlines()[0][:160]
            continue
        times[name] = (fwd, bwd)
    fused = {n: t for n, t in times.items() if n != "MATH"}
    out = {"refused": refused}
    for i, kind in enumerate(("fwd", "bwd")):
        best = min(fused, key=lambda n: fused[n][i]) if fused else None
        out[kind] = {"library_ms": fused[best][i] if best else None,
                     "library_backend": best,
                     "library_math_ms": times["MATH"][i]
                     if "MATH" in times else None,
                     "library_fused_ms": {n: t[i] for n, t in fused.items()}}
    return out


def in_turns(run, run_parent=None) -> tuple[float, dict]:
    """The kernel's time; with `run_parent`, the parent's kernel and this
    tree's timed in turns (parent, kernel, kernel, parent) on the same
    inputs: (mean of the kernel's two, the parent's fields)."""
    if run_parent is None:
        return time_ms(run), {}
    p1 = time_ms(run_parent)
    ms = time_ms(run)
    ms2 = time_ms(run)
    p2 = time_ms(run_parent)
    ms_mean = (ms + ms2) / 2
    return ms_mean, {"parent_kernel_ms": (p1 + p2) / 2,
                     "parent_kernel_ms_turns": [p1, p2],
                     "kernel_ms_turns": [ms, ms2],
                     "speedup_over_parent": (p1 + p2) / 2 / ms_mean}


def build_lib(src: str, out: str, extra=()) -> str:
    """A kernel source (`src`) built with the port's nvcc flags and
    `extra` into the shared library `out`; returns nvcc's output (the
    `-Xptxas -v` lines where asked for). Fails on an nvcc error."""
    from caffe_mpi_tpu_torch.ops import build
    proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, *extra,
                           "-o", out, src], capture_output=True, text=True,
                          timeout=900)
    if proc.returncode != 0:
        fail(f"nvcc failed on {src}: {proc.stderr[-2000:]}")
    return proc.stdout + proc.stderr


def bind_flash(path: str):
    """The K3, K4 and K5 C entry points of a built flash_attention library;
    every version of the source takes the same arguments."""
    import ctypes
    lib = ctypes.CDLL(path)
    P, I, F_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for dt in ("f32", "bf16"):
        getattr(lib, f"flash_fwd_{dt}").argtypes = [P] * 6 + [I] * 6 \
            + [F_, P]
        getattr(lib, f"flash_bwd_dq_{dt}").argtypes = [P] * 8 + [I] * 6 \
            + [F_, P]
        getattr(lib, f"flash_bwd_dkv_{dt}").argtypes = [P] * 9 + [I] * 5 \
            + [F_, P]
    return lib


def bind_lrn(path: str):
    """The K1 and K2 C entry points of a built lrn library; every version
    of the source takes the same arguments."""
    import ctypes
    lib = ctypes.CDLL(path)
    P, I, F_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for dt in ("f32", "bf16"):
        getattr(lib, f"lrn_fwd_{dt}").argtypes = [P, P, I, I, I, I, F_, F_,
                                                  F_, P]
        getattr(lib, f"lrn_bwd_{dt}").argtypes = [P, P, P, I, I, I, I, F_,
                                                  F_, F_, F_, P]
    return lib


def parent_libs(parent: str):
    """The kernels of a parent checkout (`--parent DIR`), built from
    DIR/caffe_mpi_tpu_torch/csrc/flash_attention.cu and lrn.cu (in
    parallel) into a temporary directory, so that one call times the
    parent's K1-K5 beside this tree's on the same card and inputs:
    (flash library, lrn library)."""
    srcs = [os.path.join(parent, "caffe_mpi_tpu_torch", "csrc", name)
            for name in ("flash_attention.cu", "lrn.cu")]
    for src in srcs:
        if not os.path.isfile(src):
            fail(f"--parent: no {src}")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_parent_")
    try:
        outs = [os.path.join(tmp, f"libparent_{i}.so") for i in range(2)]
        with ThreadPoolExecutor(2) as ex:
            list(ex.map(build_lib, srcs, outs))
        return bind_flash(outs[0]), bind_lrn(outs[1])  # loaded
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def call_lrn_fwd(lib, x, size, alpha, beta, k):
    """One launch of a bound library's K1; returns y."""
    n, c, h, w = x.shape
    y = torch.empty_like(x)
    dt = "f32" if x.dtype == torch.float32 else "bf16"
    err = getattr(lib, f"lrn_fwd_{dt}")(
        x.data_ptr(), y.data_ptr(), n, c, h * w, size, alpha / size, beta, k,
        torch.cuda.current_stream().cuda_stream)
    if err:
        fail(f"lrn_fwd launch failed: cudaError {err}")
    return y


def call_lrn_bwd(lib, x, dy, size, alpha, beta, k):
    """One launch of a bound library's K2; returns dx."""
    n, c, h, w = x.shape
    dx = torch.empty_like(x)
    dt = "f32" if x.dtype == torch.float32 else "bf16"
    err = getattr(lib, f"lrn_bwd_{dt}")(
        x.data_ptr(), dy.data_ptr(), dx.data_ptr(), n, c, h * w, size,
        alpha / size, beta, k, 2.0 * alpha * beta / size,
        torch.cuda.current_stream().cuda_stream)
    if err:
        fail(f"lrn_bwd launch failed: cudaError {err}")
    return dx


def call_flash_fwd(lib, q, k, v, causal, sk_valid, kb):
    """One launch of a bound library's K3; returns (o, lse)."""
    import math
    dt = "f32" if q.dtype == torch.float32 else "bf16"
    bh, sq, d = q.shape
    sk = k.shape[1]
    o = torch.empty_like(q)
    lse = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
    err = getattr(lib, f"flash_fwd_{dt}")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if kb is None else kb.data_ptr(), o.data_ptr(), lse.data_ptr(),
        bh, sq, sk, d, sk if sk_valid is None else sk_valid, int(causal),
        1.0 / math.sqrt(d), torch.cuda.current_stream().cuda_stream)
    if err:
        fail(f"fwd kernel launch failed: cudaError {err}")
    return o, lse


def call_flash_bwd(lib, kind, q, k, v, do, lse, delta, causal, sk_valid,
                   kb):
    """One launch of a bound library's K4 (kind "dq") or K5 ("dkv");
    returns (dq,) or (dk, dv)."""
    import math
    dt = "f32" if q.dtype == torch.float32 else "bf16"
    bh, sq, d = q.shape
    sk = k.shape[1]
    stream = torch.cuda.current_stream().cuda_stream
    common = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
              lse.data_ptr(), delta.data_ptr(),
              None if kb is None else kb.data_ptr())
    if kind == "dq":
        out = (torch.empty_like(q),)
        err = getattr(lib, f"flash_bwd_dq_{dt}")(
            *common, out[0].data_ptr(), bh, sq, sk, d,
            sk if sk_valid is None else sk_valid, int(causal),
            1.0 / math.sqrt(d), stream)
    else:
        out = (torch.empty_like(k), torch.empty_like(v))
        err = getattr(lib, f"flash_bwd_dkv_{dt}")(
            *common, out[0].data_ptr(), out[1].data_ptr(), bh, sq, sk, d,
            int(causal), 1.0 / math.sqrt(d), stream)
    if err:
        fail(f"{kind} kernel launch failed: cudaError {err}")
    return out


def flash_kernel_phase(rates, parent_lib=None) -> list[dict]:
    """K3, K4 and K5 against their plain versions at the path's shape and
    the edge shapes, each timed beside its plain version, the library
    call (`sdpa_library`: the fastest pinned fused backend, and the math
    path) and its bound; with `parent_lib`, the parent's K3, K4 and K5
    too, timed in turns with this tree's (parent, kernel, kernel, parent).
    Then
    autograd through flash_attention on the card against the CPU."""
    from caffe_mpi_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(3)
    cases = {"fwd": [], "dq": [], "dkv": []}
    max_err = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}
    for label, bh, s, d, dtype, causal, sk_valid, bias in _flash_cases():
        q, k, v, do = (torch.randn((bh, s, d), generator=gen, device="cuda")
                       .to(dtype) for _ in range(4))
        kb, mask = None, None
        if sk_valid is not None:  # as flash_attention pads: zero rows
            for t in (q, k, v, do):
                t[:, sk_valid:] = 0
            cols = torch.arange(s, device="cuda")
            mask = cols[None, :] < sk_valid
            if causal:
                mask = mask & (cols[:, None] >= cols[None, :])
        if bias:
            kb = torch.zeros((1, s), device="cuda")
            kb[0, :128] = torch.linspace(-1.0, 1.0, 128, device="cuda")
            kb[0, 128:] = -float("inf")
            mask = kb.reshape(1, 1, s).expand(bh, s, s)
            if causal:
                mask = mask.masked_fill(~torch.ones(
                    (s, s), dtype=torch.bool, device="cuda").tril(),
                    -float("inf"))
        kw = dict(causal=causal, k_bias=kb)
        kq = dict(kw, sk_valid=sk_valid)
        o, lse = fa.flash_fwd(q, k, v, **kq)
        o_ref, lse_ref = fa.flash_fwd_ref(q, k, v, **kq)
        delta = fa._delta(do, o)
        dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, **kq)
        dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
        dq_ref = fa.flash_bwd_dq_ref(q, k, v, do, lse, delta, **kq)
        dk_ref, dv_ref = fa.flash_bwd_dkv_ref(q, k, v, do, lse, delta, **kw)
        torch.cuda.synchronize()
        keep = slice(None) if sk_valid is None else slice(0, sk_valid)
        errs = {
            "fwd": max(_flash_close(f"K3 {label} O", o, o_ref, dtype),
                       _flash_close(f"K3 {label} lse", lse, lse_ref,
                                    torch.float32)),
            "dq": _flash_close(f"K4 {label} dQ", dq, dq_ref, dtype),
            # K5's rows past sk_valid are sliced off by flash_attention
            "dkv": max(_flash_close(f"K5 {label} dK", dk[:, keep],
                                    dk_ref[:, keep], dtype),
                       _flash_close(f"K5 {label} dV", dv[:, keep],
                                    dv_ref[:, keep], dtype)),
        }
        plain_max = {"fwd": float(o_ref.float().abs().max()),
                     "dq": float(dq_ref.float().abs().max()),
                     "dkv": max(float(dk_ref[:, keep].float().abs().max()),
                                float(dv_ref[:, keep].float().abs().max()))}
        lib = sdpa_library(q, k, v, do, mask, causal)
        runs = {
            "fwd": lambda: fa.flash_fwd(q, k, v, **kq),
            "dq": lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, **kq),
            "dkv": lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)}
        plains = {
            "fwd": lambda: fa.flash_fwd_ref(q, k, v, **kq),
            "dq": lambda: fa.flash_bwd_dq_ref(q, k, v, do, lse, delta, **kq),
            "dkv": lambda: fa.flash_bwd_dkv_ref(q, k, v, do, lse, delta,
                                                **kw)}
        for kind in ("fwd", "dq", "dkv"):
            run_parent = None
            if parent_lib is not None and kind == "fwd":
                def run_parent():
                    return call_flash_fwd(parent_lib, q, k, v, causal,
                                          sk_valid, kb)
            elif parent_lib is not None:
                def run_parent(kind=kind):
                    return call_flash_bwd(parent_lib, kind, q, k, v, do,
                                          lse, delta, causal, sk_valid, kb)
            ms, parent = in_turns(runs[kind], run_parent)
            bound, by = flash_bound(kind, bh, s, d, dtype, causal, sk_valid,
                                    bias, rates)
            max_err[kind] = max(max_err[kind], errs[kind])
            case = {"case": label, "shape": [bh, s, d],
                    "dtype": str(dtype).replace("torch.", ""),
                    "causal": causal, "sk_valid": sk_valid, "bias": bias,
                    "max_abs_err": errs[kind],
                    "plain_max_abs": plain_max[kind], "kernel_ms": ms,
                    "plain_ms": time_ms(plains[kind]),
                    **{key: val for key, val in
                       lib["fwd" if kind == "fwd" else "bwd"].items()},
                    "library_refused": lib["refused"],
                    "bound_ms": bound, "bound_by": by,
                    "share_of_bound": bound / ms, **parent}
            if case["share_of_bound"] > 1:
                fail(f"{kind} {label}: {ms:.4g} ms under its bound "
                     f"{bound:.4g} ms")
            cases[kind].append(case)
            log(f"flash_{kind} {json.dumps(case)}")
        del q, k, v, do, o, lse, dq, dk, dv
        torch.cuda.empty_cache()

    # autograd: flash_attention on the card launches K3 once forward and
    # K4, K5 once backward, and its gradients are the CPU's
    b, s, h, d = 8, 64, 4, 32
    xs = [torch.randn((b, s, h, d), generator=gen, device="cuda")
          for _ in range(4)]
    tc = [x.clone().requires_grad_() for x in xs[:3]]
    before = (fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
              fa.flash_bwd_dkv.launches)
    out = fa.flash_attention(*tc, causal=True)
    if "_FlashFunctionBackward" not in _graph_nodes(out):
        fail("flash_attention on the card returned no _FlashFunction graph")
    (out * xs[3]).sum().backward()
    after = (fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
             fa.flash_bwd_dkv.launches)
    if [a - b_ for a, b_ in zip(after, before)] != [1, 1, 1]:
        fail(f"flash_attention forward+backward launched {before} -> "
             f"{after}, want one of each")
    th = [x.cpu().requires_grad_() for x in xs[:3]]
    (fa.flash_attention(*th, causal=True) * xs[3].cpu()).sum().backward()
    for name, a, c in zip("qkv", tc, th):
        _flash_close(f"autograd d{name}", a.grad.cpu(), c.grad,
                     torch.float32)
    many = _many_heads_check(fa, gen)

    out = []
    for kind, name, rep, per in (
            ("fwd", "flash_fwd", fa.REPLACES, "launches_per_forward"),
            ("dq", "flash_bwd_dq", fa.REPLACES_DQ, "launches_per_iteration"),
            ("dkv", "flash_bwd_dkv", fa.REPLACES_DKV,
             "launches_per_iteration")):
        head = cases[kind][0]
        out.append({
            "name": name, "route": "cuda",
            "source": "caffe_mpi_tpu_torch/csrc/flash_attention.cu",
            "replaces": rep,
            "launches": None,  # the transformer path's count
            "max_abs_err": max_err[kind],
            "shape": head["shape"], "dtype": head["dtype"],
            "ms": head["kernel_ms"], "kernel_ms": head["kernel_ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "library_backend": head["library_backend"],
            "library_math_ms": head["library_math_ms"],
            "library": "F.scaled_dot_product_attention on (1, BH, S, D), "
            "the fastest fused backend pinned alone" + (
                "" if kind == "fwd" else "; torch.autograd.grad through it "
                "(dQ, dK, dV together)"),
            **({"parent_kernel_ms": head["parent_kernel_ms"]}
               if "parent_kernel_ms" in head else {}),
            per: 2, "cases": cases[kind],
            "many_heads": many[kind],
        })
    return out


# more batch x heads than the grid's second axis holds, at a tiny S and D
MANY_HEADS = (70000, 16, 8)


def _many_heads_check(fa, gen) -> dict:
    """K3, K4 and K5 at MANY_HEADS batch x heads, causal, in both types,
    against their plain versions (FLASH_TOL): the wrapper launches each in
    runs of at most 65,535 heads, so each launch count moves by two."""
    bh = MANY_HEADS[0]
    runs = -(-bh // fa.MAX_GRID_Y)
    out = {kind: {"shape": list(MANY_HEADS), "launches_a_call": runs,
                  "max_abs_err": {}} for kind in ("fwd", "dq", "dkv")}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, do = (torch.randn(MANY_HEADS, generator=gen, device="cuda")
                       .to(dtype) for _ in range(4))
        before = _flash_counts()
        o, lse = fa.flash_fwd(q, k, v, causal=True)
        delta = fa._delta(do, o)
        dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, causal=True)
        dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal=True)
        torch.cuda.synchronize()
        moved = [a - b for a, b in zip(_flash_counts(), before)]
        if moved != [runs] * 3:
            fail(f"flash kernels at BH {bh} launched {moved}, want {runs} "
                 "each")
        o_ref, lse_ref = fa.flash_fwd_ref(q, k, v, causal=True)
        dq_ref = fa.flash_bwd_dq_ref(q, k, v, do, lse, delta, causal=True)
        dk_ref, dv_ref = fa.flash_bwd_dkv_ref(q, k, v, do, lse, delta,
                                              causal=True)
        label, dt = f"BH {bh}", str(dtype).replace("torch.", "")
        errs = {
            "fwd": max(_flash_close(f"K3 {label} O", o, o_ref, dtype),
                       _flash_close(f"K3 {label} lse", lse, lse_ref,
                                    torch.float32)),
            "dq": _flash_close(f"K4 {label} dQ", dq, dq_ref, dtype),
            "dkv": max(_flash_close(f"K5 {label} dK", dk, dk_ref, dtype),
                       _flash_close(f"K5 {label} dV", dv, dv_ref, dtype))}
        for kind, err in errs.items():
            out[kind]["max_abs_err"][dt] = err
        del q, k, v, do, o, lse, dq, dk, dv, o_ref, dq_ref, dk_ref, dv_ref
        torch.cuda.empty_cache()
    log(f"flash at BH {bh}: {json.dumps(out)}")
    return out


def _graph_nodes(t, limit: int = 4000) -> list[str]:
    """Names of the autograd nodes reachable from t's grad_fn."""
    seen, todo, names = set(), [t.grad_fn], []
    while todo and len(names) < limit:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        names.append(type(node).__name__)
        todo.extend(n for n, _ in node.next_functions)
    return names


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
    """Every owned parameter, history slot and state buffer (running
    statistics) of a solver, on the host."""
    out = {}
    for lname, pname, _, p in solver._decls:
        out[f"{lname}.{pname}"] = p.detach().cpu().clone()
        for i, h in enumerate(solver.history[(lname, pname)]):
            out[f"{lname}.{pname}.h{i}"] = h.cpu().clone()
    for lname, sname, buf in solver.net.state_buffers():
        out[f"{lname}.{sname}"] = buf.cpu().clone()
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


def profile_steps(solver, feed_fn, n: int = 3,
                  ours=("lrn_fwd_kernel", "lrn_bwd_kernel"),
                  groups=None) -> dict:
    """Where a training step's device time goes: `n` more iterations under
    torch.profiler, device time summed by kernel and by the aten op that
    launched it, beside the steps' wall time under the profiler (which
    slows the host). `groups` {group: aten op names}: the device time a
    step of those ops (each op's inclusive device time: name leaf ops
    only), and "other", the rest of the device time. If the profiler sees
    no device time, the breakdown is reported as not measured."""
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
    split = None
    if groups:
        by_op = {e.key: dev(e, False) / 1e3 / n for e in events}
        split = {g: sum(by_op.get(op, 0.0) for op in ops)
                 for g, ops in groups.items()}
        split["other"] = device_ms - sum(split.values())
    return {
        "wall_ms_per_step": wall_ms / n, "device_ms_per_step": device_ms,
        "device_busy_profiled": device_ms / (wall_ms / n),
        "groups_ms_per_step": split,
        "ours_ms_per_step": {k: sum(ms for ms, name in kernels
                                    if k in name) for k in ours},
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


# -- 7. transformer -------------------------------------------------------------

TLM_DIR = os.path.join(ROOT, "models", "transformer_lm")
TLM_ITERS = 20
TLM_SEQ = 64
FLASH_KERNELS = ("flash_fwd_kernel", "flash_bwd_dq_kernel",
                 "flash_bwd_dkv_kernel")

# The induction task of tests/test_sequence_layers.py (a one-block
# transformer_lm learns x[t+1] = x[t-3]), with use_flash; the net as
# models/generate_models.py writes transformer_lm(batch=8, seq=32,
# vocab=32, dim=32, heads=2, n_blocks=1, ffn_hidden=64, moe_experts=4).
INDUCTION_NET = """name: "transformer_lm"
layer { name: "tokens" type: "Input" top: "tokens" top: "label" input_param { shape { dim: 8 dim: 32 } shape { dim: 8 dim: 32 } } }
layer { name: "embed" type: "Embed" bottom: "tokens" top: "embed" embed_param { input_dim: 32 num_output: 32 bias_term: false weight_filler { type: "gaussian" std: 0.02 } } }
layer { name: "pos" type: "Parameter" top: "pos" parameter_param { shape { dim: 32 dim: 32 } } }
layer { name: "x0" type: "Bias" bottom: "embed" bottom: "pos" top: "x0" bias_param { axis: 1 } }
layer { name: "blk0/ln1" type: "LayerNorm" bottom: "x0" top: "blk0/ln1" }
layer { name: "blk0/attn" type: "Attention" bottom: "blk0/ln1" top: "blk0/attn" attention_param { num_heads: 2 causal: true use_flash: true weight_filler { type: "gaussian" std: 0.02 } } }
layer { name: "blk0/res1" type: "Eltwise" bottom: "x0" bottom: "blk0/attn" top: "blk0/res1" }
layer { name: "blk0/ln2" type: "LayerNorm" bottom: "blk0/res1" top: "blk0/ln2" }
layer { name: "blk0/moe" type: "MoE" bottom: "blk0/ln2" top: "blk0/moe" top: "blk0/moe_aux" loss_weight: 0.0 loss_weight: 0.01 moe_param { num_experts: 4 hidden_dim: 64 capacity_factor: 2.0 } }
layer { name: "blk0/res2" type: "Eltwise" bottom: "blk0/res1" bottom: "blk0/moe" top: "blk0/res2" }
layer { name: "ln_f" type: "LayerNorm" bottom: "blk0/res2" top: "ln_f" }
layer { name: "logits" type: "InnerProduct" bottom: "ln_f" top: "logits" inner_product_param { num_output: 32 axis: 2 weight_filler { type: "gaussian" std: 0.02 } } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "logits" bottom: "label" top: "loss" softmax_param { axis: 2 } }
layer { name: "accuracy" type: "Accuracy" bottom: "logits" bottom: "label" top: "accuracy" include { phase: TEST } accuracy_param { axis: 2 } }
"""


def _with_flash(text: str) -> str:
    """The prototxt with `use_flash: true` after each `causal: true`, as the
    JAX package's own tests switch it on."""
    if "causal: true" not in text:
        fail("no causal Attention layer to switch use_flash on in")
    return text.replace("causal: true", "causal: true\n    use_flash: true")


def _flash_solver(tmp: str) -> str:
    """Copies of models/transformer_lm/solver.prototxt and its
    train_val.prototxt in `tmp`, the net with use_flash; the solver's
    path."""
    with open(os.path.join(TLM_DIR, "train_val.prototxt")) as f:
        net = _with_flash(f.read())
    net_path = os.path.join(tmp, "train_val.prototxt")
    with open(net_path, "w") as f:
        f.write(net)
    with open(os.path.join(TLM_DIR, "solver.prototxt")) as f:
        text = f.read()
    old = 'net: "models/transformer_lm/train_val.prototxt"'
    if old not in text:
        fail(f"models/transformer_lm/solver.prototxt does not name {old}")
    path = os.path.join(tmp, "solver.prototxt")
    with open(path, "w") as f:
        f.write(text.replace(old, f'net: "{net_path}"'))
    return path


def _flash_counts() -> tuple[int, int, int]:
    from caffe_mpi_tpu_torch.ops import flash_attention as fa
    return (fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
            fa.flash_bwd_dkv.launches)


def _reset_flash_counts() -> None:
    from caffe_mpi_tpu_torch.ops import flash_attention as fa
    fa.flash_fwd.launches = fa.flash_bwd_dq.launches = \
        fa.flash_bwd_dkv.launches = 0


def transformer_phase(flash: list[dict], card: str) -> dict:
    """Train transformer_lm (full width, batch 8, sequence 64, Adam) with
    use_flash through the CLI's `train`: 20 iterations, a final test pass
    of TEST_ITER batches, a snapshot in a temporary directory. K3 must
    launch twice a forward, K4 and K5 twice an iteration; every loss
    finite; blk0/attn.qkv_weight's gradient nonzero and its output's graph
    through _FlashFunction. Then resume the snapshot through the same
    entry point: weights and both Adam slots bitwise, one more step."""
    from caffe_mpi_tpu_torch.solver import Solver
    from caffe_mpi_tpu_torch.tools import cli

    tmp = tempfile.mkdtemp(prefix="chip_smoke_tlm_")
    try:
        solver_path = _flash_solver(tmp)
        prefix = os.path.join(tmp, "transformer_lm")
        argv = ["train", "-solver", solver_path, "-synthetic",
                "-test_iter", str(TEST_ITER), "-snapshot_prefix", prefix,
                "-device", "cuda"]
        torch.cuda.reset_peak_memory_stats()
        _reset_flash_counts()
        solver, summary = cli.train(cli.parse_args(
            argv + ["-max_iter", str(TLM_ITERS)]))
        torch.cuda.synchronize()
        counts = _flash_counts()
        losses = summary["losses"]
        log(f"transformer train: {json.dumps(summary)}")
        if summary["batch"] != 8 or len(losses) != TLM_ITERS:
            fail(f"transformer ran {len(losses)} iterations at batch "
                 f"{summary['batch']}, want {TLM_ITERS} at 8")
        if not np.all(np.isfinite(losses)):
            fail(f"transformer losses not all finite: {losses}")
        # forwards: every iteration and the final test pass; the solver
        # tests at iteration 0 only under test_initialization, and its
        # test_interval (1000) is past the run
        sp = solver.sp
        if sp.test_initialization or sp.test_interval <= TLM_ITERS:
            fail("the schedule below assumes test_initialization: false "
                 f"and test_interval > {TLM_ITERS}")
        forwards = TLM_ITERS + TEST_ITER
        want = (2 * forwards, 2 * TLM_ITERS, 2 * TLM_ITERS)
        if counts != want:
            fail(f"K3/K4/K5 launched {counts} times, want {want}")
        for entry, n in zip(flash, counts):
            entry["launches"] = n
            entry["launches_by_path"] = {"train_transformer_lm": n}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        grad = solver.net.layer_by_name("blk0/attn").qkv_weight.grad
        if grad is None or float(grad.abs().max()) == 0.0:
            fail("blk0/attn.qkv_weight got no gradient")
        qkv_grad_max = float(grad.abs().max())
        feeds = cli.synthetic_feed(solver.net)
        env, _ = solver.net(feeds)
        if "_FlashFunctionBackward" not in _graph_nodes(env["blk0/attn"]):
            fail("blk0/attn's output has no graph through _FlashFunction")
        del env
        trained = _state(solver)
        profile = profile_steps(solver, lambda it: feeds, ours=FLASH_KERNELS)
        log(f"transformer profile: {json.dumps(profile)}")
        del solver, feeds

        resumed, again = cli.train(cli.parse_args(
            argv + ["-max_iter", str(TLM_ITERS + 1), "-snapshot",
                    summary["snapshot"]]))
        if again["start_iter"] != TLM_ITERS or again["iters"] != 1 or \
                not np.isfinite(again["losses"][0]):
            fail(f"transformer resume: {again}")
        check = Solver(resumed.sp, model_dir=resumed.model_dir,
                       device="cuda")
        check.restore(summary["snapshot"])
        restored = _state(check)
        if any(len(h) != 2 for h in check.history.values()):
            fail("the Adam solver did not restore two slots a param")
        bad = [k for k in trained if not torch.equal(trained[k],
                                                     restored[k])]
        if bad:
            fail(f"restored transformer state differs: {bad[:5]}")
        del resumed, check
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    med = summary["median_iter_ms"]
    return {
        "solver": "models/transformer_lm/solver.prototxt",
        "net": "models/transformer_lm/train_val.prototxt with use_flash",
        "batch": 8, "seq": TLM_SEQ, "iters": TLM_ITERS, "losses": losses,
        "median_step_ms": med, "seq_per_s": summary["img_per_s"],
        "tokens_per_s": summary["img_per_s"] * TLM_SEQ,
        "step_ms": summary["iter_ms"], "test_scores": summary["test_scores"],
        "launches": dict(zip(("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"),
                             counts)),
        "qkv_weight_grad_max_abs": qkv_grad_max,
        "resumed_loss": again["losses"][0], "peak_mem_GB": peak_gb,
        "profile": profile,
        "device_busy": profile["device_ms_per_step"] / med
        if isinstance(profile["device_ms_per_step"], float) else None,
        "card": card,
    }


def induction_phase() -> dict:
    """The induction task with use_flash on the card: 300 Adam steps, then
    held-out next-token accuracy past position 8 must reach 0.9, the JAX
    test's bar — the kernels' gradients train a net that has to attend
    backwards."""
    from caffe_mpi_tpu_torch.proto import NetParameter, SolverParameter
    from caffe_mpi_tpu_torch.solver import Solver

    sp = SolverParameter.from_text(
        'base_lr: 0.003 momentum: 0.9 momentum2: 0.999 type: "Adam" '
        'lr_policy: "fixed" max_iter: 400 display: 0')
    sp.net_param = NetParameter.from_text(INDUCTION_NET)
    solver = Solver(sp, device="cuda")
    b, s, v = 8, 32, 32

    def feed(it):
        r = np.random.RandomState(it)
        seq = np.tile(r.randint(0, v, (b, 4)), (1, s // 4 + 2))[:, :s + 1]
        return {"tokens": torch.from_numpy(seq[:, :s]).cuda(),
                "label": torch.from_numpy(seq[:, 1:s + 1]).cuda()}

    steps = 300
    _reset_flash_counts()
    t0 = time.perf_counter()
    solver.step(steps, feed)
    f = feed(10_001)
    with torch.no_grad():
        blobs, _ = solver.net(f)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = _flash_counts()
    if counts != (steps + 1, steps, steps):
        fail(f"induction: K3/K4/K5 launched {counts}, want "
             f"{(steps + 1, steps, steps)}")
    pred = blobs["logits"].argmax(-1).cpu().numpy()
    lab = f["label"].cpu().numpy()
    acc = float((pred[:, 8:] == lab[:, 8:]).mean())
    res = {"steps": steps, "accuracy": acc, "bar": 0.9,
           "first_loss": solver.losses[0], "last_loss": solver.losses[-1],
           "seconds": secs, "launches": list(counts)}
    log(f"induction: {json.dumps(res)}")
    if acc < 0.9:
        fail(f"induction task reached {acc:.3f} held-out accuracy, < 0.9")
    return res


# limits of the card-against-CPU step, and why: gradients within 1e-4 of
# their largest element (f32 sums in other orders, no max pool here);
# the loss within 1e-5 of its size; the deploy net's prob rows within
# 1e-5 of the largest
TLM_GRAD_LIMIT = 1e-4


def transformer_parity_phase() -> dict:
    """One Adam step of transformer_lm at full width and batch 8 on the
    card against the CPU, TF32 off through default_forward_math: FLOAT,
    from the same weights and feeds. The MoE routes are compared first
    (a near tie can flip under another summation order, and a flipped
    route changes what is compared); then the loss, every gradient, and
    every updated parameter within Adam's sensitivity to the gradient
    limit: at step 1 the update is lr * g / (|g| + c), c = eps /
    sqrt(1 - beta2), which moves by at most lr / c per unit of gradient,
    plus two f32 ulps of the largest weight. Then the deploy net (batch
    10, BH = 40) forward on both, its prob rows compared."""
    from caffe_mpi_tpu_torch.net import Net
    from caffe_mpi_tpu_torch.ops.moe import routing
    from caffe_mpi_tpu_torch.proto import NetParameter, SolverParameter
    from caffe_mpi_tpu_torch.solver import Solver
    from caffe_mpi_tpu_torch.tools import cli

    def param():
        sp = SolverParameter.from_file(os.path.join(TLM_DIR,
                                                    "solver.prototxt"))
        with open(os.path.join(TLM_DIR, "train_val.prototxt")) as f:
            net = NetParameter.from_text(_with_flash(f.read()))
        net.default_forward_math = "FLOAT"
        sp.net, sp.net_param = "", net
        sp.test_iter, sp.test_interval = [], 0
        return sp

    def one_step(device, feeds_cpu):
        solver = Solver(param(), device=device)
        feeds = {k: v.to(device) for k, v in feeds_cpu.items()}
        moe = solver.net.layer_by_name("blk1/moe")
        with torch.no_grad(), moe.policy.math(solver.device):
            env, _ = solver.net(feeds)
            x = env["blk1/ln2"]
            routes = routing(moe.expert_params(), x.reshape(-1, x.shape[-1]),
                             top_k=max(moe.p.top_k, 1)).cpu()
        del env
        w0 = {f"{l}.{p}": t.detach().cpu().clone()
              for l, p, _, t in solver._decls}
        solver.step(1, lambda it: feeds)
        out = {"loss": solver.losses[0], "w0": w0, "grad": {}, "w": {},
               "lr_mult": {}, "routes": routes}
        for l, p, decl, t in solver._decls:
            key = f"{l}.{p}"
            out["w"][key] = t.detach().cpu()
            out["grad"][key] = t.grad.detach().cpu()
            out["lr_mult"][key] = decl.lr_mult
        return out, solver.sp

    # the frozen statistics: the batch's own, from a CPU forward with
    # moving_average_fraction 0, so the frozen net's activations are at
    # the trained net's scale
    probe = Solver(param(), device="cpu")
    feeds = cli.synthetic_feed(probe.net, seed=0)
    for layer in _batch_norms(probe.net):
        layer.p.moving_average_fraction = 0.0
    with torch.no_grad():
        probe.net(feeds)
    frozen_stats = {l.name: (l.mean.clone(), l.var.clone())
                    for l in _batch_norms(probe.net)}
    del probe
    cpu, sp = one_step("cpu", feeds)
    _reset_flash_counts()
    card, _ = one_step("cuda", feeds)
    counts = _flash_counts()
    # the routing forward and the step's forward; one backward
    if counts != (4, 2, 2):
        fail(f"card step launched K3/K4/K5 {counts}, want (4, 2, 2)")
    flips = int((card["routes"] != cpu["routes"]).any(-1).sum())
    if flips:
        fail(f"{flips} of {cpu['routes'].shape[0]} tokens routed "
             "differently on the card and the CPU")
    if any(not torch.equal(cpu["w0"][k], card["w0"][k]) for k in cpu["w0"]):
        fail("card and CPU solvers did not start from the same weights")
    c = max(sp.delta, 1e-4) / np.sqrt(1.0 - sp.momentum2)
    eps = torch.finfo(torch.float32).eps
    params, bad = {}, []
    for key, gref in cpu["grad"].items():
        gmax = float(gref.abs().max())
        grad = float((card["grad"][key] - gref).abs().max()) / gmax \
            if gmax else float(card["grad"][key].abs().max())
        w_limit = (sp.base_lr * cpu["lr_mult"][key] * TLM_GRAD_LIMIT * gmax
                   / c + 2 * eps * float(cpu["w0"][key].abs().max()))
        w = float((card["w"][key] - cpu["w"][key]).abs().max())
        params[key] = {"grad": grad, "grad_max_abs": gmax, "w": w,
                       "w_limit": w_limit}
        if not grad <= TLM_GRAD_LIMIT:
            bad.append(f"grad {key}: {grad:.3g} > {TLM_GRAD_LIMIT}")
        if not w <= w_limit:
            bad.append(f"updated {key}: {w:.3g} > {w_limit:.3g}")
    res = {"batch": 8, "loss_cpu": cpu["loss"], "loss_card": card["loss"],
           "tokens": int(cpu["routes"].shape[0]), "route_flips": flips,
           "adam_c": c, "params": params}

    # the deploy net, batch 10 (BH = 40), prob rows on both
    with open(os.path.join(TLM_DIR, "deploy.prototxt")) as f:
        dtext = _with_flash(f.read())
    nets = {}
    for device in ("cpu", "cuda"):
        dp = NetParameter.from_text(dtext)
        dp.default_forward_math = "FLOAT"
        net = Net(dp, device=device)
        net.init(0)
        nets[device] = net
    tokens = torch.from_numpy(np.random.RandomState(2).randint(
        0, 256, nets["cpu"].blob_shapes["tokens"]))
    with torch.inference_mode():
        ref = nets["cpu"]({"tokens": tokens})[0]["prob"]
        _reset_flash_counts()
        got = nets["cuda"]({"tokens": tokens.cuda()})[0]["prob"].cpu()
    if _flash_counts() != (2, 0, 0):
        fail(f"deploy forward launched K3/K4/K5 {_flash_counts()}, "
             "want (2, 0, 0)")
    diff = float((got - ref).abs().max())
    res["deploy"] = {"shape": list(ref.shape), "prob_max_abs_diff": diff,
                     "prob_max": float(ref.abs().max()),
                     "bh": int(ref.shape[0]) * 4}
    log(f"transformer parity: {json.dumps(res)}")
    if abs(card["loss"] - cpu["loss"]) > 1e-5 * abs(cpu["loss"]):
        fail(f"transformer loss on the card {card['loss']} vs CPU "
             f"{cpu['loss']}")
    if bad:
        fail(f"transformer parity: {bad}")
    if not np.isfinite(diff) or diff > 1e-5 * float(ref.abs().max()):
        fail(f"deploy prob rows differ by {diff:.3g}")
    return res



# -- 10. resnet50 ----------------------------------------------------------------

RESNET_DIR = os.path.join(ROOT, "models", "resnet50")
RESNET_ITERS = 20
RESNET_BATCH = 32
RESNET_BNS = 53
# device time of a step by the aten op that launched it (inclusive device
# time of these leaf ops, so no kernel is counted twice): convolution
# forward and backward (cuDNN, layout conversions included), BatchNorm
# (cuDNN's forward and backward, and the var_mean of the running update),
# elementwise ops (ReLU forward and backward, residual adds, gradient
# accumulation, the running update's and the SGD update's arithmetic);
# "other" is the rest (pooling, fc, the loss, copies)
RESNET_GROUPS = {
    "conv_forward": ("aten::cudnn_convolution",),
    "conv_backward": ("aten::convolution_backward",),
    "batch_norm": ("aten::cudnn_batch_norm", "aten::native_batch_norm",
                   "aten::cudnn_batch_norm_backward",
                   "aten::native_batch_norm_backward", "aten::var_mean"),
    "elementwise": ("aten::relu", "aten::relu_", "aten::threshold_backward",
                    "aten::add", "aten::add_", "aten::mul", "aten::mul_",
                    "aten::sub", "aten::div"),
}


def _kernel_counts() -> tuple[int, ...]:
    """K1-K5's launch counts."""
    from caffe_mpi_tpu_torch.ops import launch_counters
    return tuple(c.launches for c in launch_counters())


def _reset_kernel_counts() -> None:
    from caffe_mpi_tpu_torch.ops import launch_counters
    for c in launch_counters():
        c.launches = 0


def _train_cli(solver_path, prefix, iters, extra=()):
    from caffe_mpi_tpu_torch.tools import cli
    return cli.train(cli.parse_args(
        ["train", "-solver", solver_path, "-synthetic", "-test_iter",
         str(TEST_ITER), "-snapshot_prefix", prefix, "-device", "cuda",
         "-max_iter", str(iters), *extra]))


def _batch_norms(net):
    return [l for l in net.layers if l.lp.type == "BatchNorm"]


def resnet50_phase(card: str) -> dict:
    """Train models/resnet50/solver.prototxt as written (batch 32, 224^2,
    53 BatchNorms with scale_bias, poly LR with ramp-up) through the CLI's
    `train`: 20 iterations, a test pass of TEST_ITER batches at iteration
    0 and at the end through the statistics the test net shares, with
    every launch count set to 0 just before and read just after (ResNet-50
    has no LRN and no attention: all five stay 0). Every loss finite,
    every running mean and variance moved from 0 and finite. A profile
    of a step. Then the snapshot resumes through the same entry point:
    weights, history and running statistics bitwise, one more step. Then
    the card-against-CPU step and the served deploy rows."""
    from caffe_mpi_tpu_torch.layers import norm
    from caffe_mpi_tpu_torch.solver import Solver
    from caffe_mpi_tpu_torch.tools import cli

    tmp = tempfile.mkdtemp(prefix="chip_smoke_resnet50_")
    solver_path = os.path.join(RESNET_DIR, "solver.prototxt")
    try:
        prefix = os.path.join(tmp, "resnet50")
        torch.cuda.reset_peak_memory_stats()
        _reset_kernel_counts()
        solver, summary = _train_cli(solver_path, prefix, RESNET_ITERS)
        torch.cuda.synchronize()
        counts = _kernel_counts()
        losses = summary["losses"]
        log(f"resnet50 train: {json.dumps(summary)}")
        if summary["batch"] != RESNET_BATCH or len(losses) != RESNET_ITERS:
            fail(f"resnet50 ran {len(losses)} iterations at batch "
                 f"{summary['batch']}, want {RESNET_ITERS} at "
                 f"{RESNET_BATCH}")
        if not np.all(np.isfinite(losses)):
            fail(f"resnet50 losses not all finite: {losses}")
        if any(counts):
            fail(f"resnet50 launched K1-K5 {counts}, want none")
        bns = _batch_norms(solver.net)
        if len(bns) != RESNET_BNS or not all(l.scale_bias for l in bns):
            fail(f"{len(bns)} BatchNorms, want {RESNET_BNS} with scale_bias")
        stats = {"min_abs_max": float("inf"), "all_finite": True}
        for l in bns:
            for buf in (l.mean, l.var):
                stats["all_finite"] &= bool(torch.isfinite(buf).all())
                stats["min_abs_max"] = min(stats["min_abs_max"],
                                           float(buf.abs().max()))
        if not stats["all_finite"] or stats["min_abs_max"] == 0.0:
            fail(f"running statistics did not all move and stay finite: "
                 f"{stats}")
        tnet = solver.test_nets[0]
        if any(getattr(tnet.layer_by_name(ln), sn) is not buf
               for ln, sn, buf in solver.net.state_buffers()):
            fail("the test net does not share the train net's statistics")
        if not summary["test_scores"] or not all(
                np.isfinite(v) for v in summary["test_scores"][0].values()):
            fail(f"resnet50 test scores: {summary['test_scores']}")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        trained = _state(solver)
        feeds = cli.synthetic_feed(solver.net)
        profile = profile_steps(solver, lambda it: feeds, ours=(),
                                groups=RESNET_GROUPS)
        log(f"resnet50 profile: {json.dumps(profile)}")
        del solver, feeds

        resumed, again = _train_cli(solver_path, prefix, RESNET_ITERS + 1,
                                    ["-snapshot", summary["snapshot"]])
        if again["start_iter"] != RESNET_ITERS or again["iters"] != 1 or \
                not np.isfinite(again["losses"][0]):
            fail(f"resnet50 resume: {again}")
        check = Solver(resumed.sp, model_dir=resumed.model_dir,
                       device="cuda")
        check.restore(summary["snapshot"])
        restored = _state(check)
        bad = [k for k in trained if not torch.equal(trained[k],
                                                     restored[k])]
        if bad:
            fail(f"restored resnet50 state differs: {bad[:5]}")
        n_stats = sum(1 for k in trained if k.endswith((".mean", ".var")))
        del resumed, check
        torch.cuda.empty_cache()
        caffemodel = summary["snapshot"].replace(".solverstate",
                                                 ".caffemodel")
        serving = _resnet_serve(caffemodel)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    med = summary["median_iter_ms"]
    return {
        "solver": "models/resnet50/solver.prototxt", "batch": RESNET_BATCH,
        "iters": RESNET_ITERS, "losses": losses, "median_step_ms": med,
        "img_per_s": summary["img_per_s"], "step_ms": summary["iter_ms"],
        "test_scores": summary["test_scores"],
        "launches_k1_k5": list(counts), "batch_norms": len(bns),
        "statistics": stats, "resumed_statistics_bitwise": n_stats,
        "resumed_loss": again["losses"][0], "peak_mem_GB": peak_gb,
        "batch_norm_design": norm.BATCH_STATS, "profile": profile,
        "device_busy": profile["device_ms_per_step"] / med
        if isinstance(profile["device_ms_per_step"], float) else None,
        "serving": serving, "card": card,
    }


def _strict(param):
    """A NetParameter with TF32 off (default_forward_math: FLOAT)."""
    param.default_forward_math = "FLOAT"
    return param


# served deploy rows against the TEST net's forward, both on the card with
# TF32 off: f32 sums in other orders (cuDNN picks its algorithm by batch)
SERVE_LIMIT = 1e-4


def _resnet_serve(caffemodel: str) -> dict:
    """models/resnet50/deploy.prototxt (TF32 off, its Softmax cut so the
    fc1000 logits are compared: random weights leave the softmax nearly
    uniform) with the trained snapshot's caffemodel through ServingEngine
    at its ladder (1, 4, 10), bursts of 1, 3, 10 and 7 rows from four
    threads; every served row against the TEST-phase Net's forward of the
    same rows on the card, within SERVE_LIMIT of the largest logit. Every
    bucket net must hold the first bucket's statistics, and they must be
    the snapshot's (a bucket at zero statistics would give other rows)."""
    from caffe_mpi_tpu_torch import io as port_io
    from caffe_mpi_tpu_torch.net import Net
    from caffe_mpi_tpu_torch.proto import NetParameter
    from caffe_mpi_tpu_torch.serving import ServingEngine

    param = _strict(NetParameter.from_file(os.path.join(RESNET_DIR,
                                                        "deploy.prototxt")))
    param.layer = [lp for lp in param.layer if lp.type != "Softmax"]
    bursts = (1, 3, 10, 7)
    rng = np.random.RandomState(4)
    rows = rng.randn(sum(bursts), 3, 224, 224).astype(np.float32)
    weights = port_io.load_weights(caffemodel)
    with ServingEngine(device="cuda") as engine:
        model = engine.load_model("resnet50", copy.deepcopy(param),
                                  caffemodel)
        ladder = model.fwd.ladder
        owner = model.fwd.net_for(ladder[0])
        for b in ladder[1:]:
            other = model.fwd.net_for(b)
            if any(getattr(other.layer_by_name(ln), sn) is not buf
                   for ln, sn, buf in owner.state_buffers()):
                fail(f"serving bucket {b} does not share the statistics")
        first_bn = _batch_norms(owner)[0]
        if not np.array_equal(first_bn.mean.cpu().numpy(),
                              np.asarray(weights[first_bn.name][0])):
            fail("served statistics are not the snapshot's")
        starts = np.cumsum((0,) + bursts[:-1])
        with ThreadPoolExecutor(max_workers=4) as ex:
            futs = [ex.submit(engine.classify, "resnet50",
                              rows[a:a + b], preprocess=False)
                    for a, b in zip(starts, bursts)]
            served = np.concatenate([f.result(timeout=600) for f in futs])
        engine.drain()
        dispatches = engine.stats()["dispatches"]
        out_blob = model.fwd.out_blob()
    ref_param = copy.deepcopy(param)
    for lp in ref_param.layer:
        if lp.type == "Input":
            lp.input_param.shape[0].dim[0] = len(rows)
    ref_net = Net(ref_param, "TEST", device="cuda")
    ref_net.import_weights(weights)
    with torch.inference_mode():
        ref = ref_net({"data": torch.from_numpy(rows).cuda()})[0][
            out_blob].float().cpu().numpy()
    diff = float(np.abs(served - ref).max())
    res = {"model": "models/resnet50/deploy.prototxt (TF32 off, logits)",
           "ladder": list(ladder), "bursts": list(bursts),
           "dispatches": dispatches, "rows": int(len(rows)),
           "max_abs_diff": diff, "ref_max_abs": float(np.abs(ref).max()),
           "limit": SERVE_LIMIT}
    log(f"resnet50 serving: {json.dumps(res)}")
    if not np.all(np.isfinite(served)) or \
            diff > SERVE_LIMIT * float(np.abs(ref).max()):
        fail(f"served resnet50 rows against the TEST net: {res}")
    return res


RESNET_PARITY_BATCH = 16
RESNET_BELOW_POOL1 = ("conv1.", "conv1/bn.")
# Limits of the card-against-CPU step (TF32 off). ResNet-50's gradients
# at its initial weights amplify rounding: on the CPU alone, a 1e-7
# relative change of the input moves conv and BatchNorm gradients by up
# to ~17% of their largest element, with the running statistics or with
# the batch's own frozen in place of them (the first chip run of this
# check measured the card's differences at 1.05x the CPU's own). So each
# group's gradients (conv1 and conv1/bn below pool1, the layers above it)
# and the running statistics are held to RESNET_SPREAD_FACTOR x the
# largest change the CPU shows in that group under that one rounding of
# its input; fc, above every BatchNorm, to 1e-4 of its largest element
# (AlexNet's fc limit); the loss to 1e-5 of its size.
RESNET_SPREAD_FACTOR = 2.0
RESNET_FC_LIMIT = 1e-4


def _resnet_group(key: str) -> str:
    if key.startswith(RESNET_BELOW_POOL1):
        return "below_pool1"
    return "fc" if key.startswith("fc.") else "above"


def resnet50_parity_phase() -> dict:
    """One SGD step of ResNet-50 at full width, batch cut to
    RESNET_PARITY_BATCH (for this check only), on the card against the
    CPU from the same weights and feeds, TF32 off, within the limits
    above; each updated parameter within lr x lr_mult x its limit x the
    gradient's largest element, plus two f32 ulps of the largest weight.
    Then BatchNorm's two batch-statistics designs against each other on
    the card (`_bn_designs_check`)."""
    from caffe_mpi_tpu_torch.proto import NetParameter, SolverParameter
    from caffe_mpi_tpu_torch.solver import Solver, lr_policy
    from caffe_mpi_tpu_torch.tools import cli

    def param():
        sp = SolverParameter.from_file(os.path.join(RESNET_DIR,
                                                    "solver.prototxt"))
        net = _strict(NetParameter.from_file(os.path.join(ROOT, sp.net)))
        for lp in net.layer:
            if lp.type == "Input":
                for shape in lp.input_param.shape:
                    shape.dim[0] = RESNET_PARITY_BATCH
        sp.net, sp.net_param = "", net
        sp.test_iter, sp.test_interval = [], 0
        return sp

    def one_step(device, feeds_cpu):
        solver = Solver(param(), device=device)
        feeds = {k: v.to(device) for k, v in feeds_cpu.items()}
        w0 = {f"{l}.{p}": t.detach().cpu().clone()
              for l, p, _, t in solver._decls}
        solver.step(1, lambda it: feeds)
        out = {"loss": solver.losses[0], "w0": w0, "grad": {}, "w": {},
               "lr_mult": {}, "rate": lr_policy.schedule(solver.sp, 0)[0],
               "stats": {f"{l}.{n}": b.cpu().clone()
                         for l, n, b in solver.net.state_buffers()}}
        for l, p, decl, t in solver._decls:
            key = f"{l}.{p}"
            out["w"][key] = t.detach().cpu()
            out["grad"][key] = t.grad.detach().cpu()
            out["lr_mult"][key] = decl.lr_mult
        return out

    def rel(a, b):
        return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)

    probe = Solver(param(), device="cpu")
    feeds = cli.synthetic_feed(probe.net, seed=0)
    del probe
    perturbed = dict(feeds)
    perturbed["data"] = feeds["data"] * (1 + 1e-7 * torch.randn(
        feeds["data"].shape, generator=torch.Generator().manual_seed(1)))
    t0 = time.perf_counter()
    cpu = one_step("cpu", feeds)
    cpu_secs = time.perf_counter() - t0
    cpu_self = one_step("cpu", perturbed)
    card = one_step("cuda", feeds)
    if any(not torch.equal(cpu["w0"][k], card["w0"][k]) for k in cpu["w0"]):
        fail("card and CPU solvers did not start from the same weights")
    rows = {key: {"group": _resnet_group(key),
                  "grad": rel(card["grad"][key], gref),
                  "grad_cpu_self": rel(cpu_self["grad"][key], gref),
                  "w": float((card["w"][key] - cpu["w"][key]).abs().max())}
            for key, gref in cpu["grad"].items()}
    groups = ("below_pool1", "above", "fc")
    self_worst = {g: max(r["grad_cpu_self"] for r in rows.values()
                         if r["group"] == g) for g in groups}
    limits = {g: RESNET_SPREAD_FACTOR * self_worst[g] for g in groups}
    limits["fc"] = RESNET_FC_LIMIT
    eps = torch.finfo(torch.float32).eps
    bad = []
    for key, r in rows.items():
        limit = limits[r["group"]]
        r["w_limit"] = (cpu["rate"] * cpu["lr_mult"][key] * limit
                        * float(cpu["grad"][key].abs().max())
                        + 2 * eps * float(cpu["w0"][key].abs().max()))
        if not r["grad"] <= limit:
            bad.append(f"grad {key}: {r['grad']:.3g} > {limit:.3g}")
        if not r["w"] <= r["w_limit"]:
            bad.append(f"updated {key}: {r['w']:.3g} > {r['w_limit']:.3g}")
    stats = max(rel(card["stats"][k], v) for k, v in cpu["stats"].items())
    stats_self = max(rel(cpu_self["stats"][k], v)
                     for k, v in cpu["stats"].items())
    if not stats <= RESNET_SPREAD_FACTOR * stats_self:
        bad.append(f"statistics: {stats:.3g} > {RESNET_SPREAD_FACTOR} x "
                   f"{stats_self:.3g}")
    if abs(card["loss"] - cpu["loss"]) > 1e-5 * abs(cpu["loss"]):
        bad.append(f"loss on the card {card['loss']} vs CPU {cpu['loss']}")
    res = {"batch": RESNET_PARITY_BATCH, "loss_cpu": cpu["loss"],
           "loss_card": card["loss"], "loss_cpu_self": cpu_self["loss"],
           "limits": limits,
           "worst_grad": {g: max(r["grad"] for r in rows.values()
                                 if r["group"] == g) for g in groups},
           "worst_grad_cpu_self": self_worst, "worst_statistic": stats,
           "worst_statistic_cpu_self": stats_self, "cpu_step_s": cpu_secs}
    log(f"resnet50 parity: {json.dumps({**res, 'params': rows})}")
    res["batch_norm_designs"] = _bn_designs_check()
    if bad:
        fail(f"resnet50 parity: {bad[:10]}")
    return res


# BatchNorm's "fused" design (cuDNN) against its "composite" one on the
# card: y, the gradients and the running statistics within 1e-5 of each
# one's largest element (the same f32 math, reductions in other orders)
BN_DESIGN_SHAPES = ((16, 64, 112, 112), (2, 8, 3, 3))
BN_DESIGN_TOL = 1e-5


def _bn_designs_check() -> dict:
    """A BatchNorm(scale_bias) layer at conv1/bn's shape at the parity
    batch and at a small one (where the variance's n / (n - 1) would
    show), in TRAIN, run by both designs from the same input, scale, bias
    and statistics."""
    from caffe_mpi_tpu_torch.core.types import DtypePolicy
    from caffe_mpi_tpu_torch.layers import create_layer, norm
    from caffe_mpi_tpu_torch.proto import LayerParameter

    lp = LayerParameter.from_text(
        'name: "bn" type: "BatchNorm" bottom: "x" top: "y" '
        'batch_norm_param { scale_bias: true eps: 0.0001 '
        'moving_average_fraction: 0.9 }')
    gen = torch.Generator(device="cuda").manual_seed(5)
    out, shipped = {}, norm.BATCH_STATS
    try:
        for shape in BN_DESIGN_SHAPES:
            x = torch.randn(shape, generator=gen, device="cuda") * 2 + 0.5
            dy = torch.randn(shape, generator=gen, device="cuda")
            c = shape[1]
            init = [torch.randn(c, generator=gen, device="cuda")
                    for _ in range(3)] + [
                torch.rand(c, generator=gen, device="cuda") + 0.5]
            got = {}
            for design in norm.DESIGNS:
                norm.BATCH_STATS = design
                layer = create_layer(lp, DtypePolicy(), "TRAIN",
                                     torch.device("cuda"))
                layer.setup([shape])
                with torch.no_grad():
                    for t, v in zip((layer.scale, layer.bias, layer.mean,
                                     layer.var), init):
                        t.copy_(v)
                layer.scale.requires_grad_(True)
                layer.bias.requires_grad_(True)
                xg = x.clone().requires_grad_(True)
                y = layer([xg])[0]
                y.backward(dy)
                got[design] = {"y": y.detach(), "dx": xg.grad,
                               "dscale": layer.scale.grad,
                               "dbias": layer.bias.grad,
                               "mean": layer.mean.clone(),
                               "var": layer.var.clone()}
            errs = {k: float((got["fused"][k] - got["composite"][k]).abs()
                             .max()) / float(got["composite"][k].abs().max())
                    for k in got["fused"]}
            out["x".join(map(str, shape))] = errs
            if not all(e <= BN_DESIGN_TOL for e in errs.values()):
                fail(f"BatchNorm designs differ at {shape}: {errs}")
    finally:
        norm.BATCH_STATS = shipped
    log(f"batch norm designs on the card: {json.dumps(out)}")
    return out


# -- 11. googlenet ---------------------------------------------------------------

GOOGLENET_ITERS = 20
GOOGLENET_BATCH = 128


def googlenet_phase(k1: dict, k2: dict, card: str) -> dict:
    """Train models/googlenet/solver.prototxt as written (batch 128, three
    losses weighted 0.3, 0.3 and 1) through the CLI's `train`: 20
    iterations and a test pass of TEST_ITER batches at iteration 0 and at
    the end, launch counts set to 0 just before and read just after: K1
    twice a forward (pool1/norm1, conv2/norm2), K2 twice an iteration, no
    flash kernel; every loss finite."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_googlenet_")
    try:
        torch.cuda.reset_peak_memory_stats()
        _reset_kernel_counts()
        solver, summary = _train_cli(
            os.path.join(ROOT, "models", "googlenet", "solver.prototxt"),
            os.path.join(tmp, "googlenet"), GOOGLENET_ITERS)
        torch.cuda.synchronize()
        counts = _kernel_counts()
        weights = sorted(w for _, w in solver.net.loss_blobs)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        del solver
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    losses = summary["losses"]
    log(f"googlenet train: {json.dumps(summary)}")
    if summary["batch"] != GOOGLENET_BATCH or \
            len(losses) != GOOGLENET_ITERS:
        fail(f"googlenet ran {len(losses)} iterations at batch "
             f"{summary['batch']}")
    if not np.all(np.isfinite(losses)):
        fail(f"googlenet losses not all finite: {losses}")
    if weights != [0.3, 0.3, 1.0]:
        fail(f"googlenet loss weights {weights}, want 0.3, 0.3, 1")
    forwards = GOOGLENET_ITERS + 2 * TEST_ITER
    want = (2 * forwards, 2 * GOOGLENET_ITERS, 0, 0, 0)
    if counts != want:
        fail(f"googlenet launched K1-K5 {counts}, want {want}")
    k1["launches_by_path"]["train_googlenet"] = counts[0]
    k2["launches_by_path"]["train_googlenet"] = counts[1]
    med = summary["median_iter_ms"]
    return {
        "solver": "models/googlenet/solver.prototxt",
        "batch": GOOGLENET_BATCH, "iters": GOOGLENET_ITERS,
        "losses": losses, "median_step_ms": med,
        "img_per_s": summary["img_per_s"], "step_ms": summary["iter_ms"],
        "test_scores": summary["test_scores"],
        "launches_k1_k5": list(counts), "loss_weights": weights,
        "peak_mem_GB": peak_gb, "card": card,
    }

# -- 12. lmdb -------------------------------------------------------------------

CAFFENET = os.path.join(ROOT, "examples", "imagenet",
                        "caffenet_train_val.prototxt")
CAFFENET_SOLVER = os.path.join(ROOT, "examples", "imagenet",
                               "caffenet_solver.prototxt")
LMDB_SHAPE = (3, 256, 256)
LMDB_TRAIN, LMDB_VAL, LMDB_JPEG = 1280, 100, 256
LMDB_ITERS, LMDB_TEST_INTERVAL = 20, 10
JPEG_ITERS = 8
SYNTHETIC_ITERS = 10
CAFFENET_BATCH = 256


def _write_clusters(path, n, seed, codec=None):
    """An LMDB of `n` Datums (raw, or JPEG-encoded) from seeded separable
    clusters (examples/common.py synthetic_clusters: one random uint8
    template a class, plus bounded noise), by the port's writer, drawn
    in chunks of 64."""
    from caffe_mpi_tpu_torch.data import datasets, lmdb_io
    templates = np.random.RandomState(42).randint(
        0, 256, (10, *LMDB_SHAPE)).astype(np.int16)

    def records():
        for lo in range(0, n, 64):
            k = min(64, n - lo)
            rng = np.random.RandomState(seed + lo)
            labels = rng.randint(0, 10, k)
            imgs = np.clip(templates[labels] + rng.randint(
                -40, 41, (k, *LMDB_SHAPE)).astype(np.int16), 0,
                255).astype(np.uint8)
            for i in range(k):
                enc = (datasets.encode_datum(imgs[i], int(labels[i]))
                       if codec is None else datasets.encode_datum_image(
                           imgs[i], int(labels[i]), codec))
                yield f"{lo + i:08d}".encode(), enc
    lmdb_io.write_lmdb(path, records())


def _caffenet_copy(tmp, train_db, val_db, mean, tag):
    """Copies of the CaffeNet example net and solver over these files."""
    with open(CAFFENET) as f:
        net = f.read()
    for a, b in (("examples/imagenet/ilsvrc12_train_lmdb", train_db),
                 ("examples/imagenet/ilsvrc12_val_lmdb", val_db),
                 ("examples/imagenet/imagenet_mean.binaryproto", mean)):
        if a not in net:
            fail(f"{CAFFENET} no longer names {a}")
        net = net.replace(a, b)
    net_path = os.path.join(tmp, f"caffenet_{tag}.prototxt")
    with open(net_path, "w") as f:
        f.write(net)
    with open(CAFFENET_SOLVER) as f:
        solver = f.read()
    for a, b in (("examples/imagenet/caffenet_train_val.prototxt", net_path),
                 ("test_iter: 1000", "test_iter: 2"),
                 ("test_interval: 1000",
                  f"test_interval: {LMDB_TEST_INTERVAL}"),
                 ("max_iter: 450000", f"max_iter: {LMDB_ITERS}")):
        if a not in solver:
            fail(f"{CAFFENET_SOLVER} no longer sets {a}")
        solver = solver.replace(a, b)
    solver_path = os.path.join(tmp, f"caffenet_solver_{tag}.prototxt")
    with open(solver_path, "w") as f:
        f.write(solver)
    return net_path, solver_path


def _device_transform_check(solver, train_db) -> dict:
    """One TRAIN batch of the train LMDB through the card's device
    transform against the host DataTransformer over the same records and
    decisions: bitwise. Times both (the host over 256 records, the card's
    one gather)."""
    from caffe_mpi_tpu_torch.data import device_transform as dt
    from caffe_mpi_tpu_torch.data.datasets import open_dataset
    from caffe_mpi_tpu_torch.data.feeder import Feeder
    from caffe_mpi_tpu_torch.data.transformer import DataTransformer
    data = solver.net.layers[0]
    tf = DataTransformer(data.lp.transform_param, "TRAIN")
    feeder = Feeder(open_dataset("LMDB", train_db), tf, CAFFENET_BATCH,
                    device_transform=True, threads=1, lookahead=1)
    try:
        batch = feeder(0)
    finally:
        feeder.close()
    raw, aug = batch["data"], batch["data__aug"]
    flats = list(range(CAFFENET_BATCH))
    t0 = time.perf_counter()
    host = np.stack([tf(r, rng=tf.record_rng(f))
                     for r, f in zip(raw, flats)])
    host_ms = (time.perf_counter() - t0) * 1e3
    raw_d, aug_d = torch.from_numpy(raw).cuda(), torch.from_numpy(aug).cuda()
    mean = torch.from_numpy(tf.mean).cuda()
    tp = data.lp.transform_param

    def run():
        return dt.device_transform(raw_d, aug_d, crop=tp.crop_size,
                                   mean=mean, scale=tp.scale)
    got = run().cpu()
    if not torch.equal(got, torch.from_numpy(host)):
        fail("the card's device transform differs from the host "
             f"DataTransformer (max {float((got - torch.from_numpy(host)).abs().max())})")
    mirrored = int(aug[:, 2].sum())
    if not 0 < mirrored < CAFFENET_BATCH:
        fail(f"{mirrored} of {CAFFENET_BATCH} records mirrored")
    return {"bitwise": True, "records": CAFFENET_BATCH,
            "mirrored": mirrored, "device_ms": time_ms(run),
            "host_ms": host_ms}


def lmdb_phase(k1: dict, k2: dict, card: str) -> dict:
    """Train CaffeNet (examples/imagenet/caffenet_train_val.prototxt as
    written: batch 256, crop 227, mirror, a mean file) from a train LMDB
    of 1,280 raw 3x256x256 Datums and a val LMDB of 100 that the port's
    writer makes from seeded clusters, the mean from the port's
    compute_image_mean, through the CLI's `train` (no -synthetic): 20
    iterations, a test pass of 2 batches at iteration 10 and at the end,
    the device transform on. Checks finite losses, test scores, K1 twice
    a forward and K2 twice an iteration (counts set to 0 just before, read
    just after). Then: the card's busy share under the profiler, the same
    solver on a synthetic feed (the same net and device transform, no
    host feed), `test` on the val LMDB from the snapshot's caffemodel,
    `time` on the net, `device_query`, one batch of the device transform
    against the host DataTransformer bitwise, and a shorter run over a
    JPEG-encoded LMDB of 256 records (a PIL decode a record on the
    host)."""
    import contextlib

    from caffe_mpi_tpu_torch.data.feeder import DeviceFeed
    from caffe_mpi_tpu_torch.tools import cli, compute_image_mean
    tmp = tempfile.mkdtemp(prefix="chip_smoke_lmdb_")
    try:
        t0 = time.perf_counter()
        train_db = os.path.join(tmp, "train_lmdb")
        val_db = os.path.join(tmp, "val_lmdb")
        jpeg_db = os.path.join(tmp, "train_jpeg_lmdb")
        _write_clusters(train_db, LMDB_TRAIN, seed=7)
        _write_clusters(val_db, LMDB_VAL, seed=100_000)
        write_s = time.perf_counter() - t0
        _write_clusters(jpeg_db, LMDB_JPEG, seed=7, codec="jpeg")
        mean = os.path.join(tmp, "mean.binaryproto")
        with contextlib.redirect_stdout(sys.stderr):
            compute_image_mean.main([train_db, mean])
        db_mb = os.path.getsize(os.path.join(train_db, "data.mdb")) / 1e6
        log(f"lmdb: wrote {LMDB_TRAIN} + {LMDB_VAL} raw records "
            f"({db_mb:.1f} MB) in {write_s:.1f} s")
        net_path, solver_path = _caffenet_copy(tmp, train_db, val_db, mean,
                                               "raw")
        prefix = os.path.join(tmp, "caffenet")
        torch.cuda.reset_peak_memory_stats()
        _reset_kernel_counts()
        solver, summary = cli.train(cli.parse_args(
            ["train", "-solver", solver_path, "-snapshot_prefix", prefix,
             "-device", "cuda"]))
        torch.cuda.synchronize()
        counts = _kernel_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        log(f"lmdb train: {json.dumps(summary)}")
        losses = summary["losses"]
        if summary["batch"] != CAFFENET_BATCH or len(losses) != LMDB_ITERS:
            fail(f"lmdb train ran {len(losses)} iterations at batch "
                 f"{summary['batch']}")
        if not np.all(np.isfinite(losses)):
            fail(f"lmdb train losses not all finite: {losses}")
        if summary["data"] != "dataset" or not summary["device_transform"]:
            fail(f"lmdb train fed {summary['data']}, device transform "
                 f"{summary['device_transform']}")
        scores = summary["test_scores"]
        if not scores or set(scores[0]) != {"accuracy", "loss"} or \
                not all(np.isfinite(list(scores[0].values()))):
            fail(f"lmdb train test scores {scores}")
        forwards = LMDB_ITERS + 2 * 2  # two test passes of 2 batches
        want = (2 * forwards, 2 * LMDB_ITERS, 0, 0, 0)
        if counts != want:
            fail(f"lmdb train launched K1-K5 {counts}, want {want}")
        k1["launches_by_path"]["train_caffenet_lmdb"] = counts[0]
        k2["launches_by_path"]["train_caffenet_lmdb"] = counts[1]

        feed = DeviceFeed(cli.build_feeder(solver.net, "TRAIN"),
                          solver.device)
        try:
            profile = profile_steps(solver, feed)
        finally:
            feed.close()
        log(f"lmdb profile: {json.dumps(profile)}")
        syn = cli.synthetic_feed(solver.net)
        n0 = len(solver.iter_ms)
        solver.step(SYNTHETIC_ITERS, lambda it: syn)
        syn_ms = float(np.median(solver.iter_ms[n0 + 1:]))
        syn_window = cli.window_img_per_s(CAFFENET_BATCH,
                                          solver.iter_ms[n0 + 1:])
        transform = _device_transform_check(solver, train_db)
        log(f"device transform: {json.dumps(transform)}")
        del solver, syn

        with contextlib.redirect_stdout(sys.stderr):
            tested = cli.test_net(cli.parse_args(
                ["test", "-model", net_path, "-weights",
                 summary["snapshot"].replace(".solverstate", ".caffemodel"),
                 "-iterations", "2", "-device", "cuda"]))
            timed = cli.time_net(cli.parse_args(
                ["time", "-model", net_path, "-iterations", "10", "-phase",
                 "TRAIN", "-device", "cuda"]))
        if set(tested) != {"accuracy", "loss"} or \
                not all(np.isfinite(list(tested.values()))):
            fail(f"cli test on the val LMDB: {tested}")
        if not (timed["forward_backward_ms"] and timed["mfu"]):
            fail(f"cli time gave no whole step or MFU: {timed}")
        log(f"cli test: {json.dumps(tested)}")
        log(f"cli time: {json.dumps(timed)}")
        from caffe_mpi_tpu_torch.tools import device_query
        devices = device_query.query()
        if len(devices) != torch.cuda.device_count() or \
                devices[0]["name"] != torch.cuda.get_device_name(0):
            fail(f"device_query: {devices}")

        jnet, jsolver = _caffenet_copy(tmp, jpeg_db, val_db, mean, "jpeg")
        torch.cuda.empty_cache()
        jpeg_solver, jpeg = cli.train(cli.parse_args(
            ["train", "-solver", jsolver, "-max_iter", str(JPEG_ITERS),
             "-snapshot_prefix", os.path.join(tmp, "jpeg"), "-device",
             "cuda"]))
        del jpeg_solver
        log(f"lmdb jpeg train: {json.dumps(jpeg)}")
        if len(jpeg["losses"]) != JPEG_ITERS or \
                not np.all(np.isfinite(jpeg["losses"])):
            fail(f"jpeg train losses {jpeg['losses']}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    med = summary["median_iter_ms"]
    return {
        "solver": "examples/imagenet/caffenet_solver.prototxt (copy: "
        f"max_iter {LMDB_ITERS}, test_iter 2, test_interval "
        f"{LMDB_TEST_INTERVAL})",
        "batch": CAFFENET_BATCH, "records": LMDB_TRAIN,
        "record_shape": list(LMDB_SHAPE), "train_db_MB": db_mb,
        "write_s": write_s, "iters": LMDB_ITERS, "losses": losses,
        "test_scores": scores, "median_step_ms": med,
        "lmdb_img_per_s": summary["img_per_s"],
        "lmdb_window_img_per_s": summary["window_img_per_s"],
        "step_ms": summary["iter_ms"],
        "feed_ms_per_batch": summary["feed_ms_per_batch"],
        "feed_threads": summary["feed_threads"],
        "synthetic_step_ms": syn_ms,
        "synthetic_img_per_s": CAFFENET_BATCH / (syn_ms / 1e3),
        "synthetic_window_img_per_s": syn_window,
        "jpeg_records": LMDB_JPEG, "jpeg_iters": JPEG_ITERS,
        "jpeg_img_per_s": jpeg["img_per_s"],
        "jpeg_window_img_per_s": jpeg["window_img_per_s"],
        "jpeg_median_step_ms": jpeg["median_iter_ms"],
        "jpeg_feed_ms_per_batch": jpeg["feed_ms_per_batch"],
        "device_busy": profile.get("device_busy_profiled"),
        "profile": profile, "launches_k1_k5": list(counts),
        "device_transform": transform, "cli_test": tested,
        "time_step_ms": timed["forward_backward_ms"],
        "time_forward_ms": timed["forward_ms"], "time_mfu": timed["mfu"],
        "time_tflops": timed["tflops"], "time_peak_rate": timed["peak_rate"],
        "time_peak_mem_MiB": timed["peak_mem_MiB"],
        "device_query": devices[0],
        "peak_mem_GB": peak_gb, "card": card,
    }


# -- 13. bf16 ------------------------------------------------------------------

ALEXNET_FP16 = os.path.join(ROOT, "models", "alexnet", "solver_fp16.prototxt")
ALEXNET_FP16_NET = os.path.join(ROOT, "models", "alexnet",
                                "train_val_fp16.prototxt")
# the kernels' launchers (where each wrapper launches its kernel), whose
# input dtype the bf16 phases record
LAUNCHERS = (("lrn", "_launch", "lrn_fwd"), ("lrn", "_launch_bwd", "lrn_bwd"),
             ("flash_attention", "_launch_fwd", "flash_fwd"),
             ("flash_attention", "_launch_dq", "flash_bwd_dq"),
             ("flash_attention", "_launch_dkv", "flash_bwd_dkv"))


class _LaunchDtypes:
    """Within the context, the dtypes each kernel launcher was called
    with ({kernel: [dtype, ...]}), recorded around the launchers."""

    def __enter__(self):
        import importlib
        self.seen = {name: set() for _, _, name in LAUNCHERS}
        self._saved = []
        for mod_name, attr, name in LAUNCHERS:
            mod = importlib.import_module(f"caffe_mpi_tpu_torch.ops.{mod_name}")
            orig = getattr(mod, attr)

            def rec(x, *a, _orig=orig, _name=name, **k):
                self.seen[_name].add(str(x.dtype).replace("torch.", ""))
                return _orig(x, *a, **k)
            self._saved.append((mod, attr, orig))
            setattr(mod, attr, rec)
        return self

    def __exit__(self, *exc):
        for mod, attr, orig in self._saved:
            setattr(mod, attr, orig)
        return False

    def dtypes(self) -> dict:
        return {k: sorted(v) for k, v in self.seen.items() if v}


def _bf16_run(tag, solver_path, prefix, iters, extra, want_counts):
    """One CLI train run with the kernel counts set to 0 just before and
    read just after, and the launchers' dtypes recorded: finite losses,
    the counts `want_counts`, every launch in bf16, no skipped step."""
    _reset_kernel_counts()
    with _LaunchDtypes() as probe:
        solver, summary = _train_cli(solver_path, prefix, iters, extra)
        torch.cuda.synchronize()
    counts = _kernel_counts()
    losses = summary["losses"]
    log(f"bf16 {tag}: {json.dumps(summary)}")
    if len(losses) != iters or not np.all(np.isfinite(losses)):
        fail(f"bf16 {tag}: losses {losses}")
    if counts != want_counts:
        fail(f"bf16 {tag}: K1-K5 launched {counts}, want {want_counts}")
    dtypes = probe.dtypes()
    if set(dtypes) != {name for (_, _, name), n in zip(LAUNCHERS, counts)
                       if n} or any(v != ["bfloat16"]
                                    for v in dtypes.values()):
        fail(f"bf16 {tag}: kernels launched in {dtypes}, want bfloat16")
    if summary["skipped_steps"] or summary["overflow_steps"]:
        fail(f"bf16 {tag}: {summary['skipped_steps']} skipped, "
             f"{summary['overflow_steps']} overflow steps, want none")
    nets = {str(l.policy.forward) for l in solver.net.layers}
    del solver
    torch.cuda.empty_cache()
    return {"losses": losses, "median_step_ms": summary["median_iter_ms"],
            "img_per_s": summary["img_per_s"], "step_ms": summary["iter_ms"],
            "launches_k1_k5": list(counts), "launch_dtypes": dtypes,
            "layer_dtypes": sorted(nets), "precision": summary["precision"],
            "loss_scale": summary["loss_scale"],
            "skipped_steps": summary["skipped_steps"],
            "overflow_steps": summary["overflow_steps"]}


def bf16_phase(k1: dict, k2: dict, flash: list[dict], f32: dict,
               card: str) -> dict:
    """(a) AlexNet at batch 256 from models/alexnet/solver_fp16.prototxt
    (the fp16 net's FLOAT16 defaults) and from solver.prototxt under
    `-precision bf16` (dynamic loss scale, the guard armed): 20
    iterations each through the CLI's `train`, K1 twice a forward and K2
    twice an iteration, every launch in bf16, no overflow; step ms and
    img/s beside the f32 run's; `time` on the fp16 net, MFU against the
    dense bf16 peak. (b) transformer_lm with use_flash under `-precision
    bf16`: 20 iterations, K3 twice a forward, K4 and K5 twice an
    iteration, every launch in bf16. (c) ResNet-50 (b32, 53 BatchNorms,
    bf16 statistics kept f32) and GoogLeNet (b128, K1/K2 in bf16) from
    their solver_fp16.prototxt: 20 iterations each. `f32` holds the f32
    phases' results by net, for their step ms."""
    from caffe_mpi_tpu_torch.tools import cli

    tmp = tempfile.mkdtemp(prefix="chip_smoke_bf16_")
    try:
        lrn_counts = (2 * (TRAIN_ITERS + 2 * TEST_ITER), 2 * TRAIN_ITERS,
                      0, 0, 0)
        fp16 = _bf16_run("alexnet fp16 prototxt", ALEXNET_FP16,
                         os.path.join(tmp, "fp16"), TRAIN_ITERS, (),
                         lrn_counts)
        bf16 = _bf16_run("alexnet -precision bf16", SOLVER,
                         os.path.join(tmp, "bf16"), TRAIN_ITERS,
                         ("-precision", "bf16"), lrn_counts)
        r50 = _bf16_run("resnet50 fp16 prototxt",
                        os.path.join(RESNET_DIR, "solver_fp16.prototxt"),
                        os.path.join(tmp, "r50"), RESNET_ITERS, (),
                        (0, 0, 0, 0, 0))
        goog = _bf16_run(
            "googlenet fp16 prototxt",
            os.path.join(ROOT, "models", "googlenet", "solver_fp16.prototxt"),
            os.path.join(tmp, "goog"), GOOGLENET_ITERS, (),
            (2 * (GOOGLENET_ITERS + 2 * TEST_ITER), 2 * GOOGLENET_ITERS, 0,
             0, 0))
        for run, net in ((fp16, "train"), (bf16, "train"),
                         (r50, "resnet50"), (goog, "googlenet")):
            run["f32_median_step_ms"] = f32[net]["median_step_ms"]
            run["speedup_over_f32"] = f32[net]["median_step_ms"] \
                / run["median_step_ms"]
        k1["launches_by_path"]["train_alexnet_bf16"] = bf16[
            "launches_k1_k5"][0]
        k2["launches_by_path"]["train_alexnet_bf16"] = bf16[
            "launches_k1_k5"][1]
        timed = cli.time_net(cli.parse_args(
            ["time", "-model", ALEXNET_FP16_NET, "-phase", "TRAIN",
             "-iterations", "10", "-device", "cuda"]))
        if not timed["peak_rate"] or timed["peak_rate"]["name"] != \
                "dense bf16" or not timed["mfu"]:
            fail(f"time on the fp16 net: MFU {timed['mfu']} against "
                 f"{timed['peak_rate']}, want the dense bf16 peak")
        tlm_solver = _flash_solver(tmp)
        forwards = TLM_ITERS + TEST_ITER
        tlm = _bf16_run("transformer_lm -precision bf16", tlm_solver,
                        os.path.join(tmp, "tlm"), TLM_ITERS,
                        ("-precision", "bf16"),
                        (0, 0, 2 * forwards, 2 * TLM_ITERS, 2 * TLM_ITERS))
        tlm["tokens_per_s"] = tlm["img_per_s"] * TLM_SEQ
        tlm["f32_median_step_ms"] = f32["transformer"]["median_step_ms"]
        for entry, n in zip(flash, tlm["launches_k1_k5"][2:]):
            entry["launches_by_path"]["train_transformer_lm_bf16"] = n
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    return {"alexnet_fp16_prototxt": fp16, "alexnet_precision_bf16": bf16,
            "resnet50_fp16_prototxt": r50, "googlenet_fp16_prototxt": goog,
            "time_fp16": {k: timed[k] for k in (
                "model", "batch", "forward_ms", "forward_backward_ms",
                "tflops", "mfu", "peak_rate", "peak_mem_MiB")},
            "transformer_lm_bf16": tlm, "card": card}


# -- 14. chunk -----------------------------------------------------------------

CHUNK = 10
CHUNK_ITERS = 20
# graph against eager: each tensor's distance from the nearer eager run,
# as a share of its largest element, at most twice the largest such share
# between the two eager runs, plus 1e-6 (f32 ulps where the eager runs
# agree bitwise); the same for the losses
CHUNK_SPREAD, CHUNK_FLOOR = 2.0, 1e-6


class _MaskLog:
    """Within the context, every iteration's Dropout masks as the solver
    drew them (the masks both the eager iteration and a graph replay
    read), kept on the device."""

    def __enter__(self):
        from caffe_mpi_tpu_torch.solver import solver as solver_mod
        self.cls, self.masks = solver_mod.Solver, {}
        self.orig = self.cls._masks
        log_ = self.masks

        def rec(solver, it, given):
            out = self.orig(solver, it, given)
            log_[it] = [{k: v.clone() for k, v in m.items()} for m in out]
            return out
        self.cls._masks = rec
        return self

    def __exit__(self, *exc):
        self.cls._masks = self.orig
        return False


def _chunk_run(path, prefix, k, extra=()):
    """A CLI train run at step_chunk k: (solver, summary, K1-K5 counts,
    state on the host, masks by iteration)."""
    _reset_kernel_counts()
    with _MaskLog() as masks:
        solver, summary = _train_cli(path, prefix, CHUNK_ITERS,
                                     ("-step_chunk", str(k), *extra))
        torch.cuda.synchronize()
    if len(summary["losses"]) != CHUNK_ITERS or \
            not np.all(np.isfinite(summary["losses"])):
        fail(f"chunk {path} K={k}: losses {summary['losses']}")
    return solver, summary, _kernel_counts(), _state(solver), masks.masks


def _timed_steps(solver, feed_fn, n: int = CHUNK_ITERS) -> dict:
    """n more iterations: ms an iteration (host clock to the last chunk's
    read-back), and the host syncs the CUDA sync debugger reported
    against the chunks run."""
    import warnings
    d0 = solver.dispatch_count
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            t0 = time.perf_counter()
            solver.step(n, feed_fn)
            ms = (time.perf_counter() - t0) * 1e3 / n
        finally:
            torch.cuda.set_sync_debug_mode("default")
    where = [f"{os.path.basename(w.filename)}:{w.lineno}" for w in caught
             if "synchroniz" in str(w.message)]
    return {"ms_per_iter": ms, "chunks": solver.dispatch_count - d0,
            "host_syncs": len(where), "sync_sites": sorted(set(where))}


def _chunk_case(name, path, card, extra=()) -> dict:
    """step_chunk 10 against 1 on one solver: two eager runs (K = 1) and
    one of graph replays (K = 10) from the same seed and feeds; the
    graph's losses and final params, slots and statistics within the
    eager runs' spread, its Dropout masks the eager path's, its kernel
    launches the eager run's (captured x replays), one host sync a chunk;
    then step ms and the card's busy share at K = 1 and K = 10."""
    from caffe_mpi_tpu_torch.tools import cli

    tmp = tempfile.mkdtemp(prefix="chip_smoke_chunk_")
    try:
        e1, s1, c1, st1, m1 = _chunk_run(path, os.path.join(tmp, "e1"), 1,
                                         extra)
        del e1
        torch.cuda.empty_cache()
        e2, s2, c2, st2, m2 = _chunk_run(path, os.path.join(tmp, "e2"), 1,
                                         extra)
        g, sg, cg, stg, mg = _chunk_run(path, os.path.join(tmp, "g"), CHUNK,
                                        extra)
        if not g.graph_replays or not g._graphs:
            fail(f"chunk {name}: no graph replayed")
        if c1 != c2 or cg != c1:
            fail(f"chunk {name}: K1-K5 launches eager {c1} / {c2}, graph "
                 f"{cg}")
        graph = next(iter(g._graphs.values()))
        deltas = {c.__name__: n for c, n in graph.deltas.items()}
        # masks: the graph run's every iteration equal to the eager run's,
        # and the graph's static buffers hold the last iteration's
        bad_masks = [it for it in m1 if any(
            not torch.equal(a[k], b[k]) for a, b in zip(m1[it], mg[it])
            for k in a)]
        last = mg[max(mg)]
        if bad_masks or any(not torch.equal(graph.masks[i][k], last[i][k])
                            for i in range(len(last)) for k in last[i]):
            fail(f"chunk {name}: graph masks differ at {bad_masks[:5]}")
        # each tensor's distance as a share of its largest element: the
        # graph run's from the nearer eager run against the eager runs'
        # own, the largest over all tensors on each side
        worst, bad = {}, []
        for key in st1:
            scale = max(float(st1[key].float().abs().max()), 1e-30)
            spread = float((st2[key].float() - st1[key].float()).abs()
                           .max()) / scale
            diff = min(float((stg[key].float() - st[key].float()).abs()
                             .max()) for st in (st1, st2)) / scale
            worst[key] = (diff, spread)
        diff = max(d for d, _ in worst.values())
        spread = max(sp for _, sp in worst.values())
        limit = CHUNK_SPREAD * spread + CHUNK_FLOOR
        if diff > limit:
            bad.append(f"state: {diff:.3g} > {limit:.3g} of the largest "
                       "element")
        l1, l2, lg = (np.array(x["losses"]) for x in (s1, s2, sg))
        l_diff = float(np.max(np.minimum(np.abs(lg - l1), np.abs(lg - l2))
                              / np.abs(l1)))
        l_limit = CHUNK_SPREAD * float(np.max(np.abs(l2 - l1)
                                              / np.abs(l1))) + CHUNK_FLOOR
        if l_diff > l_limit:
            bad.append(f"losses {lg.tolist()} vs eager {l1.tolist()}")
        if bad:
            fail(f"chunk {name}: graph against eager: {bad}")
        del st1, st2, stg, m1, m2, mg
        feeds = cli.synthetic_feed(g.net)
        feed_fn = lambda it: feeds  # noqa: E731
        # timed in mirrored order, warm: eager, graph, graph, eager
        timing = {"k1": [], "k10": []}
        for which in ("k1", "k10", "k10", "k1"):
            timing[which].append(_timed_steps(e2 if which == "k1" else g,
                                              feed_fn))
        for t in timing["k10"]:
            if t["host_syncs"] != t["chunks"]:
                fail(f"chunk {name}: {t['host_syncs']} host syncs in "
                     f"{t['chunks']} chunks at K = {CHUNK} "
                     f"({t['sync_sites']}), want one a chunk")
        prof = {"k1": profile_steps(e2, feed_fn, n=CHUNK),
                "k10": profile_steps(g, feed_fn, n=CHUNK)}
        out = {
            "losses_eager": s1["losses"], "losses_graph": sg["losses"],
            "launches_k1_k5": list(cg), "captured_launches": deltas,
            "graph_replays": g.graph_replays,
            "dispatch_count": sg["dispatch_count"],
            "host_sync_count": sg["host_sync_count"],
            "state_diff": diff, "state_spread": spread,
            "state_limit": limit, "loss_diff": l_diff,
            "loss_limit": l_limit,
            "worst": sorted(((k, d, sp) for k, (d, sp) in worst.items()),
                            key=lambda r: -r[1])[:5],
            "step_ms": {k: [t["ms_per_iter"] for t in v]
                        for k, v in timing.items()},
            "host_syncs": {k: [[t["host_syncs"], t["chunks"]] for t in v]
                           for k, v in timing.items()},
            "sync_sites": {k: sorted({x for t in v for x in t["sync_sites"]})
                           for k, v in timing.items()},
            "device_busy": {k: (p["device_ms_per_step"]
                                / p["wall_ms_per_step"])
                            if isinstance(p["device_ms_per_step"], float)
                            else "not measured" for k, p in prof.items()},
            "device_ms_per_step": {k: p["device_ms_per_step"]
                                   for k, p in prof.items()},
            "card": card,
        }
        k1_ms = float(np.median(out["step_ms"]["k1"]))
        k10_ms = float(np.median(out["step_ms"]["k10"]))
        out["median_step_ms"] = {"k1": k1_ms, "k10": k10_ms}
        out["speedup_k10"] = k1_ms / k10_ms
        log(f"chunk {name}: {json.dumps(out)}")
        del e2, g
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    return out


def chunk_phase(k1: dict, k2: dict, flash: list[dict], card: str) -> dict:
    """step_chunk 10 as CUDA graph replays on AlexNet (b256, K1/K2 in the
    graph), ResNet-50 (b32, 53 BatchNorms' statistics updated in the
    graph) and transformer_lm with use_flash (K3-K5 in the graph, Adam)."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_chunk_tlm_")
    try:
        res = {
            "alexnet": _chunk_case("alexnet", SOLVER, card),
            "resnet50": _chunk_case(
                "resnet50", os.path.join(RESNET_DIR, "solver.prototxt"),
                card),
            "transformer_lm": _chunk_case("transformer_lm",
                                          _flash_solver(tmp), card),
        }
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    counts = res["alexnet"]["launches_k1_k5"]
    k1["launches_by_path"]["train_alexnet_chunk10"] = counts[0]
    k2["launches_by_path"]["train_alexnet_chunk10"] = counts[1]
    for entry, n in zip(flash, res["transformer_lm"]["launches_k1_k5"][2:]):
        entry["launches_by_path"]["train_transformer_lm_chunk10"] = n
    return res


# -- 15. overflow --------------------------------------------------------------

def overflow_phase() -> dict:
    """A dynamic-scale overflow injected on the card: AlexNet at batch 256
    under precision bf16 and step_chunk 10 (graph replays), NaN batches at
    iterations 3 and 4. Both are skipped (params and slots bitwise
    unchanged across them), counted as overflows, and halve the scale to
    2^13; 8 clean steps (loss_scale_window 4) grow it back to 2^15, with
    finite losses."""
    from caffe_mpi_tpu_torch.proto import SolverParameter
    from caffe_mpi_tpu_torch.solver import Solver
    from caffe_mpi_tpu_torch.tools import cli

    sp = SolverParameter.from_file(SOLVER)
    sp.precision, sp.step_chunk, sp.loss_scale_window = "bf16", CHUNK, 4
    solver = Solver(sp, device="cuda")
    feeds = cli.synthetic_feed(solver.net)
    bad = dict(feeds, data=torch.full_like(feeds["data"], float("nan")))
    feed_fn = lambda it: bad if it in (3, 4) else feeds  # noqa: E731
    solver.step(3, feed_fn)
    before = _state(solver)
    solver.step(2, feed_fn)
    after = _state(solver)
    changed = [k for k in before if not torch.equal(before[k], after[k])]
    scale_after_burst = solver.loss_scale_value
    solver.step(8, feed_fn)
    res = {"skipped_iters": solver.skipped_iters,
           "overflow_steps": solver.overflow_steps,
           "scale_after_burst": scale_after_burst,
           "scale_after_recovery": solver.loss_scale_value,
           "losses": solver.losses, "graph_replays": solver.graph_replays,
           "changed_by_skipped_steps": changed[:5]}
    log(f"overflow: {json.dumps(res)}")
    accepted = [l for i, l in enumerate(solver.losses) if i not in (3, 4)]
    if solver.skipped_iters != [3, 4] or solver.overflow_steps != 2 or \
            scale_after_burst != 2.0 ** 13 or changed or \
            solver.loss_scale_value != 2.0 ** 15 or \
            not np.all(np.isfinite(accepted)) or not solver.graph_replays:
        fail(f"overflow on the card: {res}")
    del solver
    torch.cuda.empty_cache()
    return res


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", metavar="DIR", default=None,
                    help="a checkout of the parent commit: its K1-K5 are "
                    "built and timed beside this tree's in each case")
    args = ap.parse_args(argv)
    parent = os.path.abspath(args.parent) if args.parent else None
    os.chdir(ROOT)
    card, rates = device_phase()
    build_phase()
    parent_flash, parent_lrn = parent_libs(parent) if parent else (None,
                                                                   None)
    k1 = kernel_phase(rates, parent_lrn)
    k2 = kernel_bwd_phase(rates, parent_lrn)
    flash = flash_kernel_phase(rates, parent_flash)
    serving = serve_phase(k1, card)
    train = train_phase(k1, k2, card)
    train["parity"] = parity_phase()
    transformer = transformer_phase(flash, card)
    transformer["induction"] = induction_phase()
    transformer["parity"] = transformer_parity_phase()
    resnet50 = resnet50_phase(card)
    googlenet = googlenet_phase(k1, k2, card)
    resnet50["parity"] = resnet50_parity_phase()
    lmdb = lmdb_phase(k1, k2, card)
    bf16 = bf16_phase(k1, k2, flash, {
        "train": train, "transformer": transformer, "resnet50": resnet50,
        "googlenet": googlenet}, card)
    chunk = chunk_phase(k1, k2, flash, card)
    chunk["overflow"] = overflow_phase()
    print(json.dumps({"kernels": [k1, k2, *flash]}), flush=True)
    print(json.dumps({"serving": serving}), flush=True)
    print(json.dumps({"train": train}), flush=True)
    print(json.dumps({"transformer": transformer}), flush=True)
    print(json.dumps({"resnet50": resnet50}), flush=True)
    print(json.dumps({"googlenet": googlenet}), flush=True)
    print(json.dumps({"lmdb": lmdb}), flush=True)
    print(json.dumps({"bf16": bf16}), flush=True)
    print(json.dumps({"chunk": chunk}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
