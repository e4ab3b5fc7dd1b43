#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (caffe_mpi_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py          # from the root of the repository

Phases, in order; any failure exits nonzero and prints no result line:

1. device  — requires torch.cuda.is_available(); prints the card's name and
             power limit as nvidia-smi reports them.
2. build   — builds every CUDA kernel of the port from csrc/ with nvcc for
             sm_90a (one nvcc per source, all started together).
3. kernels — holds each kernel against its plain PyTorch version on the card
             at the shapes the serving path gives it (and at edge shapes),
             in float32 and bfloat16, and times the kernel, the plain
             version and the library call that computes the same function.
4. slice   — serves AlexNet (models/alexnet/deploy.prototxt, full width,
             weights drawn from a seeded torch.Generator) through the
             port's ServingEngine: mixed bursts from several threads with
             every kernel launch count set to 0 just before and read just
             after; parity of rows served on the card (TF32 off) against
             the port's Net forward on the CPU; and a speed run of the
             prototxt as written (img/s, p50/p99 request latency).

It prints one {"kernels": [...]} line, one {"serving": ...} line, the card
line again, and last {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
MODEL = os.path.join(ROOT, "models", "alexnet", "deploy.prototxt")
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


def lrn_bound(shape, dtype, size, rates) -> tuple[float, str]:
    """Least time for the work: x read once and y written once over the
    memory rate, against 2*size+6 float32 operations an element (window
    squares and adds, scale, log, exp, products) over the f32 peak."""
    mem_rate, f32_rate = rates
    elems = float(np.prod(shape))
    itemsize = torch.empty((), dtype=dtype).element_size()
    t_bytes = 2 * elems * itemsize / mem_rate * 1e3
    t_ops = elems * (2 * size + 6) / f32_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_phase(rates) -> dict:
    import torch.nn.functional as F
    from caffe_mpi_tpu_torch.ops import lrn as lrn_op

    gen = torch.Generator(device="cuda").manual_seed(0)
    tol = {torch.float32: dict(rtol=1e-5, atol=1e-6),
           torch.bfloat16: dict(rtol=8e-3, atol=1e-6)}  # one bf16 ulp

    def check(shape, dtype, size, alpha, beta, k):
        x = (torch.randn(shape, generator=gen, device="cuda") * 4).to(dtype)
        y = lrn_op.lrn_across_channels(x, size, alpha, beta, k)
        r = lrn_op.lrn_across_channels_ref(x, size, alpha, beta, k)
        torch.cuda.synchronize()
        torch.testing.assert_close(y.float(), r.float(), **tol[dtype])
        return x, float((y.float() - r.float()).abs().max())

    max_err = 0.0
    # edge shapes of the CPU tests: C < size, 1x1 maps, HW not a multiple
    # of 128, every window size
    for shape in ((2, 96, 13, 13), (1, 3, 5, 5), (2, 16, 1, 1), (1, 8, 7, 9)):
        for size in (3, 5, 7):
            for dtype in tol:
                _, err = check(shape, dtype, size, 1e-2, 0.75, 2.0)
                max_err = max(max_err, err)
    # AlexNet's norm1 and norm2 at every bucket of its ladder
    cases = []
    for b in (1, 4, 10):
        for layer, shape in (("norm1", (b, 96, 55, 55)),
                             ("norm2", (b, 256, 27, 27))):
            for dtype in tol:
                x, err = check(shape, dtype, **LRN)
                max_err = max(max_err, err)
                args = (LRN["size"], LRN["alpha"], LRN["beta"], LRN["k"])
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
    head = next(c for c in cases if c["layer"] == "norm1"
                and c["shape"][0] == 10 and c["dtype"] == "float32")
    return {
        "name": "lrn_fwd", "route": "cuda",
        "source": "caffe_mpi_tpu_torch/csrc/lrn.cu",
        "replaces": lrn_op.REPLACES,
        "launches": None,  # the main path's count, filled by slice_phase
        "max_abs_err": max_err,
        "shape": head["shape"], "dtype": head["dtype"],
        "ms": head["kernel_ms"], "kernel_ms": head["kernel_ms"],
        "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"], "library_ms": head["library_ms"],
        "launches_per_forward": 2,
        "cases": cases,
    }


# -- 4. slice -----------------------------------------------------------------

def _images(rng, n):
    return [rng.rand(227, 227, 3).astype(np.float32) for _ in range(n)]


def _check_rows(rows, n):
    if rows.shape != (n, 1000) or not np.all(np.isfinite(rows)):
        fail(f"served rows {rows.shape} not finite (n={n}, 1000)")
    if np.abs(rows.sum(axis=1) - 1.0).max() > 1e-4:
        fail("served softmax rows do not sum to 1")


def slice_phase(kernel: dict, card: str) -> dict:
    from caffe_mpi_tpu_torch.net import Net
    from caffe_mpi_tpu_torch.ops.lrn import lrn_across_channels
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
        with ThreadPoolExecutor(max_workers=4) as ex:
            futs = [ex.submit(engine.classify, "alexnet", imgs)
                    for imgs in batches]
            results = [f.result(timeout=600) for f in futs]
        engine.drain()
        launches = lrn_across_channels.launches
        stats = engine.stats()
        for rows, b in zip(results, bursts):
            _check_rows(rows, b)
        if stats["requests"] != sum(bursts):
            fail(f"{stats['requests']} requests recorded, sent {sum(bursts)}")
        if launches == 0 or launches != 2 * stats["dispatches"]:
            fail(f"lrn kernel launched {launches} times for "
                 f"{stats['dispatches']} dispatched buckets (want 2 each)")
        kernel["launches"] = launches
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
                    ref = cpu_net({"data": torch.from_numpy(rows_in)})[
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


def main() -> int:
    card, rates = device_phase()
    build_phase()
    kernel = kernel_phase(rates)
    serving = slice_phase(kernel, card)
    print(json.dumps({"kernels": [kernel]}), flush=True)
    print(json.dumps({"serving": serving}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
