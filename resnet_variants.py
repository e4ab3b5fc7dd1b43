#!/usr/bin/env python3
"""Time ResNet-50's training step on one NVIDIA card under variants of
what the port leaves to PyTorch: the two BatchNorm designs
(caffe_mpi_tpu_torch/layers/norm.py BATCH_STATS), cuDNN's autotuner
(`torch.backends.cudnn.benchmark`) and the channels-last memory format.

    python3 resnet_variants.py [--iters N] [--warm N] [--configs a,b]

Each run builds the port's Solver on models/resnet50/solver.prototxt as
written (batch 32, 3x224x224, f32, SGD; no test pass), or on
solver_fp16.prototxt (its net's FLOAT16 defaults: bf16 compute), on the
card from the same seeded weights, takes `--warm` iterations on one
synthetic batch (cli.synthetic_feed), then `--iters` more, and reports
the median step: host wall time from the iteration's start to its loss
read back, as the CLI's `train` reports it. The configurations
(`--configs`, default all), each run twice on one card in mirrored
order (A B C D D C B A), so drift between runs shows as the gap between
a configuration's two runs:

- bn_fused, bn_composite: the two batch-statistics designs, everything
  else as shipped (the port ships the faster, "fused");
- cudnn_benchmark: the shipped design with the autotuner on (the port
  leaves it off: its algorithm choice may change between runs, and
  bitwise resume is checked);
- channels_last: the shipped design with every 4-D parameter and the
  input in channels-last memory format;
- bn_fused_fp16, bn_composite_fp16: the two designs on the fp16 net
  (the port ships "fused" for bf16 inputs too).

One JSON line a run on stdout, then a summary line and the card's name
and power limit. Fails (exit 1) on a non-finite loss or without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402

CONFIGS = ("bn_fused", "bn_composite", "cudnn_benchmark", "channels_last",
           "bn_fused_fp16", "bn_composite_fp16")


def _solver(fp16: bool):
    from caffe_mpi_tpu_torch.proto import SolverParameter
    from caffe_mpi_tpu_torch.solver import Solver
    sp = SolverParameter.from_file(os.path.join(
        ROOT, "models", "resnet50",
        "solver_fp16.prototxt" if fp16 else "solver.prototxt"))
    sp.test_iter, sp.test_interval, sp.display = [], 0, 0
    return Solver(sp, device="cuda")


def run(name: str, warm: int, iters: int) -> dict:
    from caffe_mpi_tpu_torch.layers import norm
    from caffe_mpi_tpu_torch.tools import cli
    shipped = norm.BATCH_STATS
    design = {"bn_fused": "fused", "bn_composite": "composite"}.get(
        name.removesuffix("_fp16"), shipped)
    norm.BATCH_STATS = design
    torch.backends.cudnn.benchmark = name == "cudnn_benchmark"
    try:
        solver = _solver(name.endswith("_fp16"))
        feeds = cli.synthetic_feed(solver.net)
        if name == "channels_last":
            with torch.no_grad():
                for _, _, _, p in solver._decls:
                    if p.dim() == 4:
                        p.data = p.data.contiguous(
                            memory_format=torch.channels_last)
            feeds["data"] = feeds["data"].contiguous(
                memory_format=torch.channels_last)
        solver.step(warm, lambda it: feeds)
        torch.cuda.synchronize()
        solver.step(iters, lambda it: feeds)
        steps = solver.iter_ms[warm:]
        losses = solver.losses
        del solver, feeds
    finally:
        norm.BATCH_STATS = shipped
        torch.backends.cudnn.benchmark = False
        torch.cuda.empty_cache()
    if not np.all(np.isfinite(losses)):
        cs.fail(f"{name}: losses not all finite: {losses}")
    med = float(np.median(steps))
    return {"run": name, "batch_norm_design": design,
            "fp16": name.endswith("_fp16"),
            "cudnn_benchmark": name == "cudnn_benchmark",
            "channels_last": name == "channels_last",
            "median_step_ms": med, "img_per_s": 32 / (med / 1e3),
            "step_ms": steps, "last_loss": losses[-1]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--warm", type=int, default=3)
    ap.add_argument("--configs", default=",".join(CONFIGS))
    args = ap.parse_args(argv)
    configs = args.configs.split(",")
    unknown = set(configs) - set(CONFIGS)
    if unknown:
        ap.error(f"unknown configurations {sorted(unknown)}")
    card, _ = cs.device_phase()
    results = []
    for name in configs + configs[::-1]:
        res = run(name, args.warm, args.iters)
        results.append(res)
        print(json.dumps(res), flush=True)
    by = {}
    for r in results:
        by.setdefault(r["run"], []).append(r["median_step_ms"])
    print(json.dumps({"resnet50_variants": {
        k: {"median_step_ms": v, "mean": float(np.mean(v))}
        for k, v in by.items()}, "card": card}), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
