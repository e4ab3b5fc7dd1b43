#!/usr/bin/env python3
"""Time the port's training step through `cli train` on one NVIDIA card,
this tree against a parent checkout and step_chunk 1 against 10.

    python3 step_variants.py [--parent DIR] [--configs alexnet,resnet50]
                             [--iters N] [--rounds N]

Each run is one process, `python -m caffe_mpi_tpu_torch.tools.cli train
-solver S -synthetic -max_iter N -device cuda` from the root of a tree,
its snapshots under TMPDIR; it reports the median step of the run's
`{"train": ...}` summary (host wall time to the loss read-back, each
step of a chunk its chunk's share), the first `--skip` steps left out
(the warm-up and, at step_chunk 10, the graph's capture). Configurations
(`--configs`, default all), each at step_chunk 1 from this tree and, with
`--parent DIR` (a `git archive` of the parent commit), from the parent,
and at step_chunk 10 from this tree, in `--rounds` mirrored rounds
(default 1), each: parent, tree, k10, k10, tree, parent:

- alexnet: models/alexnet/solver.prototxt (batch 256, f32);
- alexnet_fp16: models/alexnet/solver_fp16.prototxt (bf16 compute);
- resnet50: models/resnet50/solver.prototxt (batch 32, f32);
- googlenet: models/googlenet/solver.prototxt (batch 128, f32);
- resnet50_fp16, googlenet_fp16: their solver_fp16.prototxt (bf16);
- transformer_lm: models/transformer_lm with use_flash (batch 8, Adam).

Both trees build their kernels first, in parallel. One JSON line a run on
stdout, then a summary line (each configuration's median steps by tree)
and the card's name and power limit. Fails (exit 1) without a card or on
a run that fails.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SOLVERS = {
    "alexnet": "models/alexnet/solver.prototxt",
    "alexnet_fp16": "models/alexnet/solver_fp16.prototxt",
    "resnet50": "models/resnet50/solver.prototxt",
    "googlenet": "models/googlenet/solver.prototxt",
    "resnet50_fp16": "models/resnet50/solver_fp16.prototxt",
    "googlenet_fp16": "models/googlenet/solver_fp16.prototxt",
    "transformer_lm": None,  # a copy with use_flash, written at start
}


def _flash_solver(tmp: str) -> str:
    """A copy of models/transformer_lm/solver.prototxt whose net has
    `use_flash: true` after each `causal: true` (as chip_smoke.py's)."""
    d = os.path.join(ROOT, "models", "transformer_lm")
    with open(os.path.join(d, "train_val.prototxt")) as f:
        net = f.read().replace("causal: true",
                               "causal: true\n    use_flash: true")
    net_path = os.path.join(tmp, "train_val.prototxt")
    with open(net_path, "w") as f:
        f.write(net)
    with open(os.path.join(d, "solver.prototxt")) as f:
        text = f.read().replace(
            'net: "models/transformer_lm/train_val.prototxt"',
            f'net: "{net_path}"')
    path = os.path.join(tmp, "solver.prototxt")
    with open(path, "w") as f:
        f.write(text)
    return path


def _build(roots) -> None:
    procs = [subprocess.Popen(
        [sys.executable, "-c", "from caffe_mpi_tpu_torch.ops import build; "
         "build.build_all()"], cwd=root) for root in roots]
    if any(p.wait() for p in procs):
        sys.exit("step_variants: a kernel build failed")


def _run(root, solver, iters, chunk, skip, tmp) -> dict:
    argv = [sys.executable, "-m", "caffe_mpi_tpu_torch.tools.cli", "train",
            "-solver", solver, "-synthetic", "-max_iter", str(iters),
            "-device", "cuda", "-snapshot_prefix",
            os.path.join(tmp, "snap")]
    if chunk > 1:
        argv += ["-step_chunk", str(chunk)]
    proc = subprocess.run(argv, cwd=root, capture_output=True, text=True)
    lines = [l for l in proc.stdout.splitlines() if l.startswith('{"train"')]
    if proc.returncode or not lines:
        sys.stderr.write(proc.stderr[-4000:])
        sys.exit(f"step_variants: {solver} in {root} exited "
                 f"{proc.returncode}")
    summary = json.loads(lines[-1])["train"]
    steps = summary["iter_ms"][skip:]
    if not np.all(np.isfinite(summary["losses"])):
        sys.exit(f"step_variants: {solver}: non-finite losses")
    return {"median_step_ms": float(np.median(steps)),
            "mean_step_ms": float(np.mean(steps)),
            "batch": summary["batch"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default=None)
    ap.add_argument("--configs", default=",".join(SOLVERS))
    ap.add_argument("--iters", type=int, default=40)
    ap.add_argument("--skip", type=int, default=11)
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("step_variants: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    parent = os.path.abspath(args.parent) if args.parent else None
    _build([ROOT] + ([parent] if parent else []))
    tmp = tempfile.mkdtemp(prefix="step_variants_")
    try:
        solvers = dict(SOLVERS, transformer_lm=_flash_solver(tmp))
        order = (["parent"] if parent else []) + ["tree", "k10", "k10",
                                                  "tree"] \
            + (["parent"] if parent else [])
        results = {}
        for name in args.configs.split(","):
            for _ in range(args.rounds):
                for which in order:
                    root = parent if which == "parent" else ROOT
                    res = _run(root, os.path.join(ROOT, solvers[name])
                               if solvers[name] and not os.path.isabs(
                                   solvers[name]) else solvers[name],
                               args.iters, 10 if which == "k10" else 1,
                               args.skip, tmp)
                    res.update(config=name, tree=which)
                    print(json.dumps(res), flush=True)
                    results.setdefault(name, {}).setdefault(
                        which, []).append(res["median_step_ms"])
        print(json.dumps({"summary": results, "card": card}), flush=True)
        print(card, flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
