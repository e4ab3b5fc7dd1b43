"""plot_training_log — render loss / accuracy / lr curves from a training log.

Reference: tools/extra/plot_training_log.py.example + root-level
plot_{loss,top1,top5,train_loss}.py / common_plot.py (multi-log
comparison). Reads the logs through parse_log.py.

Usage:
    python -m caffe_mpi_tpu_torch.tools.plot_training_log OUTPUT.png LOG [LOG2 ...]
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="plot_training_log")
    p.add_argument("output")
    p.add_argument("logs", nargs="+")
    args = p.parse_args(argv)

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from .parse_log import parse

    fig, axes = plt.subplots(1, 2, figsize=(11, 4))
    for logfile in args.logs:
        train, test = parse(logfile)
        label = os.path.basename(logfile)
        if train:
            axes[0].plot([r["NumIters"] for r in train],
                         [r["loss"] for r in train], label=label)
        # one series per (test net, metric) — mixing metrics on one line
        # would zigzag between incomparable scales
        series: dict[tuple, list] = {}
        for r in test:
            for k, v in r.items():
                if k in ("NumIters", "TestNet"):
                    continue
                series.setdefault((r.get("TestNet", 0), k), []).append(
                    (r["NumIters"], v))
        for (net_i, metric), rows in sorted(series.items()):
            axes[1].plot([a for a, _ in rows], [v for _, v in rows],
                         label=f"{label}:#{net_i}:{metric}")
    axes[0].set_xlabel("iteration")
    axes[0].set_ylabel("train loss")
    axes[0].legend(fontsize=7)
    axes[1].set_xlabel("iteration")
    axes[1].set_ylabel("test metric")
    if axes[1].lines:
        axes[1].legend(fontsize=7)
    fig.tight_layout()
    fig.savefig(args.output, dpi=120)
    print(f"wrote {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
