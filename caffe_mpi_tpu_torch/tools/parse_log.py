"""parse_log — training-log to CSV.

Reference: tools/extra/parse_log.py parses glog training output into
aggregate train/test CSVs for plotting (plot_training_log.py). This parses
the port solver's log lines (solver/solver.py), the same lines the JAX
package's solver writes:

  2026-10-18 12:00:00,000 INFO Iteration 120 (9.8 iter/s, 620.0 img/s), loss = 0.034, lr = 0.01
  2026-10-18 12:00:01,000 INFO     Test net #0: accuracy = 0.99

Usage:
    python -m caffe_mpi_tpu_torch.tools.parse_log LOGFILE [OUTPUT_DIR]
"""

from __future__ import annotations

import argparse
import csv
import os
import re
import sys

TRAIN_RE = re.compile(
    r"Iteration (?P<iter>\d+) \((?P<ips>[\d.e+-]+) iter/s, "
    r"(?P<imgs>[\d.e+-]+) img/s\), loss = (?P<loss>[\d.e+-]+|nan|inf), "
    r"lr = (?P<lr>[\d.e+-]+)")
TEST_RE = re.compile(
    r"Test net #(?P<net>\d+): (?P<blob>\S+) = (?P<value>[\d.e+-]+)")


def parse(path: str):
    train_rows, test_rows = [], []
    last_iter = 0
    with open(path) as f:
        for line in f:
            m = TRAIN_RE.search(line)
            if m:
                last_iter = int(m["iter"])
                # lint: ok(host-sync) — a log line's text
                train_rows.append({
                    "NumIters": last_iter,
                    "LearningRate": float(m["lr"]),
                    "loss": float(m["loss"]),
                    "iter_per_s": float(m["ips"]),
                    "img_per_s": float(m["imgs"]),
                })
                continue
            m = TEST_RE.search(line)
            if m:
                # lint: ok(host-sync) — a log line's text
                test_rows.append({
                    "NumIters": last_iter,
                    "TestNet": int(m["net"]),
                    m["blob"]: float(m["value"]),
                })
    return train_rows, test_rows


def write_csv(rows, path):
    if not rows:
        return
    keys = sorted({k for r in rows for k in r})
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=keys)
        w.writeheader()
        w.writerows(rows)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="parse_log")
    p.add_argument("logfile")
    p.add_argument("output_dir", nargs="?", default=".")
    args = p.parse_args(argv)
    train, test = parse(args.logfile)
    base = os.path.basename(args.logfile)
    write_csv(train, os.path.join(args.output_dir, base + ".train"))
    write_csv(test, os.path.join(args.output_dir, base + ".test"))
    print(f"{len(train)} train rows, {len(test)} test rows")
    return 0


if __name__ == "__main__":
    sys.exit(main())
