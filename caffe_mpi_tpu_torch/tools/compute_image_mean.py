"""compute_image_mean — a dataset's mean image as a BlobProto binaryproto.

Own copy of the JAX package's caffe_mpi_tpu/tools/compute_image_mean.py,
over the port's readers and `io.save_blob_binaryproto`. Reference:
tools/compute_image_mean.cpp (averages every record; the file is what
transform_param.mean_file reads).

Usage:
    python -m caffe_mpi_tpu_torch.tools.compute_image_mean \
        [-backend lmdb|datumfile] INPUT_DB OUTPUT_FILE
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def compute_mean(ds) -> np.ndarray:
    """The float64 sum of every record over their count, as float32."""
    total = None
    n = len(ds)
    for i in range(n):
        img, _ = ds.get(i)
        img = np.asarray(img, np.float64)
        total = img if total is None else total + img
    return (total / n).astype(np.float32)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="compute_image_mean")
    p.add_argument("-backend", "--backend", default="lmdb",
                   choices=["lmdb", "datumfile"])
    p.add_argument("input_db")
    p.add_argument("output_file", nargs="?", default="mean.binaryproto")
    args = p.parse_args(argv)

    from ..data.datasets import open_dataset
    from ..io import save_blob_binaryproto

    ds = open_dataset(args.backend, args.input_db)
    mean = compute_mean(ds)
    save_blob_binaryproto(args.output_file, mean[None])  # 4D like reference
    print(f"Wrote mean of {len(ds)} images to {args.output_file}; "
          f"channel means: {mean.mean(axis=(1, 2))}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
