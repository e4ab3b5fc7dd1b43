"""convert_imageset — build a training DB from an image list.

Own copy of the JAX package's caffe_mpi_tpu/tools/convert_imageset.py,
over the port's writer (data/lmdb_io.py, with its crc sidecar) and Datum
codec. Reference: tools/convert_imageset.cpp: reads `path label` lines,
optionally resizes, writes raw Datum records to a DB with zero-padded
"%08d" keys, optionally shuffled (seed 1701).

Usage:
    python -m caffe_mpi_tpu_torch.tools.convert_imageset \
        [-resize_height H] [-resize_width W] [-shuffle] [-gray] \
        [-backend lmdb|datumfile] ROOTFOLDER LISTFILE DB_NAME
"""

from __future__ import annotations

import argparse
import os
import random
import sys

import numpy as np


def iter_datums(root: str, items, resize_hw, gray: bool):
    from PIL import Image

    from ..data.datasets import encode_datum

    for path, label in items:
        img = Image.open(os.path.join(root, path))
        img = img.convert("L" if gray else "RGB")
        if resize_hw[0] and resize_hw[1]:
            img = img.resize((resize_hw[1], resize_hw[0]), Image.BILINEAR)
        arr = np.asarray(img)
        if arr.ndim == 2:
            arr = arr[None]
        else:
            arr = arr[:, :, ::-1].transpose(2, 0, 1)  # RGB HWC -> BGR CHW
        yield encode_datum(arr, label)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="convert_imageset")
    p.add_argument("-resize_height", "--resize_height", type=int, default=0)
    p.add_argument("-resize_width", "--resize_width", type=int, default=0)
    p.add_argument("-shuffle", "--shuffle", action="store_true")
    p.add_argument("-gray", "--gray", action="store_true")
    p.add_argument("-backend", "--backend", default="lmdb",
                   choices=["lmdb", "datumfile"])
    p.add_argument("root")
    p.add_argument("listfile")
    p.add_argument("db_name")
    args = p.parse_args(argv)

    items = []
    with open(args.listfile) as f:
        for line in f:
            line = line.strip()
            if line:
                path, _, label = line.rpartition(" ")
                items.append((path, int(label)))
    if args.shuffle:
        random.Random(1701).shuffle(items)  # fixed seed like the reference

    gen = iter_datums(args.root, items,
                      (args.resize_height, args.resize_width), args.gray)
    if args.backend == "lmdb":
        from ..data.lmdb_io import write_lmdb
        # zero-padded index keys keep insertion order lexicographically
        write_lmdb(args.db_name,
                   ((f"{i:08d}".encode(), buf) for i, buf in enumerate(gen)))
        count = len(items)
    else:
        from ..data.datasets import DatumFileDataset
        count = DatumFileDataset.write(args.db_name, gen)
    print(f"Processed {count} files.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
