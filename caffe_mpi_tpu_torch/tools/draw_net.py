"""draw_net — render a net definition to DOT/PNG (reference
python/draw_net.py). A .dot or .gv output is DOT text; any other
extension renders through graphviz's `dot`, where it is installed.

Usage:
    python -m caffe_mpi_tpu_torch.tools.draw_net NET.prototxt OUT.{dot,png,svg}
        [--rankdir LR] [--phase TRAIN|TEST]
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="draw_net")
    p.add_argument("net")
    p.add_argument("output")
    p.add_argument("--rankdir", default="TB")
    p.add_argument("--phase", default=None)
    args = p.parse_args(argv)

    from ..draw import draw_net_to_file
    from ..proto import NetParameter

    draw_net_to_file(NetParameter.from_file(args.net), args.output,
                     rankdir=args.rankdir, phase=args.phase)
    print(f"drew {args.net} -> {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
