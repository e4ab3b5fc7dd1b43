"""Deprecated shim (reference tools/net_speed_benchmark.cpp:3-8 — an
equally-thin LOG(FATAL) redirect): use the caffe CLI subcommand instead."""

import sys


def main(argv=None) -> int:
    print("net_speed_benchmark is deprecated. Use: python -m "
          "caffe_mpi_tpu_torch.tools.cli time ...", file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main())
