"""Deprecated shim (reference tools/finetune_net.cpp:3-8 — an equally-thin
LOG(FATAL) redirect): use the caffe CLI subcommand instead."""

import sys


def main(argv=None) -> int:
    print("finetune_net is deprecated. Use: python -m "
          "caffe_mpi_tpu_torch.tools.cli train -weights ...", file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main())
