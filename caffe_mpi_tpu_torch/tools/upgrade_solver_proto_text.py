"""upgrade_solver_proto_text — migrate a legacy SolverParameter prototxt
(reference tools/upgrade_solver_proto_text.cpp; thin over the same
machinery as upgrade_net_proto_text -solver, which the reference also
shares via upgrade_proto.cpp).

Usage:
    python -m caffe_mpi_tpu_torch.tools.upgrade_solver_proto_text IN.prototxt OUT.prototxt
"""

from __future__ import annotations

import sys

from .upgrade_net_proto_text import main as _net_main


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    return _net_main(["-solver", *argv])


if __name__ == "__main__":
    sys.exit(main())
