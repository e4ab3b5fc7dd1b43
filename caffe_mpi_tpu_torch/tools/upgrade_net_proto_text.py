"""upgrade_net_proto_text — explicit legacy migration of a net (or, with
-solver, a solver) prototxt (reference tools/upgrade_net_proto_text.cpp
and friends; the port also migrates automatically on every load, through
proto/upgrade.py).

Usage:
    python -m caffe_mpi_tpu_torch.tools.upgrade_net_proto_text IN.prototxt OUT.prototxt
    python -m caffe_mpi_tpu_torch.tools.upgrade_net_proto_text -solver IN OUT
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="upgrade_net_proto_text")
    p.add_argument("-solver", "--solver", action="store_true",
                   help="treat input as a SolverParameter")
    p.add_argument("input")
    p.add_argument("output")
    args = p.parse_args(argv)

    from ..proto import (NetParameter, SolverParameter, normalize_net,
                         solver_type)

    if args.solver:
        sp = SolverParameter.from_file(args.input)
        if sp.has("solver_type"):
            sp.type = solver_type(sp)
            sp.solver_type = ""
            sp._node.fields.pop("solver_type", None)  # clear presence
        if sp.net_param is not None:
            normalize_net(sp.net_param)
        out = sp.to_prototxt()
    else:
        net = normalize_net(NetParameter.from_file(args.input))
        out = net.to_prototxt()
    with open(args.output, "w") as f:
        f.write(out + "\n")
    print(f"upgraded {args.input} -> {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
