"""upgrade_net_proto_binary — rewrite a legacy binary NetParameter
(.caffemodel) with modern `layer` (field 100) messages.

Reference: tools/upgrade_net_proto_binary.cpp — reads a binary
NetParameter, runs the V0->V1->V2 upgrade chain, and writes binary back
out. Here the wire-level parser (io.parse_caffemodel) already folds the
V0 (nested V0LayerParameter) and V1 (`layers` field 2) encodings into
the canonical {layer_name: blobs} form, so upgrading is parse +
re-encode. Only the weight-bearing payload matters for a .caffemodel:
the port never reads architecture from the binary (that comes from the
deploy prototxt), matching how the migrated file is consumed.

Usage:
    python -m caffe_mpi_tpu_torch.tools.upgrade_net_proto_binary IN.caffemodel OUT.caffemodel
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="upgrade_net_proto_binary")
    p.add_argument("input")
    p.add_argument("output")
    args = p.parse_args(argv)

    from ..io import load_caffemodel, save_caffemodel

    weights = load_caffemodel(args.input)
    if not weights:
        print(f"no layers with blobs found in {args.input}",
              file=sys.stderr)
        return 1
    save_caffemodel(args.output, weights)
    n = sum(len(b) for b in weights.values())
    print(f"upgraded {args.input} -> {args.output} "
          f"({len(weights)} layers, {n} blobs)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
