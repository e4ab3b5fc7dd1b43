"""summarize — tabular net structure listing from a prototxt.

Reference: tools/extra/summarize.py (a concise per-layer table to check at
a glance that the specified computation is the expected one). The port's
copy of the JAX package's `caffe_mpi_tpu/tools/summarize.py`: the table
comes from the torch-free static shape engine (proto/netshape.py — the
records netlint and the serving plan read, held equal to the built net
for the whole zoo), so summarize runs without torch, without a card and
without datasets: dims a Data layer would learn from its DB print as '?'.
It exits 1 when the engine finds problems.

Usage:
    python -m caffe_mpi_tpu_torch.tools.summarize NET.prototxt [-phase TRAIN|TEST]
"""

from __future__ import annotations

import argparse
import sys


def _fmt_bytes(n) -> str:
    return "-" if not n else f"{n / 2**20:.1f}"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="summarize")
    p.add_argument("model")
    p.add_argument("-phase", "--phase", default="TRAIN",
                   choices=["TRAIN", "TEST"])
    args = p.parse_args(argv)

    from ..proto import NetParameter
    from ..proto.netshape import _fmt, analyze_net, layer_footprint

    analysis = analyze_net(NetParameter.from_file(args.model),
                           phase=args.phase)
    total_params = 0
    total_macs = 0
    total_fwd = 0
    total_bwd = 0
    print(f"{'layer':<28}{'type':<18}{'top shape':<22}"
          f"{'params':>12}{'MMACs/img':>12}{'fwd MiB':>10}{'bwd MiB':>10}")
    for info in analysis.layers:
        shape = _fmt(info.out_shapes[0]) if info.out_shapes else "-"
        fp = layer_footprint(info)
        n_params = fp["param_count"] or 0
        macs = fp["macs"]
        total_params += n_params
        total_macs += macs or 0
        total_fwd += fp["fwd_bytes"] or 0
        total_bwd += fp["bwd_bytes"] or 0
        print(f"{info.name:<28}{info.type:<18}{shape:<22}"
              f"{n_params or '-':>12}"
              f"{f'{macs / 1e6:.1f}' if macs else '-':>12}"
              f"{_fmt_bytes(fp['fwd_bytes']):>10}"
              f"{_fmt_bytes(fp['bwd_bytes']):>10}")
    for prob in analysis.problems:
        print(f"!! {prob.layer}: [{prob.kind}] {prob.message}",
              file=sys.stderr)
    print(f"\n{len(analysis.layers)} layers | {total_params:,} params "
          f"({total_params * 4 / 2**20:.1f} MiB f32) | "
          f"{2 * total_macs / 1e9:.2f} GFLOPs/img forward | "
          f"{(total_fwd + total_bwd) / 2**20:.0f} MiB fwd+bwd "
          "traffic/batch")
    return 1 if analysis.problems else 0


if __name__ == "__main__":
    sys.exit(main())
