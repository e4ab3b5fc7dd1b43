"""Analytic FLOPs, and the card rates that MFU and the kernel bounds use.

Own copy of the JAX package's MAC model (caffe_mpi_tpu/proto/netshape.py
`macs_per_image`, and caffe_mpi_tpu/utils/flops.py `layer_macs_per_image`,
`net_macs_per_image`, `train_flops_per_image`). The count is *model*
FLOPs: convolution and product MACs only (elementwise, pooling and norm
layers are memory-bound noise beside them); the backward costs twice the
forward (one product each for the input gradient and the weight gradient).

MFU is the achieved FLOP/s over the card's dense peak for the precision
the products run at (`mfu_peak`): TF32 for float32 nets that allow it
(half the bf16 tensor-core rate), the CUDA cores' f32 rate for nets whose
math is FLOAT (TF32 off), bf16 for FLOAT16 nets. CARD_RATES is the one
table of card rates in the repo: chip_smoke.py's kernel bounds read it
too.
"""

from __future__ import annotations

import math

# (name substring, memory bytes/s, float32 flop/s outside the tensor cores,
# dense bf16 tensor-core flop/s with f32 accumulation), NVIDIA data sheets;
# the first match against the device name wins. Dense TF32 is half the
# bf16 rate.
CARD_RATES = (
    ("H100 NVL", 3.9e12, 60e12, 835e12),
    ("H100 PCIe", 2.0e12, 51e12, 756e12),
    ("H200", 4.8e12, 67e12, 989e12),
    ("H100", 3.35e12, 67e12, 989e12),  # SXM5, "NVIDIA H100 80GB HBM3"
)


def card_rates(name: str) -> tuple[float, float, float] | None:
    """(bytes/s, f32 flop/s, bf16 flop/s) of the card called `name` (as
    torch.cuda.get_device_name gives it), or None for an unknown card."""
    for key, *rates in CARD_RATES:
        if key in name:
            return tuple(rates)
    return None


def mfu_peak(name: str, precision: str, forward_bf16: bool = False
             ) -> tuple[float, str] | None:
    """(peak flop/s, the rate's name) for MFU on card `name`: bf16 for a
    bf16 net, TF32 for a float32 net whose math allows it (`precision`
    "default"), the CUDA cores' f32 for one whose math is FLOAT
    ("highest"). None for an unknown card."""
    rates = card_rates(name)
    if rates is None:
        return None
    _, f32, bf16 = rates
    if forward_bf16:
        return bf16, "dense bf16"
    if precision == "highest":
        return f32, "f32 (TF32 off)"
    return bf16 / 2, "dense TF32"


def _prod(shape):
    if shape is None or any(d is None for d in shape):
        return None
    return math.prod(shape)


def _known(*vals) -> bool:
    return all(v is not None for v in vals)


def macs_per_image(type_name: str, in_shapes: list, out_shapes: list,
                   param_shapes: dict, lp=None) -> int | None:
    """Multiply-accumulates per image or sample for one layer; 0 for
    layers without products, None when a needed dim is unknown."""
    if type_name == "Convolution":
        if not out_shapes or out_shapes[0] is None or len(out_shapes[0]) != 4:
            return None
        _, _, oh, ow = out_shapes[0]
        w = _prod(param_shapes.get("weight", (None,)))
        return None if not _known(w, oh, ow) else w * oh * ow
    if type_name == "Deconvolution":
        if not in_shapes or in_shapes[0] is None or len(in_shapes[0]) != 4:
            return None
        _, _, ih, iw = in_shapes[0]
        w = _prod(param_shapes.get("weight", (None,)))
        return None if not _known(w, ih, iw) else w * ih * iw
    if type_name == "InnerProduct":
        out = out_shapes[0] if out_shapes else None
        if out is None:
            return None
        positions = _prod(out[1:-1]) if len(out) > 2 else 1
        w = _prod(param_shapes.get("weight", (None,)))
        return None if not _known(w, positions) else w * positions
    if type_name == "Attention":
        s0 = in_shapes[0] if in_shapes else None
        if s0 is None or len(s0) != 3 or not _known(*s0[1:]):
            return None
        _, s, c = s0
        return 4 * s * c * c + 2 * s * s * c
    if type_name == "MoE":
        s0 = in_shapes[0] if in_shapes else None
        w1 = param_shapes.get("w1")
        if s0 is None or w1 is None or not _known(*w1):
            return None
        tokens = _prod(s0[1:-1]) if len(s0) > 2 else 1
        c = s0[-1]
        e, _, h = w1
        k = max(getattr(getattr(lp, "moe_param", None), "top_k", 1), 1) \
            if lp is not None else 1
        return None if not _known(tokens, c) \
            else tokens * (c * e + k * 2 * c * h)
    return 0


def layer_macs_per_image(layer) -> int:
    """MACs per image of one built layer of the port."""
    macs = macs_per_image(
        layer.type_name, layer.in_shapes, layer.out_shapes,
        {name: tuple(decl.shape) for name, decl in layer.decls.items()},
        layer.lp)
    return int(macs or 0)


def net_macs_per_image(net) -> int:
    return sum(layer_macs_per_image(l) for l in net.layers)


def train_flops_per_image(net) -> int:
    """Forward (2 FLOPs a MAC) + backward (twice the forward)."""
    return 6 * net_macs_per_image(net)
