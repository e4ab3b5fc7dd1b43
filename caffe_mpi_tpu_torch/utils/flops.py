"""Analytic FLOPs, and the card rates that MFU and the kernel bounds use.

The count is *model* FLOPs: convolution and product MACs only
(elementwise, pooling and norm layers are memory-bound noise beside
them); the backward costs twice the forward (one product each for the
input gradient and the weight gradient). The per-type MAC formulas live
in proto/netshape.py (`macs_per_image`), the one MAC model that the
torch-free summarize, netlint and serving plan read too; this module
adapts built layers onto it (as the JAX package's utils/flops.py does).

MFU is the achieved FLOP/s over the card's dense peak for the precision
the products run at (`mfu_peak`): TF32 for float32 nets that allow it
(half the bf16 tensor-core rate), the CUDA cores' f32 rate for nets whose
math is FLOAT (TF32 off), bf16 for FLOAT16 nets. CARD_RATES is the one
table of card rates in the repo: chip_smoke.py's kernel bounds read it
too.
"""

from __future__ import annotations

# (name substring, memory bytes/s, float32 flop/s outside the tensor cores,
# dense bf16 tensor-core flop/s with f32 accumulation, device memory in MiB
# as `nvidia-smi --query-gpu=name,memory.total` reports it), NVIDIA data
# sheets; the first match against the device name wins. Dense TF32 is half
# the bf16 rate.
CARD_RATES = (
    ("H100 NVL", 3.9e12, 60e12, 835e12, 95830),
    ("H100 PCIe", 2.0e12, 51e12, 756e12, 81559),
    ("H200", 4.8e12, 67e12, 989e12, 143771),
    ("H100", 3.35e12, 67e12, 989e12, 81559),  # SXM5, "NVIDIA H100 80GB HBM3"
)


def _card(name: str) -> tuple | None:
    for row in CARD_RATES:
        if row[0] in name:
            return row
    return None


def card_rates(name: str) -> tuple[float, float, float] | None:
    """(bytes/s, f32 flop/s, bf16 flop/s) of the card called `name` (as
    torch.cuda.get_device_name gives it), or None for an unknown card."""
    row = _card(name)
    return None if row is None else tuple(row[1:4])


def card_memory_mb(name: str) -> int | None:
    """Device memory in MiB of the card called `name`, or None for an
    unknown card."""
    row = _card(name)
    return None if row is None else row[4]


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


def layer_macs_per_image(layer) -> int:
    """MACs per image of one built layer of the port (0 for a layer
    without products). Delegates to the static engine's MAC model, so
    `cli time`'s MFU and the prototxt-level analysis cannot drift."""
    from ..proto.netshape import macs_per_image
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
