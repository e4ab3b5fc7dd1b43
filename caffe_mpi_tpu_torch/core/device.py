# lint: ok(reference-citation) — port-only: the JAX package runs where
# jax places it, and the reference takes its device from `-gpu`
"""Device resolution for the port's entry points.

Entry points default to the card. Without one they raise: the port never
carries on quietly on the CPU. The CPU runs only when the caller asks
for it by name (`device="cpu"`), as the tests do.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r} "
                         "(expected 'cuda', 'cuda:N' or 'cpu')")
    return dev
