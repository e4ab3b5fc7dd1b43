"""device_query — the properties of every card, from
torch.cuda.get_device_properties.

Reference: tools/device_query.cpp (and `caffe device_query`); the JAX
package's `cli.cmd_device_query` lists the jax devices. Without a card it
raises, as every entry point of the port does.

    python -m caffe_mpi_tpu_torch.tools.device_query
"""

from __future__ import annotations

import sys


def query() -> list[dict]:
    """One dict a card: its name, compute capability, multiprocessors,
    memory, and the data-sheet rates of utils/flops.py CARD_RATES."""
    import torch

    from ..core.device import resolve_device
    from ..utils.flops import card_rates
    resolve_device("cuda")  # raises without a card
    out = []
    for i in range(torch.cuda.device_count()):
        p = torch.cuda.get_device_properties(i)
        rates = card_rates(p.name)
        out.append({
            "index": i, "name": p.name,
            "capability": f"{p.major}.{p.minor}",
            "multiprocessors": p.multi_processor_count,
            "total_memory_GiB": p.total_memory / 2**30,
            "allocated_MiB": torch.cuda.memory_allocated(i) / 2**20,
            "rates": None if rates is None else {
                "memory_bytes_per_s": rates[0], "f32_flops": rates[1],
                "bf16_dense_flops": rates[2]},
        })
    return out


def print_devices(devices: list[dict]) -> None:
    for d in devices:
        print(f"device {d['index']}: {d['name']} sm_{d['capability']} "
              f"{d['multiprocessors']} SMs, "
              f"{d['total_memory_GiB']:.1f} GiB "
              f"({d['allocated_MiB']:.1f} MiB allocated)")
        if d["rates"]:
            r = d["rates"]
            print(f"  data sheet: {r['memory_bytes_per_s'] / 1e12:.2f} TB/s, "
                  f"f32 {r['f32_flops'] / 1e12:.0f} TFLOP/s, dense bf16 "
                  f"{r['bf16_dense_flops'] / 1e12:.0f} TFLOP/s")


def main(argv=None) -> int:
    print_devices(query())
    return 0


if __name__ == "__main__":
    sys.exit(main())
