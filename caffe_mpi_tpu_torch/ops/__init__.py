"""The port's ops. `launch_counters` lists the entry points of the CUDA
kernels that port the JAX package's Pallas kernels
(caffe_mpi_tpu/ops/lrn.py, caffe_mpi_tpu/ops/flash_attention.py), each
with its `.launches` count."""


def launch_counters() -> tuple:
    """Every kernel entry point that counts its launches: LRN forward (K1)
    and backward (K2), flash forward (K3), dQ (K4) and dK/dV (K5)."""
    from .flash_attention import flash_bwd_dkv, flash_bwd_dq, flash_fwd
    from .lrn import lrn_across_channels, lrn_across_channels_bwd
    return (lrn_across_channels, lrn_across_channels_bwd, flash_fwd,
            flash_bwd_dq, flash_bwd_dkv)


def launch_counts() -> dict[str, int]:
    """The launch counts of K1-K5, by ID."""
    return dict(zip(("K1", "K2", "K3", "K4", "K5"),
                    (c.launches for c in launch_counters())))
