"""The port's ops. `launch_counters` lists the entry points of the CUDA
kernels, each with its `.launches` count."""


def launch_counters() -> tuple:
    """Every kernel entry point that counts its launches: LRN forward (K1)
    and backward (K2), flash forward (K3), dQ (K4) and dK/dV (K5)."""
    from .flash_attention import flash_bwd_dkv, flash_bwd_dq, flash_fwd
    from .lrn import lrn_across_channels, lrn_across_channels_bwd
    return (lrn_across_channels, lrn_across_channels_bwd, flash_fwd,
            flash_bwd_dq, flash_bwd_dkv)
