"""caffe_mpi_tpu_torch — the PyTorch/CUDA port of caffe_mpi_tpu.

The JAX package (`caffe_mpi_tpu/`) is the reference and stays as it is;
this package mirrors its layout (`proto/`, `core/`, `layers/`, `ops/`,
`net.py`, `io.py`, `caffe_io.py`, `pycaffe.py`, `serving/`,
`tools/cli.py`) so each counterpart is found by its path. It imports `torch`, never `jax`, and
nothing of `caffe_mpi_tpu`: what it needs of that package's jax-free
modules it keeps as its own copy.

Every TPU kernel on a ported path becomes a kernel written by hand for
Hopper (`csrc/`), built with nvcc at first use and bound through ctypes.
Entry points run on the card (`device="cuda"`) and raise without one;
the CPU runs only when the caller passes `device="cpu"`.

Importing the package makes the process's first call of MKL's vector
math on one thread (`_first_vml_calls`), before the CPU paths run. The
static tools (`proto/netshape.py`, `tools/summarize.py`, `tools/lint/`)
import no torch, and run where torch cannot be imported.
"""

try:
    import torch as _torch
except ImportError:  # the static tools alone: nothing here to initialise
    _torch = None


def _first_vml_calls() -> None:
    """PyTorch's CPU build runs `exp`, `log` and the other transcendental
    ops of a float tensor past 2,048 elements as OpenMP chunks, each a call
    of MKL's vector math (`vmsExp`, `vmsLn`, ... in libtorch_cpu), which
    picks its kernels through one process-wide CPU detection
    (`mkl_vml_serv_cpu_detect`) made at the first call. When several
    threads make that first call at once, one thread's chunk can come out
    with a relative error up to 1.5e-4, on a loaded machine; every later
    call is right (`mkl_first_call.py` shows it). One call of 8 elements,
    run on this thread, completes the detection before any chunked
    call."""
    _torch.exp(_torch.ones(8))


if _torch is not None:
    _first_vml_calls()
