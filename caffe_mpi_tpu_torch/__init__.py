"""caffe_mpi_tpu_torch — the PyTorch/CUDA port of caffe_mpi_tpu.

The JAX package (`caffe_mpi_tpu/`) is the reference and stays as it is;
this package mirrors its layout (`proto/`, `core/`, `layers/`, `ops/`,
`net.py`, `io.py`, `caffe_io.py`, `serving/`, `tools/cli.py`) so each
counterpart is found by its path. It imports `torch`, never `jax`, and
nothing of `caffe_mpi_tpu`: what it needs of that package's jax-free
modules it keeps as its own copy.

Every TPU kernel on a ported path becomes a kernel written by hand for
Hopper (`csrc/`), built with nvcc at first use and bound through ctypes.
Entry points run on the card (`device="cuda"`) and raise without one;
the CPU runs only when the caller passes `device="cpu"`.
"""
