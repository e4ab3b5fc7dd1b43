"""CLI entry: `python -m caffe_mpi_tpu_torch.tools.lint` (see the
package docstring; the JAX package's caffe_mpi_tpu/tools/lint/__main__.py)."""

import sys

from . import main

if __name__ == "__main__":
    sys.exit(main())
