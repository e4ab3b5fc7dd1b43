"""Utilities of the port: the MAC model and the card-rate table (the JAX
package's caffe_mpi_tpu/utils/__init__.py)."""
