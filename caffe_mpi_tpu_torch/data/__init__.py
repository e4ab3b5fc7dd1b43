"""The data plane: LMDB records, Datum codec, host transform, feeders.

Own copies of the JAX package's caffe_mpi_tpu/data/ modules (lmdb_io,
datasets, decode, transformer, device_transform, feeder), numpy on the
host; `feeder.DeviceFeed` uploads each batch to the card.
"""

from .datasets import (LMDBDataset, SyntheticDataset, encode_datum,
                       open_dataset, parse_datum)
from .feeder import DeviceFeed, Feeder, feeder_from_layer
from .transformer import DataTransformer

__all__ = ["DataTransformer", "DeviceFeed", "Feeder", "LMDBDataset",
           "SyntheticDataset", "encode_datum", "feeder_from_layer",
           "open_dataset", "parse_datum"]
