"""Binary protobuf I/O — the .caffemodel reader, without protoc.

Own copy of the wire-format reader in the JAX package's
caffe_mpi_tpu/io.py (the port imports nothing of that package). The
reference serializes weights as a binary NetParameter holding per-layer
BlobProtos (net.cpp ToProto/CopyTrainedLayersFrom, blob.cpp ToProto); this
module reads that wire format directly over the field numbers pinned in the
reference schema (src/caffe/proto/caffe.proto):

  NetParameter: name=1, layer=100 (LayerParameter), layers=2 (V1, read-only)
  LayerParameter: name=1, type=2, blobs=7
  V1LayerParameter: name=4, blobs=6
  BlobProto: shape=7 {dim=1 packed int64}, data=5 (packed float),
             double_data=8, raw_data_type=10, raw_data=12,
             legacy num/channels/height/width = 1..4

Reads BVLC & NVCaffe .caffemodel files (incl. fp16 raw_data, mapped to
f32). Only what `serve -weights` needs is here; writing arrives with
snapshots.
"""

from __future__ import annotations

import numpy as np


# -- wire primitives --------------------------------------------------------

def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _fields(buf: bytes):
    """Yield (field_number, wire_type, value_or_span) over a message."""
    pos, n = 0, len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            val, pos = _read_varint(buf, pos)
            yield field, wire, val
        elif wire == 2:
            size, pos = _read_varint(buf, pos)
            yield field, wire, buf[pos:pos + size]
            pos += size
        elif wire == 5:
            yield field, wire, buf[pos:pos + 4]
            pos += 4
        elif wire == 1:
            yield field, wire, buf[pos:pos + 8]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")


# -- BlobProto --------------------------------------------------------------

_TYPE_ENUM = {"DOUBLE": 0, "FLOAT": 1, "FLOAT16": 2, "INT": 3, "UINT": 4}
_ENUM_TYPE = {v: k for k, v in _TYPE_ENUM.items()}


def parse_blob(buf: bytes) -> np.ndarray:
    """BlobProto -> float32 ndarray with its declared shape."""
    shape: list[int] = []
    legacy = [0, 0, 0, 0]
    data: np.ndarray | None = None
    raw_type = None
    raw = None
    floats: list[np.ndarray] = []
    doubles: list[np.ndarray] = []
    for field, wire, val in _fields(buf):
        if field == 7 and wire == 2:  # shape
            for f2, w2, v2 in _fields(val):
                if f2 == 1 and w2 == 2:  # packed dims
                    pos = 0
                    while pos < len(v2):
                        d, pos = _read_varint(v2, pos)
                        shape.append(d)
                elif f2 == 1 and w2 == 0:
                    shape.append(v2)
        elif field == 5:
            if wire == 2:
                floats.append(np.frombuffer(val, "<f4"))
            else:
                floats.append(np.frombuffer(bytes(val), "<f4"))
        elif field == 8:
            if wire == 2:
                doubles.append(np.frombuffer(val, "<f8"))
        elif field == 10 and wire == 0:
            raw_type = _ENUM_TYPE.get(val)
        elif field == 12 and wire == 2:
            raw = val
        elif field in (1, 2, 3, 4) and wire == 0:
            legacy[field - 1] = val
    if not shape and any(legacy):
        shape = [d for d in legacy]
    if raw is not None:
        if raw_type == "FLOAT16":
            data = np.frombuffer(raw, "<f2").astype(np.float32)
        elif raw_type == "DOUBLE":
            data = np.frombuffer(raw, "<f8").astype(np.float32)
        else:
            data = np.frombuffer(raw, "<f4").copy()
    elif floats:
        data = np.concatenate(floats)
    elif doubles:
        data = np.concatenate(doubles).astype(np.float32)
    else:
        data = np.zeros(int(np.prod(shape)) if shape else 0, np.float32)
    return data.reshape(shape) if shape else data


# -- NetParameter weights (.caffemodel) -------------------------------------

def parse_caffemodel(buf: bytes) -> dict[str, list[np.ndarray]]:
    """binary NetParameter -> {layer_name: [blob arrays]} in file order.

    Reads both modern `layer` (field 100) and V1 `layers` (field 2;
    name=4, blobs=6 per V1LayerParameter in the reference schema)."""
    out: dict[str, list[np.ndarray]] = {}
    for field, wire, val in _fields(buf):
        if field == 100 and wire == 2:  # LayerParameter
            name, blobs = "", []
            for f2, w2, v2 in _fields(val):
                if f2 == 1 and w2 == 2:
                    name = v2.decode("utf-8")
                elif f2 == 7 and w2 == 2:
                    blobs.append(parse_blob(v2))
            if blobs:
                out[name] = blobs
        elif field == 2 and wire == 2:  # V1LayerParameter
            name, blobs = "", []
            for f2, w2, v2 in _fields(val):
                if f2 == 4 and w2 == 2:
                    name = v2.decode("utf-8")
                elif f2 == 6 and w2 == 2:
                    blobs.append(parse_blob(v2))
                elif f2 == 1 and w2 == 2:
                    # nested V0LayerParameter (caffe.proto:1473): name=1,
                    # blobs=50 — V0-era .caffemodel files store weights here
                    for f3, w3, v3 in _fields(v2):
                        if f3 == 1 and w3 == 2:
                            name = v3.decode("utf-8")
                        elif f3 == 50 and w3 == 2:
                            blobs.append(parse_blob(v3))
            if blobs:
                out[name] = blobs
    return out


def load_caffemodel(path: str) -> dict[str, list[np.ndarray]]:
    with open(path, "rb") as f:
        return parse_caffemodel(f.read())


def load_weights(path: str) -> dict[str, list[np.ndarray]]:
    """Dispatch on extension (reference CopyTrainedLayersFrom,
    net.cpp:1119-1126)."""
    if path.endswith((".h5", ".hdf5")):
        raise ValueError(f"{path}: HDF5 weights are not ported yet; give a "
                         "binary .caffemodel")
    return load_caffemodel(path)
