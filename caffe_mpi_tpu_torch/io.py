"""Binary protobuf I/O — .caffemodel and .solverstate, without protoc.

Own copy of the wire-format reader and writers in the JAX package's
caffe_mpi_tpu/io.py (the port imports nothing of that package). The
reference serializes weights as a binary NetParameter holding per-layer
BlobProtos (net.cpp ToProto/CopyTrainedLayersFrom, blob.cpp ToProto); this
module reads and writes that wire format directly over the field numbers
pinned in the reference schema (src/caffe/proto/caffe.proto):

  NetParameter: name=1, layer=100 (LayerParameter), layers=2 (V1, read-only)
  LayerParameter: name=1, type=2, blobs=7
  V1LayerParameter: name=4, blobs=6
  BlobProto: shape=7 {dim=1 packed int64}, data=5 (packed float),
             double_data=8, raw_data_type=10, raw_data=12,
             legacy num/channels/height/width = 1..4

  SolverState: iter=1 (varint), learned_net=2 (string), history=3
               (repeated BlobProto), current_step=4 (varint)

Reads BVLC & NVCaffe .caffemodel files (incl. fp16 raw_data, mapped to
f32), and writes .caffemodel, .binaryproto and .solverstate files the
reference and the JAX package read. Every file is written to a temporary
path beside it and moved into place with `os.replace`, so a reader never
sees half a file.
"""

from __future__ import annotations

import io
import os

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


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        if v < 0x80:
            out.append(v)
            return bytes(out)
        out.append((v & 0x7F) | 0x80)
        v >>= 7


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _write_atomic(path: str, data) -> None:
    """Write `data` (bytes, or a callable that writes to a file) to a
    temporary file and move it into place."""
    tmp = f"{path}.tmp{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            if callable(data):
                data(f)
            else:
                f.write(data)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


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


def _blob_parts(arr) -> tuple[bytes, np.ndarray]:
    """A BlobProto as (its bytes up to the data, the float32 data): the
    shape, then the packed data's tag and length. The data is written
    from the array itself, never copied into a message."""
    arr = np.asarray(arr)
    dims = b"".join(_varint(d) for d in arr.shape)
    shape_msg = _tag(1, 2) + _varint(len(dims)) + dims
    data = np.ascontiguousarray(arr, "<f4")
    return (_tag(7, 2) + _varint(len(shape_msg)) + shape_msg
            + _tag(5, 2) + _varint(data.nbytes)), data


def _write_blobs(f, field: int, blobs) -> None:
    """Each blob as a length-delimited field `field`, streamed."""
    for head, data in blobs:
        f.write(_tag(field, 2) + _varint(len(head) + data.nbytes) + head)
        if data.nbytes:
            f.write(memoryview(data.reshape(-1)).cast("B"))


def _blobs_size(field: int, blobs) -> int:
    n = 0
    for head, data in blobs:
        size = len(head) + data.nbytes
        n += len(_tag(field, 2)) + len(_varint(size)) + size
    return n


def encode_blob(arr: np.ndarray) -> bytes:
    """ndarray -> BlobProto: its shape, then packed float32 data."""
    head, data = _blob_parts(arr)
    return head + data.tobytes()


def load_blob_binaryproto(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return parse_blob(f.read())


def save_blob_binaryproto(path: str, arr: np.ndarray) -> None:
    _write_atomic(path, encode_blob(arr))


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


def write_caffemodel(f, weights: dict[str, list[np.ndarray]],
                     net_name: str = "", layer_types=None) -> None:
    """{layer: [blobs]} -> binary NetParameter (net.cpp ToProto) written
    to file `f`, each blob's data straight from its array (a snapshot of
    AlexNet writes 244 MB without a copy in a message)."""
    if net_name:
        nm = net_name.encode("utf-8")
        f.write(_tag(1, 2) + _varint(len(nm)) + nm)
    for lname, blobs in weights.items():
        nm = lname.encode("utf-8")
        head = _tag(1, 2) + _varint(len(nm)) + nm
        if layer_types and lname in layer_types:
            tp = layer_types[lname].encode("utf-8")
            head += _tag(2, 2) + _varint(len(tp)) + tp
        parts = [_blob_parts(b) for b in blobs]
        f.write(_tag(100, 2) + _varint(len(head) + _blobs_size(7, parts))
                + head)
        _write_blobs(f, 7, parts)


def encode_caffemodel(weights: dict[str, list[np.ndarray]],
                      net_name: str = "",
                      layer_types: dict[str, str] | None = None) -> bytes:
    """{layer: [blobs]} -> binary NetParameter (net.cpp ToProto)."""
    buf = io.BytesIO()
    write_caffemodel(buf, weights, net_name, layer_types)
    return buf.getvalue()


def save_caffemodel(path: str, weights: dict[str, list[np.ndarray]],
                    net_name: str = "", layer_types=None) -> None:
    _write_atomic(path, lambda f: write_caffemodel(f, weights, net_name,
                                                   layer_types))


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


# -- SolverState (.solverstate) ---------------------------------------------
# History blobs are the optimizer slots of the learnable params in net
# order, slot-major: history[i + s*N] = slot s of param i (Adam/AdaDelta
# append the second bank after the first; sgd_solver.cpp PreSolve +
# adam_solver.cpp:37-39).

def write_solverstate(f, it: int, learned_net: str,
                      history: list[np.ndarray],
                      current_step: int = 0) -> None:
    """SolverState written to file `f`, each history blob's data straight
    from its array."""
    f.write(_tag(1, 0) + _varint(it))
    if learned_net:
        nm = learned_net.encode("utf-8")
        f.write(_tag(2, 2) + _varint(len(nm)) + nm)
    _write_blobs(f, 3, [_blob_parts(b) for b in history])
    if current_step:
        f.write(_tag(4, 0) + _varint(current_step))


def encode_solverstate(it: int, learned_net: str,
                       history: list[np.ndarray],
                       current_step: int = 0) -> bytes:
    buf = io.BytesIO()
    write_solverstate(buf, it, learned_net, history, current_step)
    return buf.getvalue()


def parse_solverstate(buf: bytes) -> tuple[int, str, list[np.ndarray], int]:
    it, learned_net, history, current_step = 0, "", [], 0
    for field, wire, val in _fields(buf):
        if field == 1 and wire == 0:
            it = int(val)
        elif field == 2 and wire == 2:
            learned_net = bytes(val).decode("utf-8")
        elif field == 3 and wire == 2:
            history.append(parse_blob(val))
        elif field == 4 and wire == 0:
            current_step = int(val)
    return it, learned_net, history, current_step


def save_solverstate(path: str, it: int, learned_net: str,
                     history: list[np.ndarray], current_step: int = 0) -> None:
    _write_atomic(path, lambda f: write_solverstate(
        f, it, learned_net, history, current_step))


def load_solverstate(path: str) -> tuple[int, str, list[np.ndarray], int]:
    with open(path, "rb") as f:
        return parse_solverstate(f.read())
