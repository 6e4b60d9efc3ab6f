"""Minimal ONNX reader (pure Python, no `onnx` dependency); the port's
copy of `hilcodec_tpu/utils/onnx_reader.py`.

The reference deployment ships per-stage RVQ graphs
(`onnx/hil_*_vq{i}.onnx`, `hil_*_deq{i}.onnx`) whose initializers embed the
trained codebook matrices. This module implements just enough of the
protobuf wire format to walk ModelProto -> GraphProto and decode
initializer TensorProtos, so the trained codebooks can serve as golden
vectors for RVQ parity tests.
"""

from __future__ import annotations

import os
import struct
from typing import Any, Dict, Iterator, List, Tuple

import numpy as np

# protobuf wire types
_VARINT, _I64, _LEN, _I32 = 0, 1, 2, 5

# ONNX TensorProto.DataType -> numpy dtype
_ONNX_DTYPES = {
    1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16, 5: np.int16,
    6: np.int32, 7: np.int64, 9: np.bool_, 10: np.float16, 11: np.float64,
    12: np.uint32, 13: np.uint64,
}


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7


def _fields(buf: bytes) -> Iterator[Tuple[int, int, Any]]:
    """Iterate (field_number, wire_type, value) over a protobuf message."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == _VARINT:
            val, pos = _read_varint(buf, pos)
        elif wire == _I64:
            val = buf[pos:pos + 8]
            pos += 8
        elif wire == _LEN:
            length, pos = _read_varint(buf, pos)
            val = buf[pos:pos + length]
            pos += length
        elif wire == _I32:
            val = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def _parse_tensor(buf: bytes) -> Tuple[str, np.ndarray]:
    dims: List[int] = []
    dtype_code = 1
    name = ""
    raw = b""
    float_data: List[float] = []
    int32_data: List[int] = []
    int64_data: List[int] = []
    for field, wire, val in _fields(buf):
        if field == 1:          # dims (repeated int64)
            if wire == _VARINT:
                dims.append(val)
            else:               # packed
                pos = 0
                while pos < len(val):
                    v, pos = _read_varint(val, pos)
                    dims.append(v)
        elif field == 2:        # data_type
            dtype_code = val
        elif field == 4:        # float_data
            if wire == _LEN:    # packed
                float_data.extend(struct.unpack(f"<{len(val)//4}f", val))
            else:
                float_data.append(struct.unpack("<f", val)[0])
        elif field == 5:        # int32_data
            if wire == _LEN:
                pos = 0
                while pos < len(val):
                    v, pos = _read_varint(val, pos)
                    int32_data.append(v)
            else:
                int32_data.append(val)
        elif field == 7:        # int64_data
            if wire == _LEN:
                pos = 0
                while pos < len(val):
                    v, pos = _read_varint(val, pos)
                    int64_data.append(v)
            else:
                int64_data.append(val)
        elif field == 8:        # name
            name = val.decode("utf-8")
        elif field == 9:        # raw_data
            raw = val
    dtype = _ONNX_DTYPES.get(dtype_code, np.float32)
    if raw:
        arr = np.frombuffer(raw, dtype=dtype)
    elif float_data:
        arr = np.asarray(float_data, dtype=dtype)
    elif int64_data:
        arr = np.asarray(int64_data, dtype=dtype)
    elif int32_data:
        arr = np.asarray(int32_data, dtype=dtype)
    else:
        arr = np.zeros(0, dtype=dtype)
    if dims:
        arr = arr.reshape(dims)
    return name, arr


def _parse_node(buf: bytes) -> Dict[str, Any]:
    node: Dict[str, Any] = {"input": [], "output": [], "op_type": "",
                            "name": ""}
    for field, _wire, val in _fields(buf):
        if field == 1:
            node["input"].append(val.decode("utf-8"))
        elif field == 2:
            node["output"].append(val.decode("utf-8"))
        elif field == 3:
            node["name"] = val.decode("utf-8")
        elif field == 4:
            node["op_type"] = val.decode("utf-8")
    return node


def read_onnx_graph(path: str) -> Dict[str, Any]:
    """Parse an .onnx file; return {'initializers': {name: ndarray},
    'nodes': [...], 'graph_name': str}."""
    with open(path, "rb") as f:
        model = f.read()
    graph_buf = None
    for field, _wire, val in _fields(model):
        if field == 7:          # ModelProto.graph
            graph_buf = val
    if graph_buf is None:
        raise ValueError(f"no GraphProto found in {path}")
    initializers: Dict[str, np.ndarray] = {}
    nodes: List[Dict[str, Any]] = []
    graph_name = ""
    for field, _wire, val in _fields(graph_buf):
        if field == 5:          # initializer
            name, arr = _parse_tensor(val)
            initializers[name] = arr
        elif field == 1:        # node
            nodes.append(_parse_node(val))
        elif field == 2:        # name
            graph_name = val.decode("utf-8")
    return {"initializers": initializers, "nodes": nodes,
            "graph_name": graph_name}


def load_reference_codebooks(onnx_dir: str, prefix: str,
                             num_quantizers: int) -> np.ndarray:
    """Stack the trained `embed` matrices out of `{prefix}_vq{i}.onnx`.

    Returns float32 [num_quantizers, codebook_size, dim]. The vq graphs hold
    the codebook as their largest float32 initializer (the ONNX export of
    streaming.py:46 `embed`).
    """
    books = []
    for i in range(num_quantizers):
        path = os.path.join(onnx_dir, f"{prefix}_vq{i}.onnx")
        graph = read_onnx_graph(path)
        candidates = [a for a in graph["initializers"].values()
                      if a.dtype == np.float32 and a.ndim == 2]
        if not candidates:
            raise ValueError(f"no 2-D float32 initializer in {path}")
        books.append(max(candidates, key=lambda a: a.size))
    return np.stack(books).astype(np.float32)
