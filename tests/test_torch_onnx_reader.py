"""The port's ONNX reader (`hilcodec_tpu_torch/utils/onnx_reader.py`)
against the JAX package's, on ModelProto bytes written here by a small
protobuf writer: float initializers as raw_data, as packed float_data and
as unpacked float_data, int64 and int32 tensors, dims packed and unpacked,
and nodes with attributes the readers skip. The reference's own graphs
are not in the repository, so no test reads them."""

import struct

import numpy as np
import pytest

from hilcodec_tpu.utils import onnx_reader as jax_onnx

from hilcodec_tpu_torch.utils import onnx_reader as onnx


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b, n = n & 0x7F, n >> 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _len(field: int, payload: bytes) -> bytes:
    return _key(field, 2) + _varint(len(payload)) + payload


def _int(field: int, n: int) -> bytes:
    return _key(field, 0) + _varint(n)


def _str(field: int, s: str) -> bytes:
    return _len(field, s.encode())


def tensor(name: str, arr: np.ndarray, mode: str) -> bytes:
    """A TensorProto: dims packed (unpacked for "unpacked_floats"), the
    data as raw_data, packed float_data, unpacked float_data, packed
    int64_data or packed int32_data."""
    code = {np.float32: 1, np.int32: 6, np.int64: 7}[arr.dtype.type]
    if mode == "unpacked_floats":
        dims = b"".join(_int(1, d) for d in arr.shape)
    else:
        dims = _len(1, b"".join(_varint(d) for d in arr.shape))
    flat = arr.ravel()
    if mode == "raw":
        data = _len(9, arr.tobytes())
    elif mode == "floats":
        data = _len(4, struct.pack(f"<{flat.size}f", *flat))
    elif mode == "unpacked_floats":
        data = b"".join(_key(4, 5) + struct.pack("<f", v) for v in flat)
    elif mode == "int64":
        data = _len(7, b"".join(_varint(int(v)) for v in flat))
    else:
        data = _len(5, b"".join(_varint(int(v)) for v in flat))
    return dims + _int(2, code) + _str(8, name) + data


def node(name: str, op: str, inputs, outputs) -> bytes:
    """A NodeProto with a float, an int and a string attribute."""
    attrs = [_str(1, "alpha") + _key(2, 5) + struct.pack("<f", 0.5)
             + _int(20, 1),
             _str(1, "axis") + _int(3, 1) + _int(20, 2),
             _str(1, "mode") + _len(4, b"constant") + _int(20, 3)]
    return (b"".join(_str(1, i) for i in inputs)
            + b"".join(_str(2, o) for o in outputs)
            + _str(3, name) + _str(4, op)
            + b"".join(_len(5, a) for a in attrs))


def model(graph_name: str, inits, nodes) -> bytes:
    """A ModelProto: ir_version, a producer name, an opset import and the
    graph."""
    graph = (b"".join(_len(1, n) for n in nodes) + _str(2, graph_name)
             + b"".join(_len(5, t) for t in inits))
    return (_int(1, 8) + _str(2, "handwritten")
            + _len(8, _str(1, "") + _int(2, 13)) + _len(7, graph))


def _write(path, data: bytes) -> str:
    path.write_bytes(data)
    return str(path)


@pytest.fixture
def arrays():
    rng = np.random.default_rng(0)
    return {
        "embed": rng.standard_normal((32, 16)).astype(np.float32),
        "onnx::MatMul_42": rng.standard_normal((16, 32)).astype(np.float32),
        "bias": rng.standard_normal((5,)).astype(np.float32),
        "shape": np.array([1, 3, 4096], np.int64),
        "axes": np.array([0, 2], np.int32)}


def test_read_graph_matches_jax(tmp_path, arrays):
    """Every initializer kind, the nodes and the graph name: the port's
    reader gives what the JAX package's gives, and the written values."""
    inits = [tensor("embed", arrays["embed"], "raw"),
             tensor("onnx::MatMul_42", arrays["onnx::MatMul_42"], "floats"),
             tensor("bias", arrays["bias"], "unpacked_floats"),
             tensor("shape", arrays["shape"], "int64"),
             tensor("axes", arrays["axes"], "int32")]
    nodes = [node("mm", "MatMul", ["x", "onnx::MatMul_42"], ["y"]),
             node("argmin", "ArgMin", ["y"], ["idx"])]
    path = _write(tmp_path / "g.onnx", model("vq0", inits, nodes))
    ours, ref = onnx.read_onnx_graph(path), jax_onnx.read_onnx_graph(path)
    assert ours["graph_name"] == ref["graph_name"] == "vq0"
    assert ours["nodes"] == ref["nodes"]
    assert ours["nodes"][0] == {"input": ["x", "onnx::MatMul_42"],
                                "output": ["y"], "op_type": "MatMul",
                                "name": "mm"}
    assert list(ours["initializers"]) == list(ref["initializers"])
    for name, want in arrays.items():
        got = ours["initializers"][name]
        assert got.dtype == ref["initializers"][name].dtype == want.dtype
        np.testing.assert_array_equal(got, ref["initializers"][name])
        np.testing.assert_array_equal(got, want)


def test_no_graph_raises(tmp_path):
    path = _write(tmp_path / "empty.onnx", _int(1, 8))
    with pytest.raises(ValueError, match="no GraphProto"):
        onnx.read_onnx_graph(path)
    with pytest.raises(ValueError, match="no GraphProto"):
        jax_onnx.read_onnx_graph(path)


def test_reference_codebooks_naming(tmp_path):
    """`load_reference_codebooks` stacks the largest 2-D float32
    initializer of each `{prefix}_vq{i}.onnx`, as the JAX package's does."""
    rng = np.random.default_rng(1)
    books = rng.standard_normal((3, 32, 16)).astype(np.float32)
    for i in range(3):
        inits = [tensor("small", books[i][:4, :4].copy(), "floats"),
                 tensor("embed", books[i], "raw"),
                 tensor("shape", np.array([1, 16], np.int64), "int64")]
        _write(tmp_path / f"hil_speech_vq{i}.onnx",
               model(f"vq{i}", inits, [node("mm", "MatMul", ["x"], ["y"])]))
    ours = onnx.load_reference_codebooks(str(tmp_path), "hil_speech", 3)
    ref = jax_onnx.load_reference_codebooks(str(tmp_path), "hil_speech", 3)
    assert ours.dtype == np.float32 and ours.shape == (3, 32, 16)
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(ours, books)
    with pytest.raises(FileNotFoundError):
        onnx.load_reference_codebooks(str(tmp_path), "hil_speech", 4)
