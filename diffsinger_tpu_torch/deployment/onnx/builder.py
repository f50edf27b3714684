"""ONNX model construction + parsing on top of the raw protobuf wire codec.

Implements the subset of onnx.proto needed to emit OpenUTAU-consumable
models (reference deployment/exporters emit ONNX via torch.onnx, which needs
the onnx package; here graphs are built directly):

  ModelProto{ir_version, opset_import, producer, graph}
  GraphProto{node, name, initializer, input, output, value_info}
  NodeProto{input, output, name, op_type, attribute}
  AttributeProto{name, type, f/i/s/t/g/floats/ints/strings}
  TensorProto{dims, data_type, raw_data, name}

Field numbers follow the public onnx.proto schema. `parse_model` decodes an
emitted model back into a light object tree (used by the numpy interpreter
and the round-trip tests, since onnx/onnxruntime are not installed).
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from . import protowire as pw

IR_VERSION = 8
OPSET_VERSION = 17

# TensorProto.DataType
DT_FLOAT, DT_UINT8, DT_INT8, DT_UINT16, DT_INT16, DT_INT32, DT_INT64 = 1, 2, 3, 4, 5, 6, 7
DT_STRING, DT_BOOL, DT_FLOAT16, DT_DOUBLE = 8, 9, 10, 11
DT_UINT32, DT_UINT64 = 12, 13

NP_TO_DT = {
    np.dtype(np.float32): DT_FLOAT,
    np.dtype(np.float64): DT_DOUBLE,
    np.dtype(np.float16): DT_FLOAT16,
    np.dtype(np.int64): DT_INT64,
    np.dtype(np.int32): DT_INT32,
    np.dtype(np.int16): DT_INT16,
    np.dtype(np.int8): DT_INT8,
    np.dtype(np.uint8): DT_UINT8,
    np.dtype(np.uint32): DT_UINT32,
    np.dtype(np.uint64): DT_UINT64,
    np.dtype(np.bool_): DT_BOOL,
}
DT_TO_NP = {v: k for k, v in NP_TO_DT.items()}

# AttributeProto.AttributeType
AT_FLOAT, AT_INT, AT_STRING, AT_TENSOR, AT_GRAPH = 1, 2, 3, 4, 5
AT_FLOATS, AT_INTS, AT_STRINGS = 6, 7, 8


# ------------------------------------------------------------------ encoding

def tensor_proto(name: str, array: np.ndarray) -> bytes:
    # np.ascontiguousarray makes a 0-d array 1-d: scalars keep their rank here
    array = np.ascontiguousarray(array) if np.ndim(array) else np.asarray(array)
    dt = NP_TO_DT[array.dtype]
    parts = [pw.packed_varints(1, array.shape) if array.ndim else b""]
    parts.append(pw.field_varint(2, dt))
    parts.append(pw.field_string(8, name))
    parts.append(pw.field_bytes(9, array.tobytes()))
    return b"".join(parts)


def _attribute(name: str, value: Any) -> bytes:
    parts = [pw.field_string(1, name)]
    if isinstance(value, bool):
        parts += [pw.field_varint(3, int(value)), pw.field_varint(20, AT_INT)]
    elif isinstance(value, int):
        parts += [pw.field_varint(3, value), pw.field_varint(20, AT_INT)]
    elif isinstance(value, float):
        parts += [pw.field_float(2, value), pw.field_varint(20, AT_FLOAT)]
    elif isinstance(value, str):
        parts += [pw.field_bytes(4, value.encode()), pw.field_varint(20, AT_STRING)]
    elif isinstance(value, np.ndarray):
        parts += [pw.field_bytes(5, tensor_proto(name, value)), pw.field_varint(20, AT_TENSOR)]
    elif isinstance(value, GraphBuilder):
        parts += [pw.field_bytes(6, value.graph_bytes()), pw.field_varint(20, AT_GRAPH)]
    elif isinstance(value, (list, tuple)):
        if all(isinstance(v, (int, np.integer)) for v in value):
            parts += [pw.packed_varints(8, value), pw.field_varint(20, AT_INTS)]
        elif all(isinstance(v, (float, np.floating, int)) for v in value):
            parts += [pw.packed_floats(7, value), pw.field_varint(20, AT_FLOATS)]
        elif all(isinstance(v, str) for v in value):
            parts += [b"".join(pw.field_bytes(9, v.encode()) for v in value),
                      pw.field_varint(20, AT_STRINGS)]
        else:  # pragma: no cover
            raise TypeError(f"attribute {name}: mixed list {value!r}")
    else:  # pragma: no cover
        raise TypeError(f"attribute {name}: unsupported {type(value)}")
    return b"".join(parts)


def node_proto(op_type: str, inputs: Sequence[str], outputs: Sequence[str],
               name: str = "", **attrs) -> bytes:
    parts = [pw.field_string(1, i) for i in inputs]
    parts += [pw.field_string(2, o) for o in outputs]
    if name:
        parts.append(pw.field_string(3, name))
    parts.append(pw.field_string(4, op_type))
    parts += [pw.field_bytes(5, _attribute(k, v)) for k, v in attrs.items()]
    return b"".join(parts)


def value_info(name: str, elem_type: int, shape: Sequence[Optional[int]]) -> bytes:
    dims = b""
    for d in shape:
        if d is None or isinstance(d, str):
            dim = pw.field_string(2, str(d) if d else "dyn")
        else:
            dim = pw.field_varint(1, int(d))
        dims += pw.field_bytes(1, dim)
    tensor_type = pw.field_varint(1, elem_type) + pw.field_bytes(2, dims)
    type_proto = pw.field_bytes(1, tensor_type)
    return pw.field_string(1, name) + pw.field_bytes(2, type_proto)


class GraphBuilder:
    """Accumulates nodes/initializers/io for one GraphProto."""

    def __init__(self, name: str, prefix: str = ""):
        self.name = name
        # Subgraphs (Loop/If bodies) get a unique `prefix` so their value
        # names cannot shadow outer-scope names — the ONNX IR spec requires
        # SSA across the whole lexical scope chain (onnx.checker rejects
        # subgraph names that redefine outer ones).
        self.prefix = prefix
        self.nodes: List[bytes] = []
        self.initializers: List[bytes] = []
        self.inputs: List[bytes] = []
        self.input_specs: List[tuple] = []  # (name, dtype, shape)
        self.outputs: List[bytes] = []
        self._counter = 0

    def fresh(self, hint: str = "t") -> str:
        self._counter += 1
        return f"{self.prefix}{hint}_{self._counter}"

    def add_node(self, op_type: str, inputs: Sequence[str], n_out: int = 1,
                 outputs: Optional[Sequence[str]] = None, **attrs) -> List[str]:
        if outputs is None:
            outputs = [self.fresh(op_type.lower()) for _ in range(n_out)]
        self.nodes.append(node_proto(op_type, inputs, outputs, **attrs))
        return list(outputs)

    def add_initializer(self, name: str, array: np.ndarray):
        self.initializers.append(tensor_proto(name, np.asarray(array)))

    def constant(self, array: np.ndarray, hint: str = "const") -> str:
        name = self.fresh(hint)
        self.add_initializer(name, array)
        return name

    def add_input(self, name: str, dtype: np.dtype, shape: Sequence[Optional[int]]):
        self.inputs.append(value_info(name, NP_TO_DT[np.dtype(dtype)], shape))
        self.input_specs.append((name, np.dtype(dtype), tuple(shape)))

    def internalize_noise(self, name: str):
        """Replace graph input `name` with an internal standard-normal source
        (ConstantOfShape -> RandomNormalLike), so the exported signature
        matches the reference's ONNX (noise drawn inside the graph)."""
        spec = next(s for s in self.input_specs if s[0] == name)
        idx = self.input_specs.index(spec)
        del self.inputs[idx]
        del self.input_specs[idx]
        _, dtype, shape = spec
        shape_c = self.fresh("noise_shape")
        self.add_initializer(shape_c, np.asarray(shape, np.int64))
        zeros = self.fresh("noise_zeros")
        prelude = [
            node_proto("ConstantOfShape", [shape_c], [zeros]),
            node_proto("RandomNormalLike", [zeros], [name]),
        ]
        self.nodes = prelude + self.nodes

    def internalize_constant(self, name: str, value):
        """Replace graph input `name` with a baked initializer — used to drop
        a traced-but-fixed scalar (e.g. `depth` on non-shallow acoustic
        models) so the public signature matches the reference's ONNX."""
        spec = next(s for s in self.input_specs if s[0] == name)
        idx = self.input_specs.index(spec)
        del self.inputs[idx]
        del self.input_specs[idx]
        self.add_initializer(name, np.asarray(value, spec[1]))

    def add_output(self, name: str, dtype: np.dtype, shape: Sequence[Optional[int]]):
        self.outputs.append(value_info(name, NP_TO_DT[np.dtype(dtype)], shape))

    def graph_bytes(self) -> bytes:
        parts = [pw.field_bytes(1, n) for n in self.nodes]
        parts.append(pw.field_string(2, self.name))
        parts += [pw.field_bytes(5, t) for t in self.initializers]
        parts += [pw.field_bytes(11, i) for i in self.inputs]
        parts += [pw.field_bytes(12, o) for o in self.outputs]
        return b"".join(parts)

    def model_bytes(self, producer: str = "diffsinger_tpu_torch",
                    opset: int = OPSET_VERSION, doc: str = "") -> bytes:
        opset_id = pw.field_string(1, "") + pw.field_varint(2, opset)
        parts = [
            pw.field_varint(1, IR_VERSION),
            pw.field_string(2, producer),
            pw.field_string(3, "1.0"),
            pw.field_bytes(7, self.graph_bytes()),
            pw.field_bytes(8, opset_id),
        ]
        if doc:
            parts.append(pw.field_string(6, doc))
        return b"".join(parts)


# ------------------------------------------------------------------ decoding

@dataclasses.dataclass
class Node:
    op_type: str
    inputs: List[str]
    outputs: List[str]
    attrs: Dict[str, Any]


@dataclasses.dataclass
class Graph:
    name: str
    nodes: List[Node]
    initializers: Dict[str, np.ndarray]
    inputs: List[str]
    outputs: List[str]
    input_types: Dict[str, tuple]  # name -> (np.dtype, shape tuple with None)


def _parse_tensor(buf: bytes) -> tuple:
    f = pw.decode_message(buf)
    dims: List[int] = []
    for v in f.get(1, []):
        if isinstance(v, bytes):  # packed
            pos = 0
            while pos < len(v):
                d, pos = pw.decode_varint(v, pos)
                dims.append(d)
        else:
            dims.append(v)
    dt = f[2][0]
    name = f.get(8, [b""])[0].decode()
    if 9 in f:
        arr = np.frombuffer(f[9][0], dtype=DT_TO_NP[dt]).reshape(dims)
    elif dt == DT_FLOAT and 4 in f:
        arr = np.array(struct.unpack(f"<{len(f[4])}f", b"".join(f[4])), np.float32).reshape(dims)
    else:  # pragma: no cover
        raise ValueError(f"tensor {name}: no raw_data")
    return name, arr


def _parse_attr(buf: bytes):
    f = pw.decode_message(buf)
    name = f[1][0].decode()
    at = f.get(20, [0])[0]
    if at == AT_INT:
        return name, f[3][0] if f[3][0] < (1 << 63) else f[3][0] - (1 << 64)
    if at == AT_FLOAT:
        return name, struct.unpack("<f", f[2][0])[0]
    if at == AT_STRING:
        return name, f[4][0].decode()
    if at == AT_TENSOR:
        return name, _parse_tensor(f[5][0])[1]
    if at == AT_GRAPH:
        return name, parse_graph(f[6][0])
    if at == AT_INTS:
        vals = []
        for v in f.get(8, []):
            if isinstance(v, bytes):
                pos = 0
                while pos < len(v):
                    d, pos = pw.decode_varint(v, pos)
                    vals.append(d if d < (1 << 63) else d - (1 << 64))
            else:
                vals.append(v)
        return name, vals
    if at == AT_FLOATS:
        raw = b"".join(f.get(7, []))
        return name, list(struct.unpack(f"<{len(raw) // 4}f", raw))
    if at == AT_STRINGS:
        return name, [v.decode() for v in f.get(9, [])]
    raise ValueError(f"attr {name}: unsupported type {at}")  # pragma: no cover


def _parse_value_info(buf: bytes):
    f = pw.decode_message(buf)
    name = f[1][0].decode()
    dtype, shape = None, ()
    if 2 in f:
        tp = pw.decode_message(f[2][0])
        if 1 in tp:
            tt = pw.decode_message(tp[1][0])
            elem = tt.get(1, [DT_FLOAT])[0]
            dtype = DT_TO_NP.get(elem)
            dims = []
            if 2 in tt:
                sh = pw.decode_message(tt[2][0])
                for d in sh.get(1, []):
                    dm = pw.decode_message(d)
                    dims.append(dm[1][0] if 1 in dm else None)
            shape = tuple(dims)
    return name, dtype, shape


def parse_graph(buf: bytes) -> Graph:
    f = pw.decode_message(buf)
    nodes = []
    for nb in f.get(1, []):
        nf = pw.decode_message(nb)
        nodes.append(Node(
            op_type=nf[4][0].decode(),
            inputs=[v.decode() for v in nf.get(1, [])],
            outputs=[v.decode() for v in nf.get(2, [])],
            attrs=dict(_parse_attr(a) for a in nf.get(5, [])),
        ))
    inits = dict(_parse_tensor(t) for t in f.get(5, []))
    inputs, input_types = [], {}
    for vi in f.get(11, []):
        name, dtype, shape = _parse_value_info(vi)
        inputs.append(name)
        input_types[name] = (dtype, shape)
    outputs = [_parse_value_info(vi)[0] for vi in f.get(12, [])]
    return Graph(
        name=f.get(2, [b""])[0].decode(), nodes=nodes, initializers=inits,
        inputs=inputs, outputs=outputs, input_types=input_types,
    )


def parse_model(buf: bytes) -> Graph:
    f = pw.decode_message(buf)
    return parse_graph(f[7][0])
