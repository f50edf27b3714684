"""Independent ONNX structural checker.

This module validates serialized ONNX models against the public ONNX IR
spec (github.com/onnx/onnx: docs/IR.md, onnx/onnx.proto) and deliberately
shares NO code with the emitter: it re-implements protobuf wire decoding
and the onnx.proto field schema from the specs instead of importing
``protowire``/``builder``. A misreading of either spec baked into the
emitter therefore cannot silently pass here — the closest this environment
gets to the reference's onnx.checker + onnxruntime validation culture
(reference deployment/exporters/acoustic_exporter.py:104-113; onnx and
onnxruntime are not installed).

Checks implemented (each mirrors a rule stated in docs/IR.md):

- ModelProto carries ``ir_version`` and a ``graph``, and imports the
  default-domain opset exactly once.
- Every initializer's payload length matches ``prod(dims) * sizeof(dtype)``
  and its ``data_type`` is a known enum value.
- Graphs are in single static assignment form across the whole *lexical*
  scope chain: a name defined in a subgraph must not redefine a graph
  input, initializer, or node output visible from any enclosing graph.
- Nodes are topologically sorted: every node input is either the empty
  string (optional), a graph input, an initializer, an output of an
  *earlier* node, or visible from an outer scope.
- Every graph output is defined, node op_types are non-empty, attribute
  records decode and carry a payload consistent with their declared type.
- Optionally, node op_types are restricted to a caller-provided set (used
  to keep ``docs/onnx_ops.md`` honest).

``check_model`` raises :class:`OnnxCheckError` on the first violation and
returns basic stats otherwise.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Sequence, Set, Tuple


class OnnxCheckError(ValueError):
    pass


# ------------------------------------------------------------- wire decoding
# proto3 wire format (protobuf.dev/programming-guides/encoding): a message is
# a sequence of (tag, payload) records; tag = (field_number << 3) | wire_type.

def _varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        if pos >= len(buf):
            raise OnnxCheckError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7
        if shift > 70:
            raise OnnxCheckError("varint too long")


def _records(buf: bytes) -> List[Tuple[int, int, object]]:
    """Decode one message into [(field_number, wire_type, value), ...].
    Varints decode to int; length-delimited to bytes; fixed32/64 to bytes."""
    out = []
    pos, n = 0, len(buf)
    while pos < n:
        key, pos = _varint(buf, pos)
        field, wt = key >> 3, key & 7
        if wt == 0:
            v, pos = _varint(buf, pos)
        elif wt == 2:
            ln, pos = _varint(buf, pos)
            if pos + ln > n:
                raise OnnxCheckError(
                    f"field {field}: length {ln} overruns message ({n - pos} left)")
            v = buf[pos: pos + ln]
            pos += ln
        elif wt == 5:
            v, pos = buf[pos: pos + 4], pos + 4
        elif wt == 1:
            v, pos = buf[pos: pos + 8], pos + 8
        else:
            raise OnnxCheckError(f"field {field}: unsupported wire type {wt}")
        out.append((field, wt, v))
    return out


def _group(buf: bytes) -> Dict[int, List[object]]:
    fields: Dict[int, List[object]] = {}
    for f, _, v in _records(buf):
        fields.setdefault(f, []).append(v)
    return fields


def _utf8(v: object, what: str) -> str:
    if not isinstance(v, bytes):
        raise OnnxCheckError(f"{what}: expected length-delimited string")
    return v.decode("utf-8")


# --------------------------------------------------------------- onnx schema
# Field numbers below are transcribed from onnx/onnx.proto (public schema).

# TensorProto.DataType -> element byte size (0 = variable/unsupported here)
_DTYPE_SIZES = {
    1: 4,   # FLOAT
    2: 1,   # UINT8
    3: 1,   # INT8
    4: 2,   # UINT16
    5: 2,   # INT16
    6: 4,   # INT32
    7: 8,   # INT64
    8: 0,   # STRING (string_data, not raw_data)
    9: 1,   # BOOL
    10: 2,  # FLOAT16
    11: 8,  # DOUBLE
    12: 4,  # UINT32
    13: 8,  # UINT64
    14: 8,  # COMPLEX64
    15: 16, # COMPLEX128
    16: 2,  # BFLOAT16
}

# AttributeProto.AttributeType -> the AttributeProto field that must carry
# the payload (FLOAT=f(2), INT=i(3), STRING=s(4), TENSOR=t(5), GRAPH=g(6),
# FLOATS=floats(7), INTS=ints(8), STRINGS=strings(9))
_ATTR_PAYLOAD_FIELD = {1: 2, 2: 3, 3: 4, 4: 5, 5: 6, 6: 7, 7: 8, 8: 9}


def _check_tensor(buf: bytes, what: str) -> str:
    """Validate one TensorProto; returns its name.
    TensorProto: dims=1, data_type=2, float_data=4, int32_data=5,
    int64_data=7, name=8, raw_data=9."""
    f = _group(buf)
    name = _utf8(f[8][0], f"{what}.name") if 8 in f else ""
    if 2 not in f:
        raise OnnxCheckError(f"{what} '{name}': missing data_type")
    dt = f[2][0]
    if dt not in _DTYPE_SIZES:
        raise OnnxCheckError(f"{what} '{name}': unknown data_type {dt}")
    dims: List[int] = []
    for v in f.get(1, []):
        if isinstance(v, bytes):  # packed repeated int64
            pos = 0
            while pos < len(v):
                d, pos = _varint(v, pos)
                dims.append(d)
        else:
            dims.append(int(v))
    # varints decode unsigned; negative int64 dims arrive as ~2^64 — restore
    # the two's-complement sign so the negative-dim diagnostic fires
    dims = [d - (1 << 64) if d >= (1 << 63) else d for d in dims]
    count = 1
    for d in dims:
        if d < 0:
            raise OnnxCheckError(f"{what} '{name}': negative dim {d}")
        count *= d
    if 9 in f:  # raw_data
        size = _DTYPE_SIZES[dt]
        if size == 0:
            raise OnnxCheckError(f"{what} '{name}': raw_data with string dtype")
        raw = f[9][0]
        if len(raw) != count * size:
            raise OnnxCheckError(
                f"{what} '{name}': raw_data is {len(raw)} bytes, expected "
                f"{count} x {size} = {count * size} for dims {dims}")
    elif 4 in f:  # float_data (packed floats)
        total = sum(len(v) for v in f[4] if isinstance(v, bytes))
        if total != count * 4:
            raise OnnxCheckError(
                f"{what} '{name}': float_data is {total} bytes, expected {count * 4}")
    elif count != 0 and not (5 in f or 6 in f or 7 in f):
        raise OnnxCheckError(f"{what} '{name}': no tensor payload")
    return name


def _check_value_info(buf: bytes, what: str) -> str:
    """ValueInfoProto: name=1, type=2. TypeProto: tensor_type=1;
    TypeProto.Tensor: elem_type=1, shape=2."""
    f = _group(buf)
    if 1 not in f:
        raise OnnxCheckError(f"{what}: ValueInfoProto without a name")
    name = _utf8(f[1][0], f"{what}.name")
    if not name:
        raise OnnxCheckError(f"{what}: empty value name")
    if 2 in f:
        tp = _group(f[2][0])
        if 1 in tp:  # tensor_type
            tt = _group(tp[1][0])
            elem = tt.get(1, [None])[0]
            if elem is not None and elem not in _DTYPE_SIZES:
                raise OnnxCheckError(f"{what} '{name}': unknown elem_type {elem}")
    return name


def _check_attribute(buf: bytes, node_desc: str) -> Tuple[str, Optional[bytes]]:
    """AttributeProto: name=1, f=2, i=3, s=4, t=5, g=6, floats=7, ints=8,
    strings=9, type=20. Returns (name, subgraph bytes or None)."""
    f = _group(buf)
    if 1 not in f:
        raise OnnxCheckError(f"{node_desc}: attribute without a name")
    name = _utf8(f[1][0], "attribute name")
    at = f.get(20, [0])[0]
    if at == 0:
        raise OnnxCheckError(f"{node_desc}: attribute '{name}' missing type")
    payload_field = _ATTR_PAYLOAD_FIELD.get(at)
    if payload_field is None:
        raise OnnxCheckError(
            f"{node_desc}: attribute '{name}' has unsupported type {at}")
    # repeated payloads (FLOATS/INTS/STRINGS) may legitimately be empty lists
    if at in (1, 2, 3, 4, 5) and payload_field not in f:
        raise OnnxCheckError(
            f"{node_desc}: attribute '{name}' (type {at}) carries no payload")
    if at == 4:  # TENSOR
        _check_tensor(f[5][0], f"{node_desc}: attribute '{name}' tensor")
    if at == 5:  # GRAPH
        return name, f[6][0]
    return name, None


def _check_graph(buf: bytes, outer_scope: Set[str], path: str,
                 known_ops: Optional[Set[str]], stats: Dict[str, int]) -> None:
    """GraphProto: node=1, name=2, initializer=5, input=11, output=12,
    value_info=13."""
    f = _group(buf)
    gname = _utf8(f[2][0], "graph.name") if 2 in f else ""
    desc = f"graph '{path or gname}'"

    defined: Set[str] = set()  # names defined in THIS scope, in order

    def define(name: str, what: str):
        if name in defined or name in outer_scope:
            raise OnnxCheckError(
                f"{desc}: {what} '{name}' violates SSA — the name is already "
                "defined in this or an enclosing scope")
        defined.add(name)

    for vi in f.get(11, []):  # inputs
        define(_check_value_info(vi, f"{desc} input"), "input")
    for t in f.get(5, []):  # initializers
        name = _check_tensor(t, f"{desc} initializer")
        if not name:
            raise OnnxCheckError(f"{desc}: initializer without a name")
        # IR v4+: an initializer may also appear as a graph input (default)
        if name not in defined:
            define(name, "initializer")
        stats["initializers"] += 1

    visible = outer_scope | defined
    for i, nb in enumerate(f.get(1, [])):  # nodes, must be topologically sorted
        nf = _group(nb)
        if 4 not in nf:
            raise OnnxCheckError(f"{desc}: node #{i} has no op_type")
        op = _utf8(nf[4][0], "op_type")
        if not op:
            raise OnnxCheckError(f"{desc}: node #{i} has empty op_type")
        if known_ops is not None and op not in known_ops:
            raise OnnxCheckError(
                f"{desc}: node #{i} op_type '{op}' is not in the documented op set")
        ndesc = f"{desc}: node #{i} ({op})"
        subgraphs: List[bytes] = []
        for ab in nf.get(5, []):
            _, sub = _check_attribute(ab, ndesc)
            if sub is not None:
                subgraphs.append(sub)
        # subgraphs see the outer scope as of THIS node (docs/IR.md: names
        # from enclosing scopes are visible inside Loop/If/Scan bodies)
        for sub in subgraphs:
            _check_graph(sub, visible, f"{path}/{op}#{i}", known_ops, stats)
        for v in nf.get(1, []):  # inputs: "" marks an omitted optional input
            iname = _utf8(v, f"{ndesc} input")
            if iname and iname not in visible:
                raise OnnxCheckError(
                    f"{ndesc}: input '{iname}' is not a graph input, "
                    "initializer, or earlier node output (graph must be "
                    "topologically sorted)")
        for v in nf.get(2, []):  # outputs
            oname = _utf8(v, f"{ndesc} output")
            if oname:  # "" marks an unused optional output
                define(oname, f"node #{i} output")
                visible.add(oname)
        stats["nodes"] += 1

    if not f.get(12, []):
        raise OnnxCheckError(f"{desc}: graph has no outputs")
    for vi in f.get(12, []):
        name = _check_value_info(vi, f"{desc} output")
        if name not in visible:
            raise OnnxCheckError(f"{desc}: output '{name}' is never defined")


def check_model(data: bytes, known_ops: Optional[Sequence[str]] = None) -> Dict[str, int]:
    """Validate a serialized ONNX ModelProto; raises OnnxCheckError.

    ModelProto: ir_version=1, producer_name=2, graph=7, opset_import=8.
    OperatorSetIdProto: domain=1, version=2.
    """
    try:
        return _check_model(data, known_ops)
    except OnnxCheckError:
        raise
    except Exception as e:  # corrupt wire data can fail the decoder anywhere
        # (wrong wire type -> TypeError, bad utf8 -> UnicodeDecodeError, ...);
        # uphold the documented raises-OnnxCheckError contract
        raise OnnxCheckError(
            f"model: malformed protobuf ({type(e).__name__}: {e})") from e


def op_table_ops(markdown: str) -> List[str]:
    """Op names from docs/onnx_ops.md-style audit tables (rows whose first
    cell is a backticked op). The ONE parser of that contract — used by the
    CLI whitelist and the emitter-sync test, so they cannot drift."""
    import re

    return re.findall(r"^\| *`([A-Za-z0-9]+)` *\|", markdown, flags=re.M)


def _check_model(data: bytes, known_ops: Optional[Sequence[str]]) -> Dict[str, int]:
    f = _group(data)
    if 1 not in f:
        raise OnnxCheckError("model: missing ir_version")
    ir = f[1][0]
    if not isinstance(ir, int) or ir < 3:
        # opset_import is required from IR v3 onward; nothing older is valid
        raise OnnxCheckError(f"model: unsupported ir_version {ir!r}")
    default_opsets = []
    for op in f.get(8, []):
        of = _group(op)
        domain = _utf8(of[1][0], "opset domain") if 1 in of else ""
        if domain in ("", "ai.onnx"):
            if 2 not in of:
                raise OnnxCheckError("model: opset_import without a version")
            default_opsets.append(of[2][0])
    if len(default_opsets) != 1:
        raise OnnxCheckError(
            f"model: expected exactly one default-domain opset import, "
            f"found {len(default_opsets)}")
    if 7 not in f:
        raise OnnxCheckError("model: missing graph")
    stats = {"nodes": 0, "initializers": 0}
    _check_graph(f[7][0], set(), "", set(known_ops) if known_ops else None, stats)
    stats["opset"] = default_opsets[0]
    stats["ir_version"] = ir
    return stats


def _main(argv):
    """CLI: ``python -m diffsinger_tpu_torch.deployment.onnx.checker model.onnx...``

    Validates each file and prints its stats; exits non-zero on the first
    invalid model. ``--ops docs/onnx_ops.md`` additionally restricts node
    op_types to the ops documented there (the emitted-op audit contract).
    """
    import argparse
    import pathlib
    import sys

    ap = argparse.ArgumentParser(
        description="Independent ONNX structural checker (no onnx install "
                    "needed; shares no code with the emitter)")
    ap.add_argument("models", nargs="+", type=pathlib.Path)
    ap.add_argument("--ops", type=pathlib.Path, default=None,
                    help="markdown op-audit doc; node op_types must appear "
                         "as `Op` rows in it (e.g. docs/onnx_ops.md)")
    args = ap.parse_args(argv)
    known = None
    if args.ops:
        try:
            known = op_table_ops(args.ops.read_text())
        except OSError as e:
            print(f"error: cannot read {args.ops}: {e}", file=sys.stderr)
            return 2
        if not known:
            print(f"error: no `Op` table rows found in {args.ops}", file=sys.stderr)
            return 2
    rc = 0
    for path in args.models:
        try:
            stats = check_model(path.read_bytes(), known_ops=known)
        except OnnxCheckError as e:
            print(f"{path}: INVALID — {e}")
            rc = 1
        except OSError as e:
            print(f"{path}: unreadable — {e}")
            rc = 1
        else:
            print(f"{path}: ok — {stats['nodes']} nodes, "
                  f"{stats['initializers']} initializers, "
                  f"opset {stats['opset']}, ir v{stats['ir_version']}")
    return rc


if __name__ == "__main__":  # pragma: no cover — thin shell over check_model
    import sys

    sys.exit(_main(sys.argv[1:]))
