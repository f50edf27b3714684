"""Minimal protobuf wire-format encoder/decoder.

The environment has no ``onnx`` package, so ONNX models are serialized
directly in the protobuf wire format (proto3). Only the features ONNX needs
are implemented: varint (wire type 0) and length-delimited (wire type 2)
fields, plus packed repeated scalars. The decoder is generic (returns a
field-number -> values dict) and exists so tests can round-trip and inspect
emitted models without onnx/onnxruntime.

Wire format: each field is a tag varint ((field_number << 3) | wire_type)
followed by the payload; proto3 messages are concatenations of fields.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Union

WIRE_VARINT = 0
WIRE_FIXED64 = 1
WIRE_LEN = 2
WIRE_FIXED32 = 5


def encode_varint(value: int) -> bytes:
    if value < 0:  # protobuf encodes negative ints as 10-byte two's complement
        value &= (1 << 64) - 1
    out = bytearray()
    while True:
        byte = value & 0x7F
        value >>= 7
        if value:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def tag(field: int, wire_type: int) -> bytes:
    return encode_varint((field << 3) | wire_type)


def field_varint(field: int, value: int) -> bytes:
    return tag(field, WIRE_VARINT) + encode_varint(int(value))


def field_bytes(field: int, payload: bytes) -> bytes:
    return tag(field, WIRE_LEN) + encode_varint(len(payload)) + payload


def field_string(field: int, s: str) -> bytes:
    return field_bytes(field, s.encode("utf-8"))


def field_float(field: int, value: float) -> bytes:
    return tag(field, WIRE_FIXED32) + struct.pack("<f", float(value))


def field_double(field: int, value: float) -> bytes:
    return tag(field, WIRE_FIXED64) + struct.pack("<d", float(value))


def packed_varints(field: int, values) -> bytes:
    payload = b"".join(encode_varint(int(v)) for v in values)
    return field_bytes(field, payload)


def packed_floats(field: int, values) -> bytes:
    return field_bytes(field, struct.pack(f"<{len(values)}f", *map(float, values)))


# ---------------------------------------------------------------- decoding

Value = Union[int, bytes]


def decode_varint(buf: bytes, pos: int):
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7


def decode_message(buf: bytes) -> Dict[int, List[Value]]:
    """Generic decode: {field_number: [raw values]} — varints as ints,
    length-delimited as bytes, fixed32/64 as raw bytes."""
    out: Dict[int, List[Value]] = {}
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = decode_varint(buf, pos)
        field, wt = key >> 3, key & 7
        if wt == WIRE_VARINT:
            v, pos = decode_varint(buf, pos)
        elif wt == WIRE_LEN:
            length, pos = decode_varint(buf, pos)
            v = buf[pos: pos + length]
            pos += length
        elif wt == WIRE_FIXED32:
            v = buf[pos: pos + 4]
            pos += 4
        elif wt == WIRE_FIXED64:
            v = buf[pos: pos + 8]
            pos += 8
        else:  # pragma: no cover
            raise ValueError(f"unsupported wire type {wt} for field {field}")
        out.setdefault(field, []).append(v)
    return out
