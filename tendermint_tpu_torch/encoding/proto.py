"""Deterministic protobuf wire-format encoding (the subset the slice uses).

Counterpart: tendermint_tpu/encoding/proto.py, trimmed to ProtoWriter,
FieldReader, iter_fields, encode_varint, encode_zigzag and
length_prefixed (plus the decoders they need). Encoding is deterministic by construction: fields
in ascending tag order, proto3 defaults omitted. Wire types: 0 = varint,
1 = fixed64, 2 = length-delimited, 5 = fixed32.
"""

from __future__ import annotations

import struct
from typing import Iterator, Tuple

__all__ = [
    "FieldReader",
    "ProtoWriter",
    "encode_varint",
    "encode_zigzag",
    "decode_varint",
    "length_prefixed",
    "read_length_prefixed",
    "iter_fields",
]


# one-byte varints (values < 128) cover almost every tag and
# length-prefix the codec emits; interning them removes the encode
# loop and a bytes() allocation from the hottest path (measured: the
# pure-Python varint loop was the top non-crypto cost of light-client
# block saves)
_VARINT1 = [bytes([i]) for i in range(0x80)]


def encode_varint(value: int) -> bytes:
    """Encode an unsigned integer as a base-128 varint (LSB first)."""
    if value < 0:
        # proto3 int64 negative values are encoded as 10-byte two's complement
        value &= (1 << 64) - 1
    elif value < 0x80:
        return _VARINT1[value]
    elif value < 0x4000:
        return bytes((value & 0x7F | 0x80, value >> 7))
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def encode_zigzag(value: int) -> int:
    return (value << 1) ^ (value >> 63) if value < 0 else value << 1


def decode_varint(data: bytes, offset: int = 0) -> Tuple[int, int]:
    """Decode a varint; returns (value, new_offset)."""
    # single-byte fast path: the overwhelmingly common case for tags
    # and small lengths (mirror of encode_varint's interned table).
    # TypeError covers hostile type confusion (an int smuggled where
    # bytes belong by a wire-type flip): parse errors are ValueError,
    # the sanctioned decode-failure contract.
    try:
        b = data[offset]
    except IndexError:
        raise ValueError("truncated varint") from None
    except TypeError:
        raise ValueError("varint input is not bytes") from None
    if not b & 0x80:
        return b, offset + 1
    # seed the loop with the byte already fetched
    result = b & 0x7F
    shift = 7
    offset += 1
    while True:
        if offset >= len(data):
            raise ValueError("truncated varint")
        b = data[offset]
        offset += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            if result >= 1 << 64:
                raise ValueError("varint overflows 64 bits")
            return result, offset
        shift += 7
        if shift >= 70:
            # protobuf varints are at most 10 bytes
            raise ValueError("varint too long")


class ProtoWriter:
    """Append-only deterministic protobuf message writer.

    Callers must write fields in ascending field-number order to stay
    canonical; this is asserted.
    """

    __slots__ = ("_buf", "_last_field")

    def __init__(self) -> None:
        self._buf = bytearray()
        self._last_field = 0

    def _tag(self, field: int, wire_type: int) -> None:
        if field <= 0:
            raise ValueError("field numbers start at 1")
        if field < self._last_field:
            raise ValueError(
                f"non-canonical field order: {field} after {self._last_field}"
            )
        self._last_field = field
        tag = (field << 3) | wire_type
        if tag < 0x80:  # fields 1-15: single-byte tag, no varint call
            self._buf.append(tag)
        else:
            self._buf += encode_varint(tag)

    # -- scalar writers (proto3 semantics: zero values are omitted) --

    def uint(self, field: int, value: int) -> None:
        if value:
            self._tag(field, 0)
            self._buf += encode_varint(value)

    def int(self, field: int, value: int) -> None:
        if value:
            self._tag(field, 0)
            self._buf += encode_varint(value)

    def bool(self, field: int, value: bool) -> None:
        if value:
            self._tag(field, 0)
            self._buf += b"\x01"

    def sfixed64(self, field: int, value: int) -> None:
        if value:
            self._tag(field, 1)
            self._buf += struct.pack("<q", value)

    def fixed64(self, field: int, value: int) -> None:
        if value:
            self._tag(field, 1)
            self._buf += struct.pack("<Q", value)

    def bytes(self, field: int, value: bytes) -> None:
        if value:
            self._tag(field, 2)
            n = len(value)
            if n < 0x80:
                self._buf.append(n)
            else:
                self._buf += encode_varint(n)
            self._buf += value

    def string(self, field: int, value: str) -> None:
        if value:
            self.bytes(field, value.encode("utf-8"))

    def message(self, field: int, value: "bytes | ProtoWriter | None") -> None:
        """Write an embedded message. None is omitted; empty messages are
        WRITTEN (an empty message is distinct from an absent one, matching
        gogoproto nullable=false semantics)."""
        if value is None:
            return
        body = value.finish() if isinstance(value, ProtoWriter) else value
        self._tag(field, 2)
        n = len(body)
        if n < 0x80:
            self._buf.append(n)
        else:
            self._buf += encode_varint(n)
        self._buf += body

    def finish(self) -> bytes:
        return bytes(self._buf)


def length_prefixed(msg: bytes) -> bytes:
    """Varint length-prefix a message (protoio.MarshalDelimited semantics,
    used for vote/proposal sign-bytes; reference: types/vote.go:93)."""
    return encode_varint(len(msg)) + msg


def read_length_prefixed(data: bytes, offset: int = 0) -> Tuple[bytes, int]:
    n, offset = decode_varint(data, offset)
    if offset + n > len(data):
        raise ValueError("truncated length-prefixed message")
    return data[offset : offset + n], offset + n


def iter_fields(data: bytes) -> Iterator[Tuple[int, int, "int | bytes"]]:
    """Iterate (field_number, wire_type, value) over an encoded message.

    Varint/fixed fields yield ints; length-delimited yield bytes.
    """
    if not isinstance(data, (bytes, bytearray, memoryview)):
        # a nested decoder handed a wire-type-confused value (int where
        # a submessage's bytes belong): sanctioned parse error, not a
        # TypeError three frames later
        raise ValueError(
            f"message input is not bytes (got {type(data).__name__})"
        )
    offset = 0
    while offset < len(data):
        key, offset = decode_varint(data, offset)
        field, wire_type = key >> 3, key & 7
        if wire_type == 0:
            value, offset = decode_varint(data, offset)
        elif wire_type == 1:
            if offset + 8 > len(data):
                raise ValueError("truncated fixed64 field")
            (value,) = struct.unpack_from("<Q", data, offset)
            offset += 8
        elif wire_type == 2:
            value, offset = read_length_prefixed(data, offset)
        elif wire_type == 5:
            if offset + 4 > len(data):
                raise ValueError("truncated fixed32 field")
            (value,) = struct.unpack_from("<I", data, offset)
            offset += 4
        else:
            raise ValueError(f"unsupported wire type {wire_type}")
        yield field, wire_type, value


class FieldReader:
    """Random-access view over a single encoded message's fields.

    The typed accessors ENFORCE the wire type: a peer that sends field
    N as a varint where the schema says length-delimited (or vice
    versa) gets a ValueError from the accessor, not an int leaking
    into code that calls `.decode()`/`len()` on it and dies with an
    AttributeError three frames later: malformed wire input fails as a
    parse error, never as a type confusion. `get` and `get_all` stay raw
    for callers that handle both shapes (nested submessage bytes,
    repeated fields)."""

    def __init__(self, data: bytes) -> None:
        self._fields: dict[int, list] = {}
        for field, _wt, value in iter_fields(data):
            self._fields.setdefault(field, []).append(value)

    def get(self, field: int, default=None):
        vals = self._fields.get(field)
        return vals[-1] if vals else default

    def get_all(self, field: int) -> list:
        """Every value of a repeated field, raw, in wire order."""
        return self._fields.get(field, [])

    def uint(self, field: int, default: int = 0) -> int:
        vals = self._fields.get(field)
        if not vals:
            return default
        v = vals[-1]
        if not isinstance(v, int):
            raise ValueError(
                f"field {field}: expected varint, got length-delimited"
            )
        return int(v)

    def int64(self, field: int, default: int = 0) -> int:
        vals = self._fields.get(field)
        if not vals:
            return default
        v = vals[-1]
        if not isinstance(v, int):
            raise ValueError(
                f"field {field}: expected varint, got length-delimited"
            )
        v = int(v)
        return v - (1 << 64) if v >= 1 << 63 else v

    def sfixed64(self, field: int, default: int = 0) -> int:
        v = self.get(field)
        if v is None:
            return default
        if not isinstance(v, int):
            raise ValueError(
                f"field {field}: expected fixed64, got length-delimited"
            )
        return v - (1 << 64) if v >= 1 << 63 else v

    def bool(self, field: int) -> bool:
        vals = self._fields.get(field)
        if not vals:
            return False
        v = vals[-1]
        if not isinstance(v, int):
            raise ValueError(
                f"field {field}: expected varint, got length-delimited"
            )
        return bool(v)

    def bytes(self, field: int, default: bytes = b"") -> bytes:
        vals = self._fields.get(field)
        if not vals:
            return default
        v = vals[-1]
        if not isinstance(v, (bytes, bytearray, memoryview)):
            raise ValueError(
                f"field {field}: expected length-delimited, got varint"
            )
        return v

    def string(self, field: int, default: str = "") -> str:
        v = self.get(field)
        if v is None:
            return default
        if not isinstance(v, (bytes, bytearray, memoryview)):
            raise ValueError(
                f"field {field}: expected length-delimited, got varint"
            )
        return bytes(v).decode("utf-8")
