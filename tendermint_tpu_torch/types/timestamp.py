"""Canonical timestamps: integer nanoseconds since the Unix epoch (UTC),
encoded as google.protobuf.Timestamp {seconds=1, nanos=2}.

Counterpart: tendermint_tpu/types/timestamp.py (encode/decode only).
"""

from __future__ import annotations

from ..encoding.proto import FieldReader, ProtoWriter

__all__ = ["NS", "decode_timestamp", "encode_timestamp"]

NS = 1_000_000_000


def encode_timestamp(ns: int) -> bytes:
    """google.protobuf.Timestamp wire encoding."""
    seconds, nanos = divmod(ns, NS)
    w = ProtoWriter()
    w.int(1, seconds)
    w.int(2, nanos)
    return w.finish()


def decode_timestamp(data: bytes) -> int:
    r = FieldReader(data)
    return r.int64(1) * NS + r.int64(2)
