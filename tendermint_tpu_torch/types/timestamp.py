"""Canonical timestamps: integer nanoseconds since the Unix epoch (UTC),
encoded as google.protobuf.Timestamp {seconds=1, nanos=2}.

Counterpart: tendermint_tpu/types/timestamp.py: encode/decode, now_ns,
and the RFC 3339 text of a genesis file (:54-74).
"""

from __future__ import annotations

import time as _time
from datetime import datetime, timezone

from ..encoding.proto import FieldReader, ProtoWriter

__all__ = [
    "NS",
    "decode_timestamp",
    "encode_timestamp",
    "from_rfc3339",
    "now_ns",
    "to_rfc3339",
]

NS = 1_000_000_000


def now_ns() -> int:
    return _time.time_ns()


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


def to_rfc3339(ns: int) -> str:
    seconds, nanos = divmod(ns, NS)
    dt = datetime.fromtimestamp(seconds, tz=timezone.utc)
    base = dt.strftime("%Y-%m-%dT%H:%M:%S")
    if nanos:
        frac = f"{nanos:09d}".rstrip("0")
        return f"{base}.{frac}Z"
    return base + "Z"


def from_rfc3339(s: str) -> int:
    if s.endswith("Z"):
        s = s[:-1]
    frac = 0
    if "." in s:
        s, frac_s = s.split(".")
        frac = int(frac_s.ljust(9, "0")[:9])
    dt = datetime.strptime(s, "%Y-%m-%dT%H:%M:%S").replace(tzinfo=timezone.utc)
    return int(dt.timestamp()) * NS + frac
