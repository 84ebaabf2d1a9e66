"""Canonical vote sign-bytes: the byte strings validators sign.

Counterpart: tendermint_tpu/types/canonical.py (CanonicalVote marshalled
with a varint length prefix; height and round sfixed64;
`VoteSignTemplate.sign_bytes_batch` :140-217). A commit's sign-bytes are
spliced in C (native/signbytes.c, one call a batch); the Python splice
serves only timestamps outside int64, which the C cannot take: that
route is chosen on the data, as the JAX package chooses it, and a failed
build of the C raises.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional

import numpy as np

from .. import native
from ..encoding.proto import ProtoWriter, encode_varint, length_prefixed
from .block_id import BlockID
from .timestamp import encode_timestamp

__all__ = [
    "PRECOMMIT_TYPE",
    "PREVOTE_TYPE",
    "VoteSignTemplate",
    "canonical_block_id",
    "canonical_vote_bytes",
    "vote_sign_bytes",
]

# SignedMsgType enum: prevote=1, precommit=2
PREVOTE_TYPE = 1
PRECOMMIT_TYPE = 2

# the range of the C splice's timestamps (int64 nanoseconds)
_INT64_MIN, _INT64_MAX = -(1 << 63), (1 << 63) - 1


def canonical_block_id(block_id: BlockID) -> Optional[bytes]:
    """CanonicalBlockID body, or None for a zero BlockID (nil votes carry
    no block_id field at all)."""
    if block_id.is_zero():
        return None
    w = ProtoWriter()
    w.bytes(1, block_id.hash)
    psh = ProtoWriter()
    psh.uint(1, block_id.part_set_header.total)
    psh.bytes(2, block_id.part_set_header.hash)
    w.message(2, psh.finish())
    return w.finish()


def canonical_vote_bytes(
    msg_type: int,
    height: int,
    round_: int,
    block_id: BlockID,
    timestamp_ns: int,
    chain_id: str,
) -> bytes:
    """CanonicalVote message body (no length prefix)."""
    w = ProtoWriter()
    w.int(1, msg_type)
    w.sfixed64(2, height)
    w.sfixed64(3, round_)
    w.message(4, canonical_block_id(block_id))
    w.message(5, encode_timestamp(timestamp_ns))  # always written
    w.string(6, chain_id)
    return w.finish()


def vote_sign_bytes(
    chain_id: str,
    msg_type: int,
    height: int,
    round_: int,
    block_id: BlockID,
    timestamp_ns: int,
) -> bytes:
    """The exact bytes a validator signs for a vote."""
    return length_prefixed(
        canonical_vote_bytes(
            msg_type, height, round_, block_id, timestamp_ns, chain_id
        )
    )


class VoteSignTemplate:
    """Within one commit every canonical vote shares type, height,
    round, block_id and chain_id; only the timestamp differs. The fixed
    fields are encoded once (prefix = fields 1-4, suffix = field 6) and
    per signature only the Timestamp (field 5) is encoded and spliced
    in. Byte-identical to vote_sign_bytes()."""

    __slots__ = ("_prefix", "_suffix")

    _TS_TAG = bytes([(5 << 3) | 2])  # field 5, wire type 2

    def __init__(
        self,
        chain_id: str,
        msg_type: int,
        height: int,
        round_: int,
        block_id: BlockID,
    ) -> None:
        w = ProtoWriter()
        w.int(1, msg_type)
        w.sfixed64(2, height)
        w.sfixed64(3, round_)
        w.message(4, canonical_block_id(block_id))
        self._prefix = w.finish()
        w = ProtoWriter()
        w.string(6, chain_id)
        self._suffix = w.finish()

    def sign_bytes(self, timestamp_ns: int) -> bytes:
        """The sign-bytes of one vote: the C splice of one row, through
        ctypes scalars (no array set-up for a single timestamp)."""
        if not _INT64_MIN <= timestamp_ns <= _INT64_MAX:
            return self._sign_bytes_python([timestamp_ns])[0]
        cap = len(self._prefix) + len(self._suffix) + 24
        out = ctypes.create_string_buffer(cap)
        length = ctypes.c_int32()
        total = self._splice(
            ctypes.byref(ctypes.c_int64(timestamp_ns)), 1, out, cap,
            ctypes.byref(length),
        )
        return out.raw[:total]

    def sign_bytes_batch(self, timestamps_ns) -> List[bytes]:
        """sign_bytes for a sequence of timestamps: one call of the C
        splice when every timestamp fits int64, else the Python splice.
        The two are byte-identical."""
        ts = list(timestamps_ns)
        if not ts:
            return []
        if _INT64_MIN <= min(ts) and max(ts) <= _INT64_MAX:
            return self._sign_bytes_native(np.array(ts, dtype=np.int64))
        return self._sign_bytes_python(ts)

    def _sign_bytes_native(self, ts: np.ndarray) -> List[bytes]:
        """The C splice of n >= 1 int64 timestamps, the rows cut from
        one buffer at the offsets of one cumulative sum of their
        lengths."""
        n = len(ts)
        cap = n * (len(self._prefix) + len(self._suffix) + 24)
        out = np.empty(cap, dtype=np.uint8)
        lens = np.empty(n, dtype=np.int32)
        total = self._splice(ts.ctypes.data, n, out.ctypes.data, cap, lens.ctypes.data)
        ends = np.cumsum(lens).tolist()
        raw = out[:total].tobytes()
        return [raw[a:b] for a, b in zip([0, *ends[:-1]], ends)]

    def _splice(self, ts, n: int, out, cap: int, lens) -> int:
        """tm_vote_sign_bytes_batch of n timestamps at `ts` into `out`
        (cap bytes, a proven bound), their lengths into `lens`; the
        bytes written."""
        total = native.signbytes_lib().tm_vote_sign_bytes_batch(
            self._prefix,
            len(self._prefix),
            self._suffix,
            len(self._suffix),
            self._TS_TAG[0],
            ts,
            n,
            out,
            cap,
            lens,
        )
        if total < 0:
            raise RuntimeError("signbytes: the output bound was exceeded")
        return total

    def _sign_bytes_python(self, timestamps_ns) -> List[bytes]:
        """The Python splice: the Timestamp submessage varint-encoded
        inline, for any int."""
        prefix, suffix, ts_tag = self._prefix, self._suffix, self._TS_TAG
        enc, join = encode_varint, b"".join
        out = []
        append = out.append
        for ns in timestamps_ns:
            seconds, nanos = divmod(ns, 1_000_000_000)
            ts = b""
            if seconds:
                ts = b"\x08" + enc(seconds)
            if nanos:
                ts += b"\x10" + enc(nanos)
            body = join((prefix, ts_tag, enc(len(ts)), ts, suffix))
            append(enc(len(body)) + body)
        return out
