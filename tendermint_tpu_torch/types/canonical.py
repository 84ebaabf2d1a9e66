"""Canonical vote sign-bytes: the byte strings validators sign.

Counterpart: tendermint_tpu/types/canonical.py (CanonicalVote marshalled
with a varint length prefix; height and round sfixed64). Only the Python
sign-bytes loop is kept: no native assembler.
"""

from __future__ import annotations

from typing import List, Optional

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
        return self.sign_bytes_batch([timestamp_ns])[0]

    def sign_bytes_batch(self, timestamps_ns) -> List[bytes]:
        """sign_bytes for a sequence of timestamps in one tight loop
        (the Timestamp submessage varint-encoded inline)."""
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
