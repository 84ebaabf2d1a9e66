"""Evidence of a light-client attack.

Counterpart: tendermint_tpu/types/evidence.py:115-192
(LightClientAttackEvidence; reference: types/evidence.go:230-480), which
the light client's divergence detection builds. DuplicateVoteEvidence
and the Evidence oneof are not ported: nothing in the port builds or
reads them yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

from ..crypto import tmhash
from ..encoding.proto import (
    ProtoWriter,
    encode_varint,
    encode_zigzag,
    iter_fields,
)
from .timestamp import decode_timestamp, encode_timestamp
from .validator import Validator

__all__ = ["LightClientAttackEvidence"]


@dataclass
class LightClientAttackEvidence:
    """A conflicting light block and the height both chains share."""

    conflicting_block: "object"  # types.light.LightBlock
    common_height: int = 0
    byzantine_validators: List[Validator] = field(default_factory=list)
    total_voting_power: int = 0
    timestamp_ns: int = 0

    def height(self) -> int:
        return self.common_height

    def bytes(self) -> bytes:
        return self.to_proto()

    def hash(self) -> bytes:
        """The header hash with its last byte zeroed (the reference's
        off-by-one copy, kept for parity; types/evidence.go:359-366),
        then the zigzag varint of the common height."""
        header_hash = self.conflicting_block.signed_header.hash()
        buf = bytearray(tmhash.SIZE)
        buf[: tmhash.SIZE - 1] = header_hash[: tmhash.SIZE - 1]
        return tmhash.sum256(
            bytes(buf) + encode_varint(encode_zigzag(self.common_height))
        )

    def validate_basic(self) -> None:
        if self.conflicting_block is None:
            raise ValueError("conflicting block is nil")
        if self.common_height <= 0:
            raise ValueError("negative or zero common height")
        sh = self.conflicting_block.signed_header
        if sh is None or sh.header is None:
            raise ValueError("conflicting block missing header")

    def to_proto(self) -> bytes:
        w = ProtoWriter()
        w.message(1, self.conflicting_block.to_proto())
        w.int(2, self.common_height)
        for v in self.byzantine_validators:
            w.message(3, v.to_proto())
        w.int(4, self.total_voting_power)
        w.message(5, encode_timestamp(self.timestamp_ns))
        return w.finish()

    @classmethod
    def from_proto(cls, data: bytes) -> "LightClientAttackEvidence":
        from .light import LightBlock

        cb = None
        common_height = 0
        byz: List[Validator] = []
        tvp = 0
        ts = 0
        for f, _wt, v in iter_fields(data):
            if f == 1:
                cb = LightBlock.from_proto(v)
            elif f == 2:
                common_height = v
            elif f == 3:
                byz.append(Validator.from_proto(v))
            elif f == 4:
                tvp = v
            elif f == 5:
                ts = decode_timestamp(v)
        return cls(
            conflicting_block=cb,
            common_height=common_height,
            byzantine_validators=byz,
            total_voting_power=tvp,
            timestamp_ns=ts,
        )
