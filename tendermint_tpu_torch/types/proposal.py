"""Proposal: a proposed block at (height, round), signed by the proposer.

Counterpart: tendermint_tpu/types/proposal.py:20-88 (reference:
types/proposal.go: the struct :20-40, ValidateBasic :60-100, sign-bytes
:110; proto fields proto/tendermint/types/types.pb.go:708-714). The
bytes are the JAX package's. `verify` goes through the key's
verify_signature: an sr25519 proposer's signature takes the device's
single-verify route where the min-batch gate admits one signature.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..crypto.keys import PubKey
from ..encoding.proto import FieldReader, ProtoWriter
from .block_id import BlockID
from .canonical import PROPOSAL_TYPE, proposal_sign_bytes
from .timestamp import decode_timestamp, encode_timestamp

__all__ = ["Proposal"]


@dataclass
class Proposal:
    type: int = PROPOSAL_TYPE
    height: int = 0
    round: int = 0
    pol_round: int = -1  # -1 when no proof-of-lock
    block_id: BlockID = field(default_factory=BlockID)
    timestamp_ns: int = 0
    signature: bytes = b""

    def sign_bytes(self, chain_id: str) -> bytes:
        return proposal_sign_bytes(
            chain_id,
            self.height,
            self.round,
            self.pol_round,
            self.block_id,
            self.timestamp_ns,
        )

    def verify(self, chain_id: str, pub_key: PubKey) -> bool:
        return pub_key.verify_signature(self.sign_bytes(chain_id), self.signature)

    def validate_basic(self) -> None:
        if self.type != PROPOSAL_TYPE:
            raise ValueError("invalid Type")
        if self.height < 0:
            raise ValueError("negative Height")
        if self.round < 0:
            raise ValueError("negative Round")
        if self.pol_round < -1:
            raise ValueError("negative POLRound (exception: -1)")
        self.block_id.validate_basic()
        if not self.block_id.is_complete():
            raise ValueError("expected a complete, non-empty BlockID")
        if not self.signature:
            raise ValueError("signature is missing")
        if len(self.signature) > 64:
            raise ValueError("signature is too big")

    def to_proto(self) -> bytes:
        w = ProtoWriter()
        w.int(1, self.type)
        w.int(2, self.height)
        w.int(3, self.round)
        w.int(4, self.pol_round)
        w.message(5, self.block_id.to_proto())  # nullable=false
        w.message(6, encode_timestamp(self.timestamp_ns))
        w.bytes(7, self.signature)
        return w.finish()

    @classmethod
    def from_proto(cls, data: bytes) -> "Proposal":
        r = FieldReader(data)
        bid = r.get(5)
        ts = r.get(6)
        return cls(
            type=r.uint(1),
            height=r.int64(2),
            round=r.int64(3),
            pol_round=r.int64(4),
            block_id=BlockID.from_proto(bid) if bid is not None else BlockID(),
            timestamp_ns=decode_timestamp(ts) if ts is not None else 0,
            signature=r.bytes(7),
        )
