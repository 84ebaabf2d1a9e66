"""Vote: a signed prevote/precommit from a validator.

Counterpart: tendermint_tpu/types/vote.py: the struct, the sign-bytes
memo a chain id (:40-68), verify with the verified-signature cache
(:70-87), validate_basic and the proto round-trip.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

from ..crypto import sigcache
from ..crypto.keys import PubKey
from ..encoding.proto import FieldReader, ProtoWriter
from .block_id import BlockID
from .canonical import PRECOMMIT_TYPE, PREVOTE_TYPE, vote_sign_bytes
from .timestamp import decode_timestamp, encode_timestamp

__all__ = ["Vote", "is_vote_type_valid"]


def is_vote_type_valid(t: int) -> bool:
    return t in (PREVOTE_TYPE, PRECOMMIT_TYPE)


@dataclass
class Vote:
    type: int = PREVOTE_TYPE
    height: int = 0
    round: int = 0
    block_id: BlockID = field(default_factory=BlockID)
    timestamp_ns: int = 0
    validator_address: bytes = b""
    validator_index: int = -1
    signature: bytes = b""

    # the fields sign_bytes encodes: assigning one (the dataclass
    # __init__ included) drops the memo
    _SB_FIELDS = frozenset({"type", "height", "round", "block_id", "timestamp_ns"})

    def __setattr__(self, name: str, value) -> None:
        if name in self._SB_FIELDS:
            self.__dict__.pop("_sb_memo", None)
        object.__setattr__(self, name, value)

    def sign_bytes(self, chain_id: str) -> bytes:
        """The canonical sign-bytes, memoized for one chain id: the vote
        path encodes a vote twice (the pre-verify, then Vote.verify in
        VoteSet.add_vote). Assigning an encoded field drops the memo; a
        BlockID changed in place is not a supported mutation."""
        memo = self.__dict__.get("_sb_memo")
        if memo is not None and memo[0] == chain_id:
            return memo[1]
        sb = vote_sign_bytes(
            chain_id,
            self.type,
            self.height,
            self.round,
            self.block_id,
            self.timestamp_ns,
        )
        self.__dict__["_sb_memo"] = (chain_id, sb)
        return sb

    def verify(self, chain_id: str, pub_key: PubKey) -> None:
        """Raises ValueError on an address mismatch or a bad signature.
        After the address check, a triple the verified-signature cache
        holds (proven by the consensus pre-verify or an earlier call
        here) skips the signature equation; a fresh success is
        recorded."""
        if pub_key.address() != self.validator_address:
            raise ValueError("invalid validator address")
        sign_bytes = self.sign_bytes(chain_id)
        if sigcache.seen(pub_key.bytes(), sign_bytes, self.signature):
            return
        if not pub_key.verify_signature(sign_bytes, self.signature):
            raise ValueError("invalid signature")
        sigcache.add(pub_key.bytes(), sign_bytes, self.signature)

    def validate_basic(self) -> None:
        if not is_vote_type_valid(self.type):
            raise ValueError("invalid Type")
        if self.height < 0:
            raise ValueError("negative Height")
        if self.round < 0:
            raise ValueError("negative Round")
        self.block_id.validate_basic()
        if not self.block_id.is_zero() and not self.block_id.is_complete():
            raise ValueError(
                "blockID must be either empty or complete, got "
                f"{self.block_id}"
            )
        if len(self.validator_address) != 20:
            raise ValueError("expected ValidatorAddress size to be 20 bytes")
        if self.validator_index < 0:
            raise ValueError("negative ValidatorIndex")
        if len(self.signature) == 0:
            raise ValueError("signature is missing")
        if len(self.signature) > 64:
            raise ValueError("signature is too big")

    def is_nil(self) -> bool:
        return self.block_id.is_zero()

    def copy(self) -> "Vote":
        return replace(self)

    def to_proto(self) -> bytes:
        w = ProtoWriter()
        w.int(1, self.type)
        w.int(2, self.height)
        w.int(3, self.round)
        w.message(4, self.block_id.to_proto())
        w.message(5, encode_timestamp(self.timestamp_ns))
        w.bytes(6, self.validator_address)
        w.int(7, self.validator_index)
        w.bytes(8, self.signature)
        return w.finish()

    @classmethod
    def from_proto(cls, data: bytes) -> "Vote":
        r = FieldReader(data)
        bid = r.get(4)
        ts = r.get(5)
        return cls(
            type=r.uint(1),
            height=r.int64(2),
            round=r.int64(3),
            block_id=BlockID.from_proto(bid) if bid is not None else BlockID(),
            timestamp_ns=decode_timestamp(ts) if ts is not None else 0,
            validator_address=r.bytes(6),
            validator_index=r.int64(7),
            signature=r.bytes(8),
        )
