"""Evidence of Byzantine behavior, as a block carries it.

Counterpart: tendermint_tpu/types/evidence.py: DuplicateVoteEvidence
(:36-112: from_votes, bytes, hash, validate_basic and the proto form),
LightClientAttackEvidence (:115-187; the light client's divergence
detection builds it), the Evidence oneof (:190-213) and a block's
evidence hash (:216). Reference:
types/evidence.go. The ABCI form of each, Misbehavior, is built by
state/execution.py. The evidence pool and its checks are in
evidence/pool.py and evidence/verify.py, its gossip in
evidence/reactor.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Union

from ..crypto import merkle, tmhash
from ..encoding.proto import (
    FieldReader,
    ProtoWriter,
    encode_varint,
    encode_zigzag,
    iter_fields,
)
from .timestamp import decode_timestamp, encode_timestamp
from .validator import Validator, ValidatorSet
from .vote import Vote

__all__ = [
    "DuplicateVoteEvidence",
    "LightClientAttackEvidence",
    "Evidence",
    "evidence_to_proto",
    "evidence_from_proto",
    "evidence_list_hash",
]


@dataclass
class DuplicateVoteEvidence:
    """Two conflicting votes by one validator at the same H/R/S
    (reference: types/evidence.go:33-200). vote_a is the one with the
    lexicographically smaller BlockID key."""

    vote_a: Vote
    vote_b: Vote
    total_voting_power: int = 0
    validator_power: int = 0
    timestamp_ns: int = 0

    @classmethod
    def from_votes(
        cls,
        vote1: Vote,
        vote2: Vote,
        block_time_ns: int,
        val_set: ValidatorSet,
    ) -> "DuplicateVoteEvidence":
        """reference: types/evidence.go:58-100 (NewDuplicateVoteEvidence)."""
        if vote1 is None or vote2 is None:
            raise ValueError("missing vote")
        idx, val = val_set.get_by_address(vote1.validator_address)
        if idx == -1:
            raise ValueError("validator not in validator set")
        if vote1.block_id.key() < vote2.block_id.key():
            vote_a, vote_b = vote1, vote2
        else:
            vote_a, vote_b = vote2, vote1
        return cls(
            vote_a=vote_a,
            vote_b=vote_b,
            total_voting_power=val_set.total_voting_power(),
            validator_power=val.voting_power,
            timestamp_ns=block_time_ns,
        )

    def height(self) -> int:
        return self.vote_a.height

    def bytes(self) -> bytes:
        return self.to_proto()

    def hash(self) -> bytes:
        return tmhash.sum256(self.bytes())

    def validate_basic(self) -> None:
        if self.vote_a is None or self.vote_b is None:
            raise ValueError("empty duplicate vote evidence")
        self.vote_a.validate_basic()
        self.vote_b.validate_basic()
        if self.vote_a.block_id.key() >= self.vote_b.block_id.key():
            raise ValueError(
                "duplicate votes in invalid order (or the same block id)"
            )

    def to_proto(self) -> bytes:
        w = ProtoWriter()
        w.message(1, self.vote_a.to_proto())
        w.message(2, self.vote_b.to_proto())
        w.int(3, self.total_voting_power)
        w.int(4, self.validator_power)
        w.message(5, encode_timestamp(self.timestamp_ns))
        return w.finish()

    @classmethod
    def from_proto(cls, data: bytes) -> "DuplicateVoteEvidence":
        r = FieldReader(data)
        ts = r.get(5)
        return cls(
            vote_a=Vote.from_proto(r.get(1, b"")),
            vote_b=Vote.from_proto(r.get(2, b"")),
            total_voting_power=r.int64(3),
            validator_power=r.int64(4),
            timestamp_ns=decode_timestamp(ts) if ts is not None else 0,
        )


@dataclass
class LightClientAttackEvidence:
    """A conflicting light block trace
    (reference: types/evidence.go:230-480)."""

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
        """reference: types/evidence.go:359-366 — header hash (with its
        final byte dropped by the reference's off-by-one copy, kept for
        parity) + varint common height."""
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


Evidence = Union[DuplicateVoteEvidence, LightClientAttackEvidence]


def evidence_to_proto(ev: Evidence) -> bytes:
    """tendermint.types.Evidence oneof wrapper (duplicate=1, lca=2)."""
    w = ProtoWriter()
    if isinstance(ev, DuplicateVoteEvidence):
        w.message(1, ev.to_proto())
    elif isinstance(ev, LightClientAttackEvidence):
        w.message(2, ev.to_proto())
    else:
        raise TypeError(f"unknown evidence type {type(ev)}")
    return w.finish()


def evidence_from_proto(data: bytes) -> Evidence:
    r = FieldReader(data)
    dve = r.get(1)
    if dve is not None:
        return DuplicateVoteEvidence.from_proto(dve)
    lca = r.get(2)
    if lca is not None:
        return LightClientAttackEvidence.from_proto(lca)
    raise ValueError("evidence proto is empty")


def evidence_list_hash(evidence: List[Evidence]) -> bytes:
    """Merkle root over evidence bytes
    (reference: types/evidence.go:558-569)."""
    return merkle.hash_from_byte_slices([ev.bytes() for ev in evidence])
