"""Block header and its field-merkle hash.

Counterpart: tendermint_tpu/types/header.py:25-193 (Consensus, Header,
its hash over the proto encodings of the 14 fields in declaration order,
validate_basic and the proto form; reference: types/block.go:330-520,
the cdcEncode helper of types/encoding_helper.go).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..crypto import merkle, tmhash
from ..encoding.proto import FieldReader, ProtoWriter
from .block_id import BlockID
from .timestamp import decode_timestamp, encode_timestamp

__all__ = ["BLOCK_PROTOCOL", "Consensus", "Header"]

BLOCK_PROTOCOL = 11  # reference: version/version.go:27


@dataclass(frozen=True)
class Consensus:
    """Block and app protocol versions."""

    block: int = BLOCK_PROTOCOL
    app: int = 0

    def to_proto(self) -> bytes:
        w = ProtoWriter()
        w.uint(1, self.block)
        w.uint(2, self.app)
        return w.finish()

    @classmethod
    def from_proto(cls, data: bytes) -> "Consensus":
        r = FieldReader(data)
        return cls(block=r.uint(1), app=r.uint(2))


def _cdc_bytes(value: bytes) -> bytes:
    """gogotypes.BytesValue{Value: v}.Marshal(): empty for empty."""
    if not value:
        return b""
    w = ProtoWriter()
    w.bytes(1, value)
    return w.finish()


def _cdc_string(value: str) -> bytes:
    if not value:
        return b""
    w = ProtoWriter()
    w.string(1, value)
    return w.finish()


def _cdc_int64(value: int) -> bytes:
    if not value:
        return b""
    w = ProtoWriter()
    w.int(1, value)
    return w.finish()


_HASHES = (
    "last_commit_hash",
    "data_hash",
    "evidence_hash",
    "validators_hash",
    "next_validators_hash",
    "consensus_hash",
    "last_results_hash",
)


@dataclass
class Header:
    version: Consensus = field(default_factory=Consensus)
    chain_id: str = ""
    height: int = 0
    time_ns: int = 0
    last_block_id: BlockID = field(default_factory=BlockID)
    last_commit_hash: bytes = b""
    data_hash: bytes = b""
    validators_hash: bytes = b""
    next_validators_hash: bytes = b""
    consensus_hash: bytes = b""
    app_hash: bytes = b""
    last_results_hash: bytes = b""
    evidence_hash: bytes = b""
    proposer_address: bytes = b""

    # every field is a leaf of the hash, so assigning any attribute (the
    # dataclass __init__ included) drops the memo
    def __setattr__(self, name: str, value) -> None:
        self.__dict__.pop("_hash_memo", None)
        object.__setattr__(self, name, value)

    def hash(self) -> bytes:
        """Merkle root of the 14 fields in declaration order; empty while
        validators_hash is (a header not yet filled in). Memoized: a
        light sync hashes each header several times."""
        if not self.validators_hash:
            return b""
        memo = self.__dict__.get("_hash_memo")
        if memo is not None:
            return memo
        leaves = [
            self.version.to_proto(),
            _cdc_string(self.chain_id),
            _cdc_int64(self.height),
            encode_timestamp(self.time_ns),
            self.last_block_id.to_proto(),
            _cdc_bytes(self.last_commit_hash),
            _cdc_bytes(self.data_hash),
            _cdc_bytes(self.validators_hash),
            _cdc_bytes(self.next_validators_hash),
            _cdc_bytes(self.consensus_hash),
            _cdc_bytes(self.app_hash),
            _cdc_bytes(self.last_results_hash),
            _cdc_bytes(self.evidence_hash),
            _cdc_bytes(self.proposer_address),
        ]
        h = merkle.hash_from_byte_slices(leaves)
        self.__dict__["_hash_memo"] = h
        return h

    def validate_basic(self) -> None:
        if len(self.chain_id) > 50:
            raise ValueError("chainID is too long")
        if self.height < 0:
            raise ValueError("negative Height")
        if self.height == 0:
            raise ValueError("zero Height")
        self.last_block_id.validate_basic()
        for name in _HASHES:
            h = getattr(self, name)
            if h and len(h) != tmhash.SIZE:
                raise ValueError(f"wrong {name}: expected size {tmhash.SIZE}")
        if len(self.proposer_address) != 20:
            raise ValueError("invalid ProposerAddress length")

    def to_proto(self) -> bytes:
        w = ProtoWriter()
        w.message(1, self.version.to_proto())  # nullable=false
        w.string(2, self.chain_id)
        w.int(3, self.height)
        w.message(4, encode_timestamp(self.time_ns))
        w.message(5, self.last_block_id.to_proto())
        w.bytes(6, self.last_commit_hash)
        w.bytes(7, self.data_hash)
        w.bytes(8, self.validators_hash)
        w.bytes(9, self.next_validators_hash)
        w.bytes(10, self.consensus_hash)
        w.bytes(11, self.app_hash)
        w.bytes(12, self.last_results_hash)
        w.bytes(13, self.evidence_hash)
        w.bytes(14, self.proposer_address)
        return w.finish()

    @classmethod
    def from_proto(cls, data: bytes) -> "Header":
        r = FieldReader(data)
        ver = r.get(1)
        ts = r.get(4)
        bid = r.get(5)
        return cls(
            version=Consensus.from_proto(ver) if ver is not None else Consensus(0, 0),
            chain_id=r.string(2),
            height=r.int64(3),
            time_ns=decode_timestamp(ts) if ts is not None else 0,
            last_block_id=(
                BlockID.from_proto(bid) if bid is not None else BlockID()
            ),
            last_commit_hash=r.bytes(6),
            data_hash=r.bytes(7),
            validators_hash=r.bytes(8),
            next_validators_hash=r.bytes(9),
            consensus_hash=r.bytes(10),
            app_hash=r.bytes(11),
            last_results_hash=r.bytes(12),
            evidence_hash=r.bytes(13),
            proposer_address=r.bytes(14),
        )
