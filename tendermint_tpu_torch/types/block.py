"""Block: Header + Data(Txs) + Evidence + LastCommit.

Counterpart: tendermint_tpu/types/block.py:1-186 (max_data_bytes :39,
Block :73 with fill_header, hash, make_part_set, validate_basic and the
proto form, make_block :172; reference: types/block.go, proto field
numbers proto/tendermint/types/block.pb.go:27-30). With
ops.merkle_kernel installed, the data hash of a block of at least 512
transactions and the hash of a LastCommit of at least 512 signatures
are roots on the card (kernel X4); the header's 14 fields stay on the
host. hashes_to and max_data_bytes_no_evidence, which no caller of the
port uses, are left out.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from ..encoding.proto import FieldReader, ProtoWriter, iter_fields
from .block_id import BlockID
from .commit import Commit, max_commit_bytes
from .evidence import (
    Evidence,
    evidence_from_proto,
    evidence_list_hash,
    evidence_to_proto,
)
from .header import Consensus, Header
from .part_set import BLOCK_PART_SIZE_BYTES, PartSet
from .tx import txs_hash

__all__ = [
    "Block",
    "make_block",
    "MAX_HEADER_BYTES",
    "MAX_OVERHEAD_FOR_BLOCK",
    "max_data_bytes",
]

MAX_HEADER_BYTES = 626  # reference: types/block.go:28
MAX_OVERHEAD_FOR_BLOCK = 11  # reference: types/block.go:38


def max_data_bytes(
    max_bytes: int, evidence_bytes: int, vals_count: int
) -> int:
    """reference: types/block.go:264-283."""
    md = (
        max_bytes
        - MAX_OVERHEAD_FOR_BLOCK
        - MAX_HEADER_BYTES
        - max_commit_bytes(vals_count)
        - evidence_bytes
    )
    if md < 0:
        raise ValueError(
            f"negative MaxDataBytes: Block.MaxBytes={max_bytes} too small"
        )
    return md


@dataclass
class Block:
    header: Header = field(default_factory=Header)
    txs: List[bytes] = field(default_factory=list)
    evidence: List[Evidence] = field(default_factory=list)
    last_commit: Optional[Commit] = None

    def fill_header(self) -> None:
        """Populate derived header hashes (reference: types/block.go:98)."""
        h = self.header
        if not h.last_commit_hash and self.last_commit is not None:
            h.last_commit_hash = self.last_commit.hash()
        if not h.data_hash:
            h.data_hash = txs_hash(self.txs)
        if not h.evidence_hash:
            h.evidence_hash = evidence_list_hash(self.evidence)

    def hash(self) -> bytes:
        """Header hash; empty if the block is incomplete
        (reference: types/block.go:112-124)."""
        if self.last_commit is None:
            return b""
        self.fill_header()
        return self.header.hash()

    def make_part_set(
        self, part_size: int = BLOCK_PART_SIZE_BYTES
    ) -> PartSet:
        return PartSet.from_data(self.to_proto(), part_size)

    def block_id(self, part_size: int = BLOCK_PART_SIZE_BYTES) -> BlockID:
        return BlockID(
            hash=self.hash(),
            part_set_header=self.make_part_set(part_size).header(),
        )

    def size(self) -> int:
        return len(self.to_proto())

    def validate_basic(self) -> None:
        """reference: types/block.go:52-96. Validates the header as
        received — no backfilling, so absent hashes fail the equality
        checks instead of being silently computed."""
        h = self.header
        h.validate_basic()
        if self.last_commit is None:
            if h.height != 1:
                raise ValueError("nil LastCommit")
        else:
            self.last_commit.validate_basic()
            if h.last_commit_hash != self.last_commit.hash():
                raise ValueError("wrong Header.LastCommitHash")
        if h.data_hash != txs_hash(self.txs):
            raise ValueError("wrong Header.DataHash")
        if h.evidence_hash != evidence_list_hash(self.evidence):
            raise ValueError("wrong Header.EvidenceHash")

    def to_proto(self) -> bytes:
        w = ProtoWriter()
        w.message(1, self.header.to_proto())  # nullable=false
        data = ProtoWriter()
        for tx in self.txs:
            data.bytes(1, tx)
        w.message(2, data.finish())  # nullable=false
        ev = ProtoWriter()
        for e in self.evidence:
            ev.message(1, evidence_to_proto(e))
        w.message(3, ev.finish())  # nullable=false
        if self.last_commit is not None:
            w.message(4, self.last_commit.to_proto())
        return w.finish()

    @classmethod
    def from_proto(cls, data: bytes) -> "Block":
        r = FieldReader(data)
        header = Header.from_proto(r.get(1, b""))
        txs: List[bytes] = []
        d = r.get(2)
        if d:
            txs = [v for f, _wt, v in iter_fields(d) if f == 1]
        evidence: List[Evidence] = []
        e = r.get(3)
        if e:
            evidence = [
                evidence_from_proto(v)
                for f, _wt, v in iter_fields(e)
                if f == 1
            ]
        lc = r.get(4)
        return cls(
            header=header,
            txs=txs,
            evidence=evidence,
            last_commit=Commit.from_proto(lc) if lc is not None else None,
        )


def make_block(
    height: int,
    txs: List[bytes],
    last_commit: Optional[Commit],
    evidence: List[Evidence],
) -> Block:
    """reference: types/block.go:310-325."""
    block = Block(
        header=Header(version=Consensus(), height=height),
        txs=list(txs),
        evidence=list(evidence),
        last_commit=last_commit,
    )
    block.fill_header()
    return block
