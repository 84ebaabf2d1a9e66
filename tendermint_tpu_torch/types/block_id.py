"""BlockID and PartSetHeader.

Counterpart: tendermint_tpu/types/block_id.py (the same dataclasses and
proto round-trips).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..crypto import tmhash
from ..encoding.proto import FieldReader, ProtoWriter

__all__ = ["PartSetHeader", "BlockID"]


@dataclass(frozen=True)
class PartSetHeader:
    total: int = 0
    hash: bytes = b""

    def is_zero(self) -> bool:
        return self.total == 0 and len(self.hash) == 0

    def validate_basic(self) -> None:
        if self.hash and len(self.hash) != tmhash.SIZE:
            raise ValueError(
                f"PartSetHeader hash must be {tmhash.SIZE} bytes"
            )
        if self.total < 0:
            raise ValueError("PartSetHeader total cannot be negative")

    def to_proto(self) -> bytes:
        w = ProtoWriter()
        w.uint(1, self.total)
        w.bytes(2, self.hash)
        return w.finish()

    @classmethod
    def from_proto(cls, data: bytes) -> "PartSetHeader":
        r = FieldReader(data)
        return cls(total=r.uint(1), hash=r.bytes(2))


@dataclass(frozen=True)
class BlockID:
    hash: bytes = b""
    part_set_header: PartSetHeader = field(default_factory=PartSetHeader)

    def is_zero(self) -> bool:
        """Neither a block nil-vote target nor a complete ID."""
        return len(self.hash) == 0 and self.part_set_header.is_zero()

    def is_complete(self) -> bool:
        return (
            len(self.hash) == tmhash.SIZE
            and self.part_set_header.total > 0
            and len(self.part_set_header.hash) == tmhash.SIZE
        )

    def validate_basic(self) -> None:
        if self.hash and len(self.hash) != tmhash.SIZE:
            raise ValueError(f"BlockID hash must be {tmhash.SIZE} bytes")
        self.part_set_header.validate_basic()

    def key(self) -> bytes:
        """Map key (reference: types/block.go BlockID.Key)."""
        return self.hash + self.part_set_header.to_proto()

    def to_proto(self) -> bytes:
        w = ProtoWriter()
        w.bytes(1, self.hash)
        w.message(2, self.part_set_header.to_proto())
        return w.finish()

    @classmethod
    def from_proto(cls, data: bytes) -> "BlockID":
        r = FieldReader(data)
        psh = r.get(2)
        return cls(
            hash=r.bytes(1),
            part_set_header=(
                PartSetHeader.from_proto(psh)
                if psh is not None
                else PartSetHeader()
            ),
        )
