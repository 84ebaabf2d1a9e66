"""PartSet: a block split into 64 KiB merkle-proven parts for gossip.

Counterpart: tendermint_tpu/types/part_set.py:24-150 (Part :24, PartSet
:58, from_data :81, add_part :123; reference: types/part_set.go, part
size types/params.go:21). Each part carries its proof from
crypto/merkle.proofs_from_byte_slices. A block within the default
21 MB cap has at most 337 parts, below the device root's gate of 512, so
its parts are hashed on the host.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from ..crypto import merkle
from ..encoding.proto import FieldReader, ProtoWriter
from ..libs.bits import BitArray
from .block_id import PartSetHeader

__all__ = ["BLOCK_PART_SIZE_BYTES", "Part", "PartSet"]

BLOCK_PART_SIZE_BYTES = 65536  # reference: types/params.go:21


@dataclass
class Part:
    index: int
    bytes: bytes
    proof: merkle.Proof

    def validate_basic(self) -> None:
        if len(self.bytes) > BLOCK_PART_SIZE_BYTES:
            raise ValueError(
                f"too big: {len(self.bytes)} bytes, "
                f"max: {BLOCK_PART_SIZE_BYTES}"
            )

    def to_proto(self) -> bytes:
        w = ProtoWriter()
        w.uint(1, self.index)
        w.bytes(2, self.bytes)
        w.message(3, self.proof.to_proto_bytes())  # nullable=false
        return w.finish()

    @classmethod
    def from_proto(cls, data: bytes) -> "Part":
        r = FieldReader(data)
        proof = r.get(3)
        return cls(
            index=r.uint(1),
            bytes=r.bytes(2),
            proof=(
                merkle.Proof.from_proto_bytes(proof)
                if proof is not None
                else merkle.Proof(total=0, index=0, leaf_hash=b"")
            ),
        )


class PartSet:
    """Either built complete from data (proposer side) or filled part by
    part against a trusted header (gossip receiver side)."""

    def __init__(
        self,
        total: int,
        hash_: bytes,
        parts: List[Optional[Part]],
        count: int,
        byte_size: int,
    ) -> None:
        self.total = total
        self.hash = hash_
        self.parts = parts
        self.parts_bit_array = BitArray(total)
        for i, p in enumerate(parts):
            if p is not None:
                self.parts_bit_array.set(i, True)
        self.count = count
        self.byte_size = byte_size

    @classmethod
    def from_data(
        cls, data: bytes, part_size: int = BLOCK_PART_SIZE_BYTES
    ) -> "PartSet":
        """Split + merkle-prove (reference: types/part_set.go:166-194)."""
        total = max(1, (len(data) + part_size - 1) // part_size)
        chunks = [
            data[i * part_size : (i + 1) * part_size] for i in range(total)
        ]
        root, proofs = merkle.proofs_from_byte_slices(chunks)
        parts: List[Optional[Part]] = [
            Part(index=i, bytes=chunks[i], proof=proofs[i])
            for i in range(total)
        ]
        return cls(
            total=total,
            hash_=root,
            parts=parts,
            count=total,
            byte_size=len(data),
        )

    @classmethod
    def from_header(cls, header: PartSetHeader) -> "PartSet":
        return cls(
            total=header.total,
            hash_=header.hash,
            parts=[None] * header.total,
            count=0,
            byte_size=0,
        )

    def header(self) -> PartSetHeader:
        return PartSetHeader(total=self.total, hash=self.hash)

    def get_part(self, index: int) -> Optional[Part]:
        if 0 <= index < self.total:
            return self.parts[index]
        return None

    def add_part(self, part: Part) -> bool:
        """Verify the part's proof against our hash and absorb it.
        Returns False if already present
        (reference: types/part_set.go:283-320)."""
        if part.index >= self.total:
            raise ValueError("error part set unexpected index")
        if self.parts[part.index] is not None:
            return False
        try:
            part.proof.verify(self.hash, part.bytes)
        except ValueError as e:
            raise ValueError(f"error part set invalid proof: {e}") from e
        part.validate_basic()
        self.parts[part.index] = part
        self.parts_bit_array.set(part.index, True)
        self.count += 1
        self.byte_size += len(part.bytes)
        return True

    def is_complete(self) -> bool:
        return self.count == self.total

    def assemble(self) -> bytes:
        """Concatenate all part bytes (reference reads via
        GetReader/MarshalTo)."""
        if not self.is_complete():
            raise ValueError("part set is not complete")
        return b"".join(p.bytes for p in self.parts)  # type: ignore[union-attr]
