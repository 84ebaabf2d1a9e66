"""BlockMeta: header and sizes stored per height.

Counterpart: tendermint_tpu/types/block_meta.py:20-58 (reference:
types/block_meta.go, proto fields proto/tendermint/types/types.pb.go:904-907).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..encoding.proto import FieldReader, ProtoWriter
from .block import Block
from .block_id import BlockID
from .header import Header

__all__ = ["BlockMeta"]


@dataclass
class BlockMeta:
    block_id: BlockID = field(default_factory=BlockID)
    block_size: int = 0
    header: Header = field(default_factory=Header)
    num_txs: int = 0

    @classmethod
    def from_block(cls, block: Block, block_size: int) -> "BlockMeta":
        return cls(
            block_id=BlockID(
                hash=block.hash(),
                part_set_header=block.make_part_set().header(),
            ),
            block_size=block_size,
            header=block.header,
            num_txs=len(block.txs),
        )

    def to_proto(self) -> bytes:
        w = ProtoWriter()
        w.message(1, self.block_id.to_proto())  # nullable=false
        w.int(2, self.block_size)
        w.message(3, self.header.to_proto())  # nullable=false
        w.int(4, self.num_txs)
        return w.finish()

    @classmethod
    def from_proto(cls, data: bytes) -> "BlockMeta":
        r = FieldReader(data)
        bid = r.get(1)
        h = r.get(3)
        return cls(
            block_id=(
                BlockID.from_proto(bid) if bid is not None else BlockID()
            ),
            block_size=r.int64(2),
            header=Header.from_proto(h) if h is not None else Header(),
            num_txs=r.int64(4),
        )
