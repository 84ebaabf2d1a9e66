"""BlockStore: blocks stored as meta, parts and commits by height.

Counterpart: tendermint_tpu/store/block_store.py:52-219 (loads, save_block
:125, save_signed_header :168, prune_blocks :194; reference:
internal/store/store.go, key scheme :584-640). Keys are a prefix byte and
the big-endian height, so iteration goes by height. save_signed_header
is the header-only store of state sync's base and backfill. Left out:
save_seen_commit (:188), which no port module calls.
"""

from __future__ import annotations

import struct
import threading
from typing import Optional

from ..types.block import Block
from ..types.block_id import BlockID
from ..types.block_meta import BlockMeta
from ..types.commit import Commit
from ..types.light import SignedHeader
from ..types.part_set import Part, PartSet
from .kv import Batch, KVStore

__all__ = ["BlockStore"]

_META = b"\x00"
_PART = b"\x01"
_COMMIT = b"\x02"
_SEEN_COMMIT = b"\x03"
_HASH = b"\x04"


def _meta_key(height: int) -> bytes:
    return _META + struct.pack(">q", height)


def _part_key(height: int, index: int) -> bytes:
    return _PART + struct.pack(">qi", height, index)


def _commit_key(height: int) -> bytes:
    return _COMMIT + struct.pack(">q", height)


def _seen_commit_key() -> bytes:
    return _SEEN_COMMIT


def _hash_key(h: bytes) -> bytes:
    return _HASH + h


class BlockStore:
    def __init__(self, db: KVStore) -> None:
        self._db = db
        self._lock = threading.Lock()

    # -- range info --

    def base(self) -> int:
        """Lowest stored height, 0 if empty
        (reference: internal/store/store.go:44)."""
        k = self._db.first_key(_meta_key(1), _meta_key((1 << 62)))
        if k is None:
            return 0
        return struct.unpack(">q", k[1:9])[0]

    def height(self) -> int:
        """Highest stored height, 0 if empty."""
        k = self._db.last_key(_meta_key(1), _meta_key((1 << 62)))
        if k is None:
            return 0
        return struct.unpack(">q", k[1:9])[0]

    def size(self) -> int:
        h = self.height()
        return 0 if h == 0 else h - self.base() + 1

    # -- loads --

    def load_block_meta(self, height: int) -> Optional[BlockMeta]:
        data = self._db.get(_meta_key(height))
        return BlockMeta.from_proto(data) if data is not None else None

    def load_block_meta_by_hash(self, h: bytes) -> Optional[BlockMeta]:
        height_bytes = self._db.get(_hash_key(h))
        if height_bytes is None:
            return None
        return self.load_block_meta(struct.unpack(">q", height_bytes)[0])

    def load_block(self, height: int) -> Optional[Block]:
        meta = self.load_block_meta(height)
        if meta is None:
            return None
        buf = b""
        for i in range(meta.block_id.part_set_header.total):
            part = self.load_block_part(height, i)
            if part is None:
                return None
            buf += part.bytes
        return Block.from_proto(buf)

    def load_block_by_hash(self, h: bytes) -> Optional[Block]:
        meta = self.load_block_meta_by_hash(h)
        if meta is None:
            return None
        return self.load_block(meta.header.height)

    def load_block_part(self, height: int, index: int) -> Optional[Part]:
        data = self._db.get(_part_key(height, index))
        return Part.from_proto(data) if data is not None else None

    def load_block_commit(self, height: int) -> Optional[Commit]:
        """The commit for `height` as included in block height+1."""
        data = self._db.get(_commit_key(height))
        return Commit.from_proto(data) if data is not None else None

    def load_seen_commit(self) -> Optional[Commit]:
        """Locally-seen commit for the latest height (may differ in
        round from the canonical LastCommit)."""
        data = self._db.get(_seen_commit_key())
        return Commit.from_proto(data) if data is not None else None

    # -- saves --

    def save_block(
        self, block: Block, block_parts: PartSet, seen_commit: Commit
    ) -> None:
        """reference: internal/store/store.go:449-530."""
        if block is None:
            raise ValueError("BlockStore can only save a non-nil block")
        with self._lock:
            height = block.header.height
            expected = self.height() + 1
            if self.height() > 0 and height != expected:
                raise ValueError(
                    f"cannot save block at height {height}, expected "
                    f"{expected}"
                )
            if not block_parts.is_complete():
                raise ValueError(
                    "cannot save complete block with incomplete parts"
                )
            batch = Batch()
            meta = BlockMeta(
                block_id=BlockID(
                    hash=block.hash(),
                    part_set_header=block_parts.header(),
                ),
                block_size=block.size(),
                header=block.header,
                num_txs=len(block.txs),
            )
            batch.set(_meta_key(height), meta.to_proto())
            batch.set(
                _hash_key(block.hash()), struct.pack(">q", height)
            )
            for i in range(block_parts.total):
                part = block_parts.get_part(i)
                batch.set(_part_key(height, i), part.to_proto())
            if block.last_commit is not None:
                batch.set(
                    _commit_key(height - 1),
                    block.last_commit.to_proto(),
                )
            batch.set(_seen_commit_key(), seen_commit.to_proto())
            self._db.write_batch(batch)

    def save_signed_header(
        self, sh: SignedHeader, block_id: BlockID
    ) -> None:
        """Backfill (reverse-sync) storage of header+commit without the
        full block (reference: internal/store/store.go:533-570)."""
        height = sh.header.height
        with self._lock:
            if self.load_block_meta(height) is not None:
                raise ValueError(
                    f"block meta already exists at height {height}"
                )
            batch = Batch()
            meta = BlockMeta(
                block_id=block_id, block_size=-1, header=sh.header, num_txs=-1
            )
            batch.set(_meta_key(height), meta.to_proto())
            batch.set(_commit_key(height - 1), sh.commit.to_proto())
            batch.set(_hash_key(sh.header.hash()), struct.pack(">q", height))
            self._db.write_batch(batch)

    # -- pruning --

    def prune_blocks(self, retain_height: int) -> int:
        """Remove all blocks below retain_height; returns count pruned
        (reference: internal/store/store.go:307-380)."""
        if retain_height <= 0:
            raise ValueError("height must be greater than 0")
        if retain_height > self.height():
            raise ValueError(
                f"height must be <= latest height {self.height()}"
            )
        base = self.base()
        if retain_height < base:
            return 0
        pruned = 0
        batch = Batch()
        for h in range(base, retain_height):
            meta = self.load_block_meta(h)
            if meta is None:
                continue
            batch.delete(_meta_key(h))
            batch.delete(_hash_key(meta.block_id.hash))
            batch.delete(_commit_key(h))
            for i in range(meta.block_id.part_set_header.total):
                batch.delete(_part_key(h, i))
            pruned += 1
        self._db.write_batch(batch)
        return pruned
