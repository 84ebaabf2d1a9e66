"""Trusted light-block store.

Counterpart: tendermint_tpu/light/store.py (reference:
light/store/db/db.go), whole: verified LightBlocks keyed by big-endian
height, so a range scan runs in height order.
"""

from __future__ import annotations

import struct
from typing import Optional

from ..store.kv import KVStore
from ..types.light import LightBlock

__all__ = ["LightStore"]

_PREFIX = b"lb/"


def _key(height: int) -> bytes:
    return _PREFIX + struct.pack(">Q", height)


class LightStore:
    def __init__(self, db: KVStore) -> None:
        self.db = db

    def save_light_block(self, lb: LightBlock) -> None:
        if lb.height <= 0:
            raise ValueError("light block height must be positive")
        self.db.set(_key(lb.height), lb.to_proto())

    def light_block(self, height: int) -> Optional[LightBlock]:
        raw = self.db.get(_key(height))
        if raw is None:
            return None
        return LightBlock.from_proto(raw)

    def _heights(self) -> list:
        return [
            struct.unpack(">Q", k[len(_PREFIX):])[0]
            for k, _v in self.db.iterate(_PREFIX, _PREFIX + b"\xff")
        ]

    def latest_light_block(self) -> Optional[LightBlock]:
        heights = self._heights()
        if not heights:
            return None
        return self.light_block(max(heights))

    def first_light_block(self) -> Optional[LightBlock]:
        heights = self._heights()
        if not heights:
            return None
        return self.light_block(min(heights))

    def light_block_before(self, height: int) -> Optional[LightBlock]:
        """The latest stored block below `height`."""
        below = [h for h in self._heights() if h < height]
        if not below:
            return None
        return self.light_block(max(below))

    def delete_light_block(self, height: int) -> None:
        self.db.delete(_key(height))

    def prune(self, size: int) -> None:
        """Keep only the newest `size` blocks."""
        heights = sorted(self._heights())
        for h in heights[: max(len(heights) - size, 0)]:
            self.delete_light_block(h)

    def size(self) -> int:
        return len(self._heights())
