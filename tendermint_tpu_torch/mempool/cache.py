"""The seen-transaction cache: an LRU keyed by tx hash, guarding the app
from a second CheckTx of a recently seen tx (committed ones included).

Counterpart: tendermint_tpu/mempool/cache.py: LRUTxCache (:16-45) and
NopTxCache (:48-64); reference: internal/mempool/cache.go.
"""

from __future__ import annotations

from collections import OrderedDict

from .types import tx_key

__all__ = ["LRUTxCache", "NopTxCache"]


class LRUTxCache:
    def __init__(self, size: int) -> None:
        self._size = max(1, size)
        self._map: OrderedDict[bytes, None] = OrderedDict()

    def reset(self) -> None:
        self._map.clear()

    def push(self, tx: bytes) -> bool:
        """False if already present (then it becomes the most recent)."""
        k = tx_key(tx)
        if k in self._map:
            self._map.move_to_end(k)
            return False
        self._map[k] = None
        if len(self._map) > self._size:
            self._map.popitem(last=False)
        return True

    def remove(self, tx: bytes) -> None:
        self._map.pop(tx_key(tx), None)

    def remove_by_key(self, key: bytes) -> None:
        self._map.pop(key, None)

    def has(self, tx: bytes) -> bool:
        return tx_key(tx) in self._map

    def __len__(self) -> int:
        return len(self._map)


class NopTxCache:
    """cache_size 0: no caching (reference: cache.go NopTxCache)."""

    def reset(self) -> None: ...

    def push(self, tx: bytes) -> bool:
        return True

    def remove(self, tx: bytes) -> None: ...

    def remove_by_key(self, key: bytes) -> None: ...

    def has(self, tx: bytes) -> bool:
        return False

    def __len__(self) -> int:
        return 0
