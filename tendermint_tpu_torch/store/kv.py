"""Ordered key-value store: the light store's substrate.

Counterpart: tendermint_tpu/store/kv.py:28-131 (Batch, the KVStore
interface and the in-memory MemKV; reference: tm-db and its memdb).
SqliteKV and open_db, the durable backend, are not ported: the port's
light client runs on MemKV.
"""

from __future__ import annotations

import threading
from abc import ABC, abstractmethod
from typing import Iterator, List, Optional, Tuple

__all__ = ["Batch", "KVStore", "MemKV"]


class Batch:
    """Write batch applied atomically via KVStore.write_batch."""

    def __init__(self) -> None:
        self.ops: List[Tuple[str, bytes, Optional[bytes]]] = []

    def set(self, key: bytes, value: bytes) -> None:
        self.ops.append(("set", bytes(key), bytes(value)))

    def delete(self, key: bytes) -> None:
        self.ops.append(("del", bytes(key), None))

    def __len__(self) -> int:
        return len(self.ops)


class KVStore(ABC):
    @abstractmethod
    def get(self, key: bytes) -> Optional[bytes]: ...

    @abstractmethod
    def set(self, key: bytes, value: bytes) -> None: ...

    @abstractmethod
    def delete(self, key: bytes) -> None: ...

    @abstractmethod
    def iterate(
        self,
        start: Optional[bytes] = None,
        end: Optional[bytes] = None,
        reverse: bool = False,
    ) -> Iterator[Tuple[bytes, bytes]]:
        """Ordered [start, end) iteration, like tm-db's Iterator."""
        ...

    @abstractmethod
    def write_batch(self, batch: Batch) -> None: ...

    @abstractmethod
    def close(self) -> None: ...

    def has(self, key: bytes) -> bool:
        return self.get(key) is not None

    def first_key(
        self, start: Optional[bytes] = None, end: Optional[bytes] = None
    ) -> Optional[bytes]:
        for k, _v in self.iterate(start, end):
            return k
        return None

    def last_key(
        self, start: Optional[bytes] = None, end: Optional[bytes] = None
    ) -> Optional[bytes]:
        for k, _v in self.iterate(start, end, reverse=True):
            return k
        return None


class MemKV(KVStore):
    """Sorted in-memory store."""

    def __init__(self) -> None:
        self._data: dict[bytes, bytes] = {}
        self._lock = threading.Lock()

    def get(self, key: bytes) -> Optional[bytes]:
        return self._data.get(key)

    def set(self, key: bytes, value: bytes) -> None:
        with self._lock:
            self._data[bytes(key)] = bytes(value)

    def delete(self, key: bytes) -> None:
        with self._lock:
            self._data.pop(key, None)

    def iterate(self, start=None, end=None, reverse=False):
        with self._lock:
            keys = sorted(self._data.keys())
        if start is not None:
            keys = [k for k in keys if k >= start]
        if end is not None:
            keys = [k for k in keys if k < end]
        if reverse:
            keys = list(reversed(keys))
        for k in keys:
            v = self._data.get(k)
            if v is not None:
                yield k, v

    def write_batch(self, batch: Batch) -> None:
        with self._lock:
            for op, k, v in batch.ops:
                if op == "set":
                    self._data[k] = v  # type: ignore[assignment]
                else:
                    self._data.pop(k, None)

    def close(self) -> None:
        pass
