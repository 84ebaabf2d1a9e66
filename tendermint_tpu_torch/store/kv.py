"""Ordered key-value stores: the substrate of the light, state and block
stores.

Counterpart: tendermint_tpu/store/kv.py: Batch, the KVStore interface and
the in-memory MemKV (:28-131), the durable SqliteKV (:132-227) and
open_db (:265, over the built-in backends; reference: tm-db, and the
`db-backend` setting of config/config.go:179-197). The JAX package's
register_backend, an extension point no caller of the port uses, is left
out. A SqliteKV writes only the file it is given.
"""

from __future__ import annotations

import os
import sqlite3
import threading
from abc import ABC, abstractmethod
from typing import Iterator, List, Optional, Tuple

__all__ = ["Batch", "KVStore", "MemKV", "SqliteKV", "open_db"]


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


class SqliteKV(KVStore):
    """SQLite-backed ordered KV (durable default backend).

    WAL mode for concurrent readers; BLOB keys preserve bytewise order
    so iteration semantics match the in-memory backend.
    """

    def __init__(self, path: str) -> None:
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._lock = threading.Lock()
        with self._lock:
            self._conn.execute("PRAGMA journal_mode=WAL")
            self._conn.execute("PRAGMA synchronous=NORMAL")
            self._conn.execute(
                "CREATE TABLE IF NOT EXISTS kv "
                "(k BLOB PRIMARY KEY, v BLOB NOT NULL) WITHOUT ROWID"
            )
            self._conn.commit()

    def get(self, key: bytes) -> Optional[bytes]:
        with self._lock:
            row = self._conn.execute(
                "SELECT v FROM kv WHERE k = ?", (bytes(key),)
            ).fetchone()
        return row[0] if row else None

    def set(self, key: bytes, value: bytes) -> None:
        with self._lock:
            self._conn.execute(
                "INSERT OR REPLACE INTO kv (k, v) VALUES (?, ?)",
                (bytes(key), bytes(value)),
            )
            self._conn.commit()

    def delete(self, key: bytes) -> None:
        with self._lock:
            self._conn.execute("DELETE FROM kv WHERE k = ?", (bytes(key),))
            self._conn.commit()

    def _range_query(self, select, start, end, reverse, limit=None):
        q = select
        cond, args = [], []
        if start is not None:
            cond.append("k >= ?")
            args.append(bytes(start))
        if end is not None:
            cond.append("k < ?")
            args.append(bytes(end))
        if cond:
            q += " WHERE " + " AND ".join(cond)
        q += " ORDER BY k" + (" DESC" if reverse else "")
        if limit is not None:
            q += f" LIMIT {int(limit)}"
        return q, args

    def iterate(self, start=None, end=None, reverse=False):
        q, args = self._range_query("SELECT k, v FROM kv", start, end, reverse)
        with self._lock:
            rows = self._conn.execute(q, args).fetchall()
        for k, v in rows:
            yield bytes(k), bytes(v)

    def first_key(self, start=None, end=None):
        q, args = self._range_query("SELECT k FROM kv", start, end, False, 1)
        with self._lock:
            row = self._conn.execute(q, args).fetchone()
        return bytes(row[0]) if row else None

    def last_key(self, start=None, end=None):
        q, args = self._range_query("SELECT k FROM kv", start, end, True, 1)
        with self._lock:
            row = self._conn.execute(q, args).fetchone()
        return bytes(row[0]) if row else None

    def write_batch(self, batch: Batch) -> None:
        with self._lock:
            for op, k, v in batch.ops:
                if op == "set":
                    self._conn.execute(
                        "INSERT OR REPLACE INTO kv (k, v) VALUES (?, ?)",
                        (k, v),
                    )
                else:
                    self._conn.execute("DELETE FROM kv WHERE k = ?", (k,))
            self._conn.commit()

    def close(self) -> None:
        with self._lock:
            self._conn.close()


# `db-backend` names: the reference's goleveldb and default map to sqlite
_MEM_BACKENDS = ("mem", "memdb")
_SQLITE_BACKENDS = ("default", "goleveldb", "sqlite")


def open_db(name: str, backend: str, db_dir: str) -> KVStore:
    """The store `name` of a `db-backend` (reference:
    config/config.go:179-197): in memory, or the SQLite file
    `<db_dir>/<name>.sqlite`."""
    if backend in _MEM_BACKENDS:
        return MemKV()
    if backend in _SQLITE_BACKENDS:
        os.makedirs(db_dir, exist_ok=True)
        return SqliteKV(os.path.join(db_dir, f"{name}.sqlite"))
    raise ValueError(
        f"unknown db backend {backend!r}; registered: "
        f"{sorted(_MEM_BACKENDS + _SQLITE_BACKENDS)}"
    )
