"""SQL event sink: the reference's psql sink, on sqlite3.

Counterpart: tendermint_tpu/state/sink_sql.py:1-318 (reference:
internal/state/indexer/sink/psql/{psql.go,schema.sql}), on its sqlite3
backend (DSN ``sqlite:<path>`` or ``sqlite::memory:``). The schema is the
reference's: blocks, tx_results, events and attributes with composite
keys. The JAX sink's PostgreSQL backend needs psycopg, a package the
port does not use; a ``postgres://`` DSN raises ValueError here, as it
does there when psycopg is absent.

Where the reference sink is write-only (psql.go:238-256 answers "not
supported" for every read), this one also answers the EventSink read
surface (search, get, has) over the same schema, so `tx_search` and
`block_search` keep working with the SQL sink alone.
"""

from __future__ import annotations

import datetime
import sqlite3
from typing import List, Optional, Sequence

from ..abci import types as abci
from ..pubsub.query import Query, compile_query
from ..types import events as E
from ..types.tx import tx_hash
from .indexer import EventSink, TxResult, _cond_matches

__all__ = ["SQLSink"]

_SCHEMA_SQLITE = """
CREATE TABLE IF NOT EXISTS blocks (
  rowid      INTEGER PRIMARY KEY AUTOINCREMENT,
  height     INTEGER NOT NULL,
  chain_id   TEXT NOT NULL,
  created_at TEXT NOT NULL,
  UNIQUE (height, chain_id)
);
CREATE INDEX IF NOT EXISTS idx_blocks_height_chain
  ON blocks(height, chain_id);
CREATE TABLE IF NOT EXISTS tx_results (
  rowid      INTEGER PRIMARY KEY AUTOINCREMENT,
  block_id   INTEGER NOT NULL REFERENCES blocks(rowid),
  "index"    INTEGER NOT NULL,
  created_at TEXT NOT NULL,
  tx_hash    TEXT NOT NULL,
  tx_result  BLOB NOT NULL,
  UNIQUE (block_id, "index")
);
CREATE TABLE IF NOT EXISTS events (
  rowid    INTEGER PRIMARY KEY AUTOINCREMENT,
  block_id INTEGER NOT NULL REFERENCES blocks(rowid),
  tx_id    INTEGER NULL REFERENCES tx_results(rowid),
  type     TEXT NOT NULL
);
CREATE TABLE IF NOT EXISTS attributes (
  event_id      INTEGER NOT NULL REFERENCES events(rowid),
  key           TEXT NOT NULL,
  composite_key TEXT NOT NULL,
  value         TEXT NULL
);
"""
# note: the reference schema declares UNIQUE (event_id, key) on
# attributes; dropped here deliberately — ABCI allows one event to
# repeat an attribute key with different values, the KV sink indexes
# every value, and the constraint would abort indexing on such (legal)
# events, killing the indexer task.

class SQLSink(EventSink):
    """reference: indexer/sink/psql EventSink (schema-compatible)."""

    def __init__(self, dsn: str = "sqlite::memory:", chain_id: str = "") -> None:
        self.chain_id = chain_id
        if dsn.startswith("sqlite:"):
            path = dsn[len("sqlite:"):] or ":memory:"
            self._db = sqlite3.connect(path)
            self._db.executescript(_SCHEMA_SQLITE)
        elif dsn.startswith(("postgres://", "postgresql://")):
            raise ValueError(
                "postgres DSN configured, but the SQL sink runs on "
                "sqlite3 only; use a sqlite: DSN"
            )
        else:
            raise ValueError(f"unsupported sink DSN {dsn!r}")

    def close(self) -> None:
        self._db.close()

    def type(self) -> str:
        return "psql"

    # -- helpers --

    def _exec(self, sql: str, params: tuple = ()):
        return self._db.execute(sql, params)

    def _insert_rowid(self, sql: str, params: tuple = ()) -> int:
        return self._exec(sql, params).lastrowid

    @staticmethod
    def _now() -> str:
        return datetime.datetime.now(datetime.timezone.utc).isoformat()

    def _block_rowid(self, height: int) -> Optional[int]:
        row = self._exec(
            "SELECT rowid FROM blocks WHERE height = ? AND chain_id = ?",
            (height, self.chain_id),
        ).fetchone()
        return row[0] if row else None

    def _ensure_block(self, height: int) -> int:
        """reference psql.go:154 insertBlock (idempotent per height)."""
        rowid = self._block_rowid(height)
        if rowid is not None:
            return rowid
        rowid = self._insert_rowid(
            "INSERT INTO blocks (height, chain_id, created_at) "
            "VALUES (?, ?, ?)",
            (height, self.chain_id, self._now()),
        )
        self._db.commit()
        return rowid

    def _insert_events(
        self,
        block_id: int,
        tx_id: Optional[int],
        events: Sequence[abci.Event],
        extra_attrs: Sequence[tuple] = (),
    ) -> None:
        """reference psql.go:95-143 insertEvents: only attributes the
        app marked index=true are recorded, plus the reserved keys."""
        if extra_attrs:
            event_id = self._insert_rowid(
                "INSERT INTO events (block_id, tx_id, type) VALUES (?, ?, ?)",
                (block_id, tx_id, ""),
            )
            for key, composite, value in extra_attrs:
                self._exec(
                    "INSERT INTO attributes "
                    "(event_id, key, composite_key, value) "
                    "VALUES (?, ?, ?, ?)",
                    (event_id, key, composite, value),
                )
        for ev in events or ():
            if not ev.type:
                continue
            event_id = self._insert_rowid(
                "INSERT INTO events (block_id, tx_id, type) VALUES (?, ?, ?)",
                (block_id, tx_id, ev.type),
            )
            for attr in ev.attributes:
                if not attr.index:
                    continue
                key = attr.key.decode(errors="replace")
                self._exec(
                    "INSERT INTO attributes "
                    "(event_id, key, composite_key, value) "
                    "VALUES (?, ?, ?, ?)",
                    (
                        event_id,
                        key,
                        f"{ev.type}.{key}",
                        attr.value.decode(errors="replace"),
                    ),
                )

    # -- EventSink writes --

    def index_block_events(
        self, height: int, events: Sequence[abci.Event]
    ) -> None:
        block_id = self._ensure_block(height)
        self._insert_events(block_id, None, events)
        self._db.commit()

    def index_tx_events(self, results: Sequence[TxResult]) -> None:
        """reference psql.go:182 IndexTxEvents, incl. the reserved
        tx.hash/tx.height attributes rows."""
        for tr in results:
            block_id = self._ensure_block(tr.height)
            h = tx_hash(tr.tx).hex().upper()
            cur = self._exec(
                "SELECT rowid FROM tx_results "
                'WHERE block_id = ? AND "index" = ?',
                (block_id, tr.index),
            )
            existing = cur.fetchone()
            if existing:
                continue  # already indexed (replay)
            tx_id = self._insert_rowid(
                "INSERT INTO tx_results "
                '(block_id, "index", created_at, tx_hash, tx_result) '
                "VALUES (?, ?, ?, ?, ?)",
                (block_id, tr.index, self._now(), h, tr.to_proto()),
            )
            self._insert_events(
                block_id,
                tx_id,
                tr.result.events,
                extra_attrs=[
                    ("hash", E.TX_HASH_KEY, h),
                    ("height", E.TX_HEIGHT_KEY, str(tr.height)),
                ],
            )
        self._db.commit()

    # -- EventSink reads (beyond the reference, which answers "not
    #    supported" for all of these and defers to raw SQL) --

    def get_tx_by_hash(self, h: bytes) -> Optional[TxResult]:
        # latest height wins, matching KVSink's last-write-wins when
        # the same tx bytes land at multiple heights
        row = self._exec(
            "SELECT t.tx_result FROM tx_results t "
            "JOIN blocks b ON b.rowid = t.block_id "
            "WHERE t.tx_hash = ? "
            'ORDER BY b.height DESC, t."index" DESC LIMIT 1',
            (h.hex().upper(),),
        ).fetchone()
        return TxResult.from_proto(row[0]) if row else None

    def has_block(self, height: int) -> bool:
        return self._block_rowid(height) is not None

    def _match_ids(self, cond, tx_scope: bool) -> set:
        """ids (tx rowids or block heights) whose attributes satisfy one
        query condition; value matching shares KVSink's semantics."""
        if tx_scope:
            sql = (
                "SELECT e.tx_id, a.value FROM events e "
                "JOIN attributes a ON a.event_id = e.rowid "
                "WHERE e.tx_id IS NOT NULL AND a.composite_key = ?"
            )
        else:
            sql = (
                "SELECT b.height, a.value FROM events e "
                "JOIN attributes a ON a.event_id = e.rowid "
                "JOIN blocks b ON b.rowid = e.block_id "
                "WHERE e.tx_id IS NULL AND a.composite_key = ?"
            )
        out = set()
        for ident, value in self._exec(sql, (cond.tag,)).fetchall():
            if _cond_matches(cond, value if value is not None else ""):
                out.add(ident)
        return out

    def search_tx_events(self, query: "Query | str") -> List[TxResult]:
        q = compile_query(query) if isinstance(query, str) else query
        conds = q._conditions
        if not conds:
            return []
        ids = self._match_ids(conds[0], tx_scope=True)
        for c in conds[1:]:
            ids &= self._match_ids(c, tx_scope=True)
        out: List[TxResult] = []
        for rowid in ids:
            row = self._exec(
                "SELECT tx_result FROM tx_results WHERE rowid = ?",
                (rowid,),
            ).fetchone()
            if row:
                out.append(TxResult.from_proto(row[0]))
        out.sort(key=lambda t: (t.height, t.index))
        return out

    def search_block_events(self, query: "Query | str") -> List[int]:
        q = compile_query(query) if isinstance(query, str) else query
        conds = q._conditions
        if not conds:
            return []
        sets = []
        for c in conds:
            if c.tag == E.BLOCK_HEIGHT_KEY:
                found = set()
                for (height,) in self._exec(
                    "SELECT height FROM blocks WHERE chain_id = ?",
                    (self.chain_id,),
                ).fetchall():
                    if _cond_matches(c, str(height)):
                        found.add(height)
                sets.append(found)
            else:
                sets.append(self._match_ids(c, tx_scope=False))
        ids = sets[0]
        for s in sets[1:]:
            ids &= s
        return sorted(ids)
