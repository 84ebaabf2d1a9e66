"""Event indexer: block and tx event sinks feeding tx_search and
block_search.

Counterpart: tendermint_tpu/state/indexer.py:1-336 (reference:
internal/state/indexer/: the EventSink interface eventsink.go:26, the kv
sink indexer/sink/kv, the null sink, IndexerService
indexer_service.go:20-90). The KV sink indexes events whose attributes
the app marked `index: true`, plus the reserved tx.hash and tx.height
keys, and answers the query language of the event bus. A TxResult's
ResponseDeliverTx is encoded by abci/codec.py, byte-equal to the JAX
codec's. No device call runs here.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from ..abci import types as abci
from ..abci.codec import dec_resp_deliver_tx, enc_resp_deliver_tx
from ..encoding.proto import FieldReader, ProtoWriter
from ..eventbus import EventBus
from ..libs.service import Service
from ..pubsub import SubscriptionError
from ..pubsub.query import Query, compile_query
from ..store.kv import KVStore
from ..types import events as E
from ..types.tx import tx_hash

__all__ = ["TxResult", "EventSink", "KVSink", "NullSink", "IndexerService"]


@dataclass
class TxResult:
    """reference: proto/tendermint/abci/types.pb.go TxResult."""

    height: int
    index: int
    tx: bytes
    result: abci.ResponseDeliverTx

    def to_proto(self) -> bytes:
        w = ProtoWriter()
        w.int(1, self.height)
        w.uint(2, self.index)
        w.bytes(3, self.tx)
        w.message(4, enc_resp_deliver_tx(self.result))
        return w.finish()

    @classmethod
    def from_proto(cls, data: bytes) -> "TxResult":
        r = FieldReader(data)
        return cls(
            height=r.int64(1),
            index=r.uint(2),
            tx=r.bytes(3),
            result=dec_resp_deliver_tx(r.bytes(4)),
        )


class EventSink:
    """reference: internal/state/indexer/eventsink.go:26-42."""

    def type(self) -> str:
        raise NotImplementedError

    def index_block_events(self, height: int, events: Sequence[abci.Event]) -> None:
        raise NotImplementedError

    def index_tx_events(self, results: Sequence[TxResult]) -> None:
        raise NotImplementedError

    def search_tx_events(self, query: "Query | str") -> List[TxResult]:
        raise NotImplementedError

    def search_block_events(self, query: "Query | str") -> List[int]:
        raise NotImplementedError

    def get_tx_by_hash(self, h: bytes) -> Optional[TxResult]:
        raise NotImplementedError

    def has_block(self, height: int) -> bool:
        raise NotImplementedError


class NullSink(EventSink):
    """reference: indexer/sink/null."""

    def type(self) -> str:
        return "null"

    def index_block_events(self, height, events) -> None: ...

    def index_tx_events(self, results) -> None: ...

    def search_tx_events(self, query) -> List[TxResult]:
        return []

    def search_block_events(self, query) -> List[int]:
        return []

    def get_tx_by_hash(self, h) -> Optional[TxResult]:
        return None

    def has_block(self, height: int) -> bool:
        return False


_TX_BY_HASH = b"th/"
_TX_INDEX = b"ti/"
_BLOCK_INDEX = b"bi/"
_SEP = b"\x00"


def _esc(s: str) -> bytes:
    """Escape tag/value bytes so the 0x00 key separator cannot appear
    inside them (0x00 → 0x01 0x01, 0x01 → 0x01 0x02)."""
    raw = s.encode(errors="replace")
    return raw.replace(b"\x01", b"\x01\x02").replace(b"\x00", b"\x01\x01")


def _unesc(raw: bytes) -> str:
    return (
        raw.replace(b"\x01\x01", b"\x00")
        .replace(b"\x01\x02", b"\x01")
        .decode(errors="replace")
    )


def _indexed_attrs(events: Sequence[abci.Event]) -> List[Tuple[str, str]]:
    out = []
    for ev in events or ():
        if not ev.type:
            continue
        for attr in ev.attributes:
            if attr.index:
                out.append(
                    (
                        f"{ev.type}.{attr.key.decode(errors='replace')}",
                        attr.value.decode(errors="replace"),
                    )
                )
    return out


class KVSink(EventSink):
    """Embedded-KV event sink (reference: indexer/sink/kv/kv.go)."""

    def __init__(self, db: KVStore) -> None:
        self._db = db

    def type(self) -> str:
        return "kv"

    # -- writes --

    def index_block_events(
        self, height: int, events: Sequence[abci.Event]
    ) -> None:
        hb = struct.pack(">q", height)
        self._db.set(_BLOCK_INDEX + b"height/" + hb, hb)
        for tag, value in _indexed_attrs(events):
            self._db.set(
                _BLOCK_INDEX + _esc(tag) + _SEP + _esc(value) + _SEP + hb,
                hb,
            )

    def index_tx_events(self, results: Sequence[TxResult]) -> None:
        for tr in results:
            h = tx_hash(tr.tx)
            self._db.set(_TX_BY_HASH + h, tr.to_proto())
            pos = struct.pack(">qI", tr.height, tr.index)
            pairs = _indexed_attrs(tr.result.events)
            pairs.append((E.TX_HEIGHT_KEY, str(tr.height)))
            pairs.append((E.TX_HASH_KEY, h.hex().upper()))
            for tag, value in pairs:
                self._db.set(
                    _TX_INDEX + _esc(tag) + _SEP + _esc(value) + _SEP + pos,
                    h,
                )

    # -- reads --

    def get_tx_by_hash(self, h: bytes) -> Optional[TxResult]:
        data = self._db.get(_TX_BY_HASH + h)
        return TxResult.from_proto(data) if data is not None else None

    def has_block(self, height: int) -> bool:
        return self._db.has(
            _BLOCK_INDEX + b"height/" + struct.pack(">q", height)
        )

    def _scan_condition(self, prefix: bytes, cond) -> Dict[bytes, bytes]:
        """tag-index scan → {position_key: payload} for entries whose value
        satisfies the condition."""
        base = prefix + _esc(cond.tag) + _SEP
        out: Dict[bytes, bytes] = {}
        if cond.op == "=" and isinstance(cond.arg, str):
            exact = base + _esc(cond.arg) + _SEP
            for k, v in self._db.iterate(exact, exact + b"\xff"):
                out[k[len(exact):]] = v
            return out
        for k, v in self._db.iterate(base, base + b"\xff"):
            rest = k[len(base):]
            value, _, pos = rest.partition(_SEP)
            if _cond_matches(cond, _unesc(value)):
                out[pos] = v
        return out

    def search_tx_events(self, query: "Query | str") -> List[TxResult]:
        q = compile_query(query) if isinstance(query, str) else query
        conds = q._conditions
        if not conds:
            return []
        sets = [self._scan_condition(_TX_INDEX, c) for c in conds]
        keys = set(sets[0])
        for s in sets[1:]:
            keys &= set(s)
        hashes = {sets[0][k] for k in keys}
        out = []
        for h in hashes:
            tr = self.get_tx_by_hash(h)
            if tr is not None:
                out.append(tr)
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
                # height is indexed positionally under bi/height/
                found = {}
                base = _BLOCK_INDEX + b"height/"
                for k, v in self._db.iterate(base, base + b"\xff"):
                    height = struct.unpack(">q", v)[0]
                    if _cond_matches(c, str(height)):
                        found[v] = v
                sets.append(found)
            else:
                sets.append(self._scan_condition(_BLOCK_INDEX, c))
        keys = set(sets[0])
        for s in sets[1:]:
            keys &= set(s)
        heights = sorted(
            struct.unpack(">q", sets[0][k])[0] for k in keys
        )
        return heights


def _cond_matches(cond, value: str) -> bool:
    return cond.matches([value])


class IndexerService(Service):
    """Subscribes to the event bus and feeds every sink
    (reference: internal/state/indexer/indexer_service.go:20-90)."""

    def __init__(self, sinks: List[EventSink], event_bus: EventBus) -> None:
        super().__init__(name="indexer")
        self.sinks = sinks
        self.bus = event_bus

    async def on_start(self) -> None:
        self._resubscribe("block")
        self._resubscribe("tx")
        self.spawn(self._index_blocks())
        self.spawn(self._index_txs())

    async def on_stop(self) -> None:
        try:
            self.bus.unsubscribe_all("indexer")
        except Exception:
            pass

    async def _index_blocks(self) -> None:
        await self._consume("block", lambda: self._block_sub, self._on_block)

    async def _index_txs(self) -> None:
        await self._consume("tx", lambda: self._tx_sub, self._on_tx)

    async def _consume(self, kind: str, get_sub, handler) -> None:
        """Drain a subscription forever. A sink error is logged, not fatal
        (one bad height must not kill indexing); a queue-overflow
        termination resubscribes loudly instead of silently stopping."""
        while self.is_running:
            try:
                msg = await get_sub().next()
            except SubscriptionError as e:
                if not self.is_running or str(e) in (
                    "unsubscribed", "server stopped"
                ):
                    return  # clean shutdown paths, not a lost subscription
                self.logger.error(
                    "%s subscription lost; resubscribing "
                    "(events in the gap are not indexed) err=%s",
                    kind,
                    e,
                )
                self._resubscribe(kind)
                continue
            try:
                handler(msg.data)
            except Exception:
                # a sink error, logged: one bad height must not end
                # indexing (no device call runs under this catch)
                self.logger.exception("failed to index %s events", kind)

    def _resubscribe(self, kind: str) -> None:
        if kind == "block":
            self._block_sub = self.bus.subscribe(
                "indexer",
                f"{E.EVENT_TYPE_KEY} = '{E.EventValue.NEW_BLOCK}'",
                limit=1000,
            )
        else:
            self._tx_sub = self.bus.subscribe(
                "indexer",
                f"{E.EVENT_TYPE_KEY} = '{E.EventValue.TX}'",
                limit=10000,
            )

    def _on_block(self, data) -> None:
        events = []
        for src in (data.result_begin_block, data.result_end_block):
            events.extend(getattr(src, "events", ()) or ())
        for sink in self.sinks:
            sink.index_block_events(data.block.header.height, events)

    def _on_tx(self, data) -> None:
        tr = TxResult(
            height=data.height,
            index=data.index,
            tx=data.tx,
            result=data.result,
        )
        for sink in self.sinks:
            sink.index_tx_events([tr])
