"""EventBus: the node's typed event backbone over pubsub.Server.

Counterpart: tendermint_tpu/eventbus/__init__.py:1-206 (reference:
internal/eventbus/event_bus.go: EventBus :24, publish with flattened
ABCI events :87, the typed helpers :113-176), with `EventBusMetrics`
(:20-70): events published, deliveries, the fanout lag, live
subscriptions and the subscriptions dropped for a full queue, fed at
every publish and subscription change when the bus has a struct
(node/node.py passes one on its per-node Registry). The step machine,
BlockExecutor, block sync and node start publish here.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional

from ..libs.metrics import DEFAULT_REGISTRY, Registry
from ..libs.service import Service
from ..pubsub import Query, Server, Subscription
from ..types import events as E

__all__ = ["EventBus", "EventBusMetrics"]


class EventBusMetrics:
    """The bus's fanout instruments (go-kit pattern; node assembly
    threads the per-node Registry). `eventbus_fanout_lag` is the deepest
    subscriber queue after the latest publish: near 0 on a healthy bus,
    climbing toward the queue limit when a subscriber cannot drain."""

    def __init__(self, registry: Optional[Registry] = None) -> None:
        r = registry if registry is not None else DEFAULT_REGISTRY
        self.published = r.counter(
            "eventbus",
            "published_total",
            "Events published onto the bus.",
        )
        self.deliveries = r.counter(
            "eventbus",
            "deliveries_total",
            "Per-subscriber deliveries (one publish fans out to every "
            "matching subscription).",
        )
        self.fanout_lag = r.gauge(
            "eventbus",
            "fanout_lag",
            "Deepest subscriber queue after the latest publish — how "
            "far the slowest live subscriber lags the publisher.",
        )
        self.subscriptions = r.gauge(
            "eventbus",
            "subscriptions",
            "Live subscriptions on the bus.",
        )
        self.dropped_subscriptions = r.counter(
            "eventbus",
            "dropped_subscriptions_total",
            "Subscriptions terminated because their bounded queue "
            "overflowed (slow consumer).",
        )


def _flatten_abci_events(abci_events: Iterable) -> Dict[str, List[str]]:
    """abci.Event list -> {"type.key": [values]} tag map (reference:
    internal/pubsub/pubsub.go, the events' flattening)."""
    tags: Dict[str, List[str]] = {}
    for ev in abci_events or ():
        if not ev.type:
            continue
        for attr in ev.attributes:
            key = f"{ev.type}.{attr.key.decode(errors='replace')}"
            tags.setdefault(key, []).append(attr.value.decode(errors="replace"))
    return tags


class EventBus(Service):
    def __init__(self, metrics: Optional[EventBusMetrics] = None) -> None:
        super().__init__(name="eventbus")
        self._server = Server(name="eventbus.pubsub")
        self.metrics = metrics

    async def on_start(self) -> None:
        await self._server.start()

    async def on_stop(self) -> None:
        await self._server.stop()

    # -- subscription --

    def _sync_sub_gauge(self) -> None:
        if self.metrics is not None:
            self.metrics.subscriptions.set(self._server.num_subscriptions())

    def subscribe(self, client_id: str, query: "Query | str", limit: int = 100) -> Subscription:
        sub = self._server.subscribe(client_id, query, limit)
        self._sync_sub_gauge()
        return sub

    def unsubscribe(self, client_id: str, query: "Query | str") -> None:
        self._server.unsubscribe(client_id, query)
        self._sync_sub_gauge()

    def unsubscribe_all(self, client_id: str) -> None:
        self._server.unsubscribe_all(client_id)
        self._sync_sub_gauge()

    # -- publishing --

    def _publish(
        self,
        event_value: str,
        data: object,
        extra_tags: Optional[Dict[str, List[str]]] = None,
    ) -> None:
        tags = dict(extra_tags or {})
        tags.setdefault(E.EVENT_TYPE_KEY, []).append(event_value)
        matched, max_depth, dropped = self._server.publish(data, tags)
        m = self.metrics
        if m is not None:
            m.published.inc()
            # deliveries: messages enqueued; a matched subscriber whose
            # queue overflowed (or was already dead) received nothing
            if matched > dropped:
                m.deliveries.inc(matched - dropped)
            m.fanout_lag.set(max_depth)
            if dropped:
                m.dropped_subscriptions.inc(dropped)
                self._sync_sub_gauge()

    def publish_new_block(self, data: E.EventDataNewBlock) -> None:
        tags = _flatten_abci_events(getattr(data.result_begin_block, "events", ()))
        for k, v in _flatten_abci_events(getattr(data.result_end_block, "events", ())).items():
            tags.setdefault(k, []).extend(v)
        tags[E.BLOCK_HEIGHT_KEY] = [str(data.block.header.height)]
        self._publish(E.EventValue.NEW_BLOCK, data, tags)

    def publish_new_block_header(self, data: E.EventDataNewBlockHeader) -> None:
        tags = {E.BLOCK_HEIGHT_KEY: [str(data.header.height)]}
        self._publish(E.EventValue.NEW_BLOCK_HEADER, data, tags)

    def publish_new_evidence(self, data: E.EventDataNewEvidence) -> None:
        self._publish(E.EventValue.NEW_EVIDENCE, data)

    def publish_tx(self, data: E.EventDataTx, tx_hash: bytes) -> None:
        """reference: internal/eventbus/event_bus.go:135-160: the app's
        DeliverTx events and the reserved tx.hash and tx.height keys."""
        tags = _flatten_abci_events(getattr(data.result, "events", ()))
        tags[E.TX_HASH_KEY] = [tx_hash.hex().upper()]
        tags[E.TX_HEIGHT_KEY] = [str(data.height)]
        self._publish(E.EventValue.TX, data, tags)

    def publish_validator_set_updates(self, data: E.EventDataValidatorSetUpdates) -> None:
        self._publish(E.EventValue.VALIDATOR_SET_UPDATES, data)

    def publish_vote(self, data: E.EventDataVote) -> None:
        self._publish(E.EventValue.VOTE, data)

    def publish_new_round(self, data: E.EventDataNewRound) -> None:
        self._publish(E.EventValue.NEW_ROUND, data)

    def publish_new_round_step(self, data: E.EventDataRoundState) -> None:
        self._publish(E.EventValue.NEW_ROUND_STEP, data)

    def publish_complete_proposal(self, data: E.EventDataCompleteProposal) -> None:
        self._publish(E.EventValue.COMPLETE_PROPOSAL, data)

    def publish_polka(self, data: E.EventDataRoundState) -> None:
        self._publish(E.EventValue.POLKA, data)

    def publish_valid_block(self, data: E.EventDataRoundState) -> None:
        self._publish(E.EventValue.VALID_BLOCK, data)

    def publish_lock(self, data: E.EventDataRoundState) -> None:
        self._publish(E.EventValue.LOCK, data)

    def publish_relock(self, data: E.EventDataRoundState) -> None:
        self._publish(E.EventValue.RELOCK, data)

    def publish_timeout_propose(self, data: E.EventDataRoundState) -> None:
        self._publish(E.EventValue.TIMEOUT_PROPOSE, data)

    def publish_timeout_wait(self, data: E.EventDataRoundState) -> None:
        self._publish(E.EventValue.TIMEOUT_WAIT, data)

    def publish_block_sync_status(self, data: E.EventDataBlockSyncStatus) -> None:
        self._publish(E.EventValue.BLOCK_SYNC_STATUS, data)

    def publish_state_sync_status(self, data: E.EventDataStateSyncStatus) -> None:
        self._publish(E.EventValue.STATE_SYNC_STATUS, data)
