"""EventBus: the node's typed event backbone over pubsub.Server.

Counterpart: tendermint_tpu/eventbus/__init__.py:83-206 (reference:
internal/eventbus/event_bus.go: EventBus :24, publish with flattened
ABCI events :87, the typed helpers :113-176), on its `metrics=None`
path: `EventBusMetrics` (published, deliveries, fanout lag, dropped
subscriptions) waits for the port's metrics library (ROADMAP item 11).
The step machine, BlockExecutor, block sync and node start publish here.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional

from ..libs.service import Service
from ..pubsub import Query, Server, Subscription
from ..types import events as E

__all__ = ["EventBus"]


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
    def __init__(self) -> None:
        super().__init__(name="eventbus")
        self._server = Server(name="eventbus.pubsub")

    async def on_start(self) -> None:
        await self._server.start()

    async def on_stop(self) -> None:
        await self._server.stop()

    # -- subscription --

    def subscribe(self, client_id: str, query: "Query | str", limit: int = 100) -> Subscription:
        return self._server.subscribe(client_id, query, limit)

    def unsubscribe(self, client_id: str, query: "Query | str") -> None:
        self._server.unsubscribe(client_id, query)

    def unsubscribe_all(self, client_id: str) -> None:
        self._server.unsubscribe_all(client_id)

    # -- publishing --

    def _publish(
        self,
        event_value: str,
        data: object,
        extra_tags: Optional[Dict[str, List[str]]] = None,
    ) -> None:
        tags = dict(extra_tags or {})
        tags.setdefault(E.EVENT_TYPE_KEY, []).append(event_value)
        self._server.publish(data, tags)

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
