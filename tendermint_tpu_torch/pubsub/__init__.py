"""Query-addressed publish/subscribe.

Counterpart: tendermint_tpu/pubsub/__init__.py:1-227 (reference:
internal/pubsub/pubsub.go: Server :105, SubscribeWithArgs :188, the
publish fan-out :292-344). Subscribers register a client id and a
compiled query; a published message carries event tags and reaches
every subscription whose query matches it. Each subscription owns a
bounded queue: a subscriber that overflows it is terminated with an
error (reference: internal/pubsub/subscription.go), so one laggard
cannot stall the consensus loop's publishing. The fan-out evaluates
each distinct query once a publish and hands one shared Message to its
whole group, as the JAX package does.
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..libs.service import Service
from .query import Query, compile_query  # noqa: F401

__all__ = [
    "Message",
    "Subscription",
    "Server",
    "SubscriptionError",
    "ERR_TERMINATED",
    "Query",
    "compile_query",
]

ERR_TERMINATED = "subscription terminated: queue overflow"

# Pushed into a subscription's queue on termination so a consumer blocked
# in `await get()` wakes immediately instead of polling. On queue-overflow
# termination the queue is full (consumer not blocked), so the sentinel
# being undeliverable there is fine: the consumer hits the terminated
# check after draining.
_SENTINEL = object()


class SubscriptionError(Exception):
    pass


@dataclass(frozen=True)
class Message:
    """What a subscriber receives: the payload plus the tag map it matched."""

    data: object
    events: Dict[str, List[str]] = field(default_factory=dict)


class Subscription:
    """A single subscriber feed with a bounded buffer."""

    def __init__(self, client_id: str, query: Query, limit: int = 100) -> None:
        self.client_id = client_id
        self.query = query
        self._queue: asyncio.Queue = asyncio.Queue(maxsize=max(1, limit))
        self._terminated: Optional[str] = None

    def _deliver(self, msg: Message) -> bool:
        if self._terminated:
            return False
        try:
            self._queue.put_nowait(msg)
            return True
        except asyncio.QueueFull:
            self._terminated = ERR_TERMINATED
            return False

    def _terminate(self, reason: str) -> None:
        if not self._terminated:
            self._terminated = reason
            try:
                self._queue.put_nowait(_SENTINEL)
            except asyncio.QueueFull:
                pass  # consumer isn't blocked; it'll see _terminated

    async def next(self) -> Message:
        """Await the next matching message; raises SubscriptionError once
        terminated and drained. Event-driven — no polling."""
        while True:
            try:
                msg = self._queue.get_nowait()
            except asyncio.QueueEmpty:
                if self._terminated:
                    raise SubscriptionError(self._terminated)
                msg = await self._queue.get()
            if msg is _SENTINEL:
                raise SubscriptionError(self._terminated or "terminated")
            return msg

    def next_nowait(self) -> Optional[Message]:
        """The next queued message, or None when none is queued; raises
        SubscriptionError once terminated and drained."""
        try:
            msg = self._queue.get_nowait()
        except asyncio.QueueEmpty:
            if self._terminated:
                raise SubscriptionError(self._terminated)
            return None
        if msg is _SENTINEL:
            raise SubscriptionError(self._terminated or "terminated")
        return msg

    def __aiter__(self):
        return self

    async def __anext__(self) -> Message:
        try:
            return await self.next()
        except SubscriptionError:
            raise StopAsyncIteration


class Server(Service):
    """The pubsub hub (reference: internal/pubsub/pubsub.go:105)."""

    def __init__(self, name: str = "pubsub") -> None:
        super().__init__(name=name)
        # (client_id, query string) → Subscription
        self._subs: Dict[Tuple[str, str], Subscription] = {}
        # publish-path index: query source -> (compiled query, members);
        # a publish evaluates each distinct query once
        self._groups: Dict[
            str, Tuple[Query, Dict[Tuple[str, str], Subscription]]
        ] = {}

    def subscribe(
        self, client_id: str, query: "Query | str", limit: int = 100
    ) -> Subscription:
        q = compile_query(query) if isinstance(query, str) else query
        key = (client_id, str(q))
        if key in self._subs:
            raise SubscriptionError(
                f"{client_id} already subscribed to {q}"
            )
        sub = Subscription(client_id, q, limit)
        self._subs[key] = sub
        group = self._groups.get(key[1])
        if group is None:
            # one group per distinct live query; it dies with its last
            # member (_drop_key)
            self._groups[key[1]] = (q, {key: sub})
        else:
            group[1][key] = sub
        return sub

    def _drop_key(self, key: Tuple[str, str]) -> Optional[Subscription]:
        """Remove one subscription from both indexes."""
        sub = self._subs.pop(key, None)
        if sub is None:
            return None
        group = self._groups.get(key[1])
        if group is not None:
            group[1].pop(key, None)
            if not group[1]:
                del self._groups[key[1]]
        return sub

    def unsubscribe(self, client_id: str, query: "Query | str") -> None:
        qs = str(compile_query(query) if isinstance(query, str) else query)
        sub = self._drop_key((client_id, qs))
        if sub is None:
            raise SubscriptionError(f"{client_id} not subscribed to {qs}")
        sub._terminate("unsubscribed")

    def unsubscribe_all(self, client_id: str) -> None:
        keys = [k for k in self._subs if k[0] == client_id]
        if not keys:
            raise SubscriptionError(f"{client_id} has no subscriptions")
        for k in keys:
            self._drop_key(k)._terminate("unsubscribed")

    def num_clients(self) -> int:
        return len({cid for cid, _ in self._subs})

    def num_subscriptions(self) -> int:
        return len(self._subs)

    def publish(
        self, data: object, events: Optional[Dict[str, List[str]]] = None
    ) -> Tuple[int, int, int]:
        """Synchronous fan-out: delivery is put_nowait into bounded queues,
        so publishing never blocks the caller (the consensus hot loop).

        Returns `(matched, max_depth, dropped)` — subscriptions the
        message matched, the deepest subscriber queue after delivery
        (the fanout-lag signal: how far the slowest live subscriber is
        behind the publisher), and subscriptions terminated by overflow
        on this publish. Computed inside the fan-out loop the publisher
        already pays for, so the saturation signal costs one qsize()
        per matched subscriber."""
        events = events or {}
        dead: List[Tuple[str, str]] = []
        matched = 0
        max_depth = 0
        msg: Optional[Message] = None
        for source, (q, members) in self._groups.items():
            # one query evaluation per DISTINCT query, not per
            # subscriber — and one shared Message for every recipient
            # (it is frozen, and `events` was always the same dict
            # reference across recipients, so aliasing is unchanged)
            if not q.matches(events):
                continue
            if msg is None:
                msg = Message(data=data, events=events)
            for key, sub in members.items():
                matched += 1
                if not sub._deliver(msg):
                    dead.append(key)
                else:
                    depth = sub._queue.qsize()
                    if depth > max_depth:
                        max_depth = depth
        for key in dead:
            self._drop_key(key)
        return matched, max_depth, len(dead)

    def max_queue_depth(self) -> int:
        """Deepest subscriber queue right now (scrape-time gauge)."""
        depth = 0
        for sub in self._subs.values():
            d = sub._queue.qsize()
            if d > depth:
                depth = d
        return depth

    async def on_stop(self) -> None:
        for sub in self._subs.values():
            sub._terminate("server stopped")
        self._subs.clear()
        self._groups.clear()
