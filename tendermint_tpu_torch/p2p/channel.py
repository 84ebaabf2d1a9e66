"""Channel: a reactor's typed pipe into the router.

Counterpart: tendermint_tpu/p2p/channel.py (reference:
internal/p2p/channel.go:66-153). Reactors send Envelopes (unicast or
broadcast) and iterate inbound ones; PeerErrors go out of band and evict
the peer.
"""

from __future__ import annotations

import asyncio
from typing import AsyncIterator

from .types import ChannelDescriptor, Envelope, PeerError

__all__ = ["Channel"]


class Channel:
    def __init__(self, descriptor: ChannelDescriptor) -> None:
        self.descriptor = descriptor
        self.id = descriptor.channel_id
        self.name = descriptor.name or f"ch{descriptor.channel_id}"
        # reactor → router
        self.out_queue: asyncio.Queue[Envelope] = asyncio.Queue(
            maxsize=descriptor.send_queue_capacity
        )
        # router → reactor
        self.in_queue: asyncio.Queue[Envelope] = asyncio.Queue(
            maxsize=descriptor.recv_buffer_capacity
        )
        self.error_queue: asyncio.Queue[PeerError] = asyncio.Queue(maxsize=64)
        self._closed = False

    async def send(self, envelope: Envelope) -> None:
        await self.out_queue.put(envelope)

    def try_send(self, envelope: Envelope) -> bool:
        """Non-blocking send; drops on a full queue (gossip semantics)."""
        try:
            self.out_queue.put_nowait(envelope)
            return True
        except asyncio.QueueFull:
            return False

    async def send_error(self, peer_error: PeerError) -> None:
        await self.error_queue.put(peer_error)

    async def receive(self) -> Envelope:
        return await self.in_queue.get()

    def __aiter__(self) -> AsyncIterator[Envelope]:
        return self._iter()

    async def _iter(self):
        while True:
            yield await self.in_queue.get()

    # router side
    def deliver(self, envelope: Envelope) -> bool:
        """Inbound delivery; drops (with False) when the reactor lags."""
        try:
            self.in_queue.put_nowait(envelope)
            return True
        except asyncio.QueueFull:
            return False
