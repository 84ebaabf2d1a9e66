"""PEX, the peer exchange reactor on channel 0x00.

Counterpart: tendermint_tpu/p2p/pex.py:1-200 (reference:
internal/p2p/pex/reactor.go: ChannelID 0x00 :26, the request and
response flow with per-peer poll intervals and the policing of
unsolicited responses). Peers poll each other for known addresses and
feed them to the PeerManager; seed nodes exist mostly to run it. No
device call runs here.
"""

from __future__ import annotations

import asyncio
import logging
import random
import time
from dataclasses import dataclass, field
from typing import Dict, List

from ..encoding.proto import FieldReader, ProtoWriter
from ..libs.service import Service
from .channel import Channel
from .peermanager import PeerManager, PeerStatus
from .types import ChannelDescriptor, Envelope, NodeID, PeerError

__all__ = [
    "PEX_CHANNEL_ID",
    "PexRequest",
    "PexResponse",
    "PexReactor",
    "pex_channel_descriptor",
]

PEX_CHANNEL_ID = 0x00
_MAX_ADDRESSES = 100  # reference: pex/reactor.go maxAddresses
_MIN_POLL_INTERVAL = 5.0
_MAX_POLL_INTERVAL = 600.0
_REQUEST_TIMEOUT = 30.0  # in-flight request expiry (droppable path)


@dataclass
class PexRequest:
    """reference: proto/tendermint/p2p/pex.pb.go PexRequest."""


@dataclass
class PexResponse:
    addresses: List[str] = field(default_factory=list)  # id@host:port URLs


class _Codec:
    """Message oneof: 1=request, 2=response{repeated url=1}."""

    @staticmethod
    def encode(msg) -> bytes:
        w = ProtoWriter()
        if isinstance(msg, PexRequest):
            w.message(1, b"")  # presence-carrying empty submessage
        elif isinstance(msg, PexResponse):
            inner = ProtoWriter()
            for url in msg.addresses:
                inner.bytes(1, url.encode())
            w.message(2, inner.finish())
        else:
            raise TypeError(f"not a pex message: {msg!r}")
        return w.finish()

    @staticmethod
    def decode(data: bytes):
        r = FieldReader(data)
        if r.get(1) is not None:
            return PexRequest()
        if r.get(2) is not None:
            inner = FieldReader(r.bytes(2))
            return PexResponse(
                addresses=[b.decode() for b in inner.get_all(1)]
            )
        raise ValueError("empty pex message")


def pex_channel_descriptor() -> ChannelDescriptor:
    """reference: pex/reactor.go ChannelDescriptor()."""
    return ChannelDescriptor(
        channel_id=PEX_CHANNEL_ID,
        message_type=_Codec,
        priority=1,
        send_queue_capacity=10,
        recv_message_capacity=256 * 1024,
        name="pex",
    )


class PexReactor(Service):
    """Polls peers for addresses; answers their polls.

    reference: pex/reactor.go. Per-peer poll interval grows as the
    address book fills (we learn less from each poll), resetting when
    responses still teach us new addresses.
    """

    def __init__(
        self,
        peer_manager: PeerManager,
        channel: Channel,
        peer_updates: asyncio.Queue,
    ) -> None:
        super().__init__(name="pex", logger=logging.getLogger(__name__))
        self.peer_manager = peer_manager
        self.channel = channel
        self.peer_updates = peer_updates
        self._available: Dict[NodeID, float] = {}  # peer -> next poll time
        self._poll_interval: Dict[NodeID, float] = {}
        self._requested: Dict[NodeID, float] = {}  # in-flight request time
        self.total_added = 0

    async def on_start(self) -> None:
        self.spawn(self._receive_loop(), "recv")
        self.spawn(self._peer_update_loop(), "peer-updates")
        self.spawn(self._poll_loop(), "poll")

    # -- outbound polling --

    async def _poll_loop(self) -> None:
        while True:
            await asyncio.sleep(min(0.5, _MIN_POLL_INTERVAL / 2))
            now = time.monotonic()
            # expire in-flight requests: the request or its response may
            # ride a droppable queue, and a peer stuck in _requested
            # would never be polled again
            for pid, sent_at in list(self._requested.items()):
                if now - sent_at > _REQUEST_TIMEOUT:
                    del self._requested[pid]
            due = [
                pid for pid, when in self._available.items()
                if when <= now and pid not in self._requested
            ]
            if not due:
                continue
            pid = random.choice(due)
            self._requested[pid] = now
            interval = self._poll_interval.get(pid, _MIN_POLL_INTERVAL)
            self._available[pid] = now + interval
            await self.channel.send(Envelope(to=pid, message=PexRequest()))

    # -- inbound --

    async def _receive_loop(self) -> None:
        async for envelope in self.channel:
            msg = envelope.message
            if isinstance(msg, PexRequest):
                addresses = self.peer_manager.advertise(_MAX_ADDRESSES)
                await self.channel.send(
                    Envelope(
                        to=envelope.from_peer,
                        message=PexResponse(addresses=addresses),
                    )
                )
            elif isinstance(msg, PexResponse):
                await self._handle_response(envelope.from_peer, msg)

    async def _handle_response(self, pid: NodeID, msg: PexResponse) -> None:
        if pid not in self._requested:
            # unsolicited response: protocol violation
            # (reference: pex/reactor.go handlePexMessage)
            await self.channel.send_error(
                PeerError(node_id=pid, err="unsolicited pex response")
            )
            return
        del self._requested[pid]
        if len(msg.addresses) > _MAX_ADDRESSES:
            await self.channel.send_error(
                PeerError(node_id=pid, err="oversized pex response")
            )
            return
        added = 0
        for url in msg.addresses:
            try:
                if self.peer_manager.add(url):
                    added += 1
            except ValueError:
                await self.channel.send_error(
                    PeerError(node_id=pid, err=f"invalid pex address {url!r}")
                )
                return
        self.total_added += added
        # back off polls that teach us nothing; reset productive ones
        cur = self._poll_interval.get(pid, _MIN_POLL_INTERVAL)
        if added == 0:
            self._poll_interval[pid] = min(cur * 2, _MAX_POLL_INTERVAL)
        else:
            self._poll_interval[pid] = _MIN_POLL_INTERVAL

    async def _peer_update_loop(self) -> None:
        while True:
            update = await self.peer_updates.get()
            if update.status == PeerStatus.UP:
                self._available[update.node_id] = time.monotonic()
                self._poll_interval[update.node_id] = _MIN_POLL_INTERVAL
            else:
                self._available.pop(update.node_id, None)
                self._poll_interval.pop(update.node_id, None)
                self._requested.pop(update.node_id, None)
