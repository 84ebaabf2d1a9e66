"""The evidence reactor: pending evidence gossiped on channel 0x38.

Counterpart: tendermint_tpu/evidence/reactor.py:1-181 (reference:
internal/evidence/reactor.go: the channel :22, the broadcast :112-190):
EvidenceListMessage and its proto (:41-58), the channel descriptor
(:61-69) and EvidenceReactor (:72-181). Each peer gets a task streaming
the pool's pending list; evidence received is verified by the pool
before it is admitted.

The device: admitting a light-client attack verifies the conflicting
block's commit (verify_commit_light_trusting), on the card when the
device plane is installed. The receive loop catches what the JAX one
catches around pool.add_evidence (:118-145), ValueError and
EvidenceError, which are a peer's bad evidence. A DeviceFault never
reaches it: the device verifier's fault policy contains it. Any other
error, a failed launch among them, ends the receive loop, which runs as
the reactor's own task and not as a logged spawn(): stop() raises it,
and so does failure() once it happened.
"""

from __future__ import annotations

import asyncio
import logging
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from ..encoding.proto import FieldReader, ProtoWriter
from ..libs.service import Service
from ..p2p.channel import Channel
from ..p2p.peermanager import PeerStatus
from ..p2p.types import ChannelDescriptor, Envelope, PeerError
from ..types.evidence import Evidence, evidence_from_proto, evidence_to_proto
from .pool import EvidenceError, EvidencePool

__all__ = [
    "EvidenceReactor",
    "EvidenceListMessage",
    "EVIDENCE_CHANNEL",
    "MAX_MSG_EVIDENCE",
    "evidence_channel_descriptor",
]

EVIDENCE_CHANNEL = 0x38
_BROADCAST_INTERVAL = 1.0  # the pending list is offered to peers at this cadence

# the per-message bound on evidence, kept by both sides: the receiver
# verifies at most this many items a message (each new one costs a
# signature check of a third of a committee), and the sender sends at
# most this many a tick, so the receiver's clamp never drops an honest
# sender's tail (a larger backlog drains over the ticks)
MAX_MSG_EVIDENCE = 64


@dataclass
class EvidenceListMessage:
    """proto/tendermint/evidence EvidenceList{evidence=1}."""

    evidence: Tuple[Evidence, ...] = ()

    def to_proto(self) -> bytes:
        w = ProtoWriter()
        for ev in self.evidence:
            w.bytes(1, evidence_to_proto(ev))
        return w.finish()

    @classmethod
    def from_proto(cls, data: bytes) -> "EvidenceListMessage":
        r = FieldReader(data)
        return cls(evidence=tuple(evidence_from_proto(b) for b in r.get_all(1)))


def evidence_channel_descriptor():
    return ChannelDescriptor(
        channel_id=EVIDENCE_CHANNEL,
        message_type=EvidenceListMessage,
        priority=6,
        send_queue_capacity=16,
        recv_buffer_capacity=32,
        name="evidence",
    )


class EvidenceReactor(Service):
    def __init__(self, pool: EvidencePool, channel: Channel, peer_updates: asyncio.Queue) -> None:
        super().__init__(name="evidence.reactor", logger=logging.getLogger(__name__))
        self.pool: EvidencePool = pool
        self.channel = channel
        self.peer_updates = peer_updates
        self._peer_tasks: Dict[str, asyncio.Task] = {}
        self._recv_task: Optional[asyncio.Task] = None

    async def on_start(self) -> None:
        self.spawn(self._peer_update_routine(), "peer-updates")
        # the receive loop's task is the reactor's own: an error that
        # ends it is raised by stop() and failure(), not logged
        self._recv_task = asyncio.get_running_loop().create_task(self._recv_routine())

    async def on_stop(self) -> None:
        task, self._recv_task = self._recv_task, None
        if task is None:
            return
        if not task.done():
            task.cancel()
        try:
            await task
        except asyncio.CancelledError:
            pass

    def failure(self) -> Optional[BaseException]:
        """What ended the receive loop, or None while it runs."""
        task = self._recv_task
        if task is None or not task.done() or task.cancelled():
            return None
        return task.exception()

    async def _peer_update_routine(self) -> None:
        while True:
            update = await self.peer_updates.get()
            if update.status == PeerStatus.UP:
                if update.node_id not in self._peer_tasks:
                    self._peer_tasks[update.node_id] = self.spawn(
                        self._broadcast_to_peer(update.node_id),
                        f"ev-gossip-{update.node_id[:8]}",
                    )
            elif update.status == PeerStatus.DOWN:
                t = self._peer_tasks.pop(update.node_id, None)
                if t is not None and not t.done():
                    t.cancel()
                self._tasks = [x for x in self._tasks if not x.done()]

    async def _recv_routine(self) -> None:
        async for envelope in self.channel:
            # the verification a message buys is clamped: each new item
            # costs a committee-sized signature check (a duplicate is
            # answered by the pool's pending and committed probes first)
            for ev in envelope.message.evidence[:MAX_MSG_EVIDENCE]:
                try:
                    # the shape checks run before the pool touches its
                    # state or store
                    ev.validate_basic()
                    self.pool.add_evidence(ev)
                except ValueError as e:
                    self.logger.info(
                        "peer sent malformed evidence (peer=%s): %s", envelope.from_peer[:12], e
                    )
                    await self.channel.send_error(PeerError(node_id=envelope.from_peer, err=str(e)))
                    break
                except EvidenceError as e:
                    # a lagging node cannot verify evidence of a height
                    # it lacks: not the peer's misbehavior
                    if "don't have header" in str(e) or "too old" in str(e):
                        self.logger.debug("cannot verify gossiped evidence yet: %s", e)
                        continue
                    self.logger.info(
                        "peer sent invalid evidence (peer=%s): %s", envelope.from_peer[:12], e
                    )
                    await self.channel.send_error(PeerError(node_id=envelope.from_peer, err=str(e)))
                    break

    async def _broadcast_to_peer(self, peer_id: str) -> None:
        """Send the pending evidence the peer may lack, again now and then
        (reference: reactor.go:112-190 broadcastEvidenceLoop)."""
        sent: set = set()
        ticks = 0
        while True:
            pending, _ = self.pool.pending_evidence(1 << 20)
            # one receiver's clamp of items a tick: an oversized message
            # would lose its tail there and every re-offer would resend
            # the same head
            fresh = [ev for ev in pending if ev.hash() not in sent][:MAX_MSG_EVIDENCE]
            if fresh:
                if self.channel.try_send(
                    Envelope(message=EvidenceListMessage(evidence=tuple(fresh)), to=peer_id)
                ):
                    sent.update(ev.hash() for ev in fresh)
            await asyncio.sleep(_BROADCAST_INTERVAL)
            ticks += 1
            if ticks % 10 == 0:
                # a peer too far behind to verify the first offer gets
                # another once it caught up
                sent.clear()
