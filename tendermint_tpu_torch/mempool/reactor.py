"""The mempool reactor: tx gossip on channel 0x30.

Counterpart: tendermint_tpu/mempool/reactor.py: TxsMessage and its proto
(:28-43), the channel descriptor (:47) and MempoolReactor (:60-128);
reference: internal/mempool/reactor.go (channel id types.go:14,
descriptor :100-113, per-peer broadcast :150-230). Each peer gets a task
walking the mempool's FIFO gossip cursor; a tx is never sent back to a
peer that sent it.
"""

from __future__ import annotations

import asyncio
import logging
from dataclasses import dataclass
from typing import Dict, Tuple

from ..encoding.proto import FieldReader, ProtoWriter
from ..libs.service import Service
from ..p2p.channel import Channel
from ..p2p.peermanager import PeerStatus
from ..p2p.types import ChannelDescriptor, Envelope
from .mempool import TxMempool
from .types import TxInfo

__all__ = ["MempoolReactor", "TxsMessage", "MEMPOOL_CHANNEL", "mempool_channel_descriptor"]

MEMPOOL_CHANNEL = 0x30


@dataclass
class TxsMessage:
    """proto/tendermint/mempool/types.pb.go Txs{txs=1}."""

    txs: Tuple[bytes, ...] = ()

    def to_proto(self) -> bytes:
        w = ProtoWriter()
        for tx in self.txs:
            w.bytes(1, tx)
        return w.finish()

    @classmethod
    def from_proto(cls, data: bytes) -> "TxsMessage":
        r = FieldReader(data)
        return cls(txs=tuple(r.get_all(1)))


def mempool_channel_descriptor(max_tx_bytes: int = 1 << 20):
    """reference: internal/mempool/reactor.go:100-113 (batch-sized)."""
    return ChannelDescriptor(
        channel_id=MEMPOOL_CHANNEL,
        message_type=TxsMessage,
        priority=5,
        send_queue_capacity=128,
        recv_message_capacity=max_tx_bytes * 10,
        recv_buffer_capacity=1024,
        name="mempool",
    )


class MempoolReactor(Service):
    def __init__(
        self,
        mempool: TxMempool,
        channel: Channel,
        peer_updates: asyncio.Queue,
        broadcast: bool = True,
    ) -> None:
        super().__init__(name="mempool.reactor", logger=logging.getLogger(__name__))
        self.mempool: TxMempool = mempool
        self.channel = channel
        self.peer_updates = peer_updates
        self.broadcast = broadcast
        self._peer_tasks: Dict[str, asyncio.Task] = {}

    async def on_start(self) -> None:
        self.spawn(self._peer_update_routine(), "peer-updates")
        self.spawn(self._recv_routine(), "recv")

    async def _peer_update_routine(self) -> None:
        while True:
            update = await self.peer_updates.get()
            if update.status == PeerStatus.UP and self.broadcast:
                if update.node_id not in self._peer_tasks:
                    self._peer_tasks[update.node_id] = self.spawn(
                        self._broadcast_to_peer(update.node_id),
                        f"tx-gossip-{update.node_id[:8]}",
                    )
            elif update.status == PeerStatus.DOWN:
                t = self._peer_tasks.pop(update.node_id, None)
                if t is not None and not t.done():
                    t.cancel()
                self._tasks = [x for x in self._tasks if not x.done()]

    async def _recv_routine(self) -> None:
        async for envelope in self.channel:
            msg = envelope.message
            info = TxInfo(sender_id=envelope.from_peer)
            # a tx is opaque app bytes: CheckTx is its validation. One
            # batch an envelope; duplicate, full and invalid outcomes
            # come back as values (gossip noise, dropped)
            await self.mempool.check_tx_batch(list(msg.txs), info)

    async def _broadcast_to_peer(self, peer_id: str) -> None:
        """Walk the FIFO cursor, bundling a window of txs per envelope;
        skip txs the peer already knows (reference: reactor.go:150-230
        broadcastTxRoutine, which batches the same way)."""
        cursor = -1
        batch = max(1, int(getattr(self.mempool.cfg, "tx_batch_size", 1)))
        max_bytes = self.mempool.cfg.max_tx_bytes
        while True:
            await self.mempool.wait_for_tx(cursor)
            window = self.mempool.next_gossip_txs(cursor, batch, max_bytes)
            if not window:
                continue
            cursor = window[-1].seq
            txs = tuple(
                w.tx for w in window if peer_id not in w.peers
            )
            if not txs:
                continue  # peer sent all of them to us
            # blocking send: backpressure instead of silently skipping the
            # txs for this peer forever (reference blocks on SendEnvelope)
            await self.channel.send(
                Envelope(message=TxsMessage(txs=txs), to=peer_id)
            )
