"""The block sync reactor: catch up to the chain's head, then hand over to
consensus.

Counterpart: tendermint_tpu/blocksync/reactor.py:1-291, whole (reference:
internal/blocksync/reactor.go): the channel descriptor (:45-55), serving
BlockRequests from the block store, the status exchange, the pool routine
(:247-258) and _verify_apply (:260-304): block H is verified with the
LastCommit that block H+1 carries (verify_commit_light, on the card when
the device plane is installed), then saved and applied through the
BlockExecutor. Once the pool is caught up the reactor switches the
consensus reactor on (consensus/reactor.py switch_to_consensus).

ERRORS. The JAX package catches every exception around the commit check
(:235-250) and bans both peers of the pair for it, so a failed launch
would ban honest peers. Here only a check error (light.verifier
CHECK_ERRORS: ValueError, the commit errors among them, and
OverflowError) bans them and refetches the height. A DeviceFault never
reaches the reactor: the device verifier's fault policy contains it and
the CPU plane gives the same outcome. Any other error, a failed launch
among them, ends the pool routine, which runs as the reactor's own task
and not as a logged spawn(): stop() raises it, and so does failure() once
it happened. The receive routine keeps the JAX catch around its handler
(:118-128): no device call runs under it (serving reads the store, a
response only enters the pool).
"""

from __future__ import annotations

import asyncio
import logging
from typing import Optional

from ..libs.service import Service
from ..light.verifier import CHECK_ERRORS
from ..p2p.channel import Channel
from ..p2p.peermanager import PeerStatus
from ..p2p.types import ChannelDescriptor, Envelope, PeerError
from ..state.execution import BlockExecutor
from ..state.types import State
from ..store.block_store import BlockStore
from ..types import events as E
from ..types.block_id import BlockID
from ..types.validation import verify_commit_light
from .msgs import (
    BlockRequestMessage,
    BlockResponseMessage,
    BlocksyncCodec,
    NoBlockResponseMessage,
    StatusRequestMessage,
    StatusResponseMessage,
)
from .pool import BlockPool

__all__ = [
    "BlocksyncReactor",
    "BLOCKSYNC_CHANNEL",
    "blocksync_channel_descriptor",
]

BLOCKSYNC_CHANNEL = 0x40
_STATUS_UPDATE_INTERVAL = 2.0


def blocksync_channel_descriptor():
    """reference: reactor.go:66-75."""
    return ChannelDescriptor(
        channel_id=BLOCKSYNC_CHANNEL,
        message_type=BlocksyncCodec,
        priority=5,
        send_queue_capacity=1000,
        recv_buffer_capacity=1024,
        name="blocksync",
    )


class BlocksyncReactor(Service):
    def __init__(
        self,
        state: State,
        block_exec: BlockExecutor,
        block_store: BlockStore,
        channel: Channel,
        peer_updates: asyncio.Queue,
        block_sync: bool = True,  # start in sync mode?
        consensus_reactor=None,  # switch target when caught up
        event_bus=None,
    ) -> None:
        super().__init__(name="blocksync", logger=logging.getLogger(__name__))
        self.state = state
        self.block_exec = block_exec
        self.block_store = block_store
        self.channel = channel
        self.peer_updates = peer_updates
        self.block_sync = block_sync
        self.consensus_reactor = consensus_reactor
        self.event_bus = event_bus
        start_height = state.last_block_height + 1
        if start_height == 1:
            start_height = state.initial_height
        self.pool = BlockPool(start_height, self._request_block)
        self.synced = False
        self._sync_routines_started = False
        self._pool_task: Optional[asyncio.Task] = None

    async def on_start(self) -> None:
        self.spawn(self._recv_routine(), "recv")
        self.spawn(self._peer_update_routine(), "peer-updates")
        if self.block_sync:
            await self._start_sync_routines()

    async def on_stop(self) -> None:
        try:
            task, self._pool_task = self._pool_task, None
            if task is not None:
                if not task.done():
                    task.cancel()
                try:
                    await task
                except asyncio.CancelledError:
                    pass
        finally:
            if self.pool.is_running:
                await self.pool.stop()

    def failure(self) -> Optional[BaseException]:
        """What ended the pool routine, or None while it runs."""
        task = self._pool_task
        if task is None or not task.done() or task.cancelled():
            return None
        return task.exception()

    async def start_sync(self, state: State) -> None:
        """Begin block sync from a statesync-bootstrapped state
        (reference: node wiring bcReactor.SwitchToBlockSync after
        stateSyncReactor.Sync)."""
        self.state = state
        self.block_sync = True
        start = state.last_block_height + 1
        self.pool.height = max(self.pool.height, start)
        await self._start_sync_routines()

    async def _start_sync_routines(self) -> None:
        # idempotent: two concurrent pool routines would double-apply blocks
        if self._sync_routines_started:
            return
        self._sync_routines_started = True
        if not self.pool.is_running:
            await self.pool.start()
        # the pool routine's task is the reactor's own: an error that
        # ends it is raised by stop() and failure(), not logged
        self._pool_task = asyncio.get_running_loop().create_task(self._pool_routine())
        self.spawn(self._status_routine(), "status")

    def _request_block(self, height: int, peer_id: str) -> None:
        self.channel.try_send(
            Envelope(message=BlockRequestMessage(height=height), to=peer_id)
        )

    # -- inbound --

    async def _recv_routine(self) -> None:
        async for envelope in self.channel:
            try:
                await self._handle_msg(envelope)
            except asyncio.CancelledError:
                raise
            except Exception as e:  # no device call runs under it
                self.logger.error("failed to process blocksync message: %s", e)
                await self.channel.send_error(
                    PeerError(node_id=envelope.from_peer, err=str(e))
                )

    async def _handle_msg(self, envelope: Envelope) -> None:
        """reference: reactor.go:236-320 handleMessage."""
        msg = envelope.message
        peer_id = envelope.from_peer
        if isinstance(msg, BlockRequestMessage):
            block = self.block_store.load_block(msg.height)
            if block is not None:
                self.channel.try_send(
                    Envelope(
                        message=BlockResponseMessage(block=block), to=peer_id
                    )
                )
            else:
                self.channel.try_send(
                    Envelope(
                        message=NoBlockResponseMessage(height=msg.height),
                        to=peer_id,
                    )
                )
        elif isinstance(msg, BlockResponseMessage):
            if msg.block is not None:
                self.pool.add_block(peer_id, msg.block)
        elif isinstance(msg, NoBlockResponseMessage):
            pass  # requester will time out and retry another peer
        elif isinstance(msg, StatusRequestMessage):
            self.channel.try_send(
                Envelope(
                    message=StatusResponseMessage(
                        height=self.block_store.height(),
                        base=self.block_store.base(),
                    ),
                    to=peer_id,
                )
            )
        elif isinstance(msg, StatusResponseMessage):
            self.pool.set_peer_range(peer_id, msg.base, msg.height)
        else:
            raise ValueError(
                f"unexpected blocksync message {type(msg).__name__}"
            )

    async def _peer_update_routine(self) -> None:
        while True:
            update = await self.peer_updates.get()
            if update.status == PeerStatus.UP:
                # learn the peer's range; offer ours
                self.channel.try_send(
                    Envelope(
                        message=StatusRequestMessage(), to=update.node_id
                    )
                )
                self.channel.try_send(
                    Envelope(
                        message=StatusResponseMessage(
                            height=self.block_store.height(),
                            base=self.block_store.base(),
                        ),
                        to=update.node_id,
                    )
                )
            elif update.status == PeerStatus.DOWN:
                self.pool.remove_peer(update.node_id)

    async def _status_routine(self) -> None:
        while True:
            await asyncio.sleep(_STATUS_UPDATE_INTERVAL)
            self.channel.try_send(
                Envelope(message=StatusRequestMessage(), broadcast=True)
            )

    # -- the sync pipeline (reference: reactor.go:322-450 poolRoutine) --

    async def _pool_routine(self) -> None:
        while True:
            if self.pool.is_caught_up():
                await self._switch_to_consensus()
                return
            first, second = self.pool.peek_two_blocks()
            if first is None or second is None:
                await asyncio.sleep(0.05)
                continue
            await self._verify_apply(first, second)

    async def _verify_apply(self, first, second) -> None:
        """Verify `first` with `second.LastCommit`, then apply
        (reference: reactor.go:452-520)."""
        first_parts = first.make_part_set()
        first_id = BlockID(
            hash=first.hash(), part_set_header=first_parts.header()
        )
        try:
            # the whole LastCommit of block H+1 in one device batch call
            verify_commit_light(
                self.state.chain_id,
                self.state.validators,
                first_id,
                first.header.height,
                second.last_commit,
            )
        except CHECK_ERRORS as e:
            self.logger.error(
                "invalid last commit during block sync (height=%d): %s",
                first.header.height,
                e,
            )
            # punish both providers and refetch
            for peer_id in (
                self.pool.first_block_peer(),
                self.pool.second_block_peer(),
            ):
                if peer_id:
                    self.pool.ban_peer(peer_id)
                    await self.channel.send_error(
                        PeerError(node_id=peer_id, err=f"bad block: {e}")
                    )
            self.pool.redo_request(first.header.height)
            return

        self.block_store.save_block(first, first_parts, second.last_commit)
        self.state = await self.block_exec.apply_block(
            self.state, first_id, first
        )
        self.pool.pop_request()
        if self.pool.height % 100 == 0:
            self.logger.info(
                "block-synced height=%d target=%d",
                self.pool.height,
                self.pool.max_peer_height,
            )

    async def _switch_to_consensus(self) -> None:
        """reference: reactor.go poolRoutine switch branch +
        consensus/reactor.go:252 SwitchToConsensus."""
        self.synced = True
        self.block_sync = False
        self.logger.info(
            "caught up; switching to consensus (height=%d)",
            self.state.last_block_height,
        )
        if self.event_bus is not None:
            self.event_bus.publish_block_sync_status(
                E.EventDataBlockSyncStatus(
                    complete=True, height=self.state.last_block_height
                )
            )
        if self.pool.is_running:
            await self.pool.stop()
        if self.consensus_reactor is not None:
            # rebuild LastCommit from the stored seen-commit, then roll the
            # round state forward (reference: consensus/reactor.go:252-306)
            cs = self.consensus_reactor.cs
            if self.state.last_block_height > 0:
                cs._reconstruct_last_commit_from_store(self.state)
            cs._update_to_state(self.state)
            await self.consensus_reactor.switch_to_consensus(self.state)
