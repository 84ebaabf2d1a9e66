"""BlockPool: blocks fetched in parallel, handed on in height order.

Counterpart: tendermint_tpu/blocksync/pool.py:1-215, whole (reference:
internal/blocksync/pool.go:98-348). A requester task a height asks the
peers that advertise it, one at a time; peek_two_blocks gives the blocks
back in strict height order, so the reactor verifies block H with the
LastCommit that block H+1 carries. Peers are picked with libs.rng.choice
(:215), so the same RNG state picks the same peers. The requester waits
with asyncio.wait, not wait_for (:178-192): a requester that outlived a
cancellation would hang stop()'s gather.
"""

from __future__ import annotations

import asyncio
import logging
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Set, Tuple

from ..libs import rng
from ..libs.service import Service
from ..types.block import Block

__all__ = ["BlockPool"]

MAX_PENDING_REQUESTS = 32  # heights in flight
REQUEST_TIMEOUT = 10.0  # per-attempt fetch timeout
_CAUGHT_UP_GRACE_S = 3.0  # don't declare caught-up in the first seconds


@dataclass
class _PoolPeer:
    peer_id: str
    height: int = 0
    base: int = 0
    banned: bool = False


class BlockPool(Service):
    def __init__(
        self,
        start_height: int,
        send_request: Callable[[int, str], None],  # (height, peer_id)
    ) -> None:
        super().__init__(name="blockpool", logger=logging.getLogger(__name__))
        self.height = start_height  # next height to verify/apply
        self._send_request = send_request
        self.peers: Dict[str, _PoolPeer] = {}
        self.max_peer_height = 0
        self._blocks: Dict[int, Tuple[Block, str]] = {}  # height → (block, peer)
        self._requesters: Dict[int, asyncio.Task] = {}
        self._block_events: Dict[int, asyncio.Event] = {}
        self._started_at = 0.0

    async def on_start(self) -> None:
        self._started_at = time.monotonic()
        self.spawn(self._make_requesters_routine(), "make-requesters")

    # -- peer bookkeeping --

    def set_peer_range(self, peer_id: str, base: int, height: int) -> None:
        """From StatusResponse (reference: pool.go SetPeerRange)."""
        peer = self.peers.get(peer_id)
        if peer is None:
            peer = _PoolPeer(peer_id=peer_id)
            self.peers[peer_id] = peer
        peer.base = base
        peer.height = height
        self.max_peer_height = max(
            (p.height for p in self.peers.values() if not p.banned), default=0
        )

    def remove_peer(self, peer_id: str) -> None:
        """Received blocks are kept; live requesters retry other peers."""
        self.peers.pop(peer_id, None)
        self.max_peer_height = max(
            (p.height for p in self.peers.values() if not p.banned), default=0
        )

    def ban_peer(self, peer_id: str) -> None:
        """Sent us a bad block (reference: pool.go RedoRequest path)."""
        peer = self.peers.get(peer_id)
        if peer is not None:
            peer.banned = True
        self.max_peer_height = max(
            (p.height for p in self.peers.values() if not p.banned), default=0
        )

    # -- block intake --

    def add_block(self, peer_id: str, block: Block) -> None:
        """reference: pool.go:280-305 AddBlock."""
        h = block.header.height
        if h < self.height or h in self._blocks:
            return
        if h not in self._requesters:
            return  # unsolicited height
        self._blocks[h] = (block, peer_id)
        ev = self._block_events.get(h)
        if ev is not None:
            ev.set()

    # -- ordered consumption (reference: pool.go:218-260) --

    def peek_two_blocks(self) -> Tuple[Optional[Block], Optional[Block]]:
        first = self._blocks.get(self.height)
        second = self._blocks.get(self.height + 1)
        return (
            first[0] if first else None,
            second[0] if second else None,
        )

    def first_block_peer(self) -> Optional[str]:
        first = self._blocks.get(self.height)
        return first[1] if first else None

    def second_block_peer(self) -> Optional[str]:
        second = self._blocks.get(self.height + 1)
        return second[1] if second else None

    def pop_request(self) -> None:
        """Block at self.height verified and applied; advance."""
        h = self.height
        self._blocks.pop(h, None)
        t = self._requesters.pop(h, None)
        if t is not None and not t.done():
            t.cancel()
        self._block_events.pop(h, None)
        self.height = h + 1
        self._tasks = [x for x in self._tasks if not x.done()]

    def redo_request(self, height: int) -> None:
        """Verification failed: drop fetched blocks from this height up and
        refetch from other peers (reference: pool.go RedoRequest)."""
        for h in list(self._blocks.keys()):
            if h >= height:
                block, peer_id = self._blocks.pop(h)
                ev = self._block_events.get(h)
                if ev is not None:
                    ev.clear()
                # requester for h is still alive and will refetch

    def is_caught_up(self) -> bool:
        """reference: pool.go:200-216."""
        if not self.peers:
            return False
        if time.monotonic() - self._started_at < _CAUGHT_UP_GRACE_S:
            return False
        return self.height >= self.max_peer_height

    # -- requesters --

    async def _make_requesters_routine(self) -> None:
        while True:
            pending = len(self._requesters)
            if (
                pending < MAX_PENDING_REQUESTS
                and self.height + pending <= self.max_peer_height
            ):
                h = self.height + pending
                if h not in self._requesters:
                    self._block_events[h] = asyncio.Event()
                    self._requesters[h] = self.spawn(
                        self._requester(h), f"req-{h}"
                    )
                    continue
            await asyncio.sleep(0.02)

    async def _requester(self, height: int) -> None:
        """Fetch `height` from some peer; retry across peers until a block
        arrives (reference: pool.go bpRequester:415-470)."""
        tried: Set[str] = set()
        while True:
            peer = self._pick_peer(height, tried)
            if peer is None:
                tried.clear()  # all peers tried; start over
                await asyncio.sleep(1.0)
                continue
            tried.add(peer.peer_id)
            self._send_request(height, peer.peer_id)
            ev = self._block_events.get(height)
            if ev is None:
                return
            # asyncio.wait, not wait_for: a wait_for can swallow a
            # cancellation that races the event being set, leaving this
            # requester alive and Service.stop()'s gather hanging; wait()
            # re-raises the outer cancel unconditionally
            waiter = asyncio.ensure_future(ev.wait())
            try:
                done, _pending = await asyncio.wait(
                    {waiter}, timeout=REQUEST_TIMEOUT
                )
            finally:
                waiter.cancel()
            if waiter not in done:
                continue  # timeout: try another peer
            # block arrived (possibly from redo_request → cleared event)
            while height in self._blocks:
                await asyncio.sleep(0.1)
                if height < self.height:
                    return  # consumed
            if height < self.height:
                return
            ev.clear()  # redo_request dropped it; refetch

    def _pick_peer(self, height: int, tried: Set[str]) -> Optional[_PoolPeer]:
        candidates = [
            p
            for p in self.peers.values()
            if not p.banned
            and p.height >= height
            and (p.base == 0 or p.base <= height)
            and p.peer_id not in tried
        ]
        if not candidates:
            return None
        return rng.choice(candidates)
