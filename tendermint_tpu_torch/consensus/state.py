"""ConsensusState's vote ingest: the single-writer receive loop's peer
branch, the vote-burst pre-verify on the device, and addVote.

Counterpart: tendermint_tpu/consensus/state.py: `send_peer_msg` and
`_send_internal` (:158-171), the peer and own-message branches of
`_receive_routine` (:313-393: a drain of up to 256 queued peer messages
after the first, own messages applied before each drained one),
`_preverify_votes` and `_preverify_votes_impl` (:395-487),
`_handle_msg`'s VoteMessage branch (:490-515), `_try_add_vote`,
`_add_vote` and `_add_vote_impl` (:1070-1144). The state is built from a
chain id and a consensus.types.RoundState; the HeightVoteSet of its
height is made here when the RoundState has none.

THE PRE-VERIFY. Every queued VoteMessage of the current height with a
64-byte signature, a validator index in the set and that validator's
address is a candidate; candidates group by key type; a group's cache
misses, when there are at least two, go through one batch verifier
(crypto.batch.create_batch_verifier: on the card kernels X1 and K2 for
ed25519, C merlin and X3 for sr25519, from GPUConfig.min_batch_size
signatures on; the native CPU plane below), and drain_and_cache records
the valid triples in crypto/sigcache.py. VoteSet.add_vote's Vote.verify
then finds them and skips the signature equation. Nothing else changes:
a vote left out, or whose signature failed, takes the per-vote path,
which gives its own error, and the outcome of every vote (added or not,
the error text) is the JAX package's.

A DELIBERATE DIVERGENCE. The JAX package wraps each group's batch in
`except Exception: continue` (:483-487), which hides a failed launch
behind the per-vote CPU path. Here nothing is caught: the device
verifier contains a DeviceFault under its fault policy (the batch
re-verified on the native CPU plane and marked `faulted`, which
drain_and_cache then leaves out of the cache), and any other launch or
CUDA error reaches the caller (wait_idle raises it). _handle_msg
likewise lets through what _try_add_vote does not turn into an outcome.

Not ported yet (ROADMAP item 14b): the step machine (`_after_prevote_
added`, `_after_precommit_added`, `_enter_*`), the timeout branch, the
WAL, the event bus (`_publish_vote_event`), the evidence pool (a
conflicting vote is logged, as the JAX package logs it when it has no
pool) and the privval's own-vote check. `_add_vote_impl` returns once
the vote is in its set; trace spans wait for the port's tracing (item
11).
"""

from __future__ import annotations

import asyncio
import logging
from typing import Optional

from ..crypto import sigcache
from ..crypto.batch import (
    create_batch_verifier,
    drain_and_cache,
    supports_batch_verifier,
)
from ..types.canonical import PRECOMMIT_TYPE
from ..types.vote import Vote
from ..types.vote_set import ConflictingVoteError
from .msgs import MsgInfo, VoteMessage
from .types import HeightVoteSet, RoundState, RoundStep

__all__ = ["ConsensusState", "PEER_DRAIN", "QUEUE_SIZE"]

# peer messages handled a loop turn at most (the first and up to 255
# drained behind it), and each queue's bound (the JAX package's
# consensus/state.py:118-119)
PEER_DRAIN = 256
QUEUE_SIZE = 1000


class ConsensusState:
    """The vote ingest of reference internal/consensus/state.go:60, :803
    (receiveRoutine). Producers only enqueue (send_peer_msg,
    _send_internal); start() runs the loop as a task on the running
    event loop, wait_idle() returns once every queued message was
    handled, stop() ends it."""

    def __init__(self, chain_id: str, rs: RoundState) -> None:
        self.chain_id = chain_id
        self.rs = rs
        if rs.votes is None:
            rs.votes = HeightVoteSet(chain_id, rs.height, rs.validators)
        self.logger = logging.getLogger(__name__)
        self.peer_msg_queue: asyncio.Queue = asyncio.Queue(maxsize=QUEUE_SIZE)
        self.internal_msg_queue: asyncio.Queue = asyncio.Queue(maxsize=QUEUE_SIZE)
        self._task: Optional[asyncio.Task] = None

    # -- producers and lifecycle --

    def send_peer_msg(self, msg, peer_id: str) -> bool:
        """Enqueue a message from a peer; False when the queue is full
        and it was dropped (gossip is redundant and resent, and a slow
        loop must push back on peers, not fail)."""
        try:
            self.peer_msg_queue.put_nowait(MsgInfo(msg=msg, peer_id=peer_id))
        except asyncio.QueueFull:
            self.logger.debug(
                "peer msg queue full; dropping %s from %s",
                type(msg).__name__,
                peer_id[:12],
            )
            return False
        return True

    def _send_internal(self, msg) -> None:
        """Enqueue our own message (peer id '')."""
        self.internal_msg_queue.put_nowait(MsgInfo(msg=msg, peer_id=""))

    def start(self) -> None:
        if self._task is not None:
            raise RuntimeError("the receive loop is already running")
        self._task = asyncio.get_running_loop().create_task(self._receive_routine())

    async def wait_idle(self) -> None:
        """Return once every message queued so far was handled; raise
        what ended the receive loop if it ended."""
        if self._task is None:
            raise RuntimeError("the receive loop is not running")
        joins = asyncio.ensure_future(
            asyncio.gather(self.peer_msg_queue.join(), self.internal_msg_queue.join())
        )
        done, _ = await asyncio.wait(
            {joins, self._task}, return_when=asyncio.FIRST_COMPLETED
        )
        if joins not in done:
            joins.cancel()
            self._task.result()  # the loop's error
            raise RuntimeError("the receive loop ended")

    async def stop(self) -> None:
        task, self._task = self._task, None
        if task is None:
            return
        if not task.done():
            task.cancel()
        try:
            await task
        except asyncio.CancelledError:
            pass

    # -- the receive loop --

    async def _receive_routine(self) -> None:
        internal_get = peer_get = None
        loop = asyncio.get_running_loop()
        try:
            while True:
                if internal_get is None:
                    internal_get = loop.create_task(self.internal_msg_queue.get())
                if peer_get is None:
                    peer_get = loop.create_task(self.peer_msg_queue.get())
                done, _ = await asyncio.wait(
                    {internal_get, peer_get}, return_when=asyncio.FIRST_COMPLETED
                )
                # own messages first: an own vote applies before more
                # peer input
                if internal_get in done:
                    mi = internal_get.result()
                    internal_get = None
                    await self._handle_msg(mi)
                    self.internal_msg_queue.task_done()
                if peer_get in done:
                    batch = [peer_get.result()]
                    peer_get = None
                    # verify-ahead: drain what else is queued (bounded)
                    # and verify the burst's signatures in one batch a
                    # key type before handling it message by message
                    while len(batch) < PEER_DRAIN:
                        try:
                            batch.append(self.peer_msg_queue.get_nowait())
                        except asyncio.QueueEmpty:
                            break
                    self._preverify_votes(batch)
                    for m in batch:
                        # an own message queued meanwhile (or already
                        # claimed by the pending internal_get) goes first
                        while True:
                            if internal_get is not None and internal_get.done():
                                own = internal_get.result()
                                internal_get = None
                            else:
                                try:
                                    own = self.internal_msg_queue.get_nowait()
                                except asyncio.QueueEmpty:
                                    break
                            await self._handle_msg(own)
                            self.internal_msg_queue.task_done()
                        await self._handle_msg(m)
                        self.peer_msg_queue.task_done()
        finally:
            for t in (internal_get, peer_get):
                if t is not None and not t.done():
                    t.cancel()

    def _preverify_votes(self, batch: list) -> None:
        """Verify the signatures of the burst's votes of the current
        height in one batch a key type, recording the valid triples in
        the verified-signature cache (module docstring). Runs in the
        single-writer loop against rs.validators, the set every VoteSet
        of this height verifies with; the cache key binds the exact
        triple, so it never widens what is accepted."""
        self._preverify_votes_impl(batch)

    def _preverify_votes_impl(self, batch: list) -> None:
        if not sigcache.enabled():
            # nowhere to record a result: add_vote verifies each vote
            return
        rs = self.rs
        groups: dict = {}  # key type -> [(vote, pub key)], one batch each
        for mi in batch:
            msg = mi.msg
            if not isinstance(msg, VoteMessage):
                continue
            vote = msg.vote
            if vote.height != rs.height or len(vote.signature) != 64:
                # left to the per-vote path, which gives its error; a
                # malformed size must not make the batch's add() raise
                continue
            addr, val = rs.validators.get_by_index(vote.validator_index)
            if val is None or addr != vote.validator_address:
                continue
            if val.pub_key.address() != vote.validator_address:
                continue  # the check Vote.verify makes first
            groups.setdefault(val.pub_key.type(), []).append((vote, val.pub_key))
        chain_id = self.chain_id
        for candidates in groups.values():
            if not supports_batch_verifier(candidates[0][1]):
                continue
            # only the misses are verified: a vote re-gossiped, or a
            # duplicate of an earlier burst, is proven already
            keys = [
                sigcache.key_for(pk.bytes(), vote.sign_bytes(chain_id), vote.signature)
                for vote, pk in candidates
            ]
            hit_set = sigcache.seen_keys_bulk(keys)
            misses = [
                (pk, key) for (_vote, pk), key in zip(candidates, keys) if key not in hit_set
            ]
            if len(misses) < 2:
                continue
            bv = create_batch_verifier(misses[0][0], size_hint=len(misses))
            for pk, (_pk_bytes, sign_bytes, sig) in misses:
                bv.add(pk, sign_bytes, sig)
            # the valid triples land in the cache; a failure stays out,
            # and add_vote verifies it again for its error
            drain_and_cache(bv, [key for _pk, key in misses])

    async def _handle_msg(self, mi: MsgInfo) -> None:
        """reference: state.go:891-960 handleMsg, its VoteMessage branch."""
        msg, peer_id = mi.msg, mi.peer_id
        if isinstance(msg, VoteMessage):
            await self._try_add_vote(msg.vote, peer_id)
        else:
            self.logger.error("unknown msg type in receive loop: %s", type(msg).__name__)

    # -- votes --

    async def _try_add_vote(self, vote: Vote, peer_id: str) -> bool:
        """reference: state.go:2010-2056: a vote's failure is an outcome
        (logged, False), not an error of the loop."""
        try:
            return await self._add_vote(vote, peer_id)
        except ConflictingVoteError as e:
            self.logger.debug("found conflicting votes %s / %s", e.vote_a, e.vote_b)
            return False
        except ValueError as e:
            self.logger.info("failed attempting to add vote: %s", e)
            return False

    async def _add_vote(self, vote: Vote, peer_id: str) -> bool:
        """reference: state.go:2058-2235."""
        return await self._add_vote_impl(vote, peer_id)

    async def _add_vote_impl(self, vote: Vote, peer_id: str) -> bool:
        rs = self.rs
        height = rs.height
        # a late precommit of the previous height (during timeout_commit)
        if vote.height + 1 == height and vote.type == PRECOMMIT_TYPE:
            if rs.step != RoundStep.NEW_HEIGHT:
                return False
            if rs.last_commit is None:
                return False
            return rs.last_commit.add_vote(vote)
        if vote.height != height:
            return False
        return rs.votes.add_vote(vote, peer_id)
