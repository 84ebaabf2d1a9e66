"""ConsensusState: the Tendermint step machine of one node, its receive
loop, and the vote-burst pre-verify on the device.

Counterpart: tendermint_tpu/consensus/state.py:1-1371 (reference:
internal/consensus/state.go): the constructor (:76-137), the lifecycle
and producers (:139-191), `_update_to_state` and
`_reconstruct_last_commit_from_store` (:196-308), the receive loop
(:313-393: own messages written with write_sync before they act, a
drain of up to 256 queued peer messages, own messages applied before
each drained one, timeouts written then handled), `_preverify_votes`
(:395-487), `_handle_msg` and `_handle_timeout` (:490-551), the step
transitions `_enter_new_round` through `_finalize_commit` (:556-980),
proposals and block parts (:985-1065), votes (:1070-1280), the WAL
catch-up replay (:1284-1320) and the publish helpers (:1325-1371). One
async loop serializes every input:

    NewHeight -> NewRound -> Propose -> Prevote -> (PrevoteWait) ->
    Precommit -> (PrecommitWait) -> Commit -> NewHeight ...

THE DEVICE ON THIS PATH. Each burst of queued votes of the current
height is pre-verified in one batch a key type (create_batch_verifier:
on the card X1 and K2 for ed25519, C merlin and X3 for sr25519, from
GPUConfig.min_batch_size signatures on; the native CPU plane below),
its valid triples recorded in crypto/sigcache.py, where VoteSet.add_vote
finds them. Each height's block is checked by
BlockExecutor.validate_block four times, as in the JAX package: at
prevote (:715), when locking at precommit (:798), at finalize (:923) and
inside apply_block; each verifies the block's LastCommit with one
verify_commit, which consults no cache (the port's commit paths never
do), so each launches its windows. The block's roots go to X4 at 512
leaves or more.

DELIBERATE DIVERGENCES. The JAX package catches every exception in four
places, where a failed launch would hide: `_handle_msg` logs "failed to
process message" (:508), `_default_do_prevote` prevotes nil on any
error of validate_block (:716), the signer's calls log and give up
(:655, :1258, :976), and the pre-verify skips a group that raised
(:483-487). Here each catches only check errors: `CHECK_ERRORS`
(ValueError, which the codecs, the block, part, proposal and vote checks
and InvalidCommitError raise, and the evidence pool's EvidenceError) in
the first two, and the signer's refusals and its checkpoint's I/O
failure (`SIGNER_ERRORS`) in the third; the pre-verify catches nothing.
A DeviceFault is contained by the device verifier's fault policy (the
batch re-verified on the native CPU plane), and any other launch or
CUDA error ends the receive loop and reaches the caller: it is logged at
ERROR when the loop ends ("task receive failed", as the JAX service's
`_run_guarded` logs it), failure() returns it, and wait_idle() and stop()
raise it.

The overridable hooks of the Byzantine plane (consensus/byzantine.py)
are bound as the JAX constructor binds them (:130-131):
`cs.decide_proposal` and `cs.do_prevote`, called at propose (:625) and
prevote (:700), default to `_default_decide_proposal` and
`_default_do_prevote`; `_sign_add_vote` is looked up on the instance,
so a harness may wrap it too.

`cs.timeline` is NopTimeline, a flight recorder that records nothing:
it has every mark_* method the JAX step machine, reactor and Byzantine
plane call, so the ported reactor's stall resets run as in the JAX
package with only their recording dropped. Left out: the flight
recorder itself (consensus/timeline.py), the consensus metrics and the
trace spans (ROADMAP item 11; the step machine runs as the JAX one does
with none of them fed). `replay_mode=True` (:86, :121-124 there) builds
the replay console's playback-only instance.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Optional

from ..config import ConsensusConfig
from ..crypto import sigcache
from ..crypto.batch import (
    create_batch_verifier,
    drain_and_cache,
    supports_batch_verifier,
)
from ..eventbus import EventBus
from ..evidence.pool import EvidenceError
from ..libs.service import Service
from ..privval.types import PrivValidator
from ..state.execution import BlockExecutor
from ..state.types import State
from ..store.block_store import BlockStore
from ..types import events as E
from ..types.block import Block
from ..types.block_id import BlockID, PartSetHeader
from ..types.canonical import PRECOMMIT_TYPE, PREVOTE_TYPE
from ..types.commit import Commit
from ..types.part_set import PartSet
from ..types.proposal import Proposal
from ..types.vote import Vote
from ..types.vote_set import ConflictingVoteError, VoteSet, commit_to_vote_set
from .msgs import (
    BlockPartMessage,
    EndHeightMessage,
    EventDataRoundStateWAL,
    MsgInfo,
    ProposalMessage,
    TimeoutInfo,
    VoteMessage,
)
from .ticker import TimeoutTicker
from .types import HeightVoteSet, RoundState, RoundStep, step_name
from .wal import WAL, NopWAL

__all__ = [
    "CHECK_ERRORS",
    "ConsensusState",
    "NopTimeline",
    "PEER_DRAIN",
    "QUEUE_SIZE",
    "SIGNER_ERRORS",
]

# peer messages handled a loop turn at most (the first and up to 255
# drained behind it), and each queue's bound (the JAX package's
# consensus/state.py:118-119)
PEER_DRAIN = 256
QUEUE_SIZE = 1000

# what a message's handling and the prevote's validate_block turn into
# the JAX outcome (the log line, the nil prevote): the check errors
CHECK_ERRORS = (ValueError, EvidenceError)
# what the signer's calls turn into the JAX outcome (logged, nothing
# signed): FilePV's refusals and its checkpoint's failed write
SIGNER_ERRORS = (ValueError, OSError)

NS_PER_S = 1_000_000_000
_WAIT_POLL_S = 0.01


def _s_to_ns(s: float) -> int:
    return int(round(s * NS_PER_S))


class NopTimeline:
    """A flight recorder that records nothing (the JAX package's
    consensus/timeline.py TimelineRecorder, disabled): the mark_*
    methods its step machine (:262-1151), reactor (:613, :654) and
    Byzantine plane call, each a no-op, until ROADMAP item 11 ports the
    recorder."""

    enabled = False

    def record(self, *args, **kwargs) -> None:
        pass

    def mark_new_height(self, height: int, round_: int = 0) -> None:
        pass

    def mark_proposal(self, height: int, round_: int) -> None:
        pass

    def mark_block(self, height: int, round_: int) -> None:
        pass

    def mark_prevote_any(self, height: int, round_: int) -> None:
        pass

    def mark_polka(self, height: int, round_: int) -> None:
        pass

    def mark_precommit_quorum(self, height: int, round_: int) -> None:
        pass

    def mark_commit(self, *args, **kwargs) -> None:
        pass

    def mark_evidence_seen(self, *args, **kwargs) -> None:
        pass

    def mark_evidence_committed(self, *args, **kwargs) -> None:
        pass

    def mark_stall_reset(self, kind: str, height: int, round_: int, peer_id: str) -> None:
        pass


class ConsensusState(Service):
    """reference: internal/consensus/state.go:60 (the struct), :803
    (receiveRoutine). Producers only enqueue (send_peer_msg,
    _send_internal); start() replays the WAL and runs the loop as a task,
    wait_idle() returns once every queued message was handled, stop()
    ends it."""

    def __init__(
        self,
        cfg: ConsensusConfig,
        state: State,
        block_exec: BlockExecutor,
        block_store: BlockStore,
        privval: Optional[PrivValidator] = None,
        event_bus: Optional[EventBus] = None,
        wal: "WAL | NopWAL | None" = None,
        evidence_pool=None,
        replay_mode: bool = False,
    ) -> None:
        super().__init__(name="consensus", logger=logging.getLogger(__name__))
        self.cfg = cfg
        self.block_exec = block_exec
        self.block_store = block_store
        self.privval = privval
        self.privval_pub_key = None
        self.event_bus = event_bus
        self.wal = wal if wal is not None else NopWAL()
        self.evpool = evidence_pool
        self.timeline = NopTimeline()

        self.rs = RoundState()
        self.state: Optional[State] = None

        self.peer_msg_queue: asyncio.Queue = asyncio.Queue(maxsize=QUEUE_SIZE)
        self.internal_msg_queue: asyncio.Queue = asyncio.Queue(maxsize=QUEUE_SIZE)
        self.ticker = TimeoutTicker()
        # set while the WAL's inputs are replayed: signing errors are
        # silenced and no step marker is written or published.
        # replay_mode=True builds a playback-only instance (the replay
        # console), fed recorded inputs through replay_one(), never
        # start()ed
        self._replay_mode = replay_mode
        self._task: Optional[asyncio.Task] = None
        # messages queued and not yet handled, own ones included: a
        # queue's join() cannot tell, since the loop's pending get()
        # may hold an own message taken off its queue
        self._in_flight = 0
        self._idle = asyncio.Event()
        self._idle.set()

        # overridable for the Byzantine plane (reference: state.go
        # decideProposal/doPrevote function fields)
        self.decide_proposal = self._default_decide_proposal
        self.do_prevote = self._default_do_prevote

        self._update_to_state(state)
        self._reconstruct_last_commit_from_store(state)

    # -- lifecycle --

    async def on_start(self) -> None:
        if self.privval is not None:
            self.privval_pub_key = await self.privval.get_pub_key()
        await self.wal.start()
        await self.ticker.start()
        await self._catchup_replay(self.rs.height)
        # the loop's task is the node's own, not spawn()'s: an error that
        # ends it is logged when it ends (_receive_guarded), returned by
        # failure() and raised by wait_idle() and stop()
        self._task = asyncio.get_running_loop().create_task(self._receive_guarded())
        self._schedule_round_0()

    async def on_stop(self) -> None:
        task, self._task = self._task, None
        try:
            if task is not None:
                if not task.done():
                    task.cancel()
                try:
                    await task
                except asyncio.CancelledError:
                    pass
        finally:
            await self.ticker.stop()
            await self.wal.stop()

    def failure(self) -> Optional[BaseException]:
        """What ended the receive loop, or None while it runs."""
        task = self._task
        if task is None or not task.done() or task.cancelled():
            return None
        return task.exception()

    async def wait_idle(self) -> None:
        """Return once every message queued so far was handled, own
        messages included; raise what ended the receive loop if it
        ended."""
        if self._task is None:
            raise RuntimeError("the receive loop is not running")
        idle = asyncio.ensure_future(self._idle.wait())
        done, _ = await asyncio.wait({idle, self._task}, return_when=asyncio.FIRST_COMPLETED)
        if idle not in done:
            idle.cancel()
            self._task.result()  # the loop's error
            raise RuntimeError("the receive loop ended")

    # -- public API --

    def get_round_state(self) -> RoundState:
        """The live round state (the RPC consensus routes read it)."""
        return self.rs

    def send_peer_msg(self, msg, peer_id: str) -> bool:
        """Enqueue a message from a peer; False when the queue is full
        and it was dropped (gossip is redundant and resent, and a slow
        loop must push back on peers, not fail)."""
        try:
            self.peer_msg_queue.put_nowait(MsgInfo(msg=msg, peer_id=peer_id))
        except asyncio.QueueFull:
            self.logger.debug(
                "peer msg queue full; dropping %s from %s", type(msg).__name__, peer_id[:12]
            )
            return False
        self._queued()
        return True

    def _send_internal(self, msg) -> None:
        """Enqueue our own message (peer id '')."""
        self.internal_msg_queue.put_nowait(MsgInfo(msg=msg, peer_id=""))
        self._queued()

    def _queued(self) -> None:
        self._in_flight += 1
        self._idle.clear()

    def _handled(self) -> None:
        self._in_flight -= 1
        if self._in_flight == 0:
            self._idle.set()

    def is_proposer(self, address: bytes) -> bool:
        return self.rs.validators.get_proposer().address == address

    def privval_address(self) -> Optional[bytes]:
        return self.privval_pub_key.address() if self.privval_pub_key is not None else None

    async def wait_for_height(self, height: int, timeout: float = 30) -> None:
        """Block until consensus reaches `height`; raise what ended the
        receive loop if it ended."""
        deadline = time.monotonic() + timeout
        while self.rs.height < height:
            if self._task is not None and self._task.done():
                self._task.result()
                raise RuntimeError("the receive loop ended")
            if time.monotonic() > deadline:
                raise TimeoutError(f"height {height} not reached (at {self.rs.height})")
            await asyncio.sleep(_WAIT_POLL_S)

    # -- state transitions between heights --

    def _update_to_state(self, state: State) -> None:
        """Reset the RoundState for the height after
        state.last_block_height (reference: state.go:670-792)."""
        rs = self.rs
        if rs.commit_round > -1 and 0 < rs.height != state.last_block_height:
            raise RuntimeError(
                f"updateToState at height {state.last_block_height} "
                f"while at {rs.height}/{rs.commit_round}"
            )
        if (
            self.state is not None
            and self.state.last_block_height > 0
            and self.state.last_block_height + 1 != rs.height
        ):
            # last_block_height 0 is the genesis: rs.height is then the
            # initial height, which may be above 1
            raise RuntimeError("inconsistent state for ConsensusState")

        # the +2/3 precommits carry over as the new LastCommit
        last_commit: Optional[VoteSet] = None
        if state.last_block_height > 0 and rs.commit_round > -1:
            precommits = rs.votes.precommits(rs.commit_round)
            if precommits is None or not precommits.has_two_thirds_majority():
                raise RuntimeError("updateToState called without +2/3 precommits")
            last_commit = precommits
        elif state.last_block_height > 0:
            last_commit = rs.last_commit  # a restart: set by the reconstruction

        height = state.last_block_height + 1
        if height == 1:
            height = state.initial_height

        # the height's start time: the local clock plus timeout_commit
        now_ns = time.time_ns()
        if rs.commit_time_ns == 0:
            start_time_ns = now_ns + _s_to_ns(self.cfg.timeout_commit)
        else:
            start_time_ns = rs.commit_time_ns + _s_to_ns(self.cfg.timeout_commit)

        validators = state.validators
        rs.height = height
        rs.round = 0
        rs.step = RoundStep.NEW_HEIGHT
        rs.start_time_ns = start_time_ns
        rs.validators = validators
        rs.proposal = None
        rs.proposal_block = None
        rs.proposal_block_parts = None
        rs.locked_round = -1
        rs.locked_block = None
        rs.locked_block_parts = None
        rs.valid_round = -1
        rs.valid_block = None
        rs.valid_block_parts = None
        rs.votes = HeightVoteSet(state.chain_id, height, validators)
        rs.commit_round = -1
        rs.last_commit = last_commit
        rs.last_validators = state.last_validators
        rs.triggered_timeout_precommit = False
        self.state = state

    def _reconstruct_last_commit_from_store(self, state: State) -> None:
        """On a restart, rebuild the LastCommit from the stored seen
        commit (reference: state.go:640-668)."""
        if state.last_block_height == 0:
            return
        if self.rs.last_commit is not None:
            return
        seen = self.block_store.load_seen_commit()
        if seen is None or seen.height != state.last_block_height:
            seen = self.block_store.load_block_commit(state.last_block_height)
        if seen is None:
            raise RuntimeError(
                f"failed to reconstruct last commit; commit for height "
                f"{state.last_block_height} not found"
            )
        vote_set = commit_to_vote_set(state.chain_id, seen, state.last_validators)
        if not vote_set.has_two_thirds_majority():
            raise RuntimeError("failed to reconstruct last commit; does not have +2/3")
        self.rs.last_commit = vote_set

    def _schedule_round_0(self) -> None:
        """reference: state.go scheduleRound0."""
        delay_ns = max(0, self.rs.start_time_ns - time.time_ns())
        self._schedule_timeout(delay_ns / NS_PER_S, self.rs.height, 0, RoundStep.NEW_HEIGHT)

    def _schedule_timeout(self, duration_s: float, height: int, round_: int, step: int) -> None:
        self.ticker.schedule(
            TimeoutInfo(duration_s=duration_s, height=height, round=round_, step=step)
        )

    # -- the receive loop (reference: state.go:803 receiveRoutine) --

    async def _receive_guarded(self) -> None:
        """The receive loop; an error that ends it is logged at ERROR at
        once, as the JAX service's `_run_guarded`
        (tendermint_tpu/libs/service.py:131) logs it, and raised."""
        try:
            await self._receive_routine()
        except Exception:
            self.logger.exception("task receive failed")
            raise

    async def _receive_routine(self) -> None:
        internal_get = peer_get = timeout_get = None
        loop = asyncio.get_running_loop()
        try:
            while True:
                if internal_get is None:
                    internal_get = loop.create_task(self.internal_msg_queue.get())
                if peer_get is None:
                    peer_get = loop.create_task(self.peer_msg_queue.get())
                if timeout_get is None:
                    timeout_get = loop.create_task(self.ticker.timeout_queue.get())
                done, _ = await asyncio.wait(
                    {internal_get, peer_get, timeout_get},
                    return_when=asyncio.FIRST_COMPLETED,
                )
                # own messages first: an own vote or proposal applies
                # before more peer input
                if internal_get in done:
                    mi = internal_get.result()
                    internal_get = None
                    await self._handle_own(mi)
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
                            await self._handle_own(own)
                        self.wal.write(m)
                        await self._handle_msg(m)
                        self._handled()
                if timeout_get in done:
                    ti = timeout_get.result()
                    timeout_get = None
                    self.wal.write(ti)
                    await self._handle_timeout(ti)
        finally:
            for t in (internal_get, peer_get, timeout_get):
                if t is not None and not t.done():
                    t.cancel()

    async def _handle_own(self, mi: MsgInfo) -> None:
        self.wal.write_sync(mi)  # an own message: fsync before it acts
        await self._handle_msg(mi)
        self._handled()

    def _preverify_votes(self, batch: list) -> None:
        """Verify the signatures of the burst's votes of the current
        height in one batch a key type, recording the valid triples in
        the verified-signature cache. Runs in the single-writer loop
        against rs.validators, the set every VoteSet of this height
        verifies with; the cache key binds the exact triple, so it never
        widens what is accepted. A vote left out, or whose signature
        failed, takes the per-vote path, which gives its own error."""
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
        chain_id = self.state.chain_id
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
        """reference: state.go:891-960 handleMsg."""
        msg, peer_id = mi.msg, mi.peer_id
        try:
            if isinstance(msg, ProposalMessage):
                self._set_proposal(msg.proposal)
            elif isinstance(msg, BlockPartMessage):
                added = await self._add_proposal_block_part(msg, peer_id)
                if added:
                    await self._handle_complete_proposal()
            elif isinstance(msg, VoteMessage):
                await self._try_add_vote(msg.vote, peer_id)
            else:
                self.logger.error("unknown msg type in receive loop: %s", type(msg).__name__)
        except CHECK_ERRORS as e:
            self.logger.error(
                "failed to process message: height %d round %d %s: %s",
                self.rs.height,
                self.rs.round,
                type(msg).__name__,
                e,
            )

    async def _handle_timeout(self, ti: TimeoutInfo) -> None:
        """reference: state.go:962-1011 handleTimeout."""
        rs = self.rs
        if ti.height != rs.height or ti.round < rs.round or (
            ti.round == rs.round and ti.step < rs.step
        ):
            self.logger.debug("ignoring tock because we are ahead: %r", ti)
            return
        if ti.step == RoundStep.NEW_HEIGHT:
            await self._enter_new_round(ti.height, 0)
        elif ti.step == RoundStep.NEW_ROUND:
            await self._enter_propose(ti.height, 0)
        elif ti.step == RoundStep.PROPOSE:
            self._publish_round_state_event("timeout_propose")
            await self._enter_prevote(ti.height, ti.round)
        elif ti.step == RoundStep.PREVOTE_WAIT:
            self._publish_round_state_event("timeout_wait")
            await self._enter_precommit(ti.height, ti.round)
        elif ti.step == RoundStep.PRECOMMIT_WAIT:
            self._publish_round_state_event("timeout_wait")
            await self._enter_precommit(ti.height, ti.round)
            await self._enter_new_round(ti.height, ti.round + 1)
        else:
            raise RuntimeError(f"invalid timeout step {ti.step}")

    # -- round-step transitions --

    async def _enter_new_round(self, height: int, round_: int) -> None:
        """reference: state.go:1062-1142."""
        rs = self.rs
        if rs.height != height or round_ < rs.round or (
            rs.round == round_ and rs.step != RoundStep.NEW_HEIGHT
        ):
            return
        self.logger.info("entering new round %d/%d (at %s)", height, round_, rs.height_round_step())
        validators = rs.validators
        if rs.round < round_:
            validators = validators.copy()
            validators.increment_proposer_priority(round_ - rs.round)
        rs.round = round_
        rs.step = RoundStep.NEW_ROUND
        rs.validators = validators
        if round_ != 0:
            # round 0 keeps the proposal from NewHeight; later rounds
            # start over (a valid block is re-proposed by the new proposer)
            rs.proposal = None
            rs.proposal_block = None
            rs.proposal_block_parts = None
        rs.votes.set_round(round_ + 1)  # track the next round's votes too
        rs.triggered_timeout_precommit = False
        if self.event_bus:
            self.event_bus.publish_new_round(
                E.EventDataNewRound(
                    height=height,
                    round=round_,
                    step=step_name(rs.step),
                    proposer_address=rs.validators.get_proposer().address,
                )
            )
        await self._enter_propose(height, round_)

    async def _enter_propose(self, height: int, round_: int) -> None:
        """reference: state.go:1144-1213."""
        rs = self.rs
        if rs.height != height or round_ < rs.round or (
            rs.round == round_ and rs.step >= RoundStep.PROPOSE
        ):
            return
        self.logger.debug("entering propose step %s", rs.height_round_step())
        rs.step = RoundStep.PROPOSE
        self._new_step()

        # the propose timeout, whoever proposes
        self._schedule_timeout(self.cfg.propose_timeout(round_), height, round_, RoundStep.PROPOSE)

        # replay runs this too: the signer re-signs (the same HRS gives
        # the same signature) and the queued message repeats the
        # replayed one (reference: replay.go:98-100, state.go:1258)
        addr = self.privval_address()
        if addr is not None and rs.validators.has_address(addr):
            if self.is_proposer(addr):
                self.logger.debug("our turn to propose")
                await self.decide_proposal(height, round_)

        if self._is_proposal_complete():
            await self._enter_prevote(height, round_)

    async def _default_decide_proposal(self, height: int, round_: int) -> None:
        """reference: state.go:1215-1266 defaultDecideProposal."""
        rs = self.rs
        if rs.valid_block is not None:
            block, block_parts = rs.valid_block, rs.valid_block_parts
        else:
            commit = self._load_commit_for_proposal(height)
            if commit is None:
                self.logger.error("propose: no last commit available")
                return
            block, block_parts = self.block_exec.create_proposal_block(
                height, self.state, commit, self.privval_address()
            )

        block_id = BlockID(hash=block.hash(), part_set_header=block_parts.header())
        proposal = Proposal(height=height, round=round_, pol_round=rs.valid_round, block_id=block_id)
        try:
            await self.privval.sign_proposal(self.state.chain_id, proposal)
        except SIGNER_ERRORS as e:
            if not self._replay_mode:
                self.logger.error("propose: failed to sign proposal: %s", e)
            return
        self._send_internal(ProposalMessage(proposal=proposal))
        for i in range(block_parts.total):
            part = block_parts.get_part(i)
            self._send_internal(BlockPartMessage(height=rs.height, round=round_, part=part))
        self.logger.info("signed proposal %d/%d %s", height, round_, block.hash().hex()[:16])

    def _load_commit_for_proposal(self, height: int) -> Optional[Commit]:
        if height == self.state.initial_height:
            return Commit(height=0, round=0, block_id=BlockID(), signatures=[])
        if self.rs.last_commit is not None and self.rs.last_commit.has_two_thirds_majority():
            return self.rs.last_commit.make_commit()
        return None

    def _is_proposal_complete(self) -> bool:
        """reference: state.go:1268-1282."""
        rs = self.rs
        if rs.proposal is None or rs.proposal_block is None:
            return False
        if rs.proposal.pol_round < 0:
            return True
        prevotes = rs.votes.prevotes(rs.proposal.pol_round)
        return prevotes is not None and prevotes.has_two_thirds_majority()

    async def _enter_prevote(self, height: int, round_: int) -> None:
        """reference: state.go:1323-1352."""
        rs = self.rs
        if rs.height != height or round_ < rs.round or (
            rs.round == round_ and rs.step >= RoundStep.PREVOTE
        ):
            return
        self.logger.debug("entering prevote step %s", rs.height_round_step())
        rs.step = RoundStep.PREVOTE
        self._new_step()
        await self.do_prevote(height, round_)

    async def _default_do_prevote(self, height: int, round_: int) -> None:
        """reference: state.go:1354-1417 defaultDoPrevote."""
        rs = self.rs
        if rs.locked_block is not None:
            self.logger.debug("prevote: locked block")
            await self._sign_add_vote(
                PREVOTE_TYPE, rs.locked_block.hash(), rs.locked_block_parts.header()
            )
            return
        if rs.proposal_block is None:
            self.logger.debug("prevote: ProposalBlock is nil; voting nil")
            await self._sign_add_vote(PREVOTE_TYPE, b"", None)
            return
        try:
            self.block_exec.validate_block(self.state, rs.proposal_block)
        except CHECK_ERRORS as e:
            self.logger.error("prevote: ProposalBlock is invalid; voting nil: %s", e)
            await self._sign_add_vote(PREVOTE_TYPE, b"", None)
            return
        await self._sign_add_vote(
            PREVOTE_TYPE, rs.proposal_block.hash(), rs.proposal_block_parts.header()
        )

    async def _enter_prevote_wait(self, height: int, round_: int) -> None:
        """reference: state.go enterPrevoteWait."""
        rs = self.rs
        if rs.height != height or round_ < rs.round or (
            rs.round == round_ and rs.step >= RoundStep.PREVOTE_WAIT
        ):
            return
        prevotes = rs.votes.prevotes(round_)
        if prevotes is None or not prevotes.has_two_thirds_any():
            raise RuntimeError("enterPrevoteWait without +2/3 prevotes for any block")
        rs.step = RoundStep.PREVOTE_WAIT
        self._new_step()
        self._schedule_timeout(
            self.cfg.prevote_timeout(round_), height, round_, RoundStep.PREVOTE_WAIT
        )

    async def _enter_precommit(self, height: int, round_: int) -> None:
        """reference: state.go:1419-1540."""
        rs = self.rs
        if rs.height != height or round_ < rs.round or (
            rs.round == round_ and rs.step >= RoundStep.PRECOMMIT
        ):
            return
        self.logger.debug("entering precommit step %s", rs.height_round_step())
        rs.step = RoundStep.PRECOMMIT
        self._new_step()

        prevotes = rs.votes.prevotes(round_)
        block_id, ok = prevotes.two_thirds_majority() if prevotes else (BlockID(), False)

        if not ok:
            self.logger.debug("precommit: no +2/3 prevotes; precommitting nil")
            await self._sign_add_vote(PRECOMMIT_TYPE, b"", None)
            return

        self._publish_round_state_event("polka")

        if block_id.is_zero():
            # +2/3 prevoted nil: unlock and precommit nil
            if rs.locked_block is not None:
                self.logger.debug("precommit: +2/3 prevoted nil; unlocking")
                rs.locked_round = -1
                rs.locked_block = None
                rs.locked_block_parts = None
            await self._sign_add_vote(PRECOMMIT_TYPE, b"", None)
            return

        if rs.locked_block is not None and rs.locked_block.hashes_to(block_id.hash):
            self.logger.debug("precommit: +2/3 prevoted locked block; relocking")
            rs.locked_round = round_
            self._publish_round_state_event("relock")
            await self._sign_add_vote(PRECOMMIT_TYPE, block_id.hash, block_id.part_set_header)
            return

        if rs.proposal_block is not None and rs.proposal_block.hashes_to(block_id.hash):
            self.logger.debug(
                "precommit: +2/3 prevoted proposal block; locking %s", block_id.hash.hex()[:16]
            )
            self.block_exec.validate_block(self.state, rs.proposal_block)
            rs.locked_round = round_
            rs.locked_block = rs.proposal_block
            rs.locked_block_parts = rs.proposal_block_parts
            self._publish_round_state_event("lock")
            await self._sign_add_vote(PRECOMMIT_TYPE, block_id.hash, block_id.part_set_header)
            return

        # +2/3 prevotes for a block we do not have: unlock, fetch it
        rs.locked_round = -1
        rs.locked_block = None
        rs.locked_block_parts = None
        if rs.proposal_block_parts is None or not rs.proposal_block_parts.has_header(
            block_id.part_set_header
        ):
            rs.proposal_block = None
            rs.proposal_block_parts = PartSet.from_header(block_id.part_set_header)
        await self._sign_add_vote(PRECOMMIT_TYPE, b"", None)

    async def _enter_precommit_wait(self, height: int, round_: int) -> None:
        """reference: state.go enterPrecommitWait."""
        rs = self.rs
        if rs.height != height or round_ < rs.round or (
            rs.round == round_ and rs.triggered_timeout_precommit
        ):
            return
        precommits = rs.votes.precommits(round_)
        if precommits is None or not precommits.has_two_thirds_any():
            raise RuntimeError("enterPrecommitWait without +2/3 precommits for any block")
        rs.triggered_timeout_precommit = True
        self._new_step()
        self._schedule_timeout(
            self.cfg.precommit_timeout(round_), height, round_, RoundStep.PRECOMMIT_WAIT
        )

    async def _enter_commit(self, height: int, commit_round: int) -> None:
        """reference: state.go:1573-1634."""
        rs = self.rs
        if rs.height != height or rs.step >= RoundStep.COMMIT:
            return
        self.logger.info(
            "entering commit step %s, commit round %d", rs.height_round_step(), commit_round
        )
        rs.step = RoundStep.COMMIT
        rs.commit_round = commit_round
        # the local anchor of the next height's start
        rs.commit_time_ns = time.time_ns()
        self._new_step()

        precommits = rs.votes.precommits(commit_round)
        block_id, ok = precommits.two_thirds_majority()
        if not ok:
            raise RuntimeError("enterCommit expects +2/3 precommits")

        if rs.locked_block is not None and rs.locked_block.hashes_to(block_id.hash):
            rs.proposal_block = rs.locked_block
            rs.proposal_block_parts = rs.locked_block_parts
        if rs.proposal_block is None or not rs.proposal_block.hashes_to(block_id.hash):
            if rs.proposal_block_parts is None or not (
                rs.proposal_block_parts.has_header(block_id.part_set_header)
            ):
                self.logger.info(
                    "commit is for a block we do not know about; set ProposalBlock=nil: %s",
                    block_id.hash.hex()[:16],
                )
                rs.proposal_block = None
                rs.proposal_block_parts = PartSet.from_header(block_id.part_set_header)
                self._publish_round_state_event("valid_block")
        await self._try_finalize_commit(height)

    async def _try_finalize_commit(self, height: int) -> None:
        """reference: state.go:1636-1662."""
        rs = self.rs
        if rs.height != height:
            raise RuntimeError("tryFinalizeCommit at wrong height")
        precommits = rs.votes.precommits(rs.commit_round)
        block_id, ok = precommits.two_thirds_majority()
        if not ok or block_id.is_zero():
            self.logger.error(
                "failed attempt to finalize commit; there was no +2/3 majority "
                "or +2/3 was for nil"
            )
            return
        if rs.proposal_block is None or not rs.proposal_block.hashes_to(block_id.hash):
            self.logger.debug(
                "failed attempt to finalize commit; we do not have the commit block %s",
                block_id.hash.hex()[:16],
            )
            return
        await self._finalize_commit(height)

    async def _finalize_commit(self, height: int) -> None:
        """Save the block, write EndHeight, apply the block, advance
        (reference: state.go:1664-1777)."""
        rs = self.rs
        if rs.height != height or rs.step != RoundStep.COMMIT:
            return
        precommits = rs.votes.precommits(rs.commit_round)
        block, block_parts = rs.proposal_block, rs.proposal_block_parts

        block.validate_basic()
        self.block_exec.validate_block(self.state, block)

        self.logger.info(
            "finalizing commit of block %d %s, %d txs",
            height,
            block.hash().hex()[:16],
            len(block.txs),
        )
        if self.block_store.height() < block.header.height:
            seen_commit = precommits.make_commit()
            self.block_store.save_block(block, block_parts, seen_commit)
        else:
            self.logger.debug("calling finalizeCommit on already stored block %d", height)

        # EndHeight says the block store has the block; a crash before it
        # re-runs apply_block through the handshake on restart
        # (reference: state.go:1714-1733)
        self.wal.write_end_height(height)

        state_copy = self.state.copy()
        new_state = await self.block_exec.apply_block(
            state_copy,
            BlockID(hash=block.hash(), part_set_header=block_parts.header()),
            block,
        )

        self._update_to_state(new_state)

        if self.privval is not None:
            try:
                self.privval_pub_key = await self.privval.get_pub_key()
            except SIGNER_ERRORS as e:
                self.logger.error("failed to refetch privval pubkey: %s", e)
        self._schedule_round_0()

    # -- proposals --

    def _set_proposal(self, proposal: Proposal) -> None:
        """reference: state.go:1786-1836 defaultSetProposal."""
        rs = self.rs
        if rs.proposal is not None:
            return
        if proposal.height != rs.height or proposal.round != rs.round:
            return
        if proposal.pol_round < -1 or (0 <= proposal.pol_round >= proposal.round):
            raise ValueError("invalid proposal POL round")
        proposer = rs.validators.get_proposer()
        if not proposal.verify(self.state.chain_id, proposer.pub_key):
            raise ValueError("invalid proposal signature")
        rs.proposal = proposal
        if rs.proposal_block_parts is None:
            rs.proposal_block_parts = PartSet.from_header(proposal.block_id.part_set_header)
        self.logger.info(
            "received proposal %d/%d %s",
            proposal.height,
            proposal.round,
            proposal.block_id.hash.hex()[:16],
        )

    async def _add_proposal_block_part(self, msg: BlockPartMessage, peer_id: str) -> bool:
        """reference: state.go:1838-1896. True if the part was added."""
        rs = self.rs
        if msg.height != rs.height:
            return False
        if rs.proposal_block_parts is None:
            return False
        added = rs.proposal_block_parts.add_part(msg.part)
        if added and rs.proposal_block_parts.is_complete():
            data = rs.proposal_block_parts.assemble()
            rs.proposal_block = Block.from_proto(data)
            self.logger.info(
                "received complete proposal block %d %s",
                rs.proposal_block.header.height,
                rs.proposal_block.hash().hex()[:16],
            )
            if self.event_bus:
                self.event_bus.publish_complete_proposal(
                    E.EventDataCompleteProposal(
                        height=rs.height,
                        round=rs.round,
                        step=step_name(rs.step),
                        block_id=BlockID(
                            hash=rs.proposal_block.hash(),
                            part_set_header=rs.proposal_block_parts.header(),
                        ),
                    )
                )
        return added

    async def _handle_complete_proposal(self) -> None:
        """reference: state.go:1898-1942."""
        rs = self.rs
        if rs.proposal_block is None:
            return
        prevotes = rs.votes.prevotes(rs.round)
        if prevotes is not None:
            block_id, has_two_thirds = prevotes.two_thirds_majority()
            if has_two_thirds and not block_id.is_zero() and rs.valid_round < rs.round:
                if rs.proposal_block.hashes_to(block_id.hash):
                    rs.valid_round = rs.round
                    rs.valid_block = rs.proposal_block
                    rs.valid_block_parts = rs.proposal_block_parts
        if rs.step <= RoundStep.PROPOSE and self._is_proposal_complete():
            await self._enter_prevote(rs.height, rs.round)
        elif rs.step == RoundStep.COMMIT:
            await self._try_finalize_commit(rs.height)

    # -- votes --

    async def _try_add_vote(self, vote: Vote, peer_id: str) -> bool:
        """reference: state.go:2010-2056: a vote's failure is an outcome
        (logged, False), not an error of the loop."""
        try:
            return await self._add_vote(vote, peer_id)
        except ConflictingVoteError as e:
            addr = self.privval_address()
            if addr is not None and vote.validator_address == addr:
                self.logger.error(
                    "found conflicting vote from ourselves; did you unsafe_reset "
                    "a validator? height %d round %d type %d",
                    vote.height,
                    vote.round,
                    vote.type,
                )
                return False
            if self.evpool is not None and hasattr(self.evpool, "report_conflicting_votes"):
                self.evpool.report_conflicting_votes(e.vote_a, e.vote_b)
            self.logger.debug(
                "found and sent conflicting votes to the evidence pool: %s / %s",
                e.vote_a,
                e.vote_b,
            )
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
            added = rs.last_commit.add_vote(vote)
            if not added:
                return False
            self._publish_vote_event(vote)
            if self.cfg.skip_timeout_commit and rs.last_commit.has_all():
                await self._enter_new_round(height, 0)
            return added

        if vote.height != height:
            return False

        added = rs.votes.add_vote(vote, peer_id)
        if not added:
            return False
        self._publish_vote_event(vote)

        if vote.type == PREVOTE_TYPE:
            await self._after_prevote_added(vote)
        elif vote.type == PRECOMMIT_TYPE:
            await self._after_precommit_added(vote)
        return added

    async def _after_prevote_added(self, vote: Vote) -> None:
        rs = self.rs
        height = rs.height
        prevotes = rs.votes.prevotes(vote.round)
        block_id, ok = prevotes.two_thirds_majority()
        if ok:
            # unlock on a newer POL for another block
            if (
                rs.locked_block is not None
                and rs.locked_round < vote.round <= rs.round
                and not rs.locked_block.hashes_to(block_id.hash)
            ):
                self.logger.debug(
                    "unlocking because of POL: locked round %d, POL round %d",
                    rs.locked_round,
                    vote.round,
                )
                rs.locked_round = -1
                rs.locked_block = None
                rs.locked_block_parts = None
            # update the valid block
            if not block_id.is_zero() and rs.valid_round < vote.round == rs.round:
                if rs.proposal_block is not None and rs.proposal_block.hashes_to(block_id.hash):
                    rs.valid_round = vote.round
                    rs.valid_block = rs.proposal_block
                    rs.valid_block_parts = rs.proposal_block_parts
                else:
                    # a polka for a block we do not have: fetch it
                    rs.proposal_block = None
                if rs.proposal_block_parts is None or not (
                    rs.proposal_block_parts.has_header(block_id.part_set_header)
                ):
                    rs.proposal_block_parts = PartSet.from_header(block_id.part_set_header)
                self._publish_round_state_event("valid_block")

        if rs.round < vote.round and prevotes.has_two_thirds_any():
            await self._enter_new_round(height, vote.round)
        elif rs.round == vote.round and rs.step >= RoundStep.PREVOTE:
            block_id, ok = prevotes.two_thirds_majority()
            if ok and (self._is_proposal_complete() or block_id.is_zero()):
                await self._enter_precommit(height, vote.round)
            elif prevotes.has_two_thirds_any():
                await self._enter_prevote_wait(height, vote.round)
        elif rs.proposal is not None and 0 <= rs.proposal.pol_round == vote.round:
            if self._is_proposal_complete():
                await self._enter_prevote(height, rs.round)

    async def _after_precommit_added(self, vote: Vote) -> None:
        rs = self.rs
        height = rs.height
        precommits = rs.votes.precommits(vote.round)
        block_id, ok = precommits.two_thirds_majority()
        if ok:
            await self._enter_new_round(height, vote.round)
            await self._enter_precommit(height, vote.round)
            if not block_id.is_zero():
                await self._enter_commit(height, vote.round)
                if self.cfg.skip_timeout_commit and precommits.has_all():
                    await self._enter_new_round(rs.height, 0)
            else:
                await self._enter_precommit_wait(height, vote.round)
        elif rs.round <= vote.round and precommits.has_two_thirds_any():
            await self._enter_new_round(height, vote.round)
            await self._enter_precommit_wait(height, vote.round)

    async def _sign_add_vote(self, msg_type: int, hash_: bytes, header) -> Optional[Vote]:
        """Sign our vote and feed it back through the internal queue
        (reference: state.go:2316-2372 signAddVote)."""
        rs = self.rs
        if self.privval is None or self.privval_pub_key is None:
            return None
        addr = self.privval_pub_key.address()
        if not rs.validators.has_address(addr):
            return None
        idx, _ = rs.validators.get_by_address(addr)
        vote = Vote(
            type=msg_type,
            height=rs.height,
            round=rs.round,
            block_id=BlockID(
                hash=hash_,
                part_set_header=header if header is not None else PartSetHeader(),
            ),
            timestamp_ns=self._vote_time(),
            validator_address=addr,
            validator_index=idx,
        )
        try:
            await self.privval.sign_vote(self.state.chain_id, vote)
        except SIGNER_ERRORS as e:
            if not self._replay_mode:
                self.logger.error("failed signing vote: %s", e)
            return None
        self._send_internal(VoteMessage(vote=vote))
        self.logger.debug("signed and pushed vote %d/%d type %d", rs.height, rs.round, msg_type)
        return vote

    def _vote_time(self) -> int:
        """Now, but never before the last block's time plus 1 ms
        (reference: state.go voteTime)."""
        now = time.time_ns()
        min_vote_time = now
        if self.state is not None and self.state.last_block_time_ns > 0:
            min_vote_time = self.state.last_block_time_ns + 1_000_000
        return max(now, min_vote_time)

    # -- WAL replay (crash recovery) --

    async def _catchup_replay(self, height: int) -> None:
        """Replay the WAL's messages recorded after the last EndHeight
        (reference: internal/consensus/replay.go:96-170). At the chain's
        first height there is no EndHeight(height - 1): the WAL opens
        with EndHeight(0) (replay.go:127-129)."""
        end_height = height - 1
        if self.state is not None and height == self.state.initial_height:
            end_height = 0
        msgs = self.wal.search_for_end_height(end_height)
        if msgs is None:
            return
        self._replay_mode = True
        try:
            for msg in msgs:
                await self.replay_one(msg)
        finally:
            self._replay_mode = False
        self.logger.info("replayed %d WAL messages at height %d", len(msgs), height)

    async def replay_one(self, msg) -> None:
        """Feed one recorded WAL input through the step machine. An
        EndHeight record is a store and WAL mismatch (a crash between
        the EndHeight fsync and the state's save) and raises, rather
        than merging heights (reference: replay.go readReplayMessage)."""
        if isinstance(msg, MsgInfo):
            await self._handle_msg(msg)
        elif isinstance(msg, TimeoutInfo):
            await self._handle_timeout(msg)
        elif isinstance(msg, EndHeightMessage):
            raise RuntimeError(
                f"unexpected EndHeight {msg.height} during replay at height {self.rs.height}"
            )
        # EventDataRoundStateWAL markers are informational

    # -- events --

    def _new_step(self) -> None:
        step = step_name(self.rs.step)
        if not self._replay_mode:
            # the round-state marker in the WAL (reference: state.go
            # newStep -> wal.Write(rs)); buffered, no fsync
            self.wal.write(EventDataRoundStateWAL(height=self.rs.height, round=self.rs.round, step=step))
        if self.event_bus and not self._replay_mode:
            self.event_bus.publish_new_round_step(
                E.EventDataRoundState(height=self.rs.height, round=self.rs.round, step=step)
            )

    def _publish_round_state_event(self, kind: str) -> None:
        if self.event_bus is None or self._replay_mode:
            return
        data = E.EventDataRoundState(
            height=self.rs.height, round=self.rs.round, step=step_name(self.rs.step)
        )
        publish = {
            "timeout_propose": self.event_bus.publish_timeout_propose,
            "timeout_wait": self.event_bus.publish_timeout_wait,
            "polka": self.event_bus.publish_polka,
            "relock": self.event_bus.publish_relock,
            "lock": self.event_bus.publish_lock,
            "valid_block": self.event_bus.publish_valid_block,
        }.get(kind)
        if publish:
            publish(data)

    def _publish_vote_event(self, vote: Vote) -> None:
        if self.event_bus and not self._replay_mode:
            self.event_bus.publish_vote(E.EventDataVote(vote=vote))
