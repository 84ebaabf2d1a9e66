"""The consensus reactor: the consensus protocol's gossip over p2p.

Counterpart: tendermint_tpu/consensus/reactor.py:1-773 (reference:
internal/consensus/reactor.go). Four channels (State 0x20, Data 0x21,
Vote 0x22, VoteSetBits 0x23; descriptors :65-85), the peer updates
(:137-166), the NewRoundStep and HasVote broadcasts driven by the event
bus (:171-238), the four receive routines (:243-376), and per peer the
data gossip (:381-528, with its catch-up branch), the vote gossip
(:530-734, with its catch-up branches and stall ticks) and the
VoteSetMaj23 queries (:736-773); switch_to_consensus (:127).

What the device does here: nothing directly. Votes and proposals
received are queued for the step machine (cs.send_peer_msg), whose
receive loop pre-verifies each burst of votes on the card; blocks for
catch-up are read from the block store. So `_recv_routine` keeps the
JAX catch of every exception around a handler (:243-258), which logs
and reports the peer: its handlers decode, check a message's shape,
update PeerState, queue for the step machine and read the block store
and the vote sets, and no device call runs under it. A failed launch
ends the step machine's loop and reaches the caller of its
wait_for_height() or stop() as before.

Two changes of method, not of result: a live vote or a block part to
send is found as the randbelow(count)-th set bit of what the peer lacks
(PeerState, pick_missing), where the JAX package lists every candidate;
the draw of the gossip RNG is the same (a stored commit's precommits,
sent to a peer two heights behind, are listed as there). The broadcast
routine sends a HasVote for every vote event queued when it wakes, one
turn of the loop for a burst of the step machine.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Dict, Optional

from ..config import ConsensusConfig
from ..eventbus import EventBus
from ..libs import rng
from ..libs.bits import BitArray
from ..libs.service import Service
from ..p2p.channel import Channel
from ..p2p.peermanager import PeerStatus
from ..p2p.types import ChannelDescriptor, Envelope, PeerError
from ..pubsub import SubscriptionError
from ..types import events as E
from ..types.canonical import PRECOMMIT_TYPE, PREVOTE_TYPE
from .msgs import (
    BlockPartMessage,
    HasVoteMessage,
    NewRoundStepMessage,
    NewValidBlockMessage,
    ProposalMessage,
    ProposalPOLMessage,
    VoteMessage,
    VoteSetBitsMessage,
    VoteSetMaj23Message,
    decode_msg,
    encode_msg,
)
from .peer_state import PeerState, pick_missing
from .state import ConsensusState
from .types import RoundStep

__all__ = [
    "ConsensusReactor",
    "STATE_CHANNEL",
    "DATA_CHANNEL",
    "VOTE_CHANNEL",
    "VOTE_SET_BITS_CHANNEL",
    "consensus_channel_descriptors",
]

STATE_CHANNEL = 0x20
DATA_CHANNEL = 0x21
VOTE_CHANNEL = 0x22
VOTE_SET_BITS_CHANNEL = 0x23


class _MsgCodec:
    """All four channels share the consensus Message oneof envelope."""

    encode = staticmethod(encode_msg)
    decode = staticmethod(decode_msg)


def consensus_channel_descriptors():
    """reference: reactor.go:31-67 (priorities and queue sizes)."""
    return {
        STATE_CHANNEL: ChannelDescriptor(
            channel_id=STATE_CHANNEL, message_type=_MsgCodec, priority=8,
            send_queue_capacity=64, recv_buffer_capacity=128, name="state",
        ),
        DATA_CHANNEL: ChannelDescriptor(
            channel_id=DATA_CHANNEL, message_type=_MsgCodec, priority=12,
            send_queue_capacity=64, recv_buffer_capacity=512, name="data",
        ),
        VOTE_CHANNEL: ChannelDescriptor(
            channel_id=VOTE_CHANNEL, message_type=_MsgCodec, priority=10,
            send_queue_capacity=64, recv_buffer_capacity=4096, name="vote",
        ),
        VOTE_SET_BITS_CHANNEL: ChannelDescriptor(
            channel_id=VOTE_SET_BITS_CHANNEL, message_type=_MsgCodec,
            priority=5, send_queue_capacity=8, recv_buffer_capacity=128,
            name="votebits",
        ),
    }


class ConsensusReactor(Service):
    def __init__(
        self,
        cs: ConsensusState,
        channels: Dict[int, Channel],
        peer_updates: asyncio.Queue,
        event_bus: EventBus,
        cfg: Optional[ConsensusConfig] = None,
        wait_sync: bool = False,
    ) -> None:
        super().__init__(name="consensus.reactor", logger=logging.getLogger(__name__))
        self.cs = cs
        self.state_ch = channels[STATE_CHANNEL]
        self.data_ch = channels[DATA_CHANNEL]
        self.vote_ch = channels[VOTE_CHANNEL]
        self.vote_bits_ch = channels[VOTE_SET_BITS_CHANNEL]
        self.peer_updates = peer_updates
        self.event_bus = event_bus
        self.cfg = cfg or cs.cfg
        self.peers: Dict[str, PeerState] = {}
        self._peer_tasks: Dict[str, list] = {}
        # started in block-sync mode: consensus runs after
        # switch_to_consensus (reference: reactor.go:252 SwitchToConsensus)
        self.wait_sync = wait_sync

    async def on_start(self) -> None:
        if not self.wait_sync:
            await self.cs.start()
        self.spawn(self._peer_update_routine(), "peer-updates")
        self.spawn(self._recv_routine(self.state_ch, self._handle_state_msg), "recv-state")
        self.spawn(self._recv_routine(self.data_ch, self._handle_data_msg), "recv-data")
        self.spawn(self._recv_routine(self.vote_ch, self._handle_vote_msg), "recv-vote")
        self.spawn(self._recv_routine(self.vote_bits_ch, self._handle_vote_bits_msg), "recv-votebits")
        self.spawn(self._broadcast_routine(), "broadcasts")

    async def on_stop(self) -> None:
        if self.cs.is_running:
            await self.cs.stop()

    async def switch_to_consensus(self, state, skip_wal: bool = False) -> None:
        """Called by block sync once caught up (reference:
        reactor.go:252-306)."""
        self.logger.info("switching to consensus")
        self.wait_sync = False
        await self.cs.start()

    # -- per-peer lifecycle --

    async def _peer_update_routine(self) -> None:
        while True:
            update = await self.peer_updates.get()
            if update.status == PeerStatus.UP:
                self._add_peer(update.node_id)
            elif update.status == PeerStatus.DOWN:
                self._remove_peer(update.node_id)

    def _add_peer(self, peer_id: str) -> None:
        if peer_id in self.peers:
            return
        ps = PeerState(peer_id)
        self.peers[peer_id] = ps
        self._peer_tasks[peer_id] = [
            self.spawn(self._gossip_data_routine(ps), f"gossip-data-{peer_id[:8]}"),
            self.spawn(self._gossip_votes_routine(ps), f"gossip-votes-{peer_id[:8]}"),
            self.spawn(self._query_maj23_routine(ps), f"maj23-{peer_id[:8]}"),
        ]
        # tell the new peer where we are
        self.state_ch.try_send(Envelope(message=self._our_new_round_step(), to=peer_id))

    def _remove_peer(self, peer_id: str) -> None:
        self.peers.pop(peer_id, None)
        for t in self._peer_tasks.pop(peer_id, []):
            if not t.done():
                t.cancel()
        self._tasks = [t for t in self._tasks if not t.done()]

    # -- broadcasts (reference: reactor.go:362-430) --

    async def _broadcast_routine(self) -> None:
        sub_steps = self.event_bus.subscribe(
            f"cs-reactor-{id(self)}",
            f"{E.EVENT_TYPE_KEY} = '{E.EventValue.NEW_ROUND_STEP}'",
            limit=256,
        )
        sub_votes = self.event_bus.subscribe(
            f"cs-reactor-{id(self)}",
            f"{E.EVENT_TYPE_KEY} = '{E.EventValue.VOTE}'",
            limit=4096,
        )
        step_t = asyncio.ensure_future(sub_steps.next())
        vote_t = asyncio.ensure_future(sub_votes.next())
        try:
            while True:
                done, _ = await asyncio.wait({step_t, vote_t}, return_when=asyncio.FIRST_COMPLETED)
                if step_t in done:
                    try:
                        step_t.result()
                        self.state_ch.try_send(
                            Envelope(message=self._our_new_round_step(), broadcast=True)
                        )
                    except SubscriptionError:
                        return
                    step_t = asyncio.ensure_future(sub_steps.next())
                if vote_t in done:
                    try:
                        # this vote and every one queued behind it: a
                        # burst of the step machine adds up to 256 votes
                        # in one turn, and one HasVote a turn let the
                        # subscription overflow at 10,000 validators
                        msg = vote_t.result()
                        while msg is not None:
                            vote = msg.data.vote
                            self.state_ch.try_send(
                                Envelope(
                                    message=HasVoteMessage(
                                        height=vote.height,
                                        round=vote.round,
                                        type=vote.type,
                                        index=vote.validator_index,
                                    ),
                                    broadcast=True,
                                )
                            )
                            msg = sub_votes.next_nowait()
                    except SubscriptionError:
                        return
                    vote_t = asyncio.ensure_future(sub_votes.next())
        finally:
            for t in (step_t, vote_t):
                if not t.done():
                    t.cancel()

    def _our_new_round_step(self) -> NewRoundStepMessage:
        rs = self.cs.rs
        secs = max(0, (time.time_ns() - rs.start_time_ns) // 1_000_000_000)
        last_commit_round = rs.last_commit.round if rs.last_commit is not None else -1
        return NewRoundStepMessage(
            height=rs.height,
            round=rs.round,
            step=rs.step,
            seconds_since_start_time=secs,
            last_commit_round=last_commit_round,
        )

    # -- inbound handlers --

    async def _recv_routine(self, channel: Channel, handler) -> None:
        async for envelope in channel:
            try:
                await handler(envelope)
            except asyncio.CancelledError:
                raise
            except Exception as e:  # see the module docstring: no device call runs here
                self.logger.error(
                    "failed to process message (ch=%s, peer=%s): %s",
                    channel.name, envelope.from_peer[:12], e,
                )
                await channel.send_error(PeerError(node_id=envelope.from_peer, err=str(e)))

    async def _handle_state_msg(self, envelope: Envelope) -> None:
        """reference: reactor.go:1088-1164 handleStateMessage."""
        ps = self.peers.get(envelope.from_peer)
        if ps is None:
            return
        msg = envelope.message
        if isinstance(msg, NewRoundStepMessage):
            msg.validate_basic()
            ps.apply_new_round_step(msg)
        elif isinstance(msg, NewValidBlockMessage):
            msg.validate_basic()
            ps.apply_new_valid_block(msg)
        elif isinstance(msg, HasVoteMessage):
            msg.validate_basic()
            ps.ensure_vote_bits(self.cs.rs.validators.size())
            ps.apply_has_vote(msg)
        elif isinstance(msg, VoteSetMaj23Message):
            msg.validate_basic()
            rs = self.cs.rs
            if rs.height != msg.height:
                return
            rs.votes.set_peer_maj23(msg.round, msg.type, ps.peer_id, msg.block_id)
            # answer with our bits for that block
            if msg.type == PREVOTE_TYPE:
                ours = rs.votes.prevotes(msg.round)
            else:
                ours = rs.votes.precommits(msg.round)
            bits = ours.bit_array_by_block_id(msg.block_id) if ours is not None else None
            self.vote_bits_ch.try_send(
                Envelope(
                    message=VoteSetBitsMessage(
                        height=msg.height,
                        round=msg.round,
                        type=msg.type,
                        block_id=msg.block_id,
                        votes=bits,
                    ),
                    to=ps.peer_id,
                )
            )
        else:
            raise ValueError(f"unexpected message on state channel: {type(msg).__name__}")

    async def _handle_data_msg(self, envelope: Envelope) -> None:
        """reference: reactor.go:1166-1212."""
        ps = self.peers.get(envelope.from_peer)
        if ps is None:
            return
        if self.wait_sync:
            return  # consensus data is ignored while block-syncing
        msg = envelope.message
        if isinstance(msg, ProposalMessage):
            msg.validate_basic()
            ps.set_has_proposal(msg.proposal)
            self.cs.send_peer_msg(msg, ps.peer_id)
        elif isinstance(msg, ProposalPOLMessage):
            msg.validate_basic()
            ps.apply_proposal_pol(msg)
        elif isinstance(msg, BlockPartMessage):
            msg.validate_basic()
            ps.set_has_proposal_block_part(msg.height, msg.round, msg.part.index)
            self.cs.send_peer_msg(msg, ps.peer_id)
        else:
            raise ValueError(f"unexpected message on data channel: {type(msg).__name__}")

    async def _handle_vote_msg(self, envelope: Envelope) -> None:
        """reference: reactor.go:1214-1244."""
        ps = self.peers.get(envelope.from_peer)
        if ps is None:
            return
        if self.wait_sync:
            return
        msg = envelope.message
        if not isinstance(msg, VoteMessage):
            raise ValueError(f"unexpected message on vote channel: {type(msg).__name__}")
        msg.validate_basic()
        vote = msg.vote
        ps.ensure_vote_bits(self.cs.rs.validators.size())
        ps.set_has_vote(vote.height, vote.round, vote.type, vote.validator_index)
        self.cs.send_peer_msg(msg, ps.peer_id)

    async def _handle_vote_bits_msg(self, envelope: Envelope) -> None:
        """reference: reactor.go:1246-1290."""
        ps = self.peers.get(envelope.from_peer)
        if ps is None:
            return
        msg = envelope.message
        if not isinstance(msg, VoteSetBitsMessage):
            raise ValueError(f"unexpected message on votebits channel: {type(msg).__name__}")
        msg.validate_basic()
        rs = self.cs.rs
        our_votes = None
        if rs.height == msg.height:
            if msg.type == PREVOTE_TYPE:
                vs = rs.votes.prevotes(msg.round)
            else:
                vs = rs.votes.precommits(msg.round)
            if vs is not None:
                our_votes = vs.bit_array_by_block_id(msg.block_id)
        ps.apply_vote_set_bits(msg, our_votes)

    # -- gossip routines --

    async def _gossip_data_routine(self, ps: PeerState) -> None:
        """Send the peer the proposal and parts it lacks; catch it up
        from the block store when it is behind (reference:
        reactor.go:492-610)."""
        sleep = self.cfg.peer_gossip_sleep_duration
        while True:
            rs = self.cs.rs
            prs = ps.prs
            sent = False

            # 1) the proposal first: it carries the part-set header the
            # peer needs before parts are of use
            if (
                rs.height == prs.height
                and rs.round == prs.round
                and rs.proposal is not None
                and not prs.proposal
            ):
                if self.data_ch.try_send(
                    Envelope(message=ProposalMessage(proposal=rs.proposal), to=ps.peer_id)
                ):
                    ps.set_has_proposal(rs.proposal)
                    sent = True
                if 0 <= rs.proposal.pol_round:
                    pol = rs.votes.prevotes(rs.proposal.pol_round)
                    if pol is not None:
                        self.data_ch.try_send(
                            Envelope(
                                message=ProposalPOLMessage(
                                    height=rs.height,
                                    proposal_pol_round=rs.proposal.pol_round,
                                    proposal_pol=pol.bit_array(),
                                ),
                                to=ps.peer_id,
                            )
                        )

            # 2) same height and round, matching part-set headers: a
            # window of missing parts a turn; a full send queue cuts the
            # window short instead of stalling the routine
            if (
                not sent
                and rs.proposal_block_parts is not None
                and rs.height == prs.height
                and rs.round == prs.round
                and prs.proposal_block_parts is not None
                and prs.proposal_block_parts_header == rs.proposal_block_parts.header()
            ):
                for _ in range(max(1, self.cfg.peer_gossip_part_window)):
                    part = self._pick_part_to_send(rs.proposal_block_parts, prs.proposal_block_parts)
                    if part is None:
                        break
                    if not self.data_ch.try_send(
                        Envelope(
                            message=BlockPartMessage(height=rs.height, round=rs.round, part=part),
                            to=ps.peer_id,
                        )
                    ):
                        break  # the peer's send queue is full: shed the rest
                    ps.set_has_proposal_block_part(rs.height, rs.round, part.index)
                    sent = True

            # 3) the peer is behind: a window of parts of its next
            # committed block
            if (
                not sent
                and 0 < prs.height < rs.height
                and prs.height >= self.cs.block_store.base()
            ):
                for _ in range(max(1, self.cfg.peer_gossip_part_window)):
                    if not self._gossip_catchup_part(ps):
                        break
                    sent = True

            await asyncio.sleep(0 if sent else sleep)

    def _pick_part_to_send(self, our_parts, peer_bits):
        index = pick_missing(our_parts.parts_bit_array.sub(peer_bits))
        return None if index is None else our_parts.get_part(index)

    def _gossip_catchup_part(self, ps: PeerState) -> bool:
        """reference: reactor.go gossipDataForCatchup."""
        prs = ps.prs
        meta = self.cs.block_store.load_block_meta(prs.height)
        if meta is None:
            return False
        # the peer's part-set header must match the stored block's
        if prs.proposal_block_parts is None:
            prs.proposal_block_parts_header = meta.block_id.part_set_header
            prs.proposal_block_parts = BitArray(max(1, meta.block_id.part_set_header.total))
        if prs.proposal_block_parts_header != meta.block_id.part_set_header:
            return False
        missing = [
            i
            for i in range(prs.proposal_block_parts_header.total)
            if not prs.proposal_block_parts.get(i)
        ]
        if not missing:
            # everything marked sent, yet the peer has not advanced: the
            # marks are optimistic (a part arriving before the peer's
            # part tracker exists is dropped), so after a stall forget
            # them and resend; parts are idempotent
            ps.catchup_stall += 1
            if ps.catchup_stall * self.cfg.peer_gossip_sleep_duration > 1.0:
                ps.catchup_stall = 0
                prs.proposal_block_parts = None
            return False
        ps.catchup_stall = 0
        index = rng.choice(missing)
        part = self.cs.block_store.load_block_part(prs.height, index)
        if part is None:
            return False
        if self.data_ch.try_send(
            Envelope(
                message=BlockPartMessage(height=prs.height, round=prs.round, part=part),
                to=ps.peer_id,
            )
        ):
            ps.set_has_proposal_block_part(prs.height, prs.round, index)
            return True
        return False

    async def _gossip_votes_routine(self, ps: PeerState) -> None:
        """reference: reactor.go:752-848."""
        sleep = self.cfg.peer_gossip_sleep_duration
        while True:
            rs = self.cs.rs
            prs = ps.prs
            sent = False

            if rs.height == prs.height:
                sent = self._gossip_votes_same_height(ps)
                if not sent:
                    # the optimistic marks at the live height: a lossy
                    # link loses the frame while the connection lives,
                    # our bits claim delivery, and with under 2/3
                    # prevotes delivered no timeout fires; after a
                    # frozen stall with nothing to send, resend
                    self._vote_stall_tick(ps, ps.reset_live_votes, "live")
            elif prs.height != 0 and rs.height == prs.height + 1 and rs.last_commit is not None:
                # the peer is one behind: our last commit's precommits
                sent = self._send_vote(ps, ps.pick_vote_to_send(rs.last_commit))
                if not sent:
                    # the same hazard one height back: the marks these
                    # sends left land in the peer's current precommit bits
                    self._vote_stall_tick(ps, ps.reset_live_votes, "last_commit")
            elif (
                prs.height != 0
                and rs.height >= prs.height + 2
                and prs.height >= self.cs.block_store.base()
            ):
                # far behind: precommits of the stored commit of its height
                commit = self.cs.block_store.load_block_commit(prs.height)
                if commit is not None:
                    n = self._validators_size_at(prs.height)
                    # allocate the bits the pick and mark cycle uses
                    ps.ensure_vote_bits(n)
                    ps.ensure_catchup_commit_round(prs.height, commit.round, n)
                    sent = self._send_commit_vote(ps, commit)
                    if sent:
                        ps.vote_catchup_stall = 0
                    else:
                        # precommits streamed while the peer's reactor was
                        # still block-syncing were dropped unseen, yet our
                        # bits say delivered: after a stall with no
                        # progress, forget them and resend
                        ps.vote_catchup_stall += 1
                        if ps.vote_catchup_stall * sleep > 1.0:
                            ps.vote_catchup_stall = 0
                            self.cs.timeline.mark_stall_reset(
                                "catchup", prs.height, commit.round, ps.peer_id
                            )
                            ps.reset_catchup_precommits(prs.height, commit.round, n)

            if not sent:
                await asyncio.sleep(sleep)
            else:
                ps.live_vote_stall = 0
                await asyncio.sleep(0)

    def _vote_stall_tick(self, ps: PeerState, reset, kind: str) -> None:
        """Count a gossip tick with nothing to send while both sides'
        round states are frozen; past the stall window run `reset`
        (forget the optimistic marks so gossip resends). Any progress, a
        send or either side moving, zeroes the count. `kind` ("live" or
        "last_commit") labels the reset for the flight recorder."""
        rs = self.cs.rs
        prs = ps.prs
        snap = (rs.height, rs.round, rs.step, prs.height, prs.round, prs.step)
        if ps.live_stall_snap != snap:
            ps.live_stall_snap = snap
            ps.live_vote_stall = 0
        ps.live_vote_stall += 1
        if ps.live_vote_stall * self.cfg.peer_gossip_sleep_duration > 2.0:
            ps.live_vote_stall = 0
            self.cs.timeline.mark_stall_reset(kind, rs.height, rs.round, ps.peer_id)
            reset()

    def _validators_size_at(self, height: int) -> int:
        vals = self.cs.block_exec.store.load_validators(height)
        return vals.size() if vals is not None else self.cs.rs.validators.size()

    def _gossip_votes_same_height(self, ps: PeerState) -> bool:
        """reference: reactor.go gossipVotesForHeight."""
        rs = self.cs.rs
        prs = ps.prs
        if prs.step == RoundStep.NEW_HEIGHT and rs.last_commit is not None:
            if self._send_vote(ps, ps.pick_vote_to_send(rs.last_commit)):
                return True
        if prs.step <= RoundStep.PROPOSE and prs.round != -1 and (
            prs.round <= rs.round and prs.proposal_pol_round != -1
        ):
            pol = rs.votes.prevotes(prs.proposal_pol_round)
            if pol is not None and self._send_vote(ps, ps.pick_vote_to_send(pol)):
                return True
        if prs.step <= RoundStep.PREVOTE_WAIT and prs.round != -1 and prs.round <= rs.round:
            prevotes = rs.votes.prevotes(prs.round)
            if prevotes is not None and self._send_vote(ps, ps.pick_vote_to_send(prevotes)):
                return True
        if prs.step <= RoundStep.PRECOMMIT_WAIT and prs.round != -1 and prs.round <= rs.round:
            precommits = rs.votes.precommits(prs.round)
            if precommits is not None and self._send_vote(ps, ps.pick_vote_to_send(precommits)):
                return True
        if prs.proposal_pol_round != -1:
            pol = rs.votes.prevotes(prs.proposal_pol_round)
            if pol is not None and self._send_vote(ps, ps.pick_vote_to_send(pol)):
                return True
        return False

    def _send_vote(self, ps: PeerState, vote) -> bool:
        if vote is None:
            return False
        if self.vote_ch.try_send(Envelope(message=VoteMessage(vote=vote), to=ps.peer_id)):
            ps.set_has_vote(vote.height, vote.round, vote.type, vote.validator_index)
            return True
        return False

    def _send_commit_vote(self, ps: PeerState, commit) -> bool:
        """Send a random precommit of a stored commit that the peer
        lacks. Picks and marks against the same bit array
        (_get_vote_bits), as the reference's PickSendVote does: checking
        one array and marking another loops forever."""
        peer_bits = ps._get_vote_bits(commit.height, commit.round, PRECOMMIT_TYPE)
        missing = [
            i
            for i, sig in enumerate(commit.signatures)
            if not sig.is_absent()
            and (peer_bits is None or (i < peer_bits.size and not peer_bits.get(i)))
        ]
        if not missing:
            return False
        return self._send_vote(ps, commit.get_vote(rng.choice(missing)))

    async def _query_maj23_routine(self, ps: PeerState) -> None:
        """Tell the peer our +2/3 majorities now and then (reference:
        reactor.go:850-966)."""
        sleep = self.cfg.peer_query_maj23_sleep_duration
        while True:
            await asyncio.sleep(sleep)
            # re-announce: a NewRoundStep broadcast dropped on a full
            # queue must not leave the peer's view of us stale; not while
            # syncing (the stale height would draw catch-up we discard)
            if self.wait_sync:
                continue
            self.state_ch.try_send(Envelope(message=self._our_new_round_step(), to=ps.peer_id))
            rs = self.cs.rs
            prs = ps.prs
            if rs.height != prs.height or rs.votes is None:
                continue
            for vote_type, vs in (
                (PREVOTE_TYPE, rs.votes.prevotes(prs.round)),
                (PRECOMMIT_TYPE, rs.votes.precommits(prs.round)),
            ):
                if vs is None:
                    continue
                block_id, ok = vs.two_thirds_majority()
                if ok:
                    self.state_ch.try_send(
                        Envelope(
                            message=VoteSetMaj23Message(
                                height=prs.height,
                                round=prs.round,
                                type=vote_type,
                                block_id=block_id,
                            ),
                            to=ps.peer_id,
                        )
                    )
