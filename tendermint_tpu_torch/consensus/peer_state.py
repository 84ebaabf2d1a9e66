"""PeerState: what a node knows of a peer's round state.

Counterpart: tendermint_tpu/consensus/peer_state.py:1-267 (reference:
internal/consensus/peer_state.go and types/peer_round_state.go). The
gossip routines consult it for the proposal parts and votes the peer
still lacks; the reactor updates it from the peer's NewRoundStep,
NewValidBlock, HasVote, VoteSetBits and ProposalPOL messages and from
everything it sends the peer.

One change of method, not of result: pick_vote_to_send draws the index
of the vote to send as the JAX package does (one draw of the gossip RNG
over the votes the peer lacks, in ascending order) but finds it as the
randbelow(count)-th set bit of the missing bits, where the JAX package
lists every set index of a 10,000-bit array for each vote it sends
(ROADMAP §3). `rng.choice(seq)` and `rng.randbelow(len(seq))` are the
same draw, so the same RNG state picks the same vote.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

from ..libs import rng
from ..libs.bits import BitArray
from ..types.block_id import PartSetHeader
from ..types.canonical import PRECOMMIT_TYPE, PREVOTE_TYPE
from ..types.vote import Vote

__all__ = ["PeerRoundState", "PeerState", "pick_missing"]


def pick_missing(missing: BitArray) -> Optional[int]:
    """A uniformly random set index of `missing`, drawn from the gossip
    RNG as rng.choice(list(missing.indices())) draws it; None (and no
    draw) when no bit is set."""
    n = missing.count()
    if n == 0:
        return None
    return missing.nth_set(rng.randbelow(n))


@dataclass
class PeerRoundState:
    """reference: internal/consensus/types/peer_round_state.go."""

    height: int = 0
    round: int = -1
    step: int = 0
    start_time_ns: int = 0
    proposal: bool = False
    proposal_block_parts_header: PartSetHeader = field(default_factory=PartSetHeader)
    proposal_block_parts: Optional[BitArray] = None
    proposal_pol_round: int = -1
    proposal_pol: Optional[BitArray] = None
    prevotes: Optional[BitArray] = None
    precommits: Optional[BitArray] = None
    last_commit_round: int = -1
    last_commit: Optional[BitArray] = None
    catchup_commit_round: int = -1
    catchup_commit: Optional[BitArray] = None


class PeerState:
    def __init__(self, peer_id: str) -> None:
        self.peer_id = peer_id
        self.prs = PeerRoundState()
        # the gossip routines' stall counters (consensus/reactor.py)
        self.catchup_stall = 0
        self.vote_catchup_stall = 0
        self.live_vote_stall = 0
        self.live_stall_snap: Optional[tuple] = None

    # -- applying peer messages (reference: peer_state.go:340-470) --

    def apply_new_round_step(self, msg) -> None:
        prs = self.prs
        if msg.height < prs.height or (msg.height == prs.height and msg.round < prs.round):
            return
        start_time = time.time_ns() - msg.seconds_since_start_time * 1_000_000_000
        old_height, old_round = prs.height, prs.round
        prs.height = msg.height
        prs.round = msg.round
        prs.step = msg.step
        prs.start_time_ns = start_time
        if old_height != msg.height or old_round != msg.round:
            prs.proposal = False
            prs.proposal_block_parts_header = PartSetHeader()
            prs.proposal_block_parts = None
            prs.proposal_pol_round = -1
            prs.proposal_pol = None
            prs.prevotes = None
            prs.precommits = None
        if old_height == msg.height and old_round != msg.round and (
            msg.round == prs.catchup_commit_round
        ):
            prs.precommits = prs.catchup_commit
        if old_height != msg.height:
            if old_height == msg.height - 1:
                prs.last_commit = prs.precommits
                prs.last_commit_round = old_round
            else:
                prs.last_commit = None
                prs.last_commit_round = msg.last_commit_round
            prs.catchup_commit_round = -1
            prs.catchup_commit = None

    def apply_new_valid_block(self, msg) -> None:
        prs = self.prs
        if prs.height != msg.height:
            return
        if prs.round != msg.round and not msg.is_commit:
            return
        prs.proposal_block_parts_header = msg.block_part_set_header
        prs.proposal_block_parts = msg.block_parts

    def apply_proposal_pol(self, msg) -> None:
        prs = self.prs
        if prs.height != msg.height:
            return
        if prs.proposal_pol_round != msg.proposal_pol_round:
            return
        prs.proposal_pol = msg.proposal_pol

    def apply_has_vote(self, msg) -> None:
        if self.prs.height != msg.height:
            return
        self.set_has_vote(msg.height, msg.round, msg.type, msg.index)

    def apply_vote_set_bits(self, msg, our_votes: Optional[BitArray]) -> None:
        """reference: peer_state.go ApplyVoteSetBitsMessage: the bits the
        peer has are what we tracked less what we asked about, or'd with
        the peer's reply."""
        votes = self._get_vote_bits(msg.height, msg.round, msg.type)
        if votes is None or msg.votes is None:
            return
        if our_votes is None:
            votes.update(msg.votes)
        else:
            votes.update(votes.sub(our_votes).or_(msg.votes))

    # -- tracking what we sent (reference: peer_state.go:150-330) --

    def set_has_proposal(self, proposal) -> None:
        prs = self.prs
        if prs.height != proposal.height or prs.round != proposal.round:
            return
        if prs.proposal:
            return
        prs.proposal = True
        if prs.proposal_block_parts is not None:
            return  # already set by NewValidBlock
        prs.proposal_block_parts_header = proposal.block_id.part_set_header
        prs.proposal_block_parts = BitArray(max(1, proposal.block_id.part_set_header.total))
        prs.proposal_pol_round = proposal.pol_round
        prs.proposal_pol = None

    def set_has_proposal_block_part(self, height: int, round_: int, index: int) -> None:
        prs = self.prs
        if prs.height != height or prs.round != round_:
            return
        if prs.proposal_block_parts is None:
            return
        if 0 <= index < prs.proposal_block_parts.size:
            prs.proposal_block_parts.set(index, True)

    def set_has_vote(self, height: int, round_: int, vote_type: int, index: int) -> None:
        votes = self._get_vote_bits(height, round_, vote_type)
        if votes is not None and 0 <= index < votes.size:
            votes.set(index, True)

    def ensure_vote_bits(self, num_validators: int) -> None:
        """Allocate the vote bit arrays once the validator count is
        known (reference: peer_state.go EnsureVoteBitArrays)."""
        prs = self.prs
        if prs.prevotes is None:
            prs.prevotes = BitArray(num_validators)
        if prs.precommits is None:
            prs.precommits = BitArray(num_validators)
        if prs.proposal_pol is None and prs.proposal_pol_round >= 0:
            prs.proposal_pol = BitArray(num_validators)
        if prs.last_commit is None and prs.last_commit_round >= 0:
            prs.last_commit = BitArray(num_validators)
        if prs.catchup_commit is None and prs.catchup_commit_round >= 0:
            prs.catchup_commit = BitArray(num_validators)

    def ensure_catchup_commit_round(self, height: int, round_: int, num_validators: int) -> None:
        prs = self.prs
        if prs.height != height:
            return
        if prs.catchup_commit_round == round_:
            return
        prs.catchup_commit_round = round_
        prs.catchup_commit = BitArray(num_validators)

    def reset_catchup_precommits(self, height: int, round_: int, num_validators: int) -> None:
        """Forget the delivered marks of the stored commit's precommits
        at (height, round_), so that catch-up gossip resends them. The
        marks are optimistic: a vote sent while the peer's reactor still
        block-synced was dropped unseen, and a full array with a peer
        that never advances means the marks lied; a duplicate vote is
        idempotent at the receiver."""
        prs = self.prs
        if prs.height != height:
            return
        if prs.round == round_:
            prs.precommits = BitArray(num_validators)
        elif prs.catchup_commit_round == round_:
            prs.catchup_commit = BitArray(num_validators)

    def reset_live_votes(self) -> None:
        """Forget the delivered marks of the current height's prevotes,
        precommits and POL bits, so that live gossip resends them: on a
        lossy or partitioned link the frame is lost while the connection
        lives, and the marks lie as in reset_catchup_precommits."""
        prs = self.prs
        if prs.prevotes is not None:
            prs.prevotes = BitArray(prs.prevotes.size)
        if prs.precommits is not None:
            prs.precommits = BitArray(prs.precommits.size)
        if prs.proposal_pol is not None:
            prs.proposal_pol = BitArray(prs.proposal_pol.size)

    def _get_vote_bits(self, height: int, round_: int, vote_type: int) -> Optional[BitArray]:
        prs = self.prs
        if prs.height == height:
            if prs.round == round_:
                return prs.prevotes if vote_type == PREVOTE_TYPE else prs.precommits
            if prs.catchup_commit_round == round_ and vote_type == PRECOMMIT_TYPE:
                return prs.catchup_commit
            if prs.proposal_pol_round == round_ and vote_type == PREVOTE_TYPE:
                return prs.proposal_pol
            return None
        if prs.height == height + 1:
            if prs.last_commit_round == round_ and vote_type == PRECOMMIT_TYPE:
                return prs.last_commit
            return None
        return None

    # -- the vote to gossip (reference: peer_state.go:196-260) --

    def pick_vote_to_send(self, votes) -> Optional[Vote]:
        """A random vote of `votes` (a VoteSet) that the peer lacks."""
        if votes is None or votes.size() == 0:
            return None
        height, round_, vote_type = votes.height, votes.round, votes.signed_msg_type
        if self.prs.height == height:
            self.ensure_vote_bits(votes.size())
        peer_bits = self._get_vote_bits(height, round_, vote_type)
        if peer_bits is None:
            return None
        index = pick_missing(votes.bit_array().sub(peer_bits))
        if index is None:
            return None
        return votes.get_by_index(index)
