"""Round steps, the RoundState, and HeightVoteSet.

Counterpart: tendermint_tpu/consensus/types.py: `RoundStep` and
`step_name` (:31-57), `RoundState` (:60-88: the height, round and step,
the proposal and its block and parts, the locked and valid blocks, the
votes, the commit round, the LastCommit), and `HeightVoteSet`
(:90-177): rounds 0..round+1, the peer catch-up bound of two rounds a
peer, set_round and pol_info.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ..types.block import Block
from ..types.block_id import BlockID
from ..types.canonical import PRECOMMIT_TYPE, PREVOTE_TYPE
from ..types.part_set import PartSet
from ..types.proposal import Proposal
from ..types.validator import ValidatorSet
from ..types.vote import Vote
from ..types.vote_set import VoteSet

__all__ = ["HeightVoteSet", "RoundState", "RoundStep", "step_name"]


class RoundStep:
    """reference: round_state.go:12-40."""

    NEW_HEIGHT = 1
    NEW_ROUND = 2
    PROPOSE = 3
    PREVOTE = 4
    PREVOTE_WAIT = 5
    PRECOMMIT = 6
    PRECOMMIT_WAIT = 7
    COMMIT = 8


_STEP_NAMES = {
    1: "RoundStepNewHeight",
    2: "RoundStepNewRound",
    3: "RoundStepPropose",
    4: "RoundStepPrevote",
    5: "RoundStepPrevoteWait",
    6: "RoundStepPrecommit",
    7: "RoundStepPrecommitWait",
    8: "RoundStepCommit",
}


def step_name(step: int) -> str:
    return _STEP_NAMES.get(step, f"RoundStepUnknown({step})")


@dataclass
class RoundState:
    """The consensus state of the current height (reference:
    round_state.go:65-115)."""

    height: int = 0
    round: int = 0
    step: int = RoundStep.NEW_HEIGHT
    start_time_ns: int = 0
    commit_time_ns: int = 0
    validators: Optional[ValidatorSet] = None
    proposal: Optional[Proposal] = None
    proposal_block: Optional[Block] = None
    proposal_block_parts: Optional[PartSet] = None
    locked_round: int = -1
    locked_block: Optional[Block] = None
    locked_block_parts: Optional[PartSet] = None
    valid_round: int = -1  # the last POL round, if any
    valid_block: Optional[Block] = None
    valid_block_parts: Optional[PartSet] = None
    votes: Optional["HeightVoteSet"] = None
    commit_round: int = -1
    last_commit: Optional[VoteSet] = None
    last_validators: Optional[ValidatorSet] = None
    triggered_timeout_precommit: bool = False

    def height_round_step(self) -> str:
        return f"{self.height}/{self.round}/{step_name(self.step)}"


class HeightVoteSet:
    """The prevotes and precommits of every round of one height: rounds
    0..round+1, and at most two catch-up rounds a peer, so a Byzantine
    peer cannot make it grow without bound
    (reference: height_vote_set.go:14-38)."""

    def __init__(self, chain_id: str, height: int, val_set: ValidatorSet) -> None:
        self.chain_id = chain_id
        self.height = height
        self.val_set = val_set
        self.round = 0
        self._round_vote_sets: Dict[int, Tuple[VoteSet, VoteSet]] = {}
        self._peer_catchup_rounds: Dict[str, List[int]] = {}
        self._add_round(0)
        self._add_round(1)

    def _add_round(self, round_: int) -> None:
        if round_ in self._round_vote_sets:
            return
        self._round_vote_sets[round_] = (
            VoteSet(self.chain_id, self.height, round_, PREVOTE_TYPE, self.val_set),
            VoteSet(self.chain_id, self.height, round_, PRECOMMIT_TYPE, self.val_set),
        )

    def set_round(self, round_: int) -> None:
        """Track rounds up to round_ + 1 (reference: height_vote_set.go:77)."""
        new_round = self.round + 1  # replays of old rounds keep their sets
        if round_ < new_round and self._round_vote_sets:
            raise ValueError("SetRound() must increment the round")
        for r in range(new_round, round_ + 2):
            self._add_round(r)
        self.round = round_

    def add_vote(self, vote: Vote, peer_id: str = "") -> bool:
        """reference: height_vote_set.go:109-135. Raises
        ConflictingVoteError on a double-sign, ValueError on junk."""
        if vote.type not in (PREVOTE_TYPE, PRECOMMIT_TYPE):
            raise ValueError(f"unexpected vote type {vote.type}")
        vs = self._get(vote.round, vote.type)
        if vs is None:
            rounds = self._peer_catchup_rounds.setdefault(peer_id, [])
            if len(rounds) < 2:
                self._add_round(vote.round)
                vs = self._get(vote.round, vote.type)
                rounds.append(vote.round)
            else:
                raise ValueError(
                    "peer has sent a vote that does not match our round "
                    "for more than one round"
                )
        return vs.add_vote(vote)

    def _get(self, round_: int, type_: int) -> Optional[VoteSet]:
        pair = self._round_vote_sets.get(round_)
        if pair is None:
            return None
        return pair[0] if type_ == PREVOTE_TYPE else pair[1]

    def prevotes(self, round_: int) -> Optional[VoteSet]:
        return self._get(round_, PREVOTE_TYPE)

    def precommits(self, round_: int) -> Optional[VoteSet]:
        return self._get(round_, PRECOMMIT_TYPE)

    def pol_info(self) -> Tuple[int, Optional[BlockID]]:
        """The last round with a prevote 2/3 majority, scanning down
        (reference: height_vote_set.go:154-165)."""
        for r in range(self.round, -1, -1):
            vs = self.prevotes(r)
            if vs is not None:
                block_id, ok = vs.two_thirds_majority()
                if ok:
                    return r, block_id
        return -1, None

    def set_peer_maj23(
        self, round_: int, type_: int, peer_id: str, block_id: BlockID
    ) -> None:
        """reference: height_vote_set.go:185-198."""
        self._add_round(round_)
        vs = self._get(round_, type_)
        if vs is not None:
            vs.set_peer_maj23(peer_id, block_id)
