"""VoteSet: the signed votes of one (height, round, type), tallied.

Counterpart: tendermint_tpu/types/vote_set.py: `ConflictingVoteError`
(:29), `_vote_commit_sig` (:42), `_BlockVotes` (:56-84), `VoteSet`
(:87-311: add_vote, the per-block tallies, set_peer_maj23, the bit
arrays, two_thirds_majority, make_commit) and `commit_to_vote_set`
(:314-330). The canonical vote list a validator, beside a tally a block
key, so a double-sign is detected and bounded; the first block past 2/3
of the power is `maj23`. Every exception message is the JAX package's.

Single-threaded by design: consensus/state.py feeds a set from its one
receive loop. Vote.verify consults the verified-signature cache
(crypto/sigcache.py), which the loop's vote-burst pre-verify fills.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ..libs.bits import BitArray
from .block_id import BlockID
from .canonical import PRECOMMIT_TYPE
from .commit import Commit, CommitSig
from .validator import ValidatorSet
from .vote import Vote

__all__ = [
    "ConflictingVoteError",
    "MAX_VOTES_COUNT",
    "VoteSet",
    "commit_to_vote_set",
]

MAX_VOTES_COUNT = 10000  # reference: types/vote_set.go:18


class ConflictingVoteError(Exception):
    """A validator signed two different blocks at the same H/R/S
    (reference: types/errors.go NewConflictingVoteError)."""

    def __init__(self, vote_a: Vote, vote_b: Vote) -> None:
        super().__init__(
            f"conflicting votes from validator {vote_a.validator_address.hex()}"
        )
        self.vote_a = vote_a
        self.vote_b = vote_b


def _vote_commit_sig(vote: Optional[Vote]) -> CommitSig:
    """reference: types/vote.go Vote.CommitSig."""
    if vote is None:
        return CommitSig.absent()
    if vote.is_nil():
        return CommitSig.for_nil(vote.signature, vote.validator_address, vote.timestamp_ns)
    return CommitSig.for_block(vote.signature, vote.validator_address, vote.timestamp_ns)


@dataclass
class _BlockVotes:
    """The votes for one block key (reference: types/vote_set.go:647-677)."""

    peer_maj23: bool
    bit_array: BitArray
    votes: List[Optional[Vote]]
    sum: int = 0

    @classmethod
    def new(cls, peer_maj23: bool, num_validators: int) -> "_BlockVotes":
        return cls(
            peer_maj23=peer_maj23,
            bit_array=BitArray(num_validators),
            votes=[None] * num_validators,
        )

    def add_verified_vote(self, vote: Vote, voting_power: int) -> None:
        i = vote.validator_index
        if self.votes[i] is None:
            self.bit_array.set(i, True)
            self.votes[i] = vote
            self.sum += voting_power

    def get_by_index(self, index: int) -> Optional[Vote]:
        return self.votes[index]


class VoteSet:
    def __init__(
        self,
        chain_id: str,
        height: int,
        round_: int,
        signed_msg_type: int,
        val_set: ValidatorSet,
    ) -> None:
        if height == 0:
            raise ValueError("cannot make VoteSet for height 0")
        self.chain_id = chain_id
        self.height = height
        self.round = round_
        self.signed_msg_type = signed_msg_type
        self.val_set = val_set
        n = val_set.size()
        self.votes_bit_array = BitArray(n)
        self.votes: List[Optional[Vote]] = [None] * n
        self.sum = 0
        self.maj23: Optional[BlockID] = None
        self.votes_by_block: Dict[bytes, _BlockVotes] = {}
        self.peer_maj23s: Dict[str, BlockID] = {}

    def size(self) -> int:
        return self.val_set.size()

    def add_vote(self, vote: Vote) -> bool:
        """True for a valid new vote, False for a duplicate. Raises
        ValueError for an invalid vote and ConflictingVoteError for a
        double-sign (added all the same when its block is tracked)
        (reference: types/vote_set.go:143-300)."""
        if vote is None:
            raise ValueError("nil vote")
        val_index = vote.validator_index
        val_addr = vote.validator_address
        block_key = vote.block_id.key()

        if val_index < 0:
            raise ValueError("index < 0")
        if not val_addr:
            raise ValueError("empty address")
        if (
            vote.height != self.height
            or vote.round != self.round
            or vote.type != self.signed_msg_type
        ):
            raise ValueError(
                f"expected {self.height}/{self.round}/"
                f"{self.signed_msg_type}, got {vote.height}/"
                f"{vote.round}/{vote.type}"
            )
        lookup_addr, val = self.val_set.get_by_index(val_index)
        if val is None:
            raise ValueError(
                f"cannot find validator {val_index} in valSet of size "
                f"{self.val_set.size()}"
            )
        if val_addr != lookup_addr:
            raise ValueError("vote.ValidatorAddress does not match address for index")
        existing = self._get_vote(val_index, block_key)
        if existing is not None:
            if existing.signature == vote.signature:
                return False  # duplicate
            raise ValueError("non-deterministic signature")
        # the signature (raises on failure): a triple the pre-verify
        # proved against this height's set is a cache hit here; the
        # checks above run either way
        vote.verify(self.chain_id, val.pub_key)
        added, conflicting = self._add_verified_vote(vote, block_key, val.voting_power)
        if conflicting is not None:
            raise ConflictingVoteError(conflicting, vote)
        if not added:
            raise RuntimeError("expected to add non-conflicting vote")
        return added

    def _get_vote(self, val_index: int, block_key: bytes) -> Optional[Vote]:
        existing = self.votes[val_index]
        if existing is not None and existing.block_id.key() == block_key:
            return existing
        bv = self.votes_by_block.get(block_key)
        if bv is not None:
            return bv.get_by_index(val_index)
        return None

    def _add_verified_vote(
        self, vote: Vote, block_key: bytes, voting_power: int
    ) -> Tuple[bool, Optional[Vote]]:
        val_index = vote.validator_index
        conflicting: Optional[Vote] = None

        existing = self.votes[val_index]
        if existing is not None:
            # a conflicting vote of the same validator
            conflicting = existing
            if self.maj23 is not None and self.maj23.key() == block_key:
                self.votes[val_index] = vote
                self.votes_bit_array.set(val_index, True)
        else:
            self.votes[val_index] = vote
            self.votes_bit_array.set(val_index, True)
            self.sum += voting_power

        bv = self.votes_by_block.get(block_key)
        if bv is not None:
            if conflicting is not None and not bv.peer_maj23:
                return False, conflicting
        else:
            if conflicting is not None:
                return False, conflicting
            bv = _BlockVotes.new(False, self.val_set.size())
            self.votes_by_block[block_key] = bv

        orig_sum = bv.sum
        quorum = self.val_set.total_voting_power() * 2 // 3 + 1
        bv.add_verified_vote(vote, voting_power)

        if orig_sum < quorum <= bv.sum and self.maj23 is None:
            self.maj23 = vote.block_id
            for i, v in enumerate(bv.votes):
                if v is not None:
                    self.votes[i] = v
        return True, conflicting

    def set_peer_maj23(self, peer_id: str, block_id: BlockID) -> None:
        """A peer claims 2/3 for block_id: track that block
        (reference: types/vote_set.go:309-342)."""
        block_key = block_id.key()
        existing = self.peer_maj23s.get(peer_id)
        if existing is not None:
            if existing == block_id:
                return
            raise ValueError(f"conflicting blockID from peer {peer_id}")
        self.peer_maj23s[peer_id] = block_id
        bv = self.votes_by_block.get(block_key)
        if bv is not None:
            bv.peer_maj23 = True
        else:
            self.votes_by_block[block_key] = _BlockVotes.new(True, self.val_set.size())

    def bit_array(self) -> BitArray:
        return self.votes_bit_array.copy()

    def bit_array_by_block_id(self, block_id: BlockID) -> Optional[BitArray]:
        bv = self.votes_by_block.get(block_id.key())
        return bv.bit_array.copy() if bv is not None else None

    def get_by_index(self, val_index: int) -> Optional[Vote]:
        if val_index < 0 or val_index >= len(self.votes):
            return None
        return self.votes[val_index]

    def get_by_address(self, address: bytes) -> Optional[Vote]:
        idx, val = self.val_set.get_by_address(address)
        if val is None:
            return None
        return self.votes[idx]

    def list_votes(self) -> List[Vote]:
        return [v for v in self.votes if v is not None]

    def has_two_thirds_majority(self) -> bool:
        return self.maj23 is not None

    def is_commit(self) -> bool:
        return self.signed_msg_type == PRECOMMIT_TYPE and self.maj23 is not None

    def has_two_thirds_any(self) -> bool:
        return self.sum > self.val_set.total_voting_power() * 2 // 3

    def has_all(self) -> bool:
        return self.sum == self.val_set.total_voting_power()

    def two_thirds_majority(self) -> Tuple[BlockID, bool]:
        if self.maj23 is not None:
            return self.maj23, True
        return BlockID(), False

    def make_commit(self) -> Commit:
        """The Commit of the +2/3 precommits (reference:
        types/vote_set.go:613-637): a vote for another block than maj23
        is absent in it."""
        if self.signed_msg_type != PRECOMMIT_TYPE:
            raise ValueError("cannot MakeCommit unless VoteSet type is precommit")
        if self.maj23 is None:
            raise ValueError("cannot MakeCommit unless a blockhash has +2/3")
        commit_sigs: List[CommitSig] = []
        for v in self.votes:
            cs = _vote_commit_sig(v)
            if cs.is_for_block() and v.block_id != self.maj23:
                cs = CommitSig.absent()
            commit_sigs.append(cs)
        return Commit(
            height=self.height,
            round=self.round,
            block_id=self.maj23,
            signatures=commit_sigs,
        )


def commit_to_vote_set(chain_id: str, commit: Commit, vals: ValidatorSet) -> VoteSet:
    """A precommit VoteSet rebuilt from a Commit
    (reference: types/block.go:776-788)."""
    vote_set = VoteSet(chain_id, commit.height, commit.round, PRECOMMIT_TYPE, vals)
    for idx, cs in enumerate(commit.signatures):
        if cs.is_absent():
            continue
        added = vote_set.add_vote(commit.get_vote(idx))
        if not added:
            raise RuntimeError("failed to reconstruct LastCommit")
    return vote_set
