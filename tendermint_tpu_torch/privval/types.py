"""The PrivValidator interface and the in-memory test signer.

Counterpart: tendermint_tpu/privval/types.py:1-66 (reference:
types/priv_validator.go:28-33, GetPubKey/SignVote/SignProposal, and
:63-123, MockPV).
"""

from __future__ import annotations

import time
from abc import ABC, abstractmethod

from ..crypto.ed25519 import PrivKeyEd25519
from ..crypto.keys import PrivKey, PubKey
from ..types.proposal import Proposal
from ..types.vote import Vote

__all__ = ["MockPV", "PrivValidator"]


class PrivValidator(ABC):
    """Signs votes and proposals, never twice for one height, round and
    step."""

    @abstractmethod
    async def get_pub_key(self) -> PubKey: ...

    @abstractmethod
    async def sign_vote(self, chain_id: str, vote: Vote) -> None:
        """Sets vote.signature (and maybe vote.timestamp_ns) in place."""

    @abstractmethod
    async def sign_proposal(self, chain_id: str, proposal: Proposal) -> None:
        """Sets proposal.signature in place."""


class MockPV(PrivValidator):
    """A test signer with no double-sign protection (reference:
    types/priv_validator.go:63-123)."""

    def __init__(
        self,
        priv_key: "PrivKey | None" = None,
        break_proposal_sigs: bool = False,
        break_vote_sigs: bool = False,
    ) -> None:
        self.priv_key = priv_key or PrivKeyEd25519.generate()
        self.break_proposal_sigs = break_proposal_sigs
        self.break_vote_sigs = break_vote_sigs

    async def get_pub_key(self) -> PubKey:
        return self.priv_key.pub_key()

    async def sign_vote(self, chain_id: str, vote: Vote) -> None:
        if self.break_vote_sigs:
            chain_id = "incorrect-chain-id"
        if vote.timestamp_ns == 0:
            vote.timestamp_ns = time.time_ns()
        vote.signature = self.priv_key.sign(vote.sign_bytes(chain_id))

    async def sign_proposal(self, chain_id: str, proposal: Proposal) -> None:
        if self.break_proposal_sigs:
            chain_id = "incorrect-chain-id"
        if proposal.timestamp_ns == 0:
            proposal.timestamp_ns = time.time_ns()
        proposal.signature = self.priv_key.sign(proposal.sign_bytes(chain_id))
