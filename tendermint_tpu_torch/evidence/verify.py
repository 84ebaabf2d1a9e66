"""Evidence verification.

Counterpart: tendermint_tpu/evidence/verify.py:1-148 (reference:
internal/evidence/verify.go: Verify :24, VerifyLightClientAttack :159,
VerifyDuplicateVote :202). A duplicate vote checks two signatures; a
light-client attack re-verifies the conflicting block's whole commit
against the validator set trusted at the common height through
types.validation.verify_commit_light_trusting, on the card when the
device plane is installed (kernels X1 and K2 for ed25519, X3 for
sr25519). Outcomes and messages are the JAX package's.
"""

from __future__ import annotations

from ..state.types import State
from ..types.evidence import (
    DuplicateVoteEvidence,
    Evidence,
    LightClientAttackEvidence,
)
from ..types.validation import Fraction, verify_commit_light_trusting
from ..types.validator import ValidatorSet

__all__ = ["verify_evidence", "verify_duplicate_vote", "verify_light_client_attack"]


def verify_evidence(
    ev: Evidence,
    state: State,
    state_store,
    block_store,
) -> None:
    """Full contextual verification (reference: verify.go:24-107).
    Raises ValueError on invalid evidence."""
    height = ev.height()
    header = _header_at(block_store, height)
    if header is None:
        raise ValueError(
            f"don't have header at height {height} for evidence verification"
        )
    ev_time = header.time_ns

    # expiry check against consensus params
    params = state.consensus_params.evidence
    age_num_blocks = state.last_block_height - height
    age_duration_ns = state.last_block_time_ns - ev_time
    if (
        age_duration_ns > params.max_age_duration_ns
        and age_num_blocks > params.max_age_num_blocks
    ):
        raise ValueError(
            f"evidence from height {height} is too old; "
            f"min height is {state.last_block_height - params.max_age_num_blocks}"
        )

    if isinstance(ev, DuplicateVoteEvidence):
        vals = state_store.load_validators(height)
        if vals is None:
            raise ValueError(f"no validator set at height {height}")
        verify_duplicate_vote(ev, state.chain_id, vals)
        if ev.timestamp_ns != ev_time:
            raise ValueError(
                "evidence has a different time to the block it is associated "
                f"with ({ev.timestamp_ns} != {ev_time})"
            )
    elif isinstance(ev, LightClientAttackEvidence):
        common_vals = state_store.load_validators(ev.common_height)
        if common_vals is None:
            raise ValueError(
                f"no validator set at common height {ev.common_height}"
            )
        verify_light_client_attack(ev, state.chain_id, common_vals, header)
    else:
        raise ValueError(f"unrecognized evidence type {type(ev).__name__}")


def verify_duplicate_vote(
    ev: DuplicateVoteEvidence, chain_id: str, val_set: ValidatorSet
) -> None:
    """reference: verify.go:202-263."""
    a, b = ev.vote_a, ev.vote_b
    if a.height != b.height or a.round != b.round or a.type != b.type:
        raise ValueError(
            f"h/r/s does not match: {a.height}/{a.round}/{a.type} vs "
            f"{b.height}/{b.round}/{b.type}"
        )
    if a.validator_address != b.validator_address:
        raise ValueError("validator addresses do not match")
    if a.block_id == b.block_id:
        raise ValueError(
            "block IDs are the same; duplicate evidence requires votes for "
            "different blocks"
        )
    _idx, val = val_set.get_by_address(a.validator_address)
    if val is None:
        raise ValueError(
            f"address {a.validator_address.hex()} was not a validator at "
            f"height {a.height}"
        )
    if val.voting_power != ev.validator_power:
        raise ValueError(
            f"validator power from evidence {ev.validator_power} != "
            f"{val.voting_power}"
        )
    if ev.total_voting_power != val_set.total_voting_power():
        raise ValueError(
            f"total voting power from evidence {ev.total_voting_power} != "
            f"{val_set.total_voting_power()}"
        )
    a.verify(chain_id, val.pub_key)
    b.verify(chain_id, val.pub_key)


def verify_light_client_attack(
    ev: LightClientAttackEvidence,
    chain_id: str,
    common_vals: ValidatorSet,
    trusted_header,
) -> None:
    """reference: verify.go:159-200. The conflicting block's commit must
    carry 1/3 of the validator set trusted at the common height (the
    batched device verify path), and the header must genuinely conflict."""
    cb = ev.conflicting_block
    if (
        cb is None
        or cb.signed_header is None
        or cb.signed_header.header is None
        or cb.signed_header.commit is None
    ):
        raise ValueError("conflicting block is incomplete")
    verify_commit_light_trusting(
        chain_id, common_vals, cb.signed_header.commit, Fraction(1, 3)
    )
    if trusted_header is not None:
        if trusted_header.hash() == cb.signed_header.header.hash():
            raise ValueError(
                "conflicting block is the same as the trusted block; "
                "not an attack"
            )
    if ev.total_voting_power != common_vals.total_voting_power():
        raise ValueError(
            f"total voting power from evidence {ev.total_voting_power} != "
            f"{common_vals.total_voting_power()}"
        )


def _header_at(block_store, height: int):
    meta = block_store.load_block_meta(height)
    return meta.header if meta is not None else None
