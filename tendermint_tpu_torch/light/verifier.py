"""Core light-client verification.

Counterpart: tendermint_tpu/light/verifier.py, whole (reference:
light/verifier.go: VerifyNonAdjacent :33, VerifyAdjacent :106, Verify
:158, verifyNewHeaderAndVals :174, HeaderExpired :214, VerifyBackwards
:228, DefaultTrustLevel :16). Both modes end in the commit verification
of types/validation.py, which sends whole commits through the device
batch verifier once crypto/gpu_verifier is installed; the sequential
client's windows go through verify_adjacent_batch, one merged batch for
up to 32 commits. The port has no verified-signature cache, so
verify_non_adjacent checks the commit's signatures twice (against the
trusted set, then its own) and the per-hop re-verify after a failed
window checks every hop's again.

ERRORS. The JAX package turns any exception of a commit check into a
verdict on the header. Here only what a check of the data raises is
(CHECK_ERRORS): ValueError, which InvalidCommitError and
NotEnoughVotingPowerError are, and the OverflowError of a validator
set whose power exceeds the maximum. Any other error, a failed kernel
launch's RuntimeError or a sticky CUDA error among them, raises to the
caller unchanged: a device that fails is never reported as a bad header.
A DeviceFault never gets this far: crypto/gpu_verifier contains it and
answers from the CPU. The messages are the JAX package's.
"""

from __future__ import annotations

from ..types.light import SignedHeader
from ..types.validation import (
    Fraction,
    verify_commit_light,
    verify_commit_light_bulk,
    verify_commit_light_trusting,
)
from ..types.validator import ValidatorSet
from .errors import (
    InvalidHeaderError,
    NewValSetCantBeTrustedError,
    OldHeaderExpiredError,
    VerificationError,
)

__all__ = [
    "CHECK_ERRORS",
    "DEFAULT_TRUST_LEVEL",
    "MAX_CLOCK_DRIFT_NS",
    "adjacent_header_checks",
    "header_expired",
    "verify",
    "verify_adjacent",
    "verify_adjacent_batch",
    "verify_backwards",
    "verify_non_adjacent",
]

# reference: light/verifier.go:16
DEFAULT_TRUST_LEVEL = Fraction(1, 3)
# reference: light/client.go defaultMaxClockDrift (10 s)
MAX_CLOCK_DRIFT_NS = 10 * 1_000_000_000

# what a commit or header check raises on bad data (module docstring)
CHECK_ERRORS = (ValueError, OverflowError)


def header_expired(
    h: SignedHeader, trusting_period_ns: int, now_ns: int
) -> bool:
    return now_ns > h.header.time_ns + trusting_period_ns


def _validate_trust_level(lvl: Fraction) -> None:
    """Must be within [1/3, 1]."""
    if (
        lvl.numerator * 3 < lvl.denominator
        or lvl.numerator > lvl.denominator
        or lvl.denominator == 0
    ):
        raise ValueError(f"trust level must be within [1/3, 1], got {lvl}")


def _verify_new_header_and_vals(
    chain_id: str,
    untrusted_header: SignedHeader,
    untrusted_vals: ValidatorSet,
    trusted_header: SignedHeader,
    now_ns: int,
    max_clock_drift_ns: int,
) -> None:
    try:
        untrusted_header.validate_basic(chain_id)
    except ValueError as e:
        raise InvalidHeaderError(f"untrusted header invalid: {e}") from e
    if untrusted_header.header.height <= trusted_header.header.height:
        raise InvalidHeaderError(
            f"expected new header height {untrusted_header.header.height} "
            f"to be greater than trusted {trusted_header.header.height}"
        )
    if untrusted_header.header.time_ns <= trusted_header.header.time_ns:
        raise InvalidHeaderError(
            "expected new header time after trusted header time"
        )
    if untrusted_header.header.time_ns >= now_ns + max_clock_drift_ns:
        raise InvalidHeaderError(
            "new header time is from the future (beyond clock drift)"
        )
    if untrusted_header.header.validators_hash != untrusted_vals.hash():
        raise InvalidHeaderError(
            "validator set does not match header validators_hash"
        )


def verify_non_adjacent(
    chain_id: str,
    trusted_header: SignedHeader,
    trusted_next_vals: ValidatorSet,
    untrusted_header: SignedHeader,
    untrusted_vals: ValidatorSet,
    trusting_period_ns: int,
    now_ns: int,
    max_clock_drift_ns: int = MAX_CLOCK_DRIFT_NS,
    trust_level: Fraction = DEFAULT_TRUST_LEVEL,
) -> None:
    """Skipping verification: the trust level of the trusted set signed
    the new header, and 2/3 of the header's own set. Raises
    NewValSetCantBeTrustedError when the first fails: the signal to
    bisect."""
    if untrusted_header.header.height == trusted_header.header.height + 1:
        raise ValueError("headers must be non-adjacent in height")
    _validate_trust_level(trust_level)
    if header_expired(trusted_header, trusting_period_ns, now_ns):
        raise OldHeaderExpiredError(
            trusted_header.header.time_ns + trusting_period_ns, now_ns
        )
    _verify_new_header_and_vals(
        chain_id, untrusted_header, untrusted_vals, trusted_header,
        now_ns, max_clock_drift_ns,
    )
    try:
        verify_commit_light_trusting(
            chain_id, trusted_next_vals, untrusted_header.commit, trust_level
        )
    except CHECK_ERRORS as e:
        raise NewValSetCantBeTrustedError(str(e)) from e
    try:
        verify_commit_light(
            chain_id,
            untrusted_vals,
            untrusted_header.commit.block_id,
            untrusted_header.header.height,
            untrusted_header.commit,
        )
    except CHECK_ERRORS as e:
        raise InvalidHeaderError(str(e)) from e


def adjacent_header_checks(
    chain_id: str,
    trusted_header: SignedHeader,
    untrusted_header: SignedHeader,
    untrusted_vals: ValidatorSet,
    trusting_period_ns: int,
    now_ns: int,
    max_clock_drift_ns: int = MAX_CLOCK_DRIFT_NS,
) -> None:
    """verify_adjacent's checks but the commit's signatures: split out
    so a window of hops runs every header check first, then one merged
    batch of all its commits' signatures (verify_adjacent_batch)."""
    if untrusted_header.header.height != trusted_header.header.height + 1:
        raise ValueError("headers must be adjacent in height")
    if header_expired(trusted_header, trusting_period_ns, now_ns):
        raise OldHeaderExpiredError(
            trusted_header.header.time_ns + trusting_period_ns, now_ns
        )
    _verify_new_header_and_vals(
        chain_id, untrusted_header, untrusted_vals, trusted_header,
        now_ns, max_clock_drift_ns,
    )
    if (
        untrusted_header.header.validators_hash
        != trusted_header.header.next_validators_hash
    ):
        raise InvalidHeaderError(
            "header validators_hash does not match trusted header "
            "next_validators_hash"
        )


def verify_adjacent(
    chain_id: str,
    trusted_header: SignedHeader,
    untrusted_header: SignedHeader,
    untrusted_vals: ValidatorSet,
    trusting_period_ns: int,
    now_ns: int,
    max_clock_drift_ns: int = MAX_CLOCK_DRIFT_NS,
) -> None:
    """Sequential verification: the new set is pinned by the trusted
    header's next_validators_hash."""
    adjacent_header_checks(
        chain_id, trusted_header, untrusted_header, untrusted_vals,
        trusting_period_ns, now_ns, max_clock_drift_ns,
    )
    try:
        verify_commit_light(
            chain_id,
            untrusted_vals,
            untrusted_header.commit.block_id,
            untrusted_header.header.height,
            untrusted_header.commit,
        )
    except CHECK_ERRORS as e:
        raise InvalidHeaderError(str(e)) from e


def verify_adjacent_batch(
    chain_id: str,
    trusted_header: SignedHeader,
    blocks,
    trusting_period_ns: int,
    now_ns: int,
    max_clock_drift_ns: int = MAX_CLOCK_DRIFT_NS,
) -> None:
    """verify_adjacent of an ascending run of LightBlocks from
    trusted_header.height + 1: every header check in hop order, with
    verify_adjacent's errors, then every commit's signatures in one
    verify_commit_light_bulk call. A bad signature raises
    InvalidHeaderError without the hop: a caller that needs the failing
    hop re-verifies hop by hop (the client's sequential window)."""
    prev = trusted_header
    rows = []
    for b in blocks:
        adjacent_header_checks(
            chain_id, prev, b.signed_header, b.validator_set,
            trusting_period_ns, now_ns, max_clock_drift_ns,
        )
        rows.append(
            (
                b.validator_set,
                b.signed_header.commit.block_id,
                b.signed_header.header.height,
                b.signed_header.commit,
            )
        )
        prev = b.signed_header
    try:
        verify_commit_light_bulk(chain_id, rows)
    except CHECK_ERRORS as e:
        raise InvalidHeaderError(str(e)) from e


def verify(
    chain_id: str,
    trusted_header: SignedHeader,
    trusted_next_vals: ValidatorSet,
    untrusted_header: SignedHeader,
    untrusted_vals: ValidatorSet,
    trusting_period_ns: int,
    now_ns: int,
    max_clock_drift_ns: int = MAX_CLOCK_DRIFT_NS,
    trust_level: Fraction = DEFAULT_TRUST_LEVEL,
) -> None:
    """Adjacent or non-adjacent, by height."""
    if untrusted_header.header.height != trusted_header.header.height + 1:
        verify_non_adjacent(
            chain_id, trusted_header, trusted_next_vals,
            untrusted_header, untrusted_vals,
            trusting_period_ns, now_ns, max_clock_drift_ns, trust_level,
        )
    else:
        verify_adjacent(
            chain_id, trusted_header, untrusted_header, untrusted_vals,
            trusting_period_ns, now_ns, max_clock_drift_ns,
        )


def verify_backwards(
    chain_id: str,
    untrusted_header: SignedHeader,
    trusted_header: SignedHeader,
) -> None:
    """An older header against a trusted newer one, by the hash chain;
    no signature is checked."""
    try:
        untrusted_header.validate_basic(chain_id)
    except ValueError as e:
        raise InvalidHeaderError(str(e)) from e
    if untrusted_header.header.height >= trusted_header.header.height:
        raise InvalidHeaderError(
            "untrusted header must have a smaller height"
        )
    if untrusted_header.header.time_ns >= trusted_header.header.time_ns:
        raise InvalidHeaderError(
            "untrusted header must have an earlier time"
        )
    if (
        trusted_header.header.last_block_id.hash
        != untrusted_header.header.hash()
    ):
        raise VerificationError(
            f"trusted header last_block_id does not match untrusted "
            f"header hash at height {untrusted_header.header.height}"
        )
