"""Commit verification: the north-star path.

Counterpart: tendermint_tpu/types/validation.py:74-190 (verify_commit,
verify_commit_light, verify_commit_light_trusting and their errors), the
merged light verification of many commits (collect_commit_light :191,
verify_triples_grouped :258, verify_commit_light_bulk :321, and
_prefix_crossing :476), the batch path's dispatch :430-474, the vector
plans :526-750, the scalar reference tally :752-865, the drain :868-895
and the single path :898-964. Error types and messages are
byte-identical to the JAX package's.

The batch path packs a Commit's (pubkey, sign-bytes, signature) triples
into one crypto.batch verifier per key type; with the device verifier
installed (crypto/gpu_verifier.install) that is the CUDA kernels on the
padded batch. The three entry points run the vector plans
(_verify_commit_batch_vector): a masked sum or a prefix sum over the
powers picks the indexes the reference loop would visit and its tally,
and their sign-bytes are spliced in one C call. The scalar loop
(_verify_commit_batch_scalar) runs only for a commit whose BlockIDFlags
do not fit uint8 (Commit.block_id_flags_array() is None), the JAX
package's own data route, so such a commit gets the reference error.
Left out on purpose: the verified-signature cache, the commit-level memo
and tracing. A cache would skip the kernels on the very path being
brought up. So verify_triples_grouped verifies every triple it is given,
and verify_commit_light_bulk collects every commit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

from ..crypto.batch import create_batch_verifier, supports_batch_verifier
from .block_id import BlockID
from .commit import (
    BLOCK_ID_FLAG_ABSENT,
    BLOCK_ID_FLAG_COMMIT,
    Commit,
    CommitSig,
)
from .validator import ValidatorSet

__all__ = [
    "BATCH_VERIFY_THRESHOLD",
    "Fraction",
    "InvalidCommitError",
    "NotEnoughVotingPowerError",
    "collect_commit_light",
    "verify_commit",
    "verify_commit_light",
    "verify_commit_light_bulk",
    "verify_commit_light_trusting",
    "verify_triples_grouped",
]

BATCH_VERIFY_THRESHOLD = 2  # reference: types/validation.go:12


@dataclass(frozen=True)
class Fraction:
    """Trust level, e.g. 1/3."""

    numerator: int
    denominator: int

    def validate(self) -> None:
        if self.denominator == 0:
            raise ValueError("fraction has zero denominator")


class InvalidCommitError(ValueError):
    pass


class NotEnoughVotingPowerError(InvalidCommitError):
    def __init__(self, got: int, needed: int) -> None:
        super().__init__(
            f"invalid commit -- insufficient voting power: got {got}, "
            f"needed more than {needed}"
        )
        self.got = got
        self.needed = needed


def _should_batch_verify(vals: ValidatorSet, commit: Commit) -> bool:
    return len(
        commit.signatures
    ) >= BATCH_VERIFY_THRESHOLD and supports_batch_verifier(
        vals.get_proposer().pub_key
    )


def _verify(
    chain_id, vals, commit, needed, ignore, count, count_all, by_index
) -> None:
    """The batch path's dispatch (JAX :430-474 with vector_tally=True, as
    its three entry points pass it): the vector plans, unless the flags
    do not fit uint8; a commit too small to batch verifies one by one.
    ignore and count are the entry point's standard predicates, which
    the vector plans compute from the flags."""
    if _should_batch_verify(vals, commit):
        flags = commit.block_id_flags_array()
        if flags is not None:
            _verify_commit_batch_vector(
                chain_id, vals, commit, needed, count_all, by_index, flags
            )
        else:
            _verify_commit_batch_scalar(
                chain_id, vals, commit, needed, ignore, count, count_all,
                by_index,
            )
    else:
        _verify_commit_single(
            chain_id, vals, commit, needed, ignore, count, count_all, by_index
        )


def verify_commit(
    chain_id: str,
    vals: ValidatorSet,
    block_id: BlockID,
    height: int,
    commit: Commit,
) -> None:
    """+2/3 signed, verifying ALL signatures (the full bitmap is needed
    for incentivization)."""
    _verify_basic(vals, commit, height, block_id)
    needed = vals.total_voting_power() * 2 // 3
    _verify(
        chain_id, vals, commit, needed,
        lambda c: c.is_absent(), lambda c: c.is_for_block(), True, True,
    )


def verify_commit_light(
    chain_id: str,
    vals: ValidatorSet,
    block_id: BlockID,
    height: int,
    commit: Commit,
) -> None:
    """+2/3 signed, stopping once the tally crosses 2/3."""
    _verify_basic(vals, commit, height, block_id)
    needed = vals.total_voting_power() * 2 // 3
    _verify(
        chain_id, vals, commit, needed,
        lambda c: not c.is_for_block(), lambda c: True, False, True,
    )


def verify_commit_light_trusting(
    chain_id: str,
    vals: ValidatorSet,
    commit: Commit,
    trust_level: Fraction,
) -> None:
    """trust_level (e.g. 1/3) of a TRUSTED validator set signed; lookup
    by address since the sets need not match."""
    if vals is None:
        raise InvalidCommitError("nil validator set")
    trust_level.validate()
    if commit is None:
        raise InvalidCommitError("nil commit")
    total_mul = vals.total_voting_power() * trust_level.numerator
    if total_mul >= 1 << 63:
        raise InvalidCommitError(
            "int64 overflow while calculating voting power needed"
        )
    needed = total_mul // trust_level.denominator
    _verify(
        chain_id, vals, commit, needed,
        lambda c: not c.is_for_block(), lambda c: True, False, False,
    )


def collect_commit_light(
    chain_id: str,
    vals: ValidatorSet,
    block_id: BlockID,
    height: int,
    commit: Commit,
) -> list:
    """verify_commit_light's checks but the signatures (set size, height,
    block ID, the 2/3 tally with its early exit), returning the
    (pub_key, sign_bytes, signature) triples it would have checked,
    unchecked. A caller folds the triples of many commits into one batch
    (the light client's sequential window); when that batch fails, it
    re-verifies commit by commit for the reference's error."""
    _verify_basic(vals, commit, height, block_id)
    voting_power_needed = vals.total_voting_power() * 2 // 3
    flags = commit.block_id_flags_array()
    if flags is not None:
        # the prefix-sum form of the early-exit tally: the crossing index
        # is the vote after which the scalar loop below returns
        tallied, end = _prefix_crossing(
            np.where(flags == BLOCK_ID_FLAG_COMMIT, vals.powers_array(), 0),
            voting_power_needed,
        )
        if end is None:
            raise NotEnoughVotingPowerError(tallied, voting_power_needed)
        validators = vals.validators
        signatures = commit.signatures
        idxs = np.flatnonzero(flags[:end] == BLOCK_ID_FLAG_COMMIT).tolist()
        return [
            (validators[i].pub_key, sb, signatures[i].signature)
            for i, sb in zip(idxs, commit.vote_sign_bytes_batch(chain_id, idxs))
        ]
    # the scalar reference loop, for flags outside uint8
    tallied = 0
    out = []
    for idx, commit_sig in enumerate(commit.signatures):
        if not commit_sig.is_for_block():
            continue
        val = vals.validators[idx]
        out.append(
            (
                val.pub_key,
                commit.vote_sign_bytes(chain_id, idx),
                commit_sig.signature,
            )
        )
        tallied += val.voting_power
        if tallied > voting_power_needed:
            return out
    raise NotEnoughVotingPowerError(tallied, voting_power_needed)


def verify_triples_grouped(triples) -> None:
    """One signature check over (pub_key, sign_bytes, signature) triples
    of many commits (collect_commit_light): one batch verifier a key
    type, each with its own size hint; a key type without batch support
    verifies inline. Raises InvalidCommitError on any bad signature,
    without an index: the caller re-verifies commit by commit for the
    reference's error."""
    pending: dict = {}
    for pk, sb, sig in triples:
        if not supports_batch_verifier(pk):
            if not pk.verify_signature(sb, sig):
                raise InvalidCommitError("wrong signature in merged batch")
            continue
        pending.setdefault(pk.type(), []).append((pk, sb, sig))
    for items in pending.values():
        bv = create_batch_verifier(items[0][0], size_hint=len(items))
        for pk, sb, sig in items:
            bv.add(pk, sb, sig)
        ok, _bits = bv.verify()
        if not ok:
            raise InvalidCommitError("wrong signature in merged batch")


def verify_commit_light_bulk(chain_id: str, rows) -> None:
    """verify_commit_light of M commits in one pass: `rows` holds
    (vals, block_id, height, commit), checked in order with
    collect_commit_light's errors, then every commit's triples in one
    verify_triples_grouped call. A bad signature raises
    InvalidCommitError without the commit's index."""
    triples: list = []
    for vals, block_id, height, commit in rows:
        triples.extend(
            collect_commit_light(chain_id, vals, block_id, height, commit)
        )
    if triples:
        verify_triples_grouped(triples)


def _prefix_crossing(masked_powers, voting_power_needed: int):
    """(tallied, end) of the reference's early-exit scan over
    `masked_powers`, the power each position adds (0 where the scan
    skips): the scan stops after the vote whose running total first
    exceeds the threshold, so `end` is that index + 1, or None when the
    whole array is scanned without crossing it."""
    cum = masked_powers.cumsum()
    total = int(cum[-1]) if cum.size else 0
    if total > voting_power_needed:
        cross = int(np.argmax(cum > voting_power_needed))
        return int(cum[cross]), cross + 1
    return total, None


def _verify_basic(
    vals: Optional[ValidatorSet],
    commit: Optional[Commit],
    height: int,
    block_id: BlockID,
) -> None:
    if vals is None:
        raise InvalidCommitError("nil validator set")
    if commit is None:
        raise InvalidCommitError("nil commit")
    if vals.size() != len(commit.signatures):
        raise InvalidCommitError(
            f"invalid commit -- wrong set size: {vals.size()} vs "
            f"{len(commit.signatures)}"
        )
    if height != commit.height:
        raise InvalidCommitError(
            f"invalid commit -- wrong height: {height} vs {commit.height}"
        )
    if block_id != commit.block_id:
        raise InvalidCommitError(
            f"invalid commit -- wrong block ID: want {block_id}, "
            f"got {commit.block_id}"
        )


def _verify_commit_batch_vector(
    chain_id: str,
    vals: ValidatorSet,
    commit: Commit,
    voting_power_needed: int,
    count_all_signatures: bool,
    look_up_by_index: bool,
    flags: np.ndarray,
) -> None:
    """The vector plans: the indexes the reference loop visits and its
    tally, from the flags and the powers, with the same processed
    indexes, early-exit points and errors as _verify_commit_batch_scalar:

    - verify_commit (count all, by index): every non-absent index; the
      tally is the sum of the powers where the flag is COMMIT;
    - verify_commit_light (early exit, by index): the reference loop
      counts the for-block votes in index order and stops after the one
      that crosses the threshold, the first index where the prefix sum
      of the COMMIT-masked powers exceeds it; the for-block votes
      through that index are processed;
    - verify_commit_light_trusting (early exit, by address): the same
      prefix sum over the powers resolved through the trusted set's
      address index (a missing address adds 0, as the reference skips
      it). A duplicated address can only inflate the prefix sum, so the
      crossing k never lies past the reference loop's end: a duplicate
      at j <= k is met by the per-index replay below, which raises the
      reference's double-vote error; a duplicate at j > k the reference
      loop never reached either, and then the prefix through k holds no
      duplicate, so its sums agree exactly.

    The sign-bytes of the processed indexes are spliced in one call
    (Commit.sign_bytes_batch for verify_commit, vote_sign_bytes_batch of
    the visited prefix for the early-exit plans). The triples are
    grouped per key type and drained after the plan, so each group's
    verifier gets its own size hint; a key type with no batch support
    verifies inline."""
    sigs = commit.signatures
    powers = vals.powers_array()
    if count_all_signatures:
        tallied = int(powers[flags == BLOCK_ID_FLAG_COMMIT].sum())
        idx_list = np.flatnonzero(flags != BLOCK_ID_FLAG_ABSENT).tolist()
    elif look_up_by_index:
        tallied, end = _prefix_crossing(
            np.where(flags == BLOCK_ID_FLAG_COMMIT, powers, 0),
            voting_power_needed,
        )
        idx_list = np.flatnonzero(
            (flags if end is None else flags[:end]) == BLOCK_ID_FLAG_COMMIT
        ).tolist()
    else:
        fb = np.flatnonzero(flags == BLOCK_ID_FLAG_COMMIT)
        addr_index = vals._addr_index
        vi = np.fromiter(
            (addr_index.get(sigs[i].validator_address, -1) for i in fb.tolist()),
            dtype=np.int64,
            count=fb.size,
        )
        tallied, end = _prefix_crossing(
            np.where(vi >= 0, powers[np.maximum(vi, 0)], 0),
            voting_power_needed,
        )
        idx_list = (fb if end is None else fb[:end]).tolist()

    if look_up_by_index:
        if count_all_signatures:
            rows = commit.sign_bytes_batch(chain_id)
            sbs = [rows[i] for i in idx_list]
        else:
            sbs = commit.vote_sign_bytes_batch(chain_id, idx_list)
        validators = vals.validators
        triples = zip([validators[i].pub_key for i in idx_list], sbs, idx_list)
    else:
        # trusting: the per-index replay of the reference body over the
        # plan's prefix, for the double-vote error and its order
        sbs = commit.vote_sign_bytes_batch(chain_id, idx_list)
        triples = _replay_by_address(vals, sigs, idx_list, sbs)
    # key type -> [(pub_key, sign_bytes, signature, commit idx)]
    pending: dict[str, list] = {}
    inline: set = set()  # key types with no batch support
    for pub_key, sb, i in triples:
        sig = sigs[i].signature
        key_type = pub_key.type()
        group = pending.get(key_type)
        if group is None:
            if key_type in inline or not supports_batch_verifier(pub_key):
                inline.add(key_type)
                if not pub_key.verify_signature(sb, sig):
                    raise InvalidCommitError(f"wrong signature (#{i}): {sig.hex()}")
                continue
            group = pending[key_type] = []
        group.append((pub_key, sb, sig, i))
    if tallied <= voting_power_needed:
        raise NotEnoughVotingPowerError(tallied, voting_power_needed)
    _drain_pending(commit, pending)


def _replay_by_address(vals: ValidatorSet, sigs, idx_list, sbs):
    """(pub_key, sign_bytes, idx) of each index of the trusting plan
    whose address the trusted set holds, in order, raising the
    reference's double-vote error at the second vote of a validator."""
    seen_vals: dict[int, int] = {}
    for idx, sb in zip(idx_list, sbs):
        val_idx, val = vals.get_by_address(sigs[idx].validator_address)
        if val is None:
            continue
        if val_idx in seen_vals:
            raise InvalidCommitError(
                f"double vote from {val.address.hex()} "
                f"({seen_vals[val_idx]} and {idx})"
            )
        seen_vals[val_idx] = idx
        yield val.pub_key, sb, idx


def _verify_commit_batch_scalar(
    chain_id: str,
    vals: ValidatorSet,
    commit: Commit,
    voting_power_needed: int,
    ignore_sig: Callable[[CommitSig], bool],
    count_sig: Callable[[CommitSig], bool],
    count_all_signatures: bool,
    look_up_by_index: bool,
) -> None:
    """The reference scan: per-vote predicates, incremental tally, early
    exit by running total. The vector plans must stop at the same vote
    and raise the same errors as this loop: it is the route of a commit
    whose flags do not fit uint8 and the oracle the tests hold them
    against. Triples are grouped per key type and drained after the
    scan, so each group's verifier gets its own size hint; a key type
    with no batch support verifies inline."""
    tallied = 0
    seen_vals: dict[int, int] = {}
    # key type -> [(pub_key, sign_bytes, signature, commit idx)]
    pending: dict[str, list] = {}
    batchable: dict[str, bool] = {}
    all_sign_bytes = (
        commit.sign_bytes_batch(chain_id) if count_all_signatures else None
    )
    for idx, commit_sig in enumerate(commit.signatures):
        if ignore_sig(commit_sig):
            continue
        if look_up_by_index:
            val = vals.validators[idx]
        else:
            val_idx, val = vals.get_by_address(commit_sig.validator_address)
            if val is None:
                continue
            if val_idx in seen_vals:
                raise InvalidCommitError(
                    f"double vote from {val.address.hex()} "
                    f"({seen_vals[val_idx]} and {idx})"
                )
            seen_vals[val_idx] = idx
        vote_sign_bytes = (
            all_sign_bytes[idx]
            if all_sign_bytes is not None
            else commit.vote_sign_bytes(chain_id, idx)
        )
        pub_key = val.pub_key
        key_type = pub_key.type()
        can_batch = batchable.get(key_type)
        if can_batch is None:
            can_batch = batchable[key_type] = supports_batch_verifier(pub_key)
        if not can_batch:
            if not pub_key.verify_signature(
                vote_sign_bytes, commit_sig.signature
            ):
                raise InvalidCommitError(
                    f"wrong signature (#{idx}): "
                    f"{commit_sig.signature.hex()}"
                )
        else:
            pending.setdefault(key_type, []).append(
                (pub_key, vote_sign_bytes, commit_sig.signature, idx)
            )
        if count_sig(commit_sig):
            tallied += val.voting_power
        if not count_all_signatures and tallied > voting_power_needed:
            break
    if tallied <= voting_power_needed:
        raise NotEnoughVotingPowerError(tallied, voting_power_needed)
    _drain_pending(commit, pending)


def _drain_pending(commit: Commit, pending: dict) -> None:
    """Drain the per-key-type batches and raise the reference error for
    the LOWEST bad commit index across groups."""
    first_bad: Optional[int] = None
    for items in pending.values():
        bv = create_batch_verifier(items[0][0], size_hint=len(items))
        for pub_key, sb, sig, _idx in items:
            bv.add(pub_key, sb, sig)
        ok, valid_sigs = bv.verify()
        if ok:
            continue
        bad = [items[i][3] for i, good in enumerate(valid_sigs) if not good]
        if not bad:
            raise RuntimeError(
                "BUG: batch verification failed with no invalid signatures"
            )
        if first_bad is None or bad[0] < first_bad:
            first_bad = bad[0]
    if first_bad is not None:
        raise InvalidCommitError(
            f"wrong signature (#{first_bad}): "
            f"{commit.signatures[first_bad].signature.hex()}"
        )


def _verify_commit_single(
    chain_id: str,
    vals: ValidatorSet,
    commit: Commit,
    voting_power_needed: int,
    ignore_sig: Callable[[CommitSig], bool],
    count_sig: Callable[[CommitSig], bool],
    count_all_signatures: bool,
    look_up_by_index: bool,
) -> None:
    """One verify per signature (reference: types/validation.go:265-328)."""
    tallied = 0
    seen_vals: dict[int, int] = {}
    for idx, commit_sig in enumerate(commit.signatures):
        if ignore_sig(commit_sig):
            continue
        if look_up_by_index:
            val = vals.validators[idx]
        else:
            val_idx, val = vals.get_by_address(commit_sig.validator_address)
            if val is None:
                continue
            if val_idx in seen_vals:
                raise InvalidCommitError(
                    f"double vote from {val.address.hex()} "
                    f"({seen_vals[val_idx]} and {idx})"
                )
            seen_vals[val_idx] = idx
        vote_sign_bytes = commit.vote_sign_bytes(chain_id, idx)
        if not val.pub_key.verify_signature(
            vote_sign_bytes, commit_sig.signature
        ):
            raise InvalidCommitError(
                f"wrong signature (#{idx}): {commit_sig.signature.hex()}"
            )
        if count_sig(commit_sig):
            tallied += val.voting_power
        if not count_all_signatures and tallied > voting_power_needed:
            return
    if tallied <= voting_power_needed:
        raise NotEnoughVotingPowerError(tallied, voting_power_needed)
