"""The evidence pool: verified evidence waiting for a block.

Counterpart: tendermint_tpu/evidence/pool.py:1-220 (reference:
internal/evidence/pool.go:56-324): the pending list in a KV store,
expiry by age and height, committed-evidence markers, and the intake of
a double sign the step machine reports (ReportConflictingVotes :188),
buffered until the next update, when the validator set of its height is
known. The pool's mutators keep its EvidenceMetrics struct's pool_size
exact and count committed and expired evidence (:41-58, :180-210).
"""

from __future__ import annotations

import logging
import struct
import time
from typing import List, Tuple

from ..state.types import State
from ..types.evidence import (
    DuplicateVoteEvidence,
    Evidence,
    evidence_from_proto,
    evidence_to_proto,
)
from ..types.vote import Vote
from .metrics import EvidenceMetrics
from .verify import verify_evidence

__all__ = ["EvidencePool", "EvidenceError"]

_PENDING_PREFIX = b"evp/"  # pending evidence
_COMMITTED_PREFIX = b"evc/"  # committed evidence markers


class EvidenceError(Exception):
    pass


def _key(prefix: bytes, ev: Evidence) -> bytes:
    return prefix + struct.pack(">q", ev.height()) + ev.hash()


class EvidencePool:
    def __init__(self, db, state_store, block_store, metrics=None) -> None:
        self.db = db
        self.state_store = state_store
        self.block_store = block_store
        self.logger = logging.getLogger(__name__)
        self.metrics = metrics if metrics is not None else EvidenceMetrics()
        self._pending: List[Evidence] = []
        self._pending_keys: set = set()
        # consensus-reported double signs buffered until the next Update
        # (they may be for the current height, whose block isn't stored yet;
        # reference: pool.go:188-204 + consensus buffer handling)
        self._consensus_buffer: List[Tuple[Vote, Vote]] = []
        self._load_pending()
        self.metrics.pool_size.set(len(self._pending))

    # -- queries --

    def pending_evidence(self, max_bytes: int) -> Tuple[List[Evidence], int]:
        """reference: pool.go:88-110 PendingEvidence."""
        out: List[Evidence] = []
        size = 0
        for ev in self._pending:
            ev_size = len(ev.bytes())
            if size + ev_size > max_bytes:
                break
            out.append(ev)
            size += ev_size
        return out, size

    def is_committed(self, ev: Evidence) -> bool:
        return self.db.get(_key(_COMMITTED_PREFIX, ev)) is not None

    def is_pending(self, ev: Evidence) -> bool:
        return _key(_PENDING_PREFIX, ev) in self._pending_keys

    # -- intake --

    def add_evidence(self, ev: Evidence) -> None:
        """Verify and admit gossiped/submitted evidence
        (reference: pool.go:112-160). Raises EvidenceError if invalid."""
        if self.is_pending(ev) or self.is_committed(ev):
            return  # already known
        state = self.state_store.load()
        try:
            verify_evidence(ev, state, self.state_store, self.block_store)
        except ValueError as e:
            raise EvidenceError(f"invalid evidence: {e}") from e
        self._add_pending(ev)
        self.logger.info("verified new evidence %s", ev.hash().hex()[:16])

    def report_conflicting_votes(self, vote_a: Vote, vote_b: Vote) -> None:
        """From consensus: buffer the pair; evidence is formed at the next
        Update when the validator set for that height is known
        (reference: pool.go:188-204)."""
        self._consensus_buffer.append((vote_a, vote_b))

    def check_evidence(self, evidence: List[Evidence]) -> None:
        """Block-validation path: every item must verify and not be
        committed; duplicates in one block are invalid
        (reference: pool.go:206-260)."""
        if not evidence:
            # the overwhelmingly common case — don't pay a full state
            # decode (ValidatorSet included) per evidence-free block
            return
        state = self.state_store.load()
        seen = set()
        for ev in evidence:
            if not self.is_pending(ev):
                try:
                    verify_evidence(
                        ev, state, self.state_store, self.block_store
                    )
                except ValueError as e:
                    raise EvidenceError(f"invalid evidence: {e}") from e
            if self.is_committed(ev):
                raise EvidenceError("evidence was already committed")
            h = ev.hash()
            if h in seen:
                raise EvidenceError("duplicate evidence in block")
            seen.add(h)

    # -- post-commit update --

    def update(self, state: State, evidence: List[Evidence]) -> None:
        """Mark committed, prune expired, and materialize buffered
        double-signs (reference: pool.go:162-186)."""
        for ev in evidence:
            self._mark_committed(state.last_block_height, ev)
        self._process_consensus_buffer(state)
        self._prune_expired(state)

    def _process_consensus_buffer(self, state: State) -> None:
        buffered, self._consensus_buffer = self._consensus_buffer, []
        for vote_a, vote_b in buffered:
            vals = self.state_store.load_validators(vote_a.height)
            if vals is None:
                self.logger.error(
                    "failed to form duplicate-vote evidence; no validator "
                    "set at height %d", vote_a.height,
                )
                continue
            _idx, val = vals.get_by_address(vote_a.validator_address)
            if val is None:
                continue
            ev = DuplicateVoteEvidence.from_votes(
                vote_a,
                vote_b,
                block_time_ns=self._block_time(vote_a.height),
                val_set=vals,
            )
            if not (self.is_pending(ev) or self.is_committed(ev)):
                self._add_pending(ev)
                self.logger.info(
                    "generated double-sign evidence at height %d, validator %s",
                    ev.height(),
                    vote_a.validator_address.hex()[:12],
                )

    def _block_time(self, height: int) -> int:
        meta = self.block_store.load_block_meta(height)
        return meta.header.time_ns if meta is not None else time.time_ns()

    def _prune_expired(self, state: State) -> None:
        params = state.consensus_params.evidence
        keep: List[Evidence] = []
        for ev in self._pending:
            age_blocks = state.last_block_height - ev.height()
            ev_time = self._block_time(ev.height())
            age_ns = state.last_block_time_ns - ev_time
            if (
                age_blocks > params.max_age_num_blocks
                and age_ns > params.max_age_duration_ns
            ):
                self.db.delete(_key(_PENDING_PREFIX, ev))
                self._pending_keys.discard(_key(_PENDING_PREFIX, ev))
                self.metrics.expired_total.inc()
                self.logger.info("pruned expired evidence at height %d", ev.height())
            else:
                keep.append(ev)
        self._pending = keep
        self.metrics.pool_size.set(len(self._pending))

    # -- storage --

    def _add_pending(self, ev: Evidence) -> None:
        key = _key(_PENDING_PREFIX, ev)
        self.db.set(key, evidence_to_proto(ev))
        self._pending.append(ev)
        self._pending_keys.add(key)
        self.metrics.pool_size.set(len(self._pending))

    def _mark_committed(self, commit_height: int, ev: Evidence) -> None:
        self.db.set(
            _key(_COMMITTED_PREFIX, ev), struct.pack(">q", commit_height)
        )
        self.metrics.committed_total.inc()
        key = _key(_PENDING_PREFIX, ev)
        if key in self._pending_keys:
            self.db.delete(key)
            self._pending_keys.discard(key)
            self._pending = [
                p for p in self._pending if p.hash() != ev.hash()
            ]
            self.metrics.pool_size.set(len(self._pending))

    def _load_pending(self) -> None:
        end = _PENDING_PREFIX[:-1] + bytes([_PENDING_PREFIX[-1] + 1])
        for key, value in self.db.iterate(start=_PENDING_PREFIX, end=end):
            ev = evidence_from_proto(value)
            self._pending.append(ev)
            self._pending_keys.add(key)

    def size(self) -> int:
        return len(self._pending)
