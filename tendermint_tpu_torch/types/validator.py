"""Validator and ValidatorSet.

Counterpart: tendermint_tpu/types/validator.py: Validator (:58-121),
`has_address`, `get_by_address` and `get_by_index` (:172-191), the
set's construction from a validator list (:146-160) and its change
sets (`update_with_change_set`, :389-512: the validator updates of
EndBlock), `copy` (:263) and `copy_increment_proposer_priority` (:324),
proposer selection (:124-140, :298-371), `powers_array` (:193), the
`hash()` memo and its invalidation by `_reindex` (:276-285, :373-385),
`validate_basic` (:591) and the proto round-trip with its memo
(:516-570). A set built here gets the priorities and the proposer the
JAX package's constructor gives it, so its to_proto equals the JAX
package's. Left out: the memos of the JAX package's warm commit paths
(pubkey bytes, fingerprint tokens); powers_array is computed per call.

The hash memo covers keys and powers only; like the JAX package's, it is
dropped by _reindex, which every path that changes the membership or a
power here runs, and survives a copy; an in-place change of a
validator's key or power is not a supported mutation of a set.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from ..crypto import merkle
from ..crypto.keys import PubKey, pubkey_from_proto, pubkey_to_proto
from ..encoding.proto import FieldReader, ProtoWriter, iter_fields

__all__ = [
    "MAX_TOTAL_VOTING_POWER",
    "PRIORITY_WINDOW_SIZE_FACTOR",
    "Validator",
    "ValidatorSet",
]

INT64_MAX = (1 << 63) - 1
INT64_MIN = -(1 << 63)

# reference: types/validator_set.go:25,29
MAX_TOTAL_VOTING_POWER = INT64_MAX // 8
PRIORITY_WINDOW_SIZE_FACTOR = 2


def _clip(v: int) -> int:
    return INT64_MAX if v > INT64_MAX else INT64_MIN if v < INT64_MIN else v


@dataclass
class Validator:
    pub_key: PubKey
    voting_power: int = 0
    proposer_priority: int = 0
    address: bytes = b""

    def __post_init__(self) -> None:
        if not self.address and self.pub_key is not None:
            self.address = self.pub_key.address()

    def copy(self) -> "Validator":
        return replace(self)

    def validate_basic(self) -> None:
        if self.pub_key is None:
            raise ValueError("validator does not have a public key")
        if self.voting_power < 0:
            raise ValueError("validator has negative voting power")
        if len(self.address) != 20:
            raise ValueError("validator address is the wrong size")

    def hash_bytes(self) -> bytes:
        """SimpleValidator proto (pubkey + power, no priority/address) —
        the validator-set hash leaf (reference: types/validator.go:130-145,
        proto/tendermint/types/validator.pb.go:156-157)."""
        w = ProtoWriter()
        w.message(1, pubkey_to_proto(self.pub_key))
        w.int(2, self.voting_power)
        return w.finish()

    def to_proto(self) -> bytes:
        w = ProtoWriter()
        w.bytes(1, self.address)
        w.message(2, pubkey_to_proto(self.pub_key))  # nullable=false
        w.int(3, self.voting_power)
        w.int(4, self.proposer_priority)
        return w.finish()

    @classmethod
    def from_proto(cls, data: bytes) -> "Validator":
        r = FieldReader(data)
        pk = r.get(2)
        if pk is None:
            raise ValueError("validator proto missing pub_key")
        return cls(
            pub_key=pubkey_from_proto(pk),
            voting_power=r.int64(3),
            proposer_priority=r.int64(4),
            address=r.bytes(1),
        )


def _cmp_most_priority(a: Validator, b: Validator) -> Validator:
    """Higher priority wins; ties break toward the lower address."""
    if a.proposer_priority > b.proposer_priority:
        return a
    if a.proposer_priority < b.proposer_priority:
        return b
    if a.address < b.address:
        return a
    if a.address > b.address:
        return b
    raise ValueError("cannot compare identical validators")


class ValidatorSet:
    """Validators sorted by voting power desc, then address asc, with an
    address index for O(1) get_by_address."""

    def __init__(self, validators: Optional[Iterable[Validator]] = None):
        self.validators: List[Validator] = []
        self.proposer: Optional[Validator] = None
        self._total_voting_power = 0
        self._addr_index: Dict[bytes, int] = {}
        self._hash: Optional[bytes] = None
        changes = [v.copy() for v in validators or ()]
        self._update_with_change_set(changes, allow_deletes=False)
        if changes:
            self.increment_proposer_priority(1)

    # -- basic accessors --

    def size(self) -> int:
        return len(self.validators)

    def __len__(self) -> int:
        return len(self.validators)

    def has_address(self, address: bytes) -> bool:
        return address in self._addr_index

    def get_by_address(
        self, address: bytes
    ) -> Tuple[int, Optional[Validator]]:
        """(index, validator) or (-1, None)
        (reference: types/validator_set.go:270)."""
        i = self._addr_index.get(address)
        if i is None:
            return -1, None
        return i, self.validators[i].copy()

    def get_by_index(self, index: int) -> Tuple[bytes, Optional[Validator]]:
        """(address, validator) or (b"", None) out of range."""
        if index < 0 or index >= len(self.validators):
            return b"", None
        v = self.validators[index]
        return v.address, v.copy()

    def total_voting_power(self) -> int:
        if self._total_voting_power == 0:
            self._update_total_voting_power()
        return self._total_voting_power

    def powers_array(self) -> np.ndarray:
        """Voting powers as an int64 array aligned with self.validators."""
        return np.fromiter(
            (v.voting_power for v in self.validators),
            dtype=np.int64,
            count=len(self.validators),
        )

    def copy(self) -> "ValidatorSet":
        """A deep copy; it keeps the hash memo (the same membership has
        the same root)."""
        new = ValidatorSet.__new__(ValidatorSet)
        new.validators = [v.copy() for v in self.validators]
        new.proposer = self.proposer.copy() if self.proposer else None
        new._total_voting_power = self._total_voting_power
        new._addr_index = dict(self._addr_index)
        new._hash = self._hash
        return new

    def copy_increment_proposer_priority(self, times: int) -> "ValidatorSet":
        c = self.copy()
        c.increment_proposer_priority(times)
        return c

    def _reindex(self) -> None:
        self._addr_index = {
            v.address: i for i, v in enumerate(self.validators)
        }
        self._hash = None  # the membership changed

    def _update_total_voting_power(self) -> None:
        total = 0
        for v in self.validators:
            total += v.voting_power
            if total > MAX_TOTAL_VOTING_POWER:
                raise OverflowError(
                    f"total voting power exceeds max {MAX_TOTAL_VOTING_POWER}"
                )
        self._total_voting_power = total

    # -- proposer selection (reference: types/validator_set.go:107-226) --

    def get_proposer(self) -> Validator:
        if not self.validators:
            raise ValueError("empty validator set")
        if self.proposer is None:
            self.proposer = self._find_proposer()
        return self.proposer.copy()

    def _find_proposer(self) -> Validator:
        result = None
        for v in self.validators:
            result = v if result is None else _cmp_most_priority(result, v)
        return result

    def increment_proposer_priority(self, times: int) -> None:
        if not self.validators:
            raise ValueError("empty validator set")
        if times <= 0:
            raise ValueError("times must be positive")
        self._rescale_priorities(
            PRIORITY_WINDOW_SIZE_FACTOR * self.total_voting_power()
        )
        self._shift_by_avg_proposer_priority()
        proposer = None
        for _ in range(times):
            proposer = self._increment_proposer_priority()
        self.proposer = proposer

    def _increment_proposer_priority(self) -> Validator:
        for v in self.validators:
            v.proposer_priority = _clip(v.proposer_priority + v.voting_power)
        mostest = self._find_proposer()
        mostest.proposer_priority = _clip(
            mostest.proposer_priority - self.total_voting_power()
        )
        return mostest

    def _rescale_priorities(self, diff_max: int) -> None:
        if diff_max <= 0:
            return
        prios = [v.proposer_priority for v in self.validators]
        diff = max(prios) - min(prios)
        ratio = (diff + diff_max - 1) // diff_max
        if diff > diff_max:
            for v in self.validators:
                # Go integer division truncates toward zero
                p = v.proposer_priority
                v.proposer_priority = -((-p) // ratio) if p < 0 else p // ratio

    def _shift_by_avg_proposer_priority(self) -> None:
        # Go's big.Int Div floors for a positive divisor, as // does
        avg = sum(v.proposer_priority for v in self.validators) // len(
            self.validators
        )
        for v in self.validators:
            v.proposer_priority = _clip(v.proposer_priority - avg)

    # -- hashing --

    def hash(self) -> bytes:
        """Merkle root of the SimpleValidator leaves (pub_key and power
        in order, not priorities). Memoized until _reindex(): light sync
        hashes the same set several times a header otherwise."""
        if self._hash is None:
            self._hash = merkle.hash_from_byte_slices(
                [v.hash_bytes() for v in self.validators]
            )
        return self._hash

    # -- change sets (reference: types/validator_set.go:380-651) --

    def update_with_change_set(self, changes: List[Validator]) -> None:
        """Apply validator updates: power 0 removes, a new address adds,
        a known one changes its power."""
        self._update_with_change_set([c.copy() for c in changes], allow_deletes=True)

    def _update_with_change_set(self, changes: List[Validator], allow_deletes: bool) -> None:
        """The construction of a set (additions into an empty set, no
        removals) and its updates."""
        if not changes:
            return
        updates, deletes = self._process_changes(changes)
        if not allow_deletes and deletes:
            raise ValueError("cannot process validators with voting power 0")
        num_new = sum(1 for u in updates if not self.has_address(u.address))
        if num_new == 0 and len(self.validators) == len(deletes):
            raise ValueError(
                "applying the validator changes would result in empty set"
            )
        removed_power = self._verify_removals(deletes)
        tvp_after = self._verify_updates(updates, removed_power)
        # priorities for new validators: -1.125 * updated total power
        for u in updates:
            _, existing = self.get_by_address(u.address)
            if existing is None:
                u.proposer_priority = -(tvp_after + (tvp_after >> 3))
            else:
                u.proposer_priority = existing.proposer_priority
        self._apply_updates(updates)
        self._apply_removals(deletes)
        self._total_voting_power = 0
        self._update_total_voting_power()
        self._rescale_priorities(
            PRIORITY_WINDOW_SIZE_FACTOR * self.total_voting_power()
        )
        self._shift_by_avg_proposer_priority()
        # sort by voting power desc, address asc
        self.validators.sort(key=lambda v: (-v.voting_power, v.address))
        self._reindex()

    @staticmethod
    def _process_changes(
        changes: List[Validator],
    ) -> Tuple[List[Validator], List[Validator]]:
        updates: List[Validator] = []
        removals: List[Validator] = []
        prev_addr = None
        for c in sorted(changes, key=lambda v: v.address):
            if c.address == prev_addr:
                raise ValueError(f"duplicate entry {c.address.hex()}")
            if c.voting_power < 0:
                raise ValueError("voting power can't be negative")
            if c.voting_power > MAX_TOTAL_VOTING_POWER:
                raise ValueError(
                    f"voting power can't be higher than {MAX_TOTAL_VOTING_POWER}"
                )
            (removals if c.voting_power == 0 else updates).append(c)
            prev_addr = c.address
        return updates, removals

    def _verify_removals(self, deletes: List[Validator]) -> int:
        removed = 0
        for d in deletes:
            _, val = self.get_by_address(d.address)
            if val is None:
                raise ValueError(
                    f"failed to find validator {d.address.hex()} to remove"
                )
            removed += val.voting_power
        if len(deletes) > len(self.validators):
            raise ValueError("more deletes than validators")
        return removed

    def _verify_updates(self, updates: List[Validator], removed_power: int) -> int:
        def delta(u: Validator) -> int:
            _, val = self.get_by_address(u.address)
            return u.voting_power - val.voting_power if val is not None else u.voting_power

        tvp_after_removals = self.total_voting_power() - removed_power
        for u in sorted(updates, key=delta):
            tvp_after_removals += delta(u)
            if tvp_after_removals > MAX_TOTAL_VOTING_POWER:
                raise OverflowError(
                    "total voting power of resulting valset exceeds max"
                )
        return tvp_after_removals + removed_power

    def _apply_updates(self, updates: List[Validator]) -> None:
        by_addr = {v.address: v for v in self.validators}
        by_addr.update((u.address, u) for u in updates)
        self.validators = [by_addr[a] for a in sorted(by_addr)]
        self._reindex()

    def _apply_removals(self, deletes: List[Validator]) -> None:
        if not deletes:
            return
        dead = {d.address for d in deletes}
        self.validators = [v for v in self.validators if v.address not in dead]
        self._reindex()

    # -- proto --

    def to_proto(self) -> bytes:
        """Memoized against every field the wire form reads: the light
        store saves one LightBlock a header, each with the same set, and
        re-encoding its validators is most of a save otherwise.
        Priorities change in place (increment_proposer_priority) and the
        validators are handed out live, so the memo is checked against
        their fields on every call rather than dropped by a hook."""
        key = (
            tuple(
                (v.address, v.pub_key.bytes(), v.voting_power, v.proposer_priority)
                for v in self.validators
            ),
            (
                (
                    self.proposer.address,
                    self.proposer.pub_key.bytes(),
                    self.proposer.voting_power,
                    self.proposer.proposer_priority,
                )
                if self.proposer is not None
                else None
            ),
        )
        memo = getattr(self, "_proto_memo", None)
        if memo is not None and memo[0] == key:
            return memo[1]
        w = ProtoWriter()
        for v in self.validators:
            w.message(1, v.to_proto())
        if self.proposer is not None:
            w.message(2, self.proposer.to_proto())
        w.int(3, self.total_voting_power())
        out = w.finish()
        self._proto_memo = (key, out)
        return out

    @classmethod
    def from_proto(cls, data: bytes) -> "ValidatorSet":
        # total_voting_power (field 3) is recomputed from the
        # validators, never trusted from the wire
        vals: List[Validator] = []
        proposer = None
        for f, _wt, v in iter_fields(data):
            if f == 1:
                vals.append(Validator.from_proto(v))
            elif f == 2:
                proposer = Validator.from_proto(v)
        new = cls.__new__(cls)
        new.validators = vals
        new.proposer = proposer
        new._total_voting_power = 0
        new._reindex()
        return new

    def validate_basic(self) -> None:
        if not self.validators:
            raise ValueError("validator set is nil or empty")
        for i, v in enumerate(self.validators):
            try:
                v.validate_basic()
            except ValueError as e:
                raise ValueError(f"invalid validator #{i}: {e}") from e
        if self.proposer is None:
            raise ValueError("proposer failed validate basic: nil")
        self.proposer.validate_basic()

    def __repr__(self) -> str:
        return (
            f"ValidatorSet(n={len(self.validators)}, "
            f"power={self.total_voting_power()})"
        )
