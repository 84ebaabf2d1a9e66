"""Validator and ValidatorSet: what commit verification reads.

Counterpart: tendermint_tpu/types/validator.py (construction from a
validator list, order, hash, proto round-trip). Proposer selection (the
priority increments, rescaling and change sets) is left to the slice
that wires the node: commit verification reads only the order, the
powers, the keys and the proposer's key type. A set built here keeps the
priorities it was given (zero by default) and names a proposer only when
one came with it on the wire (from_proto), so its to_proto equals the
JAX package's for a set carried across, not for one built here; the
hash, which covers keys and powers only, is the same either way.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Iterable, List, Optional, Tuple

from ..crypto import merkle
from ..crypto.keys import PubKey, pubkey_from_proto, pubkey_to_proto
from ..encoding.proto import FieldReader, ProtoWriter, iter_fields

__all__ = ["Validator", "ValidatorSet", "MAX_TOTAL_VOTING_POWER"]

# reference: types/validator_set.go:25
MAX_TOTAL_VOTING_POWER = ((1 << 63) - 1) // 8


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


class ValidatorSet:
    """Validators sorted by voting power desc, then address asc, with an
    address index for O(1) get_by_address."""

    def __init__(self, validators: Optional[Iterable[Validator]] = None):
        self.validators: List[Validator] = []
        self.proposer: Optional[Validator] = None
        self._total_voting_power = 0
        self._addr_index: Dict[bytes, int] = {}
        self._add_validators([v.copy() for v in validators or ()])

    # -- basic accessors --

    def size(self) -> int:
        return len(self.validators)

    def __len__(self) -> int:
        return len(self.validators)

    def get_by_address(
        self, address: bytes
    ) -> Tuple[int, Optional[Validator]]:
        """(index, validator) or (-1, None)
        (reference: types/validator_set.go:270)."""
        i = self._addr_index.get(address)
        if i is None:
            return -1, None
        return i, self.validators[i].copy()

    def total_voting_power(self) -> int:
        if self._total_voting_power == 0:
            self._update_total_voting_power()
        return self._total_voting_power

    def _reindex(self) -> None:
        self._addr_index = {
            v.address: i for i, v in enumerate(self.validators)
        }

    def _update_total_voting_power(self) -> None:
        total = 0
        for v in self.validators:
            total += v.voting_power
            if total > MAX_TOTAL_VOTING_POWER:
                raise OverflowError(
                    f"total voting power exceeds max {MAX_TOTAL_VOTING_POWER}"
                )
        self._total_voting_power = total

    def get_proposer(self) -> Validator:
        """The proposer from the wire, else the validator of highest
        priority, ties to the lower address (reference:
        types/validator.go:77-97)."""
        if not self.validators:
            raise ValueError("empty validator set")
        if self.proposer is not None:
            return self.proposer.copy()
        return min(
            self.validators, key=lambda v: (-v.proposer_priority, v.address)
        ).copy()

    # -- hashing --

    def hash(self) -> bytes:
        """Merkle root of the SimpleValidator leaves (pub_key and power
        in order, not priorities)."""
        return merkle.hash_from_byte_slices(
            [v.hash_bytes() for v in self.validators]
        )

    # -- construction: validator_set.go:380-651 restricted to additions
    #    into an empty set --

    def _add_validators(self, changes: List[Validator]) -> None:
        prev_addr = None
        for c in sorted(changes, key=lambda v: v.address):
            if c.address == prev_addr:
                raise ValueError(f"duplicate entry {c.address.hex()}")
            if c.voting_power < 0:
                raise ValueError("voting power can't be negative")
            if c.voting_power == 0:
                raise ValueError(
                    "cannot process validators with voting power 0"
                )
            prev_addr = c.address
        # sort by voting power desc, address asc
        self.validators = sorted(
            changes, key=lambda v: (-v.voting_power, v.address)
        )
        self._update_total_voting_power()
        self._reindex()

    # -- proto --

    def to_proto(self) -> bytes:
        w = ProtoWriter()
        for v in self.validators:
            w.message(1, v.to_proto())
        if self.proposer is not None:
            w.message(2, self.proposer.to_proto())
        w.int(3, self.total_voting_power())
        return w.finish()

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

    def __repr__(self) -> str:
        return (
            f"ValidatorSet(n={len(self.validators)}, "
            f"power={self.total_voting_power()})"
        )
