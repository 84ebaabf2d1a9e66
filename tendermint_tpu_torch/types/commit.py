"""Commit and CommitSig: the 2/3-majority precommit record in a block.

Counterpart: tendermint_tpu/types/commit.py (wire format :148-165 and
:438-464, sign-bytes :311-410, `block_id_flags_array` :262). The JAX
package's memo machinery (mutation epochs, sign-bytes rows, the flag
array's memo, fingerprint tokens) served its warm verification paths and
is left out: a Commit here encodes its sign-bytes and builds its flag
array on every call and caches only the per-chain splice templates. The
sign-bytes of a batch of votes are spliced in C (types/canonical.py).
`max_commit_bytes` (:61) sizes a block's data for a proposal.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from ..crypto import merkle
from ..encoding.proto import FieldReader, ProtoWriter, iter_fields
from ..libs.bits import BitArray
from .block_id import BlockID
from .canonical import PRECOMMIT_TYPE, VoteSignTemplate
from .timestamp import decode_timestamp, encode_timestamp
from .vote import Vote

__all__ = [
    "BLOCK_ID_FLAG_ABSENT",
    "BLOCK_ID_FLAG_COMMIT",
    "BLOCK_ID_FLAG_NIL",
    "Commit",
    "CommitSig",
    "max_commit_bytes",
]

BLOCK_ID_FLAG_ABSENT = 1  # no vote was received from this validator
BLOCK_ID_FLAG_COMMIT = 2  # voted for the committed block
BLOCK_ID_FLAG_NIL = 3  # voted nil

MAX_SIGNATURE_SIZE = 64
MAX_COMMIT_OVERHEAD_BYTES = 94  # reference: types/block.go:597
MAX_COMMIT_SIG_BYTES = 109  # reference: types/block.go:600


def max_commit_bytes(val_count: int) -> int:
    """The largest encoded Commit of val_count signatures
    (tendermint_tpu/types/commit.py:61; reference: types/block.go:621-625)."""
    proto_encoding_overhead = 2
    return MAX_COMMIT_OVERHEAD_BYTES + (
        (MAX_COMMIT_SIG_BYTES + proto_encoding_overhead) * val_count
    )


@dataclass
class CommitSig:
    block_id_flag: int = BLOCK_ID_FLAG_ABSENT
    validator_address: bytes = b""
    timestamp_ns: int = 0
    signature: bytes = b""

    @classmethod
    def absent(cls) -> "CommitSig":
        return cls(block_id_flag=BLOCK_ID_FLAG_ABSENT)

    @classmethod
    def for_block(
        cls, signature: bytes, val_addr: bytes, timestamp_ns: int
    ) -> "CommitSig":
        return cls(BLOCK_ID_FLAG_COMMIT, val_addr, timestamp_ns, signature)

    @classmethod
    def for_nil(
        cls, signature: bytes, val_addr: bytes, timestamp_ns: int
    ) -> "CommitSig":
        return cls(BLOCK_ID_FLAG_NIL, val_addr, timestamp_ns, signature)

    def is_absent(self) -> bool:
        return self.block_id_flag == BLOCK_ID_FLAG_ABSENT

    def is_for_block(self) -> bool:
        return self.block_id_flag == BLOCK_ID_FLAG_COMMIT

    def vote_block_id(self, commit_block_id: BlockID) -> BlockID:
        """The BlockID this sig's vote was cast for: the commit's for
        COMMIT, the zero BlockID otherwise."""
        if self.block_id_flag == BLOCK_ID_FLAG_COMMIT:
            return commit_block_id
        return BlockID()

    def validate_basic(self) -> None:
        if self.block_id_flag not in (
            BLOCK_ID_FLAG_ABSENT,
            BLOCK_ID_FLAG_COMMIT,
            BLOCK_ID_FLAG_NIL,
        ):
            raise ValueError(f"unknown BlockIDFlag: {self.block_id_flag}")
        if self.block_id_flag == BLOCK_ID_FLAG_ABSENT:
            if self.validator_address:
                raise ValueError("validator address is present")
            if self.timestamp_ns:
                raise ValueError("time is present")
            if self.signature:
                raise ValueError("signature is present")
        else:
            if len(self.validator_address) != 20:
                raise ValueError(
                    "expected ValidatorAddress size to be 20 bytes"
                )
            if not self.signature:
                raise ValueError("signature is missing")
            if len(self.signature) > MAX_SIGNATURE_SIZE:
                raise ValueError("signature is too big")

    def to_proto(self) -> bytes:
        w = ProtoWriter()
        w.int(1, self.block_id_flag)
        w.bytes(2, self.validator_address)
        w.message(3, encode_timestamp(self.timestamp_ns))
        w.bytes(4, self.signature)
        return w.finish()

    @classmethod
    def from_proto(cls, data: bytes) -> "CommitSig":
        r = FieldReader(data)
        ts = r.get(3)
        return cls(
            block_id_flag=r.uint(1),
            validator_address=r.bytes(2),
            timestamp_ns=decode_timestamp(ts) if ts is not None else 0,
            signature=r.bytes(4),
        )


@dataclass
class Commit:
    height: int = 0
    round: int = 0
    block_id: BlockID = field(default_factory=BlockID)
    signatures: List[CommitSig] = field(default_factory=list)

    # (chain_id, for_block) -> VoteSignTemplate
    _templates: Dict[tuple, VoteSignTemplate] = field(
        default_factory=dict, repr=False, compare=False
    )

    def size(self) -> int:
        return len(self.signatures)

    def bit_array(self) -> BitArray:
        ba = BitArray(len(self.signatures))
        for i, cs in enumerate(self.signatures):
            ba.set(i, not cs.is_absent())
        return ba

    def block_id_flags_array(self) -> Optional[np.ndarray]:
        """The per-signature BlockIDFlags as np.uint8, or None when a
        flag lies outside uint8 (from_proto reads an unbounded varint):
        the caller then takes the scalar loop, so a hostile commit gets
        the reference InvalidCommitError."""
        try:
            arr = np.fromiter(
                (cs.block_id_flag for cs in self.signatures),
                dtype=np.int64,
                count=len(self.signatures),
            )
        except (OverflowError, ValueError):
            return None
        if arr.size and (arr.min() < 0 or arr.max() > 0xFF):
            return None
        return arr.astype(np.uint8)

    def get_vote(self, val_idx: int) -> Vote:
        """The precommit vote at a validator index."""
        cs = self.signatures[val_idx]
        return Vote(
            type=PRECOMMIT_TYPE,
            height=self.height,
            round=self.round,
            block_id=cs.vote_block_id(self.block_id),
            timestamp_ns=cs.timestamp_ns,
            validator_address=cs.validator_address,
            validator_index=val_idx,
            signature=cs.signature,
        )

    def _template(self, chain_id: str, for_block: bool) -> VoteSignTemplate:
        tpl = self._templates.get((chain_id, for_block))
        if tpl is None:
            tpl = VoteSignTemplate(
                chain_id,
                PRECOMMIT_TYPE,
                self.height,
                self.round,
                self.block_id if for_block else BlockID(),
            )
            self._templates[(chain_id, for_block)] = tpl
        return tpl

    def vote_sign_bytes(self, chain_id: str, val_idx: int) -> bytes:
        """Sign-bytes of the vote at a validator index; byte-identical
        to get_vote(i).sign_bytes(chain_id)."""
        cs = self.signatures[val_idx]
        for_block = cs.block_id_flag == BLOCK_ID_FLAG_COMMIT
        tpl = self._template(chain_id, for_block)
        return tpl.sign_bytes(cs.timestamp_ns)

    def vote_sign_bytes_batch(
        self, chain_id: str, idxs: List[int]
    ) -> List[bytes]:
        """vote_sign_bytes of each index in `idxs`, in that order, in one
        splice call a template (the for-block votes, the rest): the
        encoding of the indexes an early-exit plan visits, where the JAX
        package encodes them one by one into its memo
        (tendermint_tpu/types/commit.py:344)."""
        return self._splice(chain_id, enumerate(idxs), len(idxs))

    def sign_bytes_batch(self, chain_id: str) -> List[Optional[bytes]]:
        """Sign-bytes for every non-absent signature, in one splice call
        for each of the two templates (None at absent indexes)."""
        sigs = self.signatures
        live = (
            (i, i)
            for i, cs in enumerate(sigs)
            if cs.block_id_flag != BLOCK_ID_FLAG_ABSENT
        )
        return self._splice(chain_id, live, len(sigs))

    def _splice(self, chain_id: str, places, n: int) -> List[Optional[bytes]]:
        """A list of n rows holding, at each (position, index) of
        `places`, the sign-bytes of the vote at that index: the votes
        grouped by template in one pass, each group spliced in one call."""
        sigs = self.signatures
        fb_pos, fb_ts, nil_pos, nil_ts = [], [], [], []
        for j, i in places:
            cs = sigs[i]
            if cs.block_id_flag == BLOCK_ID_FLAG_COMMIT:
                fb_pos.append(j)
                fb_ts.append(cs.timestamp_ns)
            else:
                nil_pos.append(j)
                nil_ts.append(cs.timestamp_ns)
        out: List[Optional[bytes]] = [None] * n
        for for_block, pos, ts in ((True, fb_pos, fb_ts), (False, nil_pos, nil_ts)):
            if not pos:
                continue
            rows = self._template(chain_id, for_block).sign_bytes_batch(ts)
            if len(pos) == n:  # every row, in order
                return rows
            for j, row in zip(pos, rows):
                out[j] = row
        return out

    def validate_basic(self) -> None:
        if self.height < 0:
            raise ValueError("negative Height")
        if self.round < 0:
            raise ValueError("negative Round")
        if self.height >= 1:
            if self.block_id.is_zero():
                raise ValueError("commit cannot be for nil block")
            if not self.signatures:
                raise ValueError("no signatures in commit")
            for i, cs in enumerate(self.signatures):
                try:
                    cs.validate_basic()
                except ValueError as e:
                    raise ValueError(f"wrong CommitSig #{i}: {e}") from e

    def hash(self) -> bytes:
        """Merkle root over the marshalled CommitSigs."""
        return merkle.hash_from_byte_slices(
            [cs.to_proto() for cs in self.signatures]
        )

    def to_proto(self) -> bytes:
        w = ProtoWriter()
        w.int(1, self.height)
        w.int(2, self.round)
        w.message(3, self.block_id.to_proto())
        for cs in self.signatures:
            w.message(4, cs.to_proto())
        return w.finish()

    @classmethod
    def from_proto(cls, data: bytes) -> "Commit":
        height = 0
        round_ = 0
        block_id = BlockID()
        sigs: List[CommitSig] = []
        for f, _wt, v in iter_fields(data):
            if f == 1:
                height = v
            elif f == 2:
                round_ = v
            elif f == 3:
                block_id = BlockID.from_proto(v)
            elif f == 4:
                sigs.append(CommitSig.from_proto(v))
        return cls(
            height=height, round=round_, block_id=block_id, signatures=sigs
        )
