"""SignedHeader and LightBlock.

Counterpart: tendermint_tpu/types/light.py:26-120 (reference:
types/light.go). LightBlocksRequest and LightBlocksResponse, the bulk
fetch's p2p and RPC messages, are not ported: the port has neither
layer.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..encoding.proto import FieldReader, ProtoWriter
from .commit import Commit
from .header import Header
from .validator import ValidatorSet

__all__ = ["LightBlock", "SignedHeader"]


@dataclass
class SignedHeader:
    header: Optional[Header] = None
    commit: Optional[Commit] = None

    @property
    def height(self) -> int:
        return self.header.height if self.header else 0

    def hash(self) -> bytes:
        return self.header.hash() if self.header else b""

    def validate_basic(self, chain_id: str) -> None:
        if self.header is None:
            raise ValueError("missing header")
        if self.commit is None:
            raise ValueError("missing commit")
        self.header.validate_basic()
        if self.header.chain_id != chain_id:
            raise ValueError(
                f"header belongs to another chain {self.header.chain_id!r}"
            )
        self.commit.validate_basic()
        if self.header.height != self.commit.height:
            raise ValueError("header and commit height mismatch")
        if self.header.hash() != self.commit.block_id.hash:
            raise ValueError("commit signs block with wrong hash")

    def to_proto(self) -> bytes:
        w = ProtoWriter()
        if self.header is not None:
            w.message(1, self.header.to_proto())
        if self.commit is not None:
            w.message(2, self.commit.to_proto())
        return w.finish()

    @classmethod
    def from_proto(cls, data: bytes) -> "SignedHeader":
        r = FieldReader(data)
        h = r.get(1)
        c = r.get(2)
        return cls(
            header=Header.from_proto(h) if h is not None else None,
            commit=Commit.from_proto(c) if c is not None else None,
        )


@dataclass
class LightBlock:
    signed_header: Optional[SignedHeader] = None
    validator_set: Optional[ValidatorSet] = None

    @property
    def height(self) -> int:
        return self.signed_header.height if self.signed_header else 0

    def validate_basic(self, chain_id: str) -> None:
        if self.signed_header is None:
            raise ValueError("missing signed header")
        if self.validator_set is None:
            raise ValueError("missing validator set")
        self.signed_header.validate_basic(chain_id)
        self.validator_set.validate_basic()
        if (
            self.signed_header.header.validators_hash
            != self.validator_set.hash()
        ):
            raise ValueError(
                "expected validator hash of header to match validator set hash"
            )

    def to_proto(self) -> bytes:
        w = ProtoWriter()
        if self.signed_header is not None:
            w.message(1, self.signed_header.to_proto())
        if self.validator_set is not None:
            w.message(2, self.validator_set.to_proto())
        return w.finish()

    @classmethod
    def from_proto(cls, data: bytes) -> "LightBlock":
        r = FieldReader(data)
        sh = r.get(1)
        vs = r.get(2)
        return cls(
            signed_header=(
                SignedHeader.from_proto(sh) if sh is not None else None
            ),
            validator_set=(
                ValidatorSet.from_proto(vs) if vs is not None else None
            ),
        )
