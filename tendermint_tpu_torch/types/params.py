"""ConsensusParams: consensus-critical limits, hashed into headers.

Counterpart: tendermint_tpu/types/params.py:1-233 (BlockParams,
EvidenceParams, ValidatorParams, VersionParams, ConsensusParams with
validate, its `hash` :128-154, update and the proto form; reference:
types/params.go). Left out: update_from_proto, which no path of the JAX
package calls.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import List, Optional

from ..crypto import tmhash
from ..encoding.proto import FieldReader, ProtoWriter, iter_fields

__all__ = [
    "MAX_BLOCK_SIZE_BYTES",
    "MAX_BLOCK_PARTS_COUNT",
    "BlockParams",
    "EvidenceParams",
    "ValidatorParams",
    "VersionParams",
    "ConsensusParams",
]

MAX_BLOCK_SIZE_BYTES = 104857600  # 100 MB (reference: types/params.go:18)
MAX_BLOCK_PARTS_COUNT = MAX_BLOCK_SIZE_BYTES // 65536 + 1

NS_PER_SECOND = 1_000_000_000


@dataclass
class BlockParams:
    max_bytes: int = 22020096  # 21 MB (reference: types/params.go:91)
    max_gas: int = -1

    def to_proto(self) -> bytes:
        w = ProtoWriter()
        w.int(1, self.max_bytes)
        w.int(2, self.max_gas)
        return w.finish()

    @classmethod
    def from_proto(cls, data: bytes) -> "BlockParams":
        r = FieldReader(data)
        return cls(max_bytes=r.int64(1), max_gas=r.int64(2))


@dataclass
class EvidenceParams:
    max_age_num_blocks: int = 100000
    max_age_duration_ns: int = 48 * 3600 * NS_PER_SECOND
    max_bytes: int = 1048576  # 1 MB

    def to_proto(self) -> bytes:
        w = ProtoWriter()
        w.int(1, self.max_age_num_blocks)
        # google.protobuf.Duration {seconds=1, nanos=2}
        d = ProtoWriter()
        secs, nanos = divmod(self.max_age_duration_ns, NS_PER_SECOND)
        d.int(1, secs)
        d.int(2, nanos)
        w.message(2, d.finish())  # stdduration, nullable=false
        w.int(3, self.max_bytes)
        return w.finish()

    @classmethod
    def from_proto(cls, data: bytes) -> "EvidenceParams":
        r = FieldReader(data)
        dur = 0
        d = r.get(2)
        if d is not None:
            dr = FieldReader(d)
            dur = dr.int64(1) * NS_PER_SECOND + dr.int64(2)
        return cls(
            max_age_num_blocks=r.int64(1),
            max_age_duration_ns=dur,
            max_bytes=r.int64(3),
        )


@dataclass
class ValidatorParams:
    pub_key_types: List[str] = field(
        default_factory=lambda: ["ed25519"]
    )

    def is_valid_pubkey_type(self, t: str) -> bool:
        return t in self.pub_key_types

    def to_proto(self) -> bytes:
        w = ProtoWriter()
        for t in self.pub_key_types:
            w.string(1, t)
        return w.finish()

    @classmethod
    def from_proto(cls, data: bytes) -> "ValidatorParams":
        types = []
        for f, _wt, v in iter_fields(data):
            if f == 1:
                if not isinstance(v, bytes):
                    # wire-type flip: sanctioned parse error
                    raise ValueError(
                        "ValidatorParams.pub_key_types: expected "
                        "length-delimited"
                    )
                types.append(v.decode("utf-8"))
        return cls(pub_key_types=types)


@dataclass
class VersionParams:
    app_version: int = 0

    def to_proto(self) -> bytes:
        w = ProtoWriter()
        w.uint(1, self.app_version)
        return w.finish()

    @classmethod
    def from_proto(cls, data: bytes) -> "VersionParams":
        r = FieldReader(data)
        return cls(app_version=r.uint(1))


@dataclass
class ConsensusParams:
    block: BlockParams = field(default_factory=BlockParams)
    evidence: EvidenceParams = field(default_factory=EvidenceParams)
    validator: ValidatorParams = field(default_factory=ValidatorParams)
    version: VersionParams = field(default_factory=VersionParams)

    def validate(self) -> None:
        """reference: types/params.go:130-180."""
        if self.block.max_bytes <= 0:
            raise ValueError("block.MaxBytes must be greater than 0")
        if self.block.max_bytes > MAX_BLOCK_SIZE_BYTES:
            raise ValueError("block.MaxBytes is too big")
        if self.block.max_gas < -1:
            raise ValueError("block.MaxGas must be >= -1")
        if self.evidence.max_age_num_blocks <= 0:
            raise ValueError("evidence.MaxAgeNumBlocks must be > 0")
        if self.evidence.max_age_duration_ns <= 0:
            raise ValueError("evidence.MaxAgeDuration must be > 0")
        if (
            self.evidence.max_bytes > self.block.max_bytes
            or self.evidence.max_bytes < 0
        ):
            raise ValueError("evidence.MaxBytes out of range")
        if not self.validator.pub_key_types:
            raise ValueError("validator.PubKeyTypes must not be empty")

    def hash(self) -> bytes:
        """sha256 of HashedParams{BlockMaxBytes, BlockMaxGas} — the
        Header.ConsensusHash value (reference: types/params.go:185-205,
        proto/tendermint/types/params.pb.go:325-326)."""
        w = ProtoWriter()
        w.int(1, self.block.max_bytes)
        w.int(2, self.block.max_gas)
        return tmhash.sum256(w.finish())

    def update(self, other: Optional["ConsensusParams"]) -> "ConsensusParams":
        """Overlay non-nil sections (reference: types/params.go:213-239).
        `other` is a full params object, as EndBlock's decoded update."""
        if other is None:
            return replace(self)
        return ConsensusParams(
            block=replace(other.block),
            evidence=replace(other.evidence),
            validator=ValidatorParams(
                pub_key_types=list(other.validator.pub_key_types)
            ),
            version=replace(other.version),
        )

    def to_proto(self) -> bytes:
        w = ProtoWriter()
        w.message(1, self.block.to_proto())
        w.message(2, self.evidence.to_proto())
        w.message(3, self.validator.to_proto())
        w.message(4, self.version.to_proto())
        return w.finish()

    @classmethod
    def from_proto(cls, data: bytes) -> "ConsensusParams":
        r = FieldReader(data)
        b, e, v, ver = r.get(1), r.get(2), r.get(3), r.get(4)
        return cls(
            block=BlockParams.from_proto(b) if b is not None else BlockParams(),
            evidence=(
                EvidenceParams.from_proto(e)
                if e is not None
                else EvidenceParams()
            ),
            validator=(
                ValidatorParams.from_proto(v)
                if v is not None
                else ValidatorParams()
            ),
            version=(
                VersionParams.from_proto(ver)
                if ver is not None
                else VersionParams()
            ),
        )
