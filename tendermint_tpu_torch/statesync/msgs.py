"""State sync wire messages (channels 0x60-0x63).

Counterpart: tendermint_tpu/statesync/msgs.py:1-205, whole (reference:
proto/tendermint/statesync/types.pb.go): the Message oneof of
snapshots_request=1, snapshots_response=2, chunk_request=3,
chunk_response=4, light_block_request=5, light_block_response=6,
params_request=7, params_response=8, and StatesyncCodec.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..encoding.proto import FieldReader, ProtoWriter
from ..types.light import LightBlock

__all__ = [
    "SnapshotsRequestMessage",
    "SnapshotsResponseMessage",
    "ChunkRequestMessage",
    "ChunkResponseMessage",
    "LightBlockRequestMessage",
    "LightBlockResponseMessage",
    "ParamsRequestMessage",
    "ParamsResponseMessage",
    "StatesyncCodec",
]


@dataclass
class SnapshotsRequestMessage:
    def to_proto(self) -> bytes:
        return b""

    @classmethod
    def from_proto(cls, data: bytes) -> "SnapshotsRequestMessage":
        return cls()


@dataclass
class SnapshotsResponseMessage:
    height: int = 0
    format: int = 0
    chunks: int = 0
    hash: bytes = b""
    metadata: bytes = b""

    def to_proto(self) -> bytes:
        w = ProtoWriter()
        w.uint(1, self.height)
        w.uint(2, self.format)
        w.uint(3, self.chunks)
        w.bytes(4, self.hash)
        w.bytes(5, self.metadata)
        return w.finish()

    @classmethod
    def from_proto(cls, data: bytes) -> "SnapshotsResponseMessage":
        r = FieldReader(data)
        return cls(
            height=r.uint(1), format=r.uint(2), chunks=r.uint(3),
            hash=r.bytes(4), metadata=r.bytes(5),
        )


@dataclass
class ChunkRequestMessage:
    height: int = 0
    format: int = 0
    index: int = 0

    def to_proto(self) -> bytes:
        w = ProtoWriter()
        w.uint(1, self.height)
        w.uint(2, self.format)
        w.uint(3, self.index)
        return w.finish()

    @classmethod
    def from_proto(cls, data: bytes) -> "ChunkRequestMessage":
        r = FieldReader(data)
        return cls(height=r.uint(1), format=r.uint(2), index=r.uint(3))


@dataclass
class ChunkResponseMessage:
    height: int = 0
    format: int = 0
    index: int = 0
    chunk: bytes = b""
    missing: bool = False

    def to_proto(self) -> bytes:
        w = ProtoWriter()
        w.uint(1, self.height)
        w.uint(2, self.format)
        w.uint(3, self.index)
        w.bytes(4, self.chunk)
        w.bool(5, self.missing)
        return w.finish()

    @classmethod
    def from_proto(cls, data: bytes) -> "ChunkResponseMessage":
        r = FieldReader(data)
        return cls(
            height=r.uint(1), format=r.uint(2), index=r.uint(3),
            chunk=r.bytes(4), missing=r.bool(5),
        )


@dataclass
class LightBlockRequestMessage:
    height: int = 0

    def to_proto(self) -> bytes:
        w = ProtoWriter()
        w.uint(1, self.height)
        return w.finish()

    @classmethod
    def from_proto(cls, data: bytes) -> "LightBlockRequestMessage":
        return cls(height=FieldReader(data).uint(1))


@dataclass
class LightBlockResponseMessage:
    light_block: Optional[LightBlock] = None

    def to_proto(self) -> bytes:
        w = ProtoWriter()
        w.message(
            1, self.light_block.to_proto() if self.light_block else None
        )
        return w.finish()

    @classmethod
    def from_proto(cls, data: bytes) -> "LightBlockResponseMessage":
        b = FieldReader(data).get(1)
        return cls(
            light_block=LightBlock.from_proto(b) if b else None
        )


@dataclass
class ParamsRequestMessage:
    height: int = 0

    def to_proto(self) -> bytes:
        w = ProtoWriter()
        w.uint(1, self.height)
        return w.finish()

    @classmethod
    def from_proto(cls, data: bytes) -> "ParamsRequestMessage":
        return cls(height=FieldReader(data).uint(1))


@dataclass
class ParamsResponseMessage:
    height: int = 0
    consensus_params: bytes = b""  # proto-encoded ConsensusParams

    def to_proto(self) -> bytes:
        w = ProtoWriter()
        w.uint(1, self.height)
        w.message(2, self.consensus_params)
        return w.finish()

    @classmethod
    def from_proto(cls, data: bytes) -> "ParamsResponseMessage":
        r = FieldReader(data)
        return cls(height=r.uint(1), consensus_params=r.get(2) or b"")


_FIELDS = {
    1: SnapshotsRequestMessage,
    2: SnapshotsResponseMessage,
    3: ChunkRequestMessage,
    4: ChunkResponseMessage,
    5: LightBlockRequestMessage,
    6: LightBlockResponseMessage,
    7: ParamsRequestMessage,
    8: ParamsResponseMessage,
}
_FIELD_OF = {cls: num for num, cls in _FIELDS.items()}


class StatesyncCodec:
    @staticmethod
    def encode(msg) -> bytes:
        num = _FIELD_OF.get(type(msg))
        if num is None:
            raise TypeError(f"unknown statesync message {type(msg).__name__}")
        w = ProtoWriter()
        w.message(num, msg.to_proto())
        return w.finish()

    @staticmethod
    def decode(data: bytes):
        r = FieldReader(data)
        for num, cls in _FIELDS.items():
            body = r.get(num)
            if body is not None:
                return cls.from_proto(body)
        raise ValueError("empty or unknown statesync Message envelope")
