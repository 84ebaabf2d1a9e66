"""Block sync wire messages (channel 0x40).

Counterpart: tendermint_tpu/blocksync/msgs.py:1-123, whole (reference:
proto/tendermint/blocksync/types.pb.go): BlockRequest, NoBlockResponse,
BlockResponse, StatusRequest, StatusResponse, and BlocksyncCodec over the
Message oneof (fields 1-5).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..encoding.proto import FieldReader, ProtoWriter
from ..types.block import Block

__all__ = [
    "BlockRequestMessage",
    "NoBlockResponseMessage",
    "BlockResponseMessage",
    "StatusRequestMessage",
    "StatusResponseMessage",
    "BlocksyncCodec",
]


@dataclass
class BlockRequestMessage:
    height: int = 0

    def to_proto(self) -> bytes:
        w = ProtoWriter()
        w.int(1, self.height)
        return w.finish()

    @classmethod
    def from_proto(cls, data: bytes) -> "BlockRequestMessage":
        return cls(height=FieldReader(data).int64(1))


@dataclass
class NoBlockResponseMessage:
    height: int = 0

    def to_proto(self) -> bytes:
        w = ProtoWriter()
        w.int(1, self.height)
        return w.finish()

    @classmethod
    def from_proto(cls, data: bytes) -> "NoBlockResponseMessage":
        return cls(height=FieldReader(data).int64(1))


@dataclass
class BlockResponseMessage:
    block: Optional[Block] = None

    def to_proto(self) -> bytes:
        w = ProtoWriter()
        w.message(1, self.block.to_proto() if self.block else None)
        return w.finish()

    @classmethod
    def from_proto(cls, data: bytes) -> "BlockResponseMessage":
        b = FieldReader(data).get(1)
        return cls(block=Block.from_proto(b) if b is not None else None)


@dataclass
class StatusRequestMessage:
    def to_proto(self) -> bytes:
        return b""

    @classmethod
    def from_proto(cls, data: bytes) -> "StatusRequestMessage":
        return cls()


@dataclass
class StatusResponseMessage:
    height: int = 0
    base: int = 0

    def to_proto(self) -> bytes:
        w = ProtoWriter()
        w.int(1, self.height)
        w.int(2, self.base)
        return w.finish()

    @classmethod
    def from_proto(cls, data: bytes) -> "StatusResponseMessage":
        r = FieldReader(data)
        return cls(height=r.int64(1), base=r.int64(2))


_FIELDS = {
    1: BlockRequestMessage,
    2: NoBlockResponseMessage,
    3: BlockResponseMessage,
    4: StatusRequestMessage,
    5: StatusResponseMessage,
}
_FIELD_OF = {cls: num for num, cls in _FIELDS.items()}


class BlocksyncCodec:
    @staticmethod
    def encode(msg) -> bytes:
        num = _FIELD_OF.get(type(msg))
        if num is None:
            raise TypeError(f"unknown blocksync message {type(msg).__name__}")
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
        raise ValueError("empty or unknown blocksync Message envelope")
