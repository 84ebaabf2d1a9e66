"""The consensus wire messages of the vote path.

Counterpart: tendermint_tpu/consensus/msgs.py: `encode_bit_array` and
`decode_bit_array` (:64-93), `VoteMessage` (:292), `HasVoteMessage`
(:313), `VoteSetMaj23Message` (:353), `VoteSetBitsMessage` (:393), the
Message oneof's `encode_msg` / `decode_msg` (:438-470) and `MsgInfo`
(:473). The bytes are the JAX package's. The oneof's other arms
(new round step, new valid block, proposal, proposal POL, block part)
and the WAL records come with the step machine and the WAL (ROADMAP
item 14b): decode_msg refuses them by name.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ..encoding.proto import FieldReader, ProtoWriter, decode_varint, encode_varint
from ..libs.bits import BitArray
from ..types.block_id import BlockID
from ..types.vote import Vote, is_vote_type_valid

__all__ = [
    "HasVoteMessage",
    "MsgInfo",
    "VoteMessage",
    "VoteSetBitsMessage",
    "VoteSetMaj23Message",
    "decode_bit_array",
    "decode_msg",
    "encode_bit_array",
    "encode_msg",
]


# BitArray proto (libs/bits/types.pb.go: bits=1, elems=2). `elems` is a
# repeated uint64, which proto3 packs into one length-delimited field of
# varints; packed varints keep zero words, which the singular writer
# would drop (shifting every later word down).


def encode_bit_array(ba: Optional[BitArray]) -> Optional[bytes]:
    if ba is None:
        return None
    w = ProtoWriter()
    w.int(1, ba.size)
    packed = bytearray()
    for word in ba.to_words():
        packed += encode_varint(word)
    w.bytes(2, bytes(packed))
    return w.finish()


def decode_bit_array(data: Optional[bytes]) -> Optional[BitArray]:
    """The packed form, or a record of unpacked words (written before
    packing; its zero words are lost, so their placement is best
    effort). BitArray.from_words bounds the size and the word count."""
    if data is None:
        return None
    r = FieldReader(data)
    size = r.int64(1)
    words: list = []
    for v in r.get_all(2):
        if isinstance(v, bytes):
            off = 0
            while off < len(v):
                word, off = decode_varint(v, off)
                words.append(word)
        else:
            words.append(v)
    return BitArray.from_words(size, words)


def _check_hrt(height: int, round_: int, type_: int) -> None:
    if height < 0:
        raise ValueError("negative Height")
    if round_ < 0:
        raise ValueError("negative Round")
    if not is_vote_type_valid(type_):
        raise ValueError("invalid Type")


@dataclass
class VoteMessage:
    """reference: consensus/types.pb.go:356."""

    vote: Vote = field(default_factory=Vote)

    def to_proto(self) -> bytes:
        w = ProtoWriter()
        w.message(1, self.vote.to_proto())
        return w.finish()

    @classmethod
    def from_proto(cls, data: bytes) -> "VoteMessage":
        v = FieldReader(data).get(1)
        return cls(vote=Vote.from_proto(v) if v is not None else Vote())

    def validate_basic(self) -> None:
        self.vote.validate_basic()


@dataclass
class HasVoteMessage:
    """reference: consensus/types.pb.go:401-404."""

    height: int = 0
    round: int = 0
    type: int = 0
    index: int = 0

    def to_proto(self) -> bytes:
        w = ProtoWriter()
        w.int(1, self.height)
        w.int(2, self.round)
        w.int(3, self.type)
        w.int(4, self.index)
        return w.finish()

    @classmethod
    def from_proto(cls, data: bytes) -> "HasVoteMessage":
        r = FieldReader(data)
        return cls(
            height=r.int64(1),
            round=r.int64(2),
            type=r.uint(3),
            index=r.int64(4),
        )

    def validate_basic(self) -> None:
        _check_hrt(self.height, self.round, self.type)
        if self.index < 0:
            raise ValueError("negative Index")


@dataclass
class VoteSetMaj23Message:
    """reference: consensus/types.pb.go:470-473."""

    height: int = 0
    round: int = 0
    type: int = 0
    block_id: BlockID = field(default_factory=BlockID)

    def to_proto(self) -> bytes:
        w = ProtoWriter()
        w.int(1, self.height)
        w.int(2, self.round)
        w.int(3, self.type)
        w.message(4, self.block_id.to_proto())
        return w.finish()

    @classmethod
    def from_proto(cls, data: bytes) -> "VoteSetMaj23Message":
        r = FieldReader(data)
        bid = r.get(4)
        return cls(
            height=r.int64(1),
            round=r.int64(2),
            type=r.uint(3),
            block_id=BlockID.from_proto(bid) if bid is not None else BlockID(),
        )

    def validate_basic(self) -> None:
        _check_hrt(self.height, self.round, self.type)
        self.block_id.validate_basic()


@dataclass
class VoteSetBitsMessage:
    """reference: consensus/types.pb.go:540-544."""

    height: int = 0
    round: int = 0
    type: int = 0
    block_id: BlockID = field(default_factory=BlockID)
    votes: Optional[BitArray] = None

    def to_proto(self) -> bytes:
        w = ProtoWriter()
        w.int(1, self.height)
        w.int(2, self.round)
        w.int(3, self.type)
        w.message(4, self.block_id.to_proto())
        w.message(5, encode_bit_array(self.votes))
        return w.finish()

    @classmethod
    def from_proto(cls, data: bytes) -> "VoteSetBitsMessage":
        r = FieldReader(data)
        bid = r.get(4)
        return cls(
            height=r.int64(1),
            round=r.int64(2),
            type=r.uint(3),
            block_id=BlockID.from_proto(bid) if bid is not None else BlockID(),
            votes=decode_bit_array(r.get(5)),
        )

    def validate_basic(self) -> None:
        _check_hrt(self.height, self.round, self.type)
        self.block_id.validate_basic()


# The Message oneof (reference: consensus/types.pb.go:669-693): the
# ported arms, and the names of those still to come
_MSG_FIELDS = {
    6: VoteMessage,
    7: HasVoteMessage,
    8: VoteSetMaj23Message,
    9: VoteSetBitsMessage,
}
_MSG_FIELD_OF = {cls: num for num, cls in _MSG_FIELDS.items()}
_UNPORTED_FIELDS = {
    1: "NewRoundStepMessage",
    2: "NewValidBlockMessage",
    3: "ProposalMessage",
    4: "ProposalPOLMessage",
    5: "BlockPartMessage",
}


def encode_msg(msg) -> bytes:
    """A consensus message in the Message oneof envelope."""
    num = _MSG_FIELD_OF.get(type(msg))
    if num is None:
        raise TypeError(f"unknown consensus message: {type(msg).__name__}")
    w = ProtoWriter()
    w.message(num, msg.to_proto())
    return w.finish()


def decode_msg(data: bytes):
    """The message in a Message envelope: the lowest field number
    present wins, as in the JAX package. An arm not ported yet raises
    ValueError naming it."""
    r = FieldReader(data)
    for num in range(1, 10):
        body = r.get(num)
        if body is None:
            continue
        if num in _UNPORTED_FIELDS:
            raise ValueError(
                f"consensus Message arm {num} ({_UNPORTED_FIELDS[num]}) is not "
                f"ported: only the vote path's messages decode"
            )
        return _MSG_FIELDS[num].from_proto(body)
    raise ValueError("empty or unknown consensus Message envelope")


@dataclass
class MsgInfo:
    """A consensus input and the peer it came from ('' = our own)
    (reference: internal/consensus/state.go msgInfo)."""

    msg: object = None
    peer_id: str = ""

    def to_proto(self) -> bytes:
        w = ProtoWriter()
        w.message(1, encode_msg(self.msg))
        w.string(2, self.peer_id)
        return w.finish()

    @classmethod
    def from_proto(cls, data: bytes) -> "MsgInfo":
        r = FieldReader(data)
        m = r.get(1)
        return cls(msg=decode_msg(m) if m is not None else None, peer_id=r.string(2))
