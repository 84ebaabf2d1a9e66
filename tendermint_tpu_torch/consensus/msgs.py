"""The consensus wire messages and the WAL's records.

Counterpart: tendermint_tpu/consensus/msgs.py:1-616: `encode_bit_array`
and `decode_bit_array` (:64-93), the nine arms of the Message oneof
(NewRoundStep :101, NewValidBlock :136, Proposal :189, ProposalPOL
:211, BlockPart :252, Vote :292, HasVote :313, VoteSetMaj23 :353,
VoteSetBits :393), `encode_msg` / `decode_msg` (:438-470), and the WAL
records: `MsgInfo` (:473), `TimeoutInfo` (:497), `EndHeightMessage`
(:544), `EventDataRoundStateWAL` (:561) and the TimedWALMessage codec
(:585-616). The bytes are the JAX package's.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ..crypto import merkle
from ..encoding.proto import FieldReader, ProtoWriter, decode_varint, encode_varint
from ..libs.bits import BitArray
from ..types.block_id import BlockID, PartSetHeader
from ..types.part_set import Part
from ..types.proposal import Proposal
from ..types.timestamp import decode_timestamp, encode_timestamp
from ..types.vote import Vote, is_vote_type_valid

__all__ = [
    "BlockPartMessage",
    "EndHeightMessage",
    "EventDataRoundStateWAL",
    "HasVoteMessage",
    "MsgInfo",
    "NewRoundStepMessage",
    "NewValidBlockMessage",
    "ProposalMessage",
    "ProposalPOLMessage",
    "TimeoutInfo",
    "VoteMessage",
    "VoteSetBitsMessage",
    "VoteSetMaj23Message",
    "decode_bit_array",
    "decode_msg",
    "decode_timed_wal_message",
    "encode_bit_array",
    "encode_msg",
    "encode_timed_wal_message",
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
class NewRoundStepMessage:
    """reference: consensus/types.pb.go:31-35."""

    height: int = 0
    round: int = 0
    step: int = 0
    seconds_since_start_time: int = 0
    last_commit_round: int = 0

    def to_proto(self) -> bytes:
        w = ProtoWriter()
        w.int(1, self.height)
        w.int(2, self.round)
        w.uint(3, self.step)
        w.int(4, self.seconds_since_start_time)
        w.int(5, self.last_commit_round)
        return w.finish()

    @classmethod
    def from_proto(cls, data: bytes) -> "NewRoundStepMessage":
        r = FieldReader(data)
        return cls(
            height=r.int64(1),
            round=r.int64(2),
            step=r.uint(3),
            seconds_since_start_time=r.int64(4),
            last_commit_round=r.int64(5),
        )

    def validate_basic(self) -> None:
        if self.height < 0:
            raise ValueError("negative Height")
        if self.round < 0:
            raise ValueError("negative Round")
        if self.height == 1 and self.last_commit_round != -1:
            raise ValueError("initial height must have LastCommitRound -1")


@dataclass
class NewValidBlockMessage:
    """reference: consensus/types.pb.go:112-116."""

    height: int = 0
    round: int = 0
    block_part_set_header: PartSetHeader = field(default_factory=PartSetHeader)
    block_parts: Optional[BitArray] = None
    is_commit: bool = False

    def to_proto(self) -> bytes:
        w = ProtoWriter()
        w.int(1, self.height)
        w.int(2, self.round)
        w.message(3, self.block_part_set_header.to_proto())
        w.message(4, encode_bit_array(self.block_parts))
        w.bool(5, self.is_commit)
        return w.finish()

    @classmethod
    def from_proto(cls, data: bytes) -> "NewValidBlockMessage":
        r = FieldReader(data)
        psh = r.get(3)
        return cls(
            height=r.int64(1),
            round=r.int64(2),
            block_part_set_header=(
                PartSetHeader.from_proto(psh) if psh is not None else PartSetHeader()
            ),
            block_parts=decode_bit_array(r.get(4)),
            is_commit=r.bool(5),
        )

    def validate_basic(self) -> None:
        if self.height < 0:
            raise ValueError("negative Height")
        if self.round < 0:
            raise ValueError("negative Round")
        self.block_part_set_header.validate_basic()
        if (
            self.block_parts is not None
            and self.block_parts.size != self.block_part_set_header.total
        ):
            raise ValueError(
                f"blockParts bit array size {self.block_parts.size} "
                f"not equal to BlockPartSetHeader.Total "
                f"{self.block_part_set_header.total}"
            )


@dataclass
class ProposalMessage:
    """reference: consensus/types.pb.go:189."""

    proposal: Proposal = field(default_factory=Proposal)

    def to_proto(self) -> bytes:
        w = ProtoWriter()
        w.message(1, self.proposal.to_proto())
        return w.finish()

    @classmethod
    def from_proto(cls, data: bytes) -> "ProposalMessage":
        p = FieldReader(data).get(1)
        return cls(proposal=Proposal.from_proto(p) if p is not None else Proposal())

    def validate_basic(self) -> None:
        self.proposal.validate_basic()


@dataclass
class ProposalPOLMessage:
    """reference: consensus/types.pb.go:234-236."""

    height: int = 0
    proposal_pol_round: int = 0
    proposal_pol: Optional[BitArray] = None

    def to_proto(self) -> bytes:
        w = ProtoWriter()
        w.int(1, self.height)
        w.int(2, self.proposal_pol_round)
        w.message(3, encode_bit_array(self.proposal_pol))
        return w.finish()

    @classmethod
    def from_proto(cls, data: bytes) -> "ProposalPOLMessage":
        r = FieldReader(data)
        return cls(
            height=r.int64(1),
            proposal_pol_round=r.int64(2),
            proposal_pol=decode_bit_array(r.get(3)),
        )

    def validate_basic(self) -> None:
        if self.height < 0:
            raise ValueError("negative Height")
        if self.proposal_pol_round < 0:
            raise ValueError("negative ProposalPOLRound")
        if self.proposal_pol is None or self.proposal_pol.size == 0:
            raise ValueError("empty ProposalPOL bit array")


def _empty_part() -> Part:
    return Part(index=0, bytes=b"", proof=merkle.Proof(total=0, index=0, leaf_hash=b""))


@dataclass
class BlockPartMessage:
    """reference: consensus/types.pb.go:295-297."""

    height: int = 0
    round: int = 0
    part: Part = field(default_factory=_empty_part)

    def to_proto(self) -> bytes:
        w = ProtoWriter()
        w.int(1, self.height)
        w.int(2, self.round)
        w.message(3, self.part.to_proto())
        return w.finish()

    @classmethod
    def from_proto(cls, data: bytes) -> "BlockPartMessage":
        r = FieldReader(data)
        p = r.get(3)
        if p is None:
            # a missing part is a parse error, as the reference's nil-Part
            # FromProto failure
            raise ValueError("BlockPartMessage: missing part field")
        return cls(height=r.int64(1), round=r.int64(2), part=Part.from_proto(p))

    def validate_basic(self) -> None:
        if self.height < 0:
            raise ValueError("negative Height")
        if self.round < 0:
            raise ValueError("negative Round")
        self.part.validate_basic()


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


# The Message oneof (reference: consensus/types.pb.go:669-693)
_MSG_FIELDS = {
    1: NewRoundStepMessage,
    2: NewValidBlockMessage,
    3: ProposalMessage,
    4: ProposalPOLMessage,
    5: BlockPartMessage,
    6: VoteMessage,
    7: HasVoteMessage,
    8: VoteSetMaj23Message,
    9: VoteSetBitsMessage,
}
_MSG_FIELD_OF = {cls: num for num, cls in _MSG_FIELDS.items()}


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
    present wins, as in the JAX package."""
    r = FieldReader(data)
    for num, cls in _MSG_FIELDS.items():
        body = r.get(num)
        if body is not None:
            return cls.from_proto(body)
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


# -- WAL records (reference: proto/tendermint/consensus/wal.proto) --


@dataclass
class TimeoutInfo:
    """A scheduled timeout of (height, round, step) (reference:
    internal/consensus/state.go timeoutInfo, ticker.go)."""

    duration_s: float = 0.0
    height: int = 0
    round: int = 0
    step: int = 0  # a RoundStep

    def to_proto(self) -> bytes:
        # google.protobuf.Duration: seconds=1, nanos=2
        d = ProtoWriter()
        total_ns = int(self.duration_s * 1e9)
        d.int(1, total_ns // 1_000_000_000)
        d.int(2, total_ns % 1_000_000_000)
        w = ProtoWriter()
        w.message(1, d.finish())
        w.int(2, self.height)
        w.int(3, self.round)
        w.uint(4, self.step)
        return w.finish()

    @classmethod
    def from_proto(cls, data: bytes) -> "TimeoutInfo":
        r = FieldReader(data)
        dur = r.get(1)
        duration_s = 0.0
        if dur is not None:
            dr = FieldReader(dur)
            duration_s = dr.int64(1) + dr.int64(2) / 1e9
        return cls(duration_s=duration_s, height=r.int64(2), round=r.int64(3), step=r.uint(4))

    def __repr__(self) -> str:
        return f"{self.duration_s:.3f}s@{self.height}/{self.round}/{self.step}"


@dataclass
class EndHeightMessage:
    """A height finished in the WAL: replay starts after the last one
    (reference: internal/consensus/wal.go:36-42)."""

    height: int = 0

    def to_proto(self) -> bytes:
        w = ProtoWriter()
        w.int(1, self.height)
        return w.finish()

    @classmethod
    def from_proto(cls, data: bytes) -> "EndHeightMessage":
        return cls(height=FieldReader(data).int64(1))


@dataclass
class EventDataRoundStateWAL:
    """A round-step marker in the WAL (reference:
    proto/tendermint/types/events.proto EventDataRoundState)."""

    height: int = 0
    round: int = 0
    step: str = ""

    def to_proto(self) -> bytes:
        w = ProtoWriter()
        w.int(1, self.height)
        w.int(2, self.round)
        w.string(3, self.step)
        return w.finish()

    @classmethod
    def from_proto(cls, data: bytes) -> "EventDataRoundStateWAL":
        r = FieldReader(data)
        return cls(height=r.int64(1), round=r.int64(2), step=r.string(3))


# the WALMessage oneof (wal.proto: event_data_round_state=1, msg_info=2,
# timeout_info=3, end_height=4)
_WAL_FIELDS = {
    1: EventDataRoundStateWAL,
    2: MsgInfo,
    3: TimeoutInfo,
    4: EndHeightMessage,
}
_WAL_FIELD_OF = {cls: num for num, cls in _WAL_FIELDS.items()}


def encode_timed_wal_message(time_ns: int, msg) -> bytes:
    """TimedWALMessage{time=1, msg=2} (wal.proto)."""
    num = _WAL_FIELD_OF.get(type(msg))
    if num is None:
        raise TypeError(f"unknown WAL message: {type(msg).__name__}")
    inner = ProtoWriter()
    inner.message(num, msg.to_proto())
    w = ProtoWriter()
    w.message(1, encode_timestamp(time_ns))
    w.message(2, inner.finish())
    return w.finish()


def decode_timed_wal_message(data: bytes):
    """(time_ns, msg) of a TimedWALMessage."""
    r = FieldReader(data)
    ts = r.get(1)
    time_ns = decode_timestamp(ts) if ts is not None else 0
    body = r.get(2)
    if body is None:
        raise ValueError("TimedWALMessage without msg")
    br = FieldReader(body)
    for num, cls in _WAL_FIELDS.items():
        sub = br.get(num)
        if sub is not None:
            return time_ns, cls.from_proto(sub)
    raise ValueError("unknown WALMessage oneof")
