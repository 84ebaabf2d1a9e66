"""P2P core types: node identity, addresses, NodeInfo, envelopes, peer
errors and channel descriptors.

Counterpart: tendermint_tpu/p2p/types.py: node IDs and addresses
(:35-62), NodeInfo and its proto bytes (:64-127), Envelope (:130),
PeerError (:140) and ChannelDescriptor (:150); reference:
types/node_id.go, types/node_info.go, types/netaddress.go,
internal/p2p/channel.go.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Tuple

from ..crypto.keys import PubKey
from ..encoding.proto import FieldReader, ProtoWriter

__all__ = [
    "NodeID",
    "node_id_from_pubkey",
    "parse_node_address",
    "NodeInfo",
    "Envelope",
    "PeerError",
    "ChannelDescriptor",
]

NODE_ID_BYTES = 20

_NODE_ID_RE = re.compile(r"^[0-9a-f]{40}$")
_ADDR_RE = re.compile(
    r"^(?:(?P<proto>\w+)://)?(?:(?P<id>[0-9a-f]{40})@)?"
    r"(?P<host>[^:/@]+)(?::(?P<port>\d+))?$"
)


def node_id_from_pubkey(pub_key: PubKey) -> str:
    """Node ID = hex of the 20-byte address hash of the node key
    (reference: types/node_id.go NodeIDFromPubKey)."""
    return pub_key.address().hex()


def validate_node_id(node_id: str) -> None:
    if not _NODE_ID_RE.match(node_id):
        raise ValueError(f"invalid node ID {node_id!r}")


NodeID = str  # 40-char lowercase hex


def parse_node_address(addr: str) -> Tuple[NodeID, str, int]:
    """'id@host:port' (optionally with scheme) → (id, host, port)
    (reference: internal/p2p/address.go ParseNodeAddress)."""
    m = _ADDR_RE.match(addr.strip())
    if m is None:
        raise ValueError(f"invalid node address {addr!r}")
    node_id = m.group("id") or ""
    if node_id:
        validate_node_id(node_id)
    host = m.group("host")
    port = int(m.group("port") or 26656)
    return node_id, host, port


@dataclass
class NodeInfo:
    """What peers exchange during the handshake
    (reference: types/node_info.go:31-60)."""

    node_id: NodeID = ""
    listen_addr: str = ""
    network: str = ""  # chain ID
    version: str = ""
    channels: bytes = b""  # supported channel IDs, one byte each
    moniker: str = ""
    protocol_version_p2p: int = 0
    protocol_version_block: int = 0
    protocol_version_app: int = 0

    def validate_basic(self) -> None:
        validate_node_id(self.node_id)
        if len(self.channels) > 64:
            raise ValueError("too many channels")

    def compatible_with(self, other: "NodeInfo") -> None:
        """reference: types/node_info.go CompatibleWith."""
        if self.protocol_version_block != other.protocol_version_block:
            raise ValueError(
                f"peer is on a different block protocol: "
                f"{other.protocol_version_block} != "
                f"{self.protocol_version_block}"
            )
        if self.network != other.network:
            raise ValueError(
                f"peer is on a different network: {other.network!r} != "
                f"{self.network!r}"
            )
        if self.channels and other.channels:
            if not any(c in self.channels for c in other.channels):
                raise ValueError("no common channels")

    def to_proto(self) -> bytes:
        w = ProtoWriter()
        w.string(1, self.node_id)
        w.string(2, self.listen_addr)
        w.string(3, self.network)
        w.string(4, self.version)
        w.bytes(5, self.channels)
        w.string(6, self.moniker)
        w.uint(7, self.protocol_version_p2p)
        w.uint(8, self.protocol_version_block)
        w.uint(9, self.protocol_version_app)
        return w.finish()

    @classmethod
    def from_proto(cls, data: bytes) -> "NodeInfo":
        r = FieldReader(data)
        return cls(
            node_id=r.string(1),
            listen_addr=r.string(2),
            network=r.string(3),
            version=r.string(4),
            channels=r.bytes(5),
            moniker=r.string(6),
            protocol_version_p2p=r.uint(7),
            protocol_version_block=r.uint(8),
            protocol_version_app=r.uint(9),
        )


@dataclass
class Envelope:
    """One message on a channel (reference: internal/p2p/channel.go:15-28)."""

    message: object = None
    from_peer: NodeID = ""  # set on inbound
    to: NodeID = ""  # set on outbound (unless broadcast)
    broadcast: bool = False


@dataclass
class PeerError:
    """Reported by reactors to evict a misbehaving peer
    (reference: internal/p2p/channel.go:30-41)."""

    node_id: NodeID
    err: str
    fatal: bool = True


@dataclass
class ChannelDescriptor:
    """reference: internal/p2p/conn/connection.go ChannelDescriptor."""

    channel_id: int
    message_type: object  # class with to_proto/from_proto OR codec pair
    priority: int = 1
    send_queue_capacity: int = 64
    recv_message_capacity: int = 1 << 20
    recv_buffer_capacity: int = 128
    name: str = ""

    def encode(self, msg) -> bytes:
        # message_type is either a codec (encode/decode functions, e.g. the
        # consensus Message-oneof codec) or a dataclass with to/from_proto
        if hasattr(self.message_type, "encode"):
            return self.message_type.encode(msg)
        return msg.to_proto()

    def decode(self, data: bytes):
        if hasattr(self.message_type, "decode"):
            return self.message_type.decode(data)
        return self.message_type.from_proto(data)
