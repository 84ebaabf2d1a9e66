"""The p2p stack: router, peer manager, transports, SecretConnection,
PEX and the in-process test network (counterpart: tendermint_tpu/p2p/;
reference: internal/p2p/), and P2PMetrics (p2p/metrics.py)."""

from .channel import Channel  # noqa: F401
from .peermanager import PeerManager, PeerManagerOptions, PeerStatus, PeerUpdate  # noqa: F401
from .router import Router, RouterOptions  # noqa: F401
from .transport import Connection, MemoryNetwork, MemoryTransport, TCPTransport, Transport  # noqa: F401
from .types import (  # noqa: F401
    ChannelDescriptor,
    Envelope,
    NodeInfo,
    PeerError,
    node_id_from_pubkey,
    parse_node_address,
)
