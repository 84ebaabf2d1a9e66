"""P2P metrics struct.

Counterpart: tendermint_tpu/p2p/metrics.py:1-64 (reference:
internal/p2p/metrics.go). The go-kit pattern: one struct holding the
subsystem's instruments, built against a Registry and threaded through
the constructor. node/node.py passes its per-node Registry; a struct
built without one lands on DEFAULT_REGISTRY, where repeated default
constructions share the instruments. Names, HELP texts, label names and
buckets are the JAX package's.

The Router and the PeerManager share one (p2p/router.py, p2p/peermanager.py).
"""

from __future__ import annotations

from typing import Optional

from ..libs.metrics import DEFAULT_REGISTRY, Registry

__all__ = ["P2PMetrics"]


# dial-backoff delays span "retry immediately" to the 10-minute cap
_BACKOFF_BUCKETS = (
    0.1, 0.25, 0.5, 1.0, 2.0, 5.0, 10.0, 20.0, 60.0, 180.0, 600.0
)


class P2PMetrics:
    def __init__(self, registry: Optional[Registry] = None) -> None:
        r = registry if registry is not None else DEFAULT_REGISTRY
        self.peers = r.gauge("p2p", "peers", "Number of connected peers.")
        self.bytes_sent = r.counter(
            "p2p",
            "message_send_bytes_total",
            "Bytes sent, by channel.",
            label_names=("ch",),
        )
        self.bytes_recv = r.counter(
            "p2p",
            "message_receive_bytes_total",
            "Bytes received, by channel.",
            label_names=("ch",),
        )
        # -- the peer lifecycle --
        # reason values come from the router's FIXED vocabulary
        # (router._PEER_REASONS; remote-reported reasons are sanitized
        # against it before becoming labels), never from the wire
        self.peer_disconnects = r.counter(
            "p2p",
            "peer_disconnects_total",
            "Peer disconnects, by reason (remote/* = peer-reported).",
            label_names=("reason",),
        )
        self.dial_backoff = r.histogram(
            "p2p",
            "dial_backoff_seconds",
            "Backoff delay scheduled after each failed dial.",
            buckets=_BACKOFF_BUCKETS,
        )
        self.send_queue_dropped = r.counter(
            "p2p",
            "send_queue_dropped_total",
            "Outbound messages shed by full per-peer channel queues.",
            label_names=("ch",),
        )
        self.net_faults = r.counter(
            "p2p",
            "net_faults_total",
            "Injected network faults applied (chaos runs only).",
            label_names=("point", "mode"),
        )
