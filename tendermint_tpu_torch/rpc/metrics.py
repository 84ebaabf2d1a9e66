"""RPC metrics struct.

Counterpart: tendermint_tpu/rpc/metrics.py:1-153. The go-kit pattern: one struct holding the
subsystem's instruments, built against a Registry and threaded through
the constructor. node/node.py passes its per-node Registry; a struct
built without one lands on DEFAULT_REGISTRY, where repeated default
constructions share the instruments. Names, HELP texts, label names and
buckets are the JAX package's.

The transport (rpc/jsonrpc.py _dispatch) records every route's requests,
errors, latency and in-flight count, so POST, URI GET and websocket
requests land in one place; a method with no route increments the
unlabeled unknown_methods_total, so a client cannot mint label values.
A request slower than `slo_for(route)` counts in slow_requests_total;
the JAX package also captures a trace exemplar of it, which waits for
the port's trace ring. The serving cache (rpc/servingcache.py) feeds its
hit, miss and eviction counters.
"""

from __future__ import annotations

from typing import Dict, Optional

from ..libs.metrics import DEFAULT_REGISTRY, Registry

__all__ = ["RPCMetrics", "DEFAULT_SLO_S", "ROUTE_SLO_S"]

# default per-request SLO: anything over this is an outlier worth a
# captured exemplar on an interactive serving path
DEFAULT_SLO_S = 1.0

# per-route overrides for routes that are slow BY DESIGN — their SLO is
# their documented contract, not the interactive default
ROUTE_SLO_S: Dict[str, float] = {
    # waits for the tx to be committed in a block (cfg
    # rpc.timeout_broadcast_tx_commit bounds it at 10 s by default)
    "broadcast_tx_commit": 15.0,
}


class RPCMetrics:
    def __init__(self, registry: Optional[Registry] = None) -> None:
        r = registry if registry is not None else DEFAULT_REGISTRY
        self.requests_total = r.counter(
            "rpc",
            "requests_total",
            "JSON-RPC requests dispatched, by route.",
            label_names=("route",),
        )
        self.request_errors = r.counter(
            "rpc",
            "request_errors_total",
            "JSON-RPC requests answered with an error, by route.",
            label_names=("route",),
        )
        self.request_latency = r.sketch(
            "rpc",
            "request_latency_seconds",
            "Per-route request latency (mergeable log-bucketed sketch; "
            "1% relative-error bound, see docs/metrics.md).",
            label_names=("route",),
        )
        self.inflight = r.gauge(
            "rpc",
            "inflight_requests",
            "JSON-RPC requests currently executing, by route.",
            label_names=("route",),
        )
        self.unknown_methods = r.counter(
            "rpc",
            "unknown_methods_total",
            "Requests for methods with no route (not labeled: method "
            "names are client-chosen).",
        )
        self.ws_connections = r.gauge(
            "rpc",
            "ws_connections",
            "Live websocket connections.",
        )
        self.ws_send_queue_depth = r.histogram(
            "rpc",
            "ws_send_queue_depth",
            "Websocket subscriber send-queue depth sampled at each "
            "enqueue (the per-subscriber lag signal; the queue cap is "
            "512, overflow drops the subscriber).",
            buckets=(0.0, 1.0, 4.0, 16.0, 64.0, 128.0, 256.0, 512.0),
        )
        self.ws_slow_clients_dropped = r.counter(
            "rpc",
            "ws_slow_clients_dropped_total",
            "Websocket subscribers disconnected because their send "
            "queue overflowed.",
        )
        self.slow_requests = r.counter(
            "rpc",
            "slow_requests_total",
            "Requests that exceeded their per-route SLO threshold "
            "(each also captures a trace exemplar when enabled).",
            label_names=("route",),
        )
        # bulk light_blocks keeps its route-specific instruments
        # (batch size has no generic analog)
        self.light_blocks_requests = r.counter(
            "rpc",
            "light_blocks_requests",
            "Bulk light_blocks requests served.",
        )
        self.light_blocks_batch_size = r.histogram(
            "rpc",
            "light_blocks_batch_size",
            "Light blocks returned per bulk light_blocks request.",
            buckets=(1.0, 2.0, 5.0, 10.0, 20.0, 50.0),
        )
        self.tx_proofs_requests = r.counter(
            "rpc",
            "tx_proofs_requests",
            "tx_proofs requests served (merkle proofs from the held "
            "per-block tree).",
        )
        # per-block serving cache (rpc/servingcache.py): encoded
        # LightBlock blobs + held MerkleMultiTrees
        self.servingcache_hits = r.counter(
            "rpc",
            "servingcache_hits_total",
            "Per-block serving-cache hits (page encode / tree build "
            "skipped).",
        )
        self.servingcache_misses = r.counter(
            "rpc",
            "servingcache_misses_total",
            "Per-block serving-cache misses (artifact assembled from "
            "the stores).",
        )
        self.servingcache_evictions = r.counter(
            "rpc",
            "servingcache_evictions_total",
            "Per-block serving-cache entries dropped by the LRU bound.",
        )
        # SLO policy is per-struct (per-node): harnesses and tests
        # tighten thresholds without touching process-global state
        self.default_slo_s = DEFAULT_SLO_S
        self.slo_s: Dict[str, float] = dict(ROUTE_SLO_S)

    def slo_for(self, route: str) -> float:
        """The SLO threshold (seconds) for one route."""
        return self.slo_s.get(route, self.default_slo_s)
