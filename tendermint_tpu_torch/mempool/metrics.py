"""Mempool metrics struct.

Counterpart: tendermint_tpu/mempool/metrics.py:1-68 (reference:
internal/mempool/metrics.go). The go-kit pattern: one struct holding the
subsystem's instruments, built against a Registry and threaded through
the constructor. node/node.py passes its per-node Registry; a struct
built without one lands on DEFAULT_REGISTRY, where repeated default
constructions share the instruments. Names, HELP texts, label names and
buckets are the JAX package's.

TxMempool feeds it (mempool/mempool.py).
"""

from __future__ import annotations

from typing import Optional

from ..libs.metrics import DEFAULT_REGISTRY, Registry

__all__ = ["MempoolMetrics"]


class MempoolMetrics:
    def __init__(self, registry: Optional[Registry] = None) -> None:
        r = registry if registry is not None else DEFAULT_REGISTRY
        self.size = r.gauge(
            "mempool", "size", "Number of uncommitted transactions."
        )
        self.failed_txs = r.counter(
            "mempool",
            "failed_txs_total",
            "Transactions rejected by CheckTx.",
        )
        # CheckTx ingest latency, the mempool lock wait included
        self.checktx_seconds = r.sketch(
            "mempool",
            "checktx_seconds",
            "End-to-end CheckTx ingest latency (lock wait + app "
            "round-trip + pool insert).",
        )
        # the lock-wait share of checktx_seconds on its own
        self.lock_wait_seconds = r.sketch(
            "mempool",
            "lock_wait_seconds",
            "Time CheckTx spent waiting to acquire the mempool lock "
            "(the contention share of checktx_seconds).",
        )
        # update()'s recheck of every surviving tx under the lock
        self.recheck_seconds = r.sketch(
            "mempool",
            "recheck_seconds",
            "Post-commit recheck duration per block (all pool txs "
            "re-validated under the consensus-held lock).",
        )
        # why txs leave without committing: TTL expiry vs full-pool
        # priority eviction — the two exits that silently eat offered
        # load before it ever reaches a proposal
        self.evicted_txs = r.counter(
            "mempool",
            "evicted_total",
            "Transactions evicted from the pool, by reason.",
            label_names=("reason",),
        )
