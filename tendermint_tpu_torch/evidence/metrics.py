"""Evidence pool metrics struct.

Counterpart: tendermint_tpu/evidence/metrics.py:1-35. The go-kit pattern: one struct holding the
subsystem's instruments, built against a Registry and threaded through
the constructor. node/node.py passes its per-node Registry; a struct
built without one lands on DEFAULT_REGISTRY, where repeated default
constructions share the instruments. Names, HELP texts, label names and
buckets are the JAX package's.

The pool's mutators keep pool_size exact (evidence/pool.py).
"""

from __future__ import annotations

from typing import Optional

from ..libs.metrics import DEFAULT_REGISTRY, Registry

__all__ = ["EvidenceMetrics"]


class EvidenceMetrics:
    def __init__(self, registry: Optional[Registry] = None) -> None:
        r = registry if registry is not None else DEFAULT_REGISTRY
        self.pool_size = r.gauge(
            "evidence",
            "pool_size",
            "Verified evidence pending inclusion in a block.",
        )
        self.committed_total = r.counter(
            "evidence",
            "committed_total",
            "Evidence items committed in blocks (marked by Update).",
        )
        self.expired_total = r.counter(
            "evidence",
            "expired_total",
            "Pending evidence pruned after aging past both expiry bounds.",
        )
