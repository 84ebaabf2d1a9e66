"""Block execution metrics struct.

Counterpart: tendermint_tpu/state/metrics.py:1-23 (reference:
internal/state/metrics.go). The go-kit pattern: one struct holding the
subsystem's instruments, built against a Registry and threaded through
the constructor. node/node.py passes its per-node Registry; a struct
built without one lands on DEFAULT_REGISTRY, where repeated default
constructions share the instruments. Names, HELP texts, label names and
buckets are the JAX package's.

BlockExecutor.apply_block observes block_processing_seconds.
"""

from __future__ import annotations

from typing import Optional

from ..libs.metrics import DEFAULT_REGISTRY, Registry

__all__ = ["StateMetrics"]


class StateMetrics:
    def __init__(self, registry: Optional[Registry] = None) -> None:
        r = registry if registry is not None else DEFAULT_REGISTRY
        self.block_processing = r.histogram(
            "state",
            "block_processing_seconds",
            "Time spent processing a block (validate + execute + commit).",
            buckets=(0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0),
        )
