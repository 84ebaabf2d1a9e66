"""Consensus metrics struct.

Counterpart: tendermint_tpu/consensus/metrics.py:1-81 (reference:
internal/consensus/metrics.go). The go-kit pattern: one struct holding the
subsystem's instruments, built against a Registry and threaded through
the constructor. node/node.py passes its per-node Registry; a struct
built without one lands on DEFAULT_REGISTRY, where repeated default
constructions share the instruments. Names, HELP texts, label names and
buckets are the JAX package's.

The step machine feeds the height, rounds, validators, block and tx
series (consensus/state.py). rounds_per_height, quorum_prevote_seconds,
quorum_precommit_seconds and stall_resets_total are registered with the
JAX HELP and buckets and stay unfed until the flight recorder
(tendermint_tpu/consensus/timeline.py:272-338) is ported.
"""

from __future__ import annotations

from typing import Optional

from ..libs.metrics import DEFAULT_REGISTRY, Registry

__all__ = ["ConsensusMetrics"]


class ConsensusMetrics:
    def __init__(self, registry: Optional[Registry] = None) -> None:
        r = registry if registry is not None else DEFAULT_REGISTRY
        self.height = r.gauge(
            "consensus", "height", "Height of the chain."
        )
        self.rounds = r.gauge(
            "consensus", "rounds", "Number of rounds at the current height."
        )
        self.validators = r.gauge(
            "consensus", "validators", "Number of validators."
        )
        self.validators_power = r.gauge(
            "consensus",
            "validators_power",
            "Total voting power of validators.",
        )
        # a quantile sketch where the reference has a histogram
        self.block_interval = r.sketch(
            "consensus",
            "block_interval_seconds",
            "Time between this and the last block.",
        )
        self.rounds_per_height = r.histogram(
            "consensus",
            "rounds_per_height",
            "Rounds needed to commit a height (1 = no burned round).",
            buckets=(1.0, 2.0, 3.0, 4.0, 6.0, 11.0),
        )
        self.quorum_prevote_latency = r.sketch(
            "consensus",
            "quorum_prevote_seconds",
            "Proposal received to +2/3 prevotes (polka), same round.",
        )
        self.quorum_precommit_latency = r.sketch(
            "consensus",
            "quorum_precommit_seconds",
            "+2/3 prevotes (polka) to +2/3 precommits, same round.",
        )
        self.stall_resets = r.counter(
            "consensus",
            "stall_resets_total",
            "Gossip stall-reset ticks (forget-and-resend of optimistic "
            "delivered-marks) by reset site: catchup (peer >=2 behind), "
            "live (same height), last_commit (peer one behind).",
            label_names=("kind",),
        )
        self.num_txs = r.gauge(
            "consensus",
            "num_txs",
            "Number of transactions in the latest block.",
        )
        self.total_txs = r.counter(
            "consensus",
            "total_txs",
            "Total number of transactions committed.",
        )
        self.block_size = r.gauge(
            "consensus", "block_size_bytes", "Size of the latest block."
        )
