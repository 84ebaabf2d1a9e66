"""The device plane's configuration, the step machine's timeouts, the
mempool's settings and the p2p settings the router and peer manager read.

Counterpart: tendermint_tpu/config.py:47 (DEFAULT_BUCKET_SIZES),
:104-130 (P2PConfig), :132-151 (MempoolConfig), :172-202
(ConsensusConfig) and :254-268 (TPUConfig). 12288 exists for the 10k-validator commit: padding
10k signatures to 16384 would waste 39% of the device work, 12288 cuts
that to 18%.
"""

from __future__ import annotations

from dataclasses import dataclass, field

__all__ = [
    "ConsensusConfig",
    "DEFAULT_BUCKET_SIZES",
    "DEFAULT_MIN_BATCH",
    "GPUConfig",
    "MempoolConfig",
    "P2PConfig",
]

DEFAULT_BUCKET_SIZES = (8, 32, 128, 512, 2048, 8192, 12288, 16384)

# Below this many signatures one device window loses to the native CPU
# batch on an H100, for either key type (chip_smoke.py phase
# `min_batch`, PERF.md §5): from 32 on a window of ed25519 or of sr25519
# wins at every size measured up to 512. The JAX package's figure, for a
# TPU, is 8.
DEFAULT_MIN_BATCH = 32


@dataclass
class GPUConfig:
    """What node/device.py installs the device plane from.

    - enable: install crypto/gpu_verifier and ops/merkle_kernel at all;
    - min_batch_size: the smallest batch of either key type sent to the
      card (smaller ones stay on the native CPU plane);
    - bucket_sizes: the padded window widths of the signature kernels;
    - devices: 1 is one card; 0 is every visible card; more than one
      card (X6, ROADMAP item 10) is refused.

    TPUConfig's donate_buffers is left out: it is XLA's input buffer
    donation, and the port's kernels write into outputs their wrappers
    allocate, so there is nothing to donate."""

    enable: bool = True
    min_batch_size: int = DEFAULT_MIN_BATCH
    bucket_sizes: list = field(default_factory=lambda: list(DEFAULT_BUCKET_SIZES))
    devices: int = 1


@dataclass
class ConsensusConfig:
    """The step machine's timeouts, in seconds (reference defaults,
    config/config.go:923-939, milliseconds there). The JAX package's
    other fields (the WAL's path, empty-block creation, the reactor's
    gossip knobs, the double-sign check height) serve node start and the
    reactors (ROADMAP items 17 and 21)."""

    timeout_propose: float = 3.0
    timeout_propose_delta: float = 0.5
    timeout_prevote: float = 1.0
    timeout_prevote_delta: float = 0.5
    timeout_precommit: float = 1.0
    timeout_precommit_delta: float = 0.5
    timeout_commit: float = 1.0
    skip_timeout_commit: bool = False

    def propose_timeout(self, round_: int) -> float:
        return self.timeout_propose + self.timeout_propose_delta * round_

    def prevote_timeout(self, round_: int) -> float:
        return self.timeout_prevote + self.timeout_prevote_delta * round_

    def precommit_timeout(self, round_: int) -> float:
        return self.timeout_precommit + self.timeout_precommit_delta * round_


@dataclass
class P2PConfig:
    """The fields of the JAX P2PConfig that node start hands the peer
    manager and the router (tendermint_tpu/node/node.py:284-330); the
    listen and external addresses, PEX, the bootstrap peers and the
    queue type serve node start and PEX (ROADMAP items 17 and 21)."""

    persistent_peers: str = ""
    max_connections: int = 64
    max_incoming_connection_attempts: int = 100
    send_rate: int = 5_120_000
    recv_rate: int = 5_120_000
    handshake_timeout: float = 20.0
    dial_timeout: float = 3.0
    # jittered capped exponential dial backoff (peer manager)
    min_retry_time: float = 0.25
    max_retry_time: float = 600.0
    max_retry_time_persistent: float = 20.0
    # keepalive liveness (router; any received traffic counts)
    ping_interval: float = 30.0
    pong_timeout: float = 15.0
    # slow-peer shedding: this many send-queue drops inside the window
    # evict the peer with reason slow_peer and ban it for the sit-out
    slow_peer_drop_threshold: int = 64
    slow_peer_window: float = 10.0
    slow_peer_ban: float = 30.0


@dataclass
class MempoolConfig:
    recheck: bool = True
    broadcast: bool = True
    size: int = 5000
    max_txs_bytes: int = 1 << 30
    cache_size: int = 10000
    keep_invalid_txs_in_cache: bool = False
    max_tx_bytes: int = 1 << 20
    ttl_duration: float = 0.0  # seconds; 0: no TTL
    ttl_num_blocks: int = 0
    # admission shards: CheckTx takes only its tx-key-hashed shard's
    # lock; consensus's lock() is a barrier across every shard
    shards: int = 8
    # the most txs in one gossip envelope or one batched admission call
    # (the recheck's ABCI grain too)
    tx_batch_size: int = 64
