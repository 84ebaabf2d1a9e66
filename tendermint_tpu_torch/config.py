"""Node configuration: the sections of config.toml, and its TOML I/O.

Counterpart: tendermint_tpu/config.py (reference: config/config.go:61-74):
BaseConfig with root() and path() (:51), PrivValidatorConfig (:83),
RPCConfig (:90), P2PConfig (:104), MempoolConfig (:132), StateSyncConfig
and BlockSyncConfig (:155-169), ConsensusConfig (:172, consensus
timeouts as config/config.go:923-939), TxIndexConfig (:205),
InstrumentationConfig (:215), Config with ensure_dirs (:272), the TOML
subset parser (:308-366), load_config (:367) and write_config (:401),
and DEFAULT_BUCKET_SIZES (:47). 12288 exists for the 10k-validator
commit: padding 10k signatures to 16384 would waste 39% of the device
work, 12288 cuts that to 18%.

The port's Config holds `gpu: GPUConfig` where the JAX one holds
`tpu: TPUConfig`, and config.toml has a [gpu] section in place of [tpu];
every other section and key is the JAX file's. The default home is
~/.tendermint_tpu_torch, so that the two CLIs never share a home by
accident. InstrumentationConfig is carried so that home files
round-trip: what it switches on (the Prometheus server, trace spans,
the profiler and the flight recorder) is ROADMAP item 11, and node start
refuses `prometheus = true` (node/node.py).
"""

from __future__ import annotations

import ast
import dataclasses
import os
from dataclasses import dataclass, field

__all__ = [
    "BaseConfig",
    "BlockSyncConfig",
    "Config",
    "ConsensusConfig",
    "DEFAULT_BUCKET_SIZES",
    "DEFAULT_MIN_BATCH",
    "GPUConfig",
    "InstrumentationConfig",
    "MempoolConfig",
    "MODE_FULL",
    "MODE_SEED",
    "MODE_VALIDATOR",
    "P2PConfig",
    "PrivValidatorConfig",
    "RPCConfig",
    "StateSyncConfig",
    "TxIndexConfig",
    "load_config",
    "write_config",
]

MODE_VALIDATOR = "validator"
MODE_FULL = "full"
MODE_SEED = "seed"

DEFAULT_HOME = "~/.tendermint_tpu_torch"

DEFAULT_BUCKET_SIZES = (8, 32, 128, 512, 2048, 8192, 12288, 16384)

# Below this many signatures one device window loses to the native CPU
# batch on an H100, for either key type (chip_smoke.py phase
# `min_batch`, PERF.md §5): from 32 on a window of ed25519 or of sr25519
# wins at every size measured up to 512. The JAX package's figure, for a
# TPU, is 8.
DEFAULT_MIN_BATCH = 32


@dataclass
class BaseConfig:
    chain_id: str = ""
    moniker: str = "anonymous"
    mode: str = MODE_VALIDATOR
    home: str = DEFAULT_HOME
    # sqlite | memdb ("goleveldb" and "default" name sqlite, so that a
    # reference config.toml works unchanged; store/kv.py open_db)
    db_backend: str = "sqlite"
    db_dir: str = "data"
    log_level: str = "info"
    log_format: str = "plain"
    genesis_file: str = "config/genesis.json"
    node_key_file: str = "config/node_key.json"
    abci: str = "builtin"  # builtin | socket | grpc
    proxy_app: str = "kvstore"

    def root(self) -> str:
        return os.path.expanduser(self.home)

    def path(self, rel: str) -> str:
        return os.path.join(self.root(), rel)


@dataclass
class PrivValidatorConfig:
    key_file: str = "config/priv_validator_key.json"
    state_file: str = "data/priv_validator_state.json"
    listen_addr: str = ""  # non-empty: a remote signer dials in here


@dataclass
class GPUConfig:
    """What node/device.py installs the device plane from.

    - enable: install crypto/gpu_verifier and ops/merkle_kernel at all;
    - min_batch_size: the smallest batch of either key type sent to the
      card (smaller ones stay on the native CPU plane);
    - bucket_sizes: the padded window widths of the signature kernels;
    - devices: 1 is one card; 0 is every visible card; n the first n
      cards, each window of both key types split over them
      (parallel/sharding.py); more than are visible is refused.

    TPUConfig's donate_buffers is left out: it is XLA's input buffer
    donation, and the port's kernels write into outputs their wrappers
    allocate, so there is nothing to donate."""

    enable: bool = True
    min_batch_size: int = DEFAULT_MIN_BATCH
    bucket_sizes: list = field(default_factory=lambda: list(DEFAULT_BUCKET_SIZES))
    devices: int = 1


@dataclass
class ConsensusConfig:
    """The WAL's path, the step machine's timeouts in seconds (reference
    defaults, config/config.go:923-939, milliseconds there), and the
    consensus reactor's gossip knobs: the sleep of a gossip routine with
    nothing to send, the block parts one data-gossip turn may burst to a
    peer, and the period of the VoteSetMaj23 queries. The empty-block
    knobs and double_sign_check_height are carried as the JAX node
    carries them: neither package's step machine reads them."""

    wal_file: str = "data/cs.wal/wal"
    timeout_propose: float = 3.0
    timeout_propose_delta: float = 0.5
    timeout_prevote: float = 1.0
    timeout_prevote_delta: float = 0.5
    timeout_precommit: float = 1.0
    timeout_precommit_delta: float = 0.5
    timeout_commit: float = 1.0
    skip_timeout_commit: bool = False
    create_empty_blocks: bool = True
    create_empty_blocks_interval: float = 0.0
    peer_gossip_sleep_duration: float = 0.1
    # sends past the first use try_send: a slow peer's full queue sheds
    # the rest of the window instead of stalling the routine
    peer_gossip_part_window: int = 16
    peer_query_maj23_sleep_duration: float = 2.0
    double_sign_check_height: int = 0

    def propose_timeout(self, round_: int) -> float:
        return self.timeout_propose + self.timeout_propose_delta * round_

    def prevote_timeout(self, round_: int) -> float:
        return self.timeout_prevote + self.timeout_prevote_delta * round_

    def precommit_timeout(self, round_: int) -> float:
        return self.timeout_precommit + self.timeout_precommit_delta * round_


@dataclass
class P2PConfig:
    """What node start hands the peer manager and the router
    (tendermint_tpu/node/node.py:270-331): the listen and advertised
    addresses, the persistent and bootstrap peers, PEX, and their
    options."""

    laddr: str = "tcp://0.0.0.0:26656"
    external_address: str = ""
    persistent_peers: str = ""
    bootstrap_peers: str = ""
    max_connections: int = 64
    max_incoming_connection_attempts: int = 100
    send_rate: int = 5_120_000
    recv_rate: int = 5_120_000
    pex: bool = True
    handshake_timeout: float = 20.0
    dial_timeout: float = 3.0
    queue_type: str = "priority"  # fifo | priority
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


@dataclass
class StateSyncConfig:
    enable: bool = False
    rpc_servers: list[str] = field(default_factory=list)
    trust_height: int = 0
    trust_hash: str = ""
    trust_period: float = 168 * 3600.0
    discovery_time: float = 15.0
    chunk_request_timeout: float = 15.0
    fetchers: int = 4


@dataclass
class BlockSyncConfig:
    enable: bool = True


@dataclass
class RPCConfig:
    laddr: str = "tcp://127.0.0.1:26657"
    max_open_connections: int = 900
    max_subscription_clients: int = 100
    max_subscriptions_per_client: int = 5
    timeout_broadcast_tx_commit: float = 10.0
    max_body_bytes: int = 1_000_000
    # per-block serving cache (rpc/servingcache.py): LRU capacity in
    # blocks for each artifact family (encoded LightBlock blobs, held
    # tx-proof merkle trees); 0 disables the cache for this node
    serving_cache_blocks: int = 64


@dataclass
class TxIndexConfig:
    # kv | null | psql (the psql sink runs on sqlite3 here:
    # state/sink_sql.py)
    indexer: list[str] = field(default_factory=lambda: ["kv"])
    # DSN for the "psql" sink: sqlite:<path> or sqlite::memory:. Empty:
    # a sqlite file in the data dir.
    psql_conn: str = ""


@dataclass
class InstrumentationConfig:
    """Carried so that config.toml round-trips with the JAX package's
    keys and defaults. Node start refuses prometheus = true and logs the
    other switches that are on as not yet honored (ROADMAP item 11)."""

    prometheus: bool = False
    prometheus_listen_addr: str = ":26660"
    namespace: str = "tendermint_tpu"
    trace_spans: bool = False
    trace_ring_capacity: int = 8192
    slo_exemplars: bool = False
    slo_exemplar_capacity: int = 64
    consensus_timeline: bool = True
    consensus_timeline_capacity: int = 4096
    profiler: bool = False
    profiler_hz: float = 97.0
    profiler_max_stacks: int = 2048
    profiler_labels: bool = True


@dataclass
class Config:
    base: BaseConfig = field(default_factory=BaseConfig)
    priv_validator: PrivValidatorConfig = field(default_factory=PrivValidatorConfig)
    rpc: RPCConfig = field(default_factory=RPCConfig)
    p2p: P2PConfig = field(default_factory=P2PConfig)
    mempool: MempoolConfig = field(default_factory=MempoolConfig)
    statesync: StateSyncConfig = field(default_factory=StateSyncConfig)
    blocksync: BlockSyncConfig = field(default_factory=BlockSyncConfig)
    consensus: ConsensusConfig = field(default_factory=ConsensusConfig)
    tx_index: TxIndexConfig = field(default_factory=TxIndexConfig)
    instrumentation: InstrumentationConfig = field(default_factory=InstrumentationConfig)
    gpu: GPUConfig = field(default_factory=GPUConfig)

    def ensure_dirs(self) -> None:
        root = self.base.root()
        for sub in ("config", "data", os.path.dirname(self.consensus.wal_file)):
            os.makedirs(os.path.join(root, sub), exist_ok=True)


_SECTIONS = {
    "base": BaseConfig,
    "priv_validator": PrivValidatorConfig,
    "rpc": RPCConfig,
    "p2p": P2PConfig,
    "mempool": MempoolConfig,
    "statesync": StateSyncConfig,
    "blocksync": BlockSyncConfig,
    "consensus": ConsensusConfig,
    "tx_index": TxIndexConfig,
    "instrumentation": InstrumentationConfig,
    "gpu": GPUConfig,
}


def _parse_toml_value(val: str):
    """One scalar, flat list or inline table of scalars; ValueError on
    anything else."""
    if val == "true":
        return True
    if val == "false":
        return False
    if val.startswith("{") and val.endswith("}"):
        out = {}
        inner = val[1:-1].strip()
        if inner:
            for pair in inner.split(","):
                k, eq, v = pair.partition("=")
                if not eq:
                    raise ValueError(f"bad inline table entry: {pair!r}")
                out[k.strip()] = _parse_toml_value(v.strip())
        return out
    try:
        # numbers, quoted strings (the escapes write_config emits) and
        # flat lists of them
        return ast.literal_eval(val)
    except (ValueError, SyntaxError) as e:
        raise ValueError(f"unsupported TOML value: {val!r}") from e


def _parse_toml_subset(text: str) -> dict:
    """The TOML subset write_config emits: sections (dotted names too)
    of bool, number, string, flat-list and inline-table values. Used
    where the standard library has no tomllib (Python < 3.11)."""
    raw: dict = {}
    cur: dict = raw  # keys before any [section] are the document root's
    for line in text.splitlines():
        line = line.strip()
        if line.startswith("#"):
            continue
        if '"' not in line:
            # a trailing comment is stripped only where no string value
            # could hold the '#'
            line = line.split("#", 1)[0].strip()
        if not line:
            continue
        if line.startswith("[") and line.endswith("]"):
            cur = raw
            for part in line[1:-1].strip().split("."):
                cur = cur.setdefault(part.strip(), {})
            continue
        if "=" not in line:
            # a typo'd setting must not fall back to its default unseen
            raise ValueError(f"unparseable TOML line: {line!r}")
        key, _, val = line.partition("=")
        cur[key.strip()] = _parse_toml_value(val.strip())
    return raw


def load_config(path: str) -> Config:
    """The Config of a config.toml: each section's known keys, the
    defaults for the rest. A JAX package's [tpu] section is not read."""
    try:
        import tomllib
    except ImportError:
        tomllib = None

    if tomllib is not None:
        with open(path, "rb") as f:
            raw = tomllib.load(f)
    else:
        with open(path, encoding="utf-8") as f:
            raw = _parse_toml_subset(f.read())
    cfg = Config()
    for section, cls in _SECTIONS.items():
        data = raw.get(section, {})
        known = {f.name for f in dataclasses.fields(cls)}
        setattr(cfg, section, cls(**{k: v for k, v in data.items() if k in known}))
    return cfg


def _toml_value(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        return str(v)
    if isinstance(v, str):
        return '"' + v.replace("\\", "\\\\").replace('"', '\\"') + '"'
    if isinstance(v, list):
        return "[" + ", ".join(_toml_value(x) for x in v) + "]"
    raise TypeError(f"unsupported TOML value: {v!r}")


def write_config(cfg: Config, path: str) -> None:
    lines = ["# tendermint-tpu node configuration", ""]
    for section in _SECTIONS:
        obj = getattr(cfg, section)
        lines.append(f"[{section}]")
        for f in dataclasses.fields(obj):
            lines.append(f"{f.name} = {_toml_value(getattr(obj, f.name))}")
        lines.append("")
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(path, "w") as fh:
        fh.write("\n".join(lines))
