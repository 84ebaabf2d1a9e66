"""The port's metrics plane held against tendermint_tpu/libs/metrics.py and
the JAX node's /metrics and /healthz (after tests/test_metrics.py).

- the same sequence of counter, gauge, histogram and sketch operations
  renders the same exposition bytes in both packages (label escaping,
  the float format, empty series); registration conflicts and a negative
  counter increment raise the same errors; LatencySketch quantiles,
  merges and dict round trips equal the JAX ones;
- each subsystem struct registers the JAX specs (name, type, labels,
  HELP, buckets, error bound);
- a started port node's catalog (its registry and DEFAULT_REGISTRY's
  process-wide families) equals a started JAX node's in names, types,
  labels, HELP and buckets, apart from the device family's subsystem
  (`tpu` -> `gpu`) and the two commit-memo counters the port drops; both
  servers answer GET, HEAD, POST, an unknown path, a path that merely
  contains /metrics and a request past the header cap alike, and the
  scrape parses with no duplicate series;
- two port nodes in one process have disjoint registries;
- the gpu_* counters move with gpu_verifier.stats() over the plain
  versions on the CPU, a contained fault and its breaker included; the
  sigcache_* counters with sigcache.stats().

Process-wide series are read as deltas. Servers bind 127.0.0.1:0.
Tolerance: zero (bytes, names, counts).
"""

import asyncio
import json
import math
import random
import time

import pytest

from tendermint_tpu.config import Config as JaxConfig
from tendermint_tpu.consensus.metrics import ConsensusMetrics as JaxConsensusMetrics
from tendermint_tpu.crypto import sigcache as jax_sigcache
from tendermint_tpu.crypto.ed25519 import PrivKeyEd25519 as JaxPriv
from tendermint_tpu.eventbus import EventBusMetrics as JaxEventBusMetrics
from tendermint_tpu.evidence.metrics import EvidenceMetrics as JaxEvidenceMetrics
from tendermint_tpu.libs import metrics as jax_metrics
from tendermint_tpu.mempool.metrics import MempoolMetrics as JaxMempoolMetrics
from tendermint_tpu.node import make_node as jax_make_node
from tendermint_tpu.p2p.metrics import P2PMetrics as JaxP2PMetrics
from tendermint_tpu.privval import FilePV as JaxFilePV
from tendermint_tpu.rpc.metrics import RPCMetrics as JaxRPCMetrics
from tendermint_tpu.state.metrics import StateMetrics as JaxStateMetrics
from tendermint_tpu.types.genesis import GenesisDoc as JaxGenesisDoc
from tendermint_tpu.types.genesis import GenesisValidator as JaxGenesisValidator
from tendermint_tpu_torch import workloads
from tendermint_tpu_torch.config import Config, GPUConfig
from tendermint_tpu_torch.consensus.metrics import ConsensusMetrics
from tendermint_tpu_torch.crypto import faults, gpu_verifier, sigcache
from tendermint_tpu_torch.crypto.batch import create_batch_verifier
from tendermint_tpu_torch.crypto.ed25519 import PrivKeyEd25519
from tendermint_tpu_torch.eventbus import EventBusMetrics
from tendermint_tpu_torch.evidence.metrics import EvidenceMetrics
from tendermint_tpu_torch.libs import metrics as port_metrics
from tendermint_tpu_torch.mempool.metrics import MempoolMetrics
from tendermint_tpu_torch.node import device as device_plane
from tendermint_tpu_torch.node import make_node
from tendermint_tpu_torch.p2p.metrics import P2PMetrics
from tendermint_tpu_torch.privval.file import FilePV
from tendermint_tpu_torch.rpc.metrics import RPCMetrics
from tendermint_tpu_torch.state.metrics import StateMetrics
from tendermint_tpu_torch.types.genesis import GenesisDoc, GenesisValidator

from .test_torch_isolation import jax_device_plane_paused  # noqa: F401 (autouse)

NS = "tendermint_tpu"
# the JAX package's commit-memo counters, which the port drops with the memo
COMMIT_MEMO = {f"{NS}_sigcache_commit_hits_total", f"{NS}_sigcache_commit_misses_total"}


def parse_exposition(text: str) -> dict:
    """A Prometheus text-format (0.0.4) parser: series (name and sorted
    labels) -> value; raises on a line it cannot parse or a series seen
    twice."""
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        metric, _, value = line.rpartition(" ")
        assert metric, f"unparseable exposition line: {line!r}"
        if "{" in metric:
            name, _, rest = metric.partition("{")
            labels = []
            for pair in rest.rstrip("}").split('",'):
                k, _, v = pair.partition("=")
                labels.append((k, v.strip('"')))
            key = name + "{" + ",".join(f"{k}={v}" for k, v in sorted(labels)) + "}"
        else:
            key = metric
        assert key not in out, f"duplicate series {key}"
        out[key] = float(value) if value != "+Inf" else math.inf
    return out


# -- the library --


def _drive(mod, seed: int) -> str:
    """A seeded sequence of operations on a fresh Registry of `mod`."""
    rng = random.Random(seed)
    r = mod.Registry()
    c = r.counter("sub", "events_total", "Events, by kind.", label_names=("kind",))
    u = r.counter("sub", "plain_total", "An unlabeled counter.")
    g = r.gauge("sub", "level", "A gauge.", label_names=("ch", "peer"))
    r.gauge("sub", "idle", "A gauge never set.")
    h = r.histogram("sub", "lat_seconds", "A histogram.", buckets=(0.001, 0.1, 1.0, 2.5))
    d = r.histogram("sub", "default_seconds", "Default buckets.", label_names=("route",))
    s = r.sketch("sub", "sketch_seconds", "A sketch.", label_names=("route",))
    kinds = ["a", 'quo"te', "back\\slash", "new\nline", "ünï"]
    for _ in range(200):
        op = rng.randrange(6)
        if op == 0:
            c.inc(rng.choice([1, 2.5, 0.1]), kind=rng.choice(kinds))
        elif op == 1:
            u.inc(rng.randrange(1, 5))
        elif op == 2:
            g.set(rng.uniform(-5, 5), ch=rng.randrange(3), peer=rng.choice(kinds))
            g.add(rng.randrange(-2, 3), ch=0, peer="a")
        elif op == 3:
            h.observe(rng.expovariate(5.0))
        elif op == 4:
            d.observe(rng.uniform(0, 12), route=rng.choice(["block", "status"]))
        else:
            s.observe(rng.lognormvariate(-5, 2), route=rng.choice(["block", "status", "tx"]))
    return r.render() + r.render(exclude=frozenset({f"{NS}_sub_level"}))


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_exposition_bytes_equal_jax(seed):
    text = _drive(port_metrics, seed)
    assert text == _drive(jax_metrics, seed)
    parse_exposition(text.split("\n# HELP tendermint_tpu_sub_default_seconds", 1)[0])
    assert port_metrics.Registry().render() == jax_metrics.Registry().render() == ""


def test_conflicts_and_a_negative_increment_raise_as_jax():
    def errors(mod):
        out = []
        r = mod.Registry("ns")
        r.counter("sub", "x_total", "help")
        assert r.counter("sub", "x_total", "help") is r.get("ns_sub_x_total")
        r.histogram("sub", "h_seconds", "help", buckets=(0.1, 1.0))
        r.sketch("rpc", "lat", "h", relative_error=0.01)
        for call in (
            lambda: r.gauge("sub", "x_total", "help"),
            lambda: r.counter("sub", "x_total", "help", label_names=("ch",)),
            lambda: r.histogram("sub", "h_seconds", "help", buckets=(0.2, 1.0)),
            lambda: r.sketch("rpc", "lat", "h", relative_error=0.05),
            lambda: r.get("ns_sub_x_total").inc(-1),
        ):
            with pytest.raises(ValueError) as e:
                call()
            out.append(str(e.value))
        return out, sorted(r.names())

    assert errors(port_metrics) == errors(jax_metrics)


DISTRIBUTIONS = {
    "uniform": lambda r: r.uniform(1e-4, 2.0),
    "lognormal": lambda r: r.lognormvariate(-5.0, 2.0),
    "exponential": lambda r: r.expovariate(100.0),
    "bimodal": lambda r: r.uniform(1e-3, 2e-3) if r.random() < 0.9 else r.uniform(0.5, 1.5),
}


@pytest.mark.parametrize("dist", sorted(DISTRIBUTIONS))
def test_sketch_quantiles_merges_and_dicts_equal_jax(dist):
    r = random.Random(11)
    vals = [DISTRIBUTIONS[dist](r) for _ in range(3000)]
    out = []
    for mod in (port_metrics, jax_metrics):
        parts = [mod.LatencySketch(relative_error=0.01) for _ in range(3)]
        for i, v in enumerate(vals):
            parts[i % 3].record(v)
        merged = parts[0].snapshot().merge(parts[1].snapshot()).merge(parts[2])
        qs = merged.quantiles((0.0, 0.25, 0.5, 0.9, 0.99, 0.999, 1.0))
        rt = mod.LatencySketch.from_dict(json.loads(json.dumps(merged.to_dict())))
        out.append((qs, merged.to_dict(), rt.quantile(0.99), merged.count, merged.min, merged.max))
        with pytest.raises(ValueError):
            merged.merge(mod.LatencySketch(relative_error=0.02))
    assert out[0] == out[1]
    sv = sorted(vals)
    for q, est in zip((0.5, 0.9, 0.99), out[0][0][2:5]):
        oracle = sv[max(1, math.ceil(q * len(sv))) - 1]
        assert abs(est - oracle) / oracle <= 0.01 + 1e-9


def _specs(registry) -> dict:
    """name -> (type, label names, HELP, buckets, error bound)."""
    return {
        name: (m.kind, m.label_names, m.help, getattr(m, "buckets", None),
               getattr(m, "relative_error", None))
        for name in registry.names()
        for m in [registry.get(name)]
    }


STRUCTS = [
    (ConsensusMetrics, JaxConsensusMetrics),
    (StateMetrics, JaxStateMetrics),
    (EvidenceMetrics, JaxEvidenceMetrics),
    (MempoolMetrics, JaxMempoolMetrics),
    (P2PMetrics, JaxP2PMetrics),
    (RPCMetrics, JaxRPCMetrics),
    (EventBusMetrics, JaxEventBusMetrics),
]


@pytest.mark.parametrize("port_cls,jax_cls", STRUCTS, ids=[p.__name__ for p, _ in STRUCTS])
def test_struct_specs_equal_jax(port_cls, jax_cls):
    port_reg, jax_reg = port_metrics.Registry(), jax_metrics.Registry()
    port_struct, jax_struct = port_cls(port_reg), jax_cls(jax_reg)
    assert _specs(port_reg) == _specs(jax_reg) and port_reg.names()
    assert vars(port_struct).keys() == vars(jax_struct).keys()
    if port_cls is RPCMetrics:
        assert port_struct.slo_for("broadcast_tx_commit") == 15.0 == jax_struct.slo_for("broadcast_tx_commit")
        assert port_struct.slo_for("status") == 1.0
    # a struct without a registry lands on DEFAULT_REGISTRY, idempotently
    assert port_cls().__dict__.keys() == port_cls().__dict__.keys()


# -- the nodes --


def _jax_cfg(tmp_path, name: str, priv):
    genesis = JaxGenesisDoc(chain_id="metrics-chain", genesis_time_ns=time.time_ns(),
                            validators=[JaxGenesisValidator(pub_key=priv.pub_key(), power=10)])
    cfg = JaxConfig()
    cfg.base.home = str(tmp_path / name)
    cfg.base.chain_id = "metrics-chain"
    cfg.base.db_backend = "memdb"
    cfg.tpu.enable = False
    cfg.consensus.timeout_commit = 0.05
    cfg.rpc.laddr = "tcp://127.0.0.1:0"
    cfg.p2p.laddr = "tcp://127.0.0.1:0"
    cfg.instrumentation.prometheus = True
    cfg.instrumentation.prometheus_listen_addr = "127.0.0.1:0"
    cfg.ensure_dirs()
    genesis.save_as(cfg.base.path(cfg.base.genesis_file))
    JaxFilePV.from_priv_key(priv, cfg.base.path(cfg.priv_validator.key_file),
                            cfg.base.path(cfg.priv_validator.state_file)).save()
    return cfg


def _port_cfg(tmp_path, name: str, priv):
    genesis = GenesisDoc(chain_id="metrics-chain", genesis_time_ns=time.time_ns(),
                         validators=[GenesisValidator(pub_key=priv.pub_key(), power=10)])
    cfg = Config()
    cfg.base.home = str(tmp_path / name)
    cfg.base.chain_id = "metrics-chain"
    cfg.base.db_backend = "memdb"
    cfg.gpu.enable = False
    cfg.consensus.timeout_commit = 0.05
    cfg.rpc.laddr = "tcp://127.0.0.1:0"
    cfg.p2p.laddr = "tcp://127.0.0.1:0"
    cfg.instrumentation.prometheus = True
    cfg.instrumentation.prometheus_listen_addr = "127.0.0.1:0"
    cfg.ensure_dirs()
    genesis.save_as(cfg.base.path(cfg.base.genesis_file))
    FilePV.from_priv_key(priv, cfg.base.path(cfg.priv_validator.key_file),
                         cfg.base.path(cfg.priv_validator.state_file)).save()
    return cfg


async def _request(port: int, raw: bytes) -> bytes:
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(raw)
    await writer.drain()
    data = await asyncio.wait_for(reader.read(-1), 15.0)
    writer.close()
    return data


REQUESTS = {
    "get_metrics": b"GET /metrics HTTP/1.1\r\nHost: x\r\n\r\n",
    "get_query": b"GET /metrics?x=1 HTTP/1.1\r\nHost: x\r\n\r\n",
    "head_metrics": b"HEAD /metrics HTTP/1.1\r\n\r\n",
    "post_metrics": b"POST /metrics HTTP/1.1\r\nContent-Length: 0\r\n\r\n",
    "unknown": b"GET /nope HTTP/1.1\r\n\r\n",
    "contains": b"GET /foo?x=/metrics HTTP/1.1\r\n\r\n",
    "longer": b"GET /metricsfoo HTTP/1.1\r\n\r\n",
    "garbage": b"\xff\xfe\r\n\r\n",
    "header_cap": b"GET /healthz HTTP/1.1\r\n" + b"X-a: b\r\n" * 101 + b"\r\n",
    "healthz": b"GET /healthz HTTP/1.1\r\n\r\n",
}


def _shape(name: str, data: bytes):
    """What the comparison holds equal: the status line and headers, and
    the body but for a scrape's values and the node's own identity."""
    head, _, body = data.partition(b"\r\n\r\n")
    lines = head.split(b"\r\n")
    if name == "healthz":
        return lines, sorted(json.loads(body))
    if name in ("get_metrics", "get_query", "head_metrics"):
        return lines[:2] + lines[3:], bool(body)
    return lines, body


def test_node_catalog_and_server_equal_jax(tmp_path):
    """A started port node's catalog is the JAX node's, but for the device
    family's subsystem and the commit-memo counters; both servers answer
    every request alike, and the port's scrape parses with no duplicate
    series and /healthz's height is the block store's."""
    port_cfg = _port_cfg(tmp_path, "port", PrivKeyEd25519.from_seed(b"\x71" * 32))
    jax_cfg = _jax_cfg(tmp_path, "jax", JaxPriv.from_seed(b"\x72" * 32))

    async def go():
        port, jax = make_node(port_cfg, device="cpu"), jax_make_node(jax_cfg)
        await port.start()
        await jax.start()
        try:
            await port.consensus.wait_for_height(2, timeout=30.0)
            await jax.consensus.wait_for_height(2, timeout=30.0)
            answers = {}
            for name, raw in REQUESTS.items():
                answers[name] = (await _request(port.metrics_port, raw), await _request(jax.metrics_port, raw))
            catalogs = []
            for node, mod in ((port, port_metrics), (jax, jax_metrics)):
                specs = _specs(mod.DEFAULT_REGISTRY)
                specs.update(_specs(node.metrics_registry))
                catalogs.append(specs)
            health = json.loads(answers["healthz"][0].partition(b"\r\n\r\n")[2])
            return answers, catalogs, health, port.block_store.height(), port.node_key.node_id
        finally:
            await port.stop()
            await jax.stop()

    with jax_sigcache.disabled():
        answers, (port_cat, jax_cat), health, height, node_id = asyncio.run(asyncio.wait_for(go(), 60.0))
    want = {name.replace(f"{NS}_tpu_", f"{NS}_gpu_"): spec
            for name, spec in jax_cat.items() if name not in COMMIT_MEMO}
    assert port_cat == want
    assert f"{NS}_gpu_verify_batches_total" in port_cat and f"{NS}_breaker_state" in port_cat
    for name, (got, jax_got) in answers.items():
        assert _shape(name, got) == _shape(name, jax_got), name
    assert answers["header_cap"][0] == b"" and b"405" in answers["post_metrics"][0]
    assert answers["head_metrics"][0].endswith(b"\r\n\r\n")
    assert b"404" in answers["contains"][0] and b"404" in answers["longer"][0]
    text = answers["get_metrics"][0].partition(b"\r\n\r\n")[2].decode()
    series = parse_exposition(text)
    assert text.count(f"# TYPE {NS}_consensus_height ") == 1
    assert series[f"{NS}_p2p_peers"] == 0 and series[f"{NS}_consensus_height"] >= 2
    assert series[f"{NS}_state_block_processing_seconds_count"] >= 1
    assert health["node_id"] == node_id and 1 <= health["height"] <= height and health["syncing"] is False


def test_two_port_nodes_in_one_process_have_disjoint_registries(tmp_path):
    cfgs = [_port_cfg(tmp_path, f"n{i}", PrivKeyEd25519.from_seed(bytes([0x80 + i]) * 32)) for i in range(2)]

    async def go():
        nodes = [make_node(c, device="cpu") for c in cfgs]
        for n in nodes:
            await n.start()
        try:
            await asyncio.gather(*(n.consensus.wait_for_height(2, timeout=30.0) for n in nodes))
            regs = [n.metrics_registry for n in nodes]
            assert regs[0] is not regs[1] and regs[0].names() == regs[1].names()
            nodes[0].consensus.metrics.height.set(99999)
            nodes[1].mempool.metrics.failed_txs.inc(7)
            scrapes = [n._render_metrics() for n in nodes]
        finally:
            for n in nodes:
                await n.stop()
        return scrapes

    scrapes = asyncio.run(asyncio.wait_for(go(), 60.0))
    parsed = [parse_exposition(s) for s in scrapes]
    assert parsed[0][f"{NS}_consensus_height"] == 99999 != parsed[1][f"{NS}_consensus_height"]
    assert parsed[1][f"{NS}_mempool_failed_txs_total"] == 7 != parsed[0][f"{NS}_mempool_failed_txs_total"]


# -- the process-wide families --

GPU_SERIES = {
    "batches": "verify_batches_total",
    "sigs": "verify_sigs_total",
    "faults": "device_faults_total",
    "pad_waste": "pad_waste_slots_total",
    "warm_buckets": "warm_bucket_hits_total",
    "cold_buckets": "warm_bucket_misses_total",
}


def _gpu_reading() -> dict:
    reg = port_metrics.DEFAULT_REGISTRY
    out = {key: reg.get(f"{NS}_gpu_{name}").value() for key, name in GPU_SERIES.items()}
    for name in ("verify_seconds", "host_prep_seconds", "device_wall_seconds"):
        out[name] = reg.get(f"{NS}_gpu_{name}").count()
    breaker = reg.get(f"{NS}_breaker_trips_total")
    out["trips"] = breaker.value(name="ed25519")
    out["state"] = reg.get(f"{NS}_breaker_state").value(name="ed25519")
    return out


def _batch(privs, tag: bytes, bad: int = -1):
    bv = create_batch_verifier(privs[0].pub_key(), len(privs))
    for i, p in enumerate(privs):
        sig = p.sign(tag + bytes([i]))
        if i == bad:
            sig = bytes([sig[0] ^ 1]) + sig[1:]
        bv.add(p.pub_key(), tag + bytes([i]), sig)
    return bv.verify()


def test_gpu_counters_follow_stats_over_the_plain_versions():
    privs = workloads.seeded_keys(8, 21, n_sr=4)
    # three signatures a batch in buckets of 4: each window pads one lane
    by_type = {kt: [p for p in privs if p.type() == kt][:3] for kt in ("ed25519", "sr25519")}
    device_plane.install_device_plane(GPUConfig(enable=True, min_batch_size=2, bucket_sizes=[4, 8]), "cpu")
    try:
        stats0, seen0 = gpu_verifier.stats(), _gpu_reading()
        assert _batch(by_type["ed25519"], b"a", bad=2) == (False, [True, True, False])
        assert _batch(by_type["sr25519"], b"b") == (True, [True] * 3)
        assert _batch(by_type["ed25519"], b"c") == (True, [True] * 3)
        stats1, seen1 = gpu_verifier.stats(), _gpu_reading()
        for key in GPU_SERIES:
            assert seen1[key] - seen0[key] == stats1[key] - stats0[key], key
        assert stats1["batches"] - stats0["batches"] == 3 and stats1["faults"] == stats0["faults"]
        assert stats1["pad_waste"] - stats0["pad_waste"] == 3
        for name in ("verify_seconds", "host_prep_seconds", "device_wall_seconds"):
            assert seen1[name] - seen0[name] == 3, name
        # a contained fault: counted once in both, the breaker opened
        with faults.inject("gpu.dispatch", "raise", p=1.0, seed=3):
            assert _batch(by_type["ed25519"], b"d") == (True, [True] * 3)
        stats2, seen2 = gpu_verifier.stats(), _gpu_reading()
        assert seen2["faults"] - seen1["faults"] == stats2["faults"] - stats1["faults"] == 1
        assert seen2["trips"] - seen1["trips"] == 1
        assert seen2["state"] == stats2["breaker_ed25519"] == 1
        assert seen2["verify_seconds"] - seen1["verify_seconds"] == 1
        assert seen2["host_prep_seconds"] == seen1["host_prep_seconds"]
    finally:
        device_plane.uninstall_device_plane()


def test_sigcache_counters_follow_stats():
    reg = port_metrics.DEFAULT_REGISTRY

    def reading():
        return [reg.get(f"{NS}_sigcache_{n}_total").value() for n in ("hits", "misses", "evictions")]

    capacity = sigcache.stats()["capacity"]
    s0, m0 = sigcache.stats(), reading()
    try:
        sigcache.set_capacity(4)
        for i in range(10):
            key = (b"pk%d" % i, b"sb", b"sig")
            assert not sigcache.seen(*key)
            sigcache.add(*key)
            assert sigcache.seen(*key)
    finally:
        sigcache.set_capacity(capacity)
    s1, m1 = sigcache.stats(), reading()
    deltas = [s1[k] - s0[k] for k in ("hits", "misses", "evictions")]
    assert [b - a for a, b in zip(m0, m1)] == deltas
    assert deltas[0] == 10 and deltas[1] == 10 and deltas[2] > 0
