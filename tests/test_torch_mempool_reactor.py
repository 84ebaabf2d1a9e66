"""The port's mempool reactor and a proposer that reaps its mempool, held
against the JAX package's.

- TxsMessage's bytes and the mempool channel's descriptor;
- two and three nodes of each package gossiping on their own
  MemoryNetwork (routers, peer managers and mempool reactors): every tx
  admitted at one node reaches every pool, none is sent back to a peer
  it came from, and with two nodes the receiving pool holds the sender's
  order, as in the JAX package;
- the proposer harness at 6 validators (2 sr25519): a node whose
  TxMempool holds the txs of the height it proposes meets a seeded chain
  (workloads.build_consensus_chain with node_reaps), run by hand as
  tests/test_torch_consensus_state.py runs it, in both packages with
  the clock pinned: the same blocks, metas, seen commit, state, app
  hash, own messages, WAL EndHeight records and pool afterwards, bytes
  equal; late txs admitted during its height are rechecked at its
  commit and stay.

The JAX side runs on its CPU verifiers with its verified-signature
cache off and its metrics on private registries. No socket is opened.
"""

import asyncio
import itertools
import os

import numpy as np
import pytest

from tendermint_tpu.abci.client import LocalClient as JaxLocalClient
from tendermint_tpu.abci.kvstore import KVStoreApplication as JaxKVStore
from tendermint_tpu.config import ConsensusConfig as JaxConsensusConfig
from tendermint_tpu.config import MempoolConfig as JaxMempoolConfig
from tendermint_tpu.consensus import msgs as jax_msgs
from tendermint_tpu.consensus.metrics import ConsensusMetrics
from tendermint_tpu.consensus.state import ConsensusState as JaxConsensusState
from tendermint_tpu.consensus.timeline import TimelineRecorder
from tendermint_tpu.consensus.wal import WAL as JaxWAL
from tendermint_tpu.crypto import sigcache as jax_sigcache
from tendermint_tpu.crypto import sr25519 as _jax_sr  # noqa: F401  (registers the key type)
from tendermint_tpu.crypto.ed25519 import PrivKeyEd25519 as JaxPrivKey
from tendermint_tpu.eventbus import EventBus as JaxEventBus
from tendermint_tpu.evidence.metrics import EvidenceMetrics
from tendermint_tpu.evidence.pool import EvidencePool as JaxEvidencePool
from tendermint_tpu.libs.metrics import Registry
from tendermint_tpu.mempool import reactor as jax_reactor
from tendermint_tpu.mempool.mempool import TxMempool as JaxTxMempool
from tendermint_tpu.mempool.metrics import MempoolMetrics
from tendermint_tpu.p2p import peermanager as jax_pm
from tendermint_tpu.p2p import router as jax_router
from tendermint_tpu.p2p import transport as jax_transport
from tendermint_tpu.p2p import types as jax_types
from tendermint_tpu.p2p.metrics import P2PMetrics
from tendermint_tpu.privval.file import FilePV as JaxFilePV
from tendermint_tpu.state.execution import BlockExecutor as JaxBlockExecutor
from tendermint_tpu.state.metrics import StateMetrics
from tendermint_tpu.state.store import StateStore as JaxStateStore
from tendermint_tpu.state.types import state_from_genesis as jax_state_from_genesis
from tendermint_tpu.store.block_store import BlockStore as JaxBlockStore
from tendermint_tpu.store.kv import MemKV as JaxMemKV
from tendermint_tpu.types.genesis import GenesisDoc as JaxGenesisDoc
from tendermint_tpu_torch import workloads
from tendermint_tpu_torch.abci.kvstore import KVStoreApplication as PortKVStore
from tendermint_tpu_torch.config import ConsensusConfig, MempoolConfig
from tendermint_tpu_torch.consensus import msgs as port_msgs
from tendermint_tpu_torch.consensus.types import RoundStep
from tendermint_tpu_torch.crypto import sigcache
from tendermint_tpu_torch.mempool import reactor as port_reactor
from tendermint_tpu_torch.p2p import transport as port_transport

CHAIN_ID = "torch-mempool-chain"
SEED = 43
SLOW = dict(
    timeout_propose=30.0, timeout_prevote=30.0, timeout_precommit=30.0,
    timeout_commit=30.0, skip_timeout_commit=True,
)


@pytest.fixture(autouse=True)
def _isolated():
    sigcache.reset()
    with jax_sigcache.disabled():
        yield
    sigcache.reset()


def run(coro):
    return asyncio.run(coro)


# -- TxsMessage and the descriptor --


@pytest.mark.parametrize("seed", range(3))
def test_txs_message_bytes_equal_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(20):
        txs = tuple(rng.bytes(int(rng.integers(0, 300))) for _ in range(int(rng.integers(0, 70))))
        data = port_reactor.TxsMessage(txs=txs).to_proto()
        assert data == jax_reactor.TxsMessage(txs=txs).to_proto()
        # an empty tx is proto3's default and is not written, in both
        assert port_reactor.TxsMessage.from_proto(data).txs == jax_reactor.TxsMessage.from_proto(data).txs
        assert port_reactor.TxsMessage.from_proto(data).txs == tuple(t for t in txs if t)
    p = port_reactor.mempool_channel_descriptor(4096)
    j = jax_reactor.mempool_channel_descriptor(4096)
    fields = ("channel_id", "priority", "send_queue_capacity", "recv_message_capacity",
              "recv_buffer_capacity", "name")
    assert [getattr(p, f) for f in fields] == [getattr(j, f) for f in fields]
    assert port_reactor.MEMPOOL_CHANNEL == jax_reactor.MEMPOOL_CHANNEL == 0x30


# -- gossip between nodes --


def _jax_gossip_node(net, i: int, pool):
    priv = JaxPrivKey.from_seed(workloads.node_key(SEED, i).bytes()[:32])
    nid = jax_types.node_id_from_pubkey(priv.pub_key())
    addr = f"node{i}.mem:{i + 1}"
    info = jax_types.NodeInfo(node_id=nid, listen_addr=addr, network=CHAIN_ID, moniker=f"node{i}")
    pm = jax_pm.PeerManager(nid, jax_pm.PeerManagerOptions())
    router = jax_router.Router(info, priv, pm, jax_transport.MemoryTransport(net, addr),
                               listen_addr=addr, metrics=P2PMetrics(Registry()))
    ch = router.open_channel(jax_reactor.mempool_channel_descriptor(pool.cfg.max_tx_bytes))
    reactor = jax_reactor.MempoolReactor(pool, ch, pm.subscribe())
    return workloads.GossipNode(nid, pool, router, reactor, pm), addr


def _port_gossip_node(net, i: int, pool):
    addr = f"node{i}.mem:{i + 1}"
    node = workloads.gossip_node(pool, workloads.node_key(SEED, i), port_transport.MemoryTransport(net, addr),
                                 CHAIN_ID, listen_addr=addr, moniker=f"node{i}")
    return node, addr


async def _gossip(pkg: str, n_nodes: int, streams: dict) -> dict:
    """n_nodes of one package, fully meshed; streams[i] admitted at node
    i through check_tx_batch in batches of 64. Returns each pool's txs
    in arrival order and each receipt (receiver, sender, tx)."""
    if pkg == "jax":
        net = jax_transport.MemoryNetwork()
        pools = [JaxTxMempool(JaxLocalClient(JaxKVStore()), JaxMempoolConfig(size=2000),
                              metrics=MempoolMetrics(Registry())) for _ in range(n_nodes)]
        made = [_jax_gossip_node(net, i, p) for i, p in enumerate(pools)]
    else:
        net = port_transport.MemoryNetwork()
        pools = [workloads.kv_mempool(PortKVStore(), MempoolConfig(size=2000)) for _ in range(n_nodes)]
        made = [_port_gossip_node(net, i, p) for i, p in enumerate(pools)]
    nodes = [m[0] for m in made]
    receipts, sends, clock = [], [], itertools.count()
    for i, (pool, node) in enumerate(zip(pools, nodes)):
        inner, send = pool.check_tx_batch, node.reactor.channel.send

        async def receiving(txs, tx_info=None, _inner=inner, _i=i):
            if tx_info is not None and tx_info.sender_id:
                n = next(clock)
                receipts.extend((_i, tx_info.sender_id, tx, n) for tx in txs)
            return await _inner(txs, tx_info)

        async def sending(env, _send=send, _i=i):
            n = next(clock)
            sends.extend((_i, env.to, tx, n) for tx in env.message.txs)
            return await _send(env)

        pool.check_tx_batch = receiving
        node.reactor.channel.send = sending
    for i, a in enumerate(nodes):
        for b, (_, addr) in zip(nodes[i + 1:], made[i + 1:]):
            a.peer_manager.add(f"{b.node_id}@{addr}")
    for node in nodes:
        await node.start()
    try:
        for _ in range(500):
            if all(len(nd.peer_manager.peers()) == n_nodes - 1 for nd in nodes):
                break
            await asyncio.sleep(0.01)
        for i, txs in streams.items():
            for lo in range(0, len(txs), 64):
                outs = await pools[i].check_tx_batch(list(txs[lo : lo + 64]))
                assert all(getattr(o, "code", 1) == 0 for o in outs)
        total = sum(len(t) for t in streams.values())
        for _ in range(1000):
            if all(p.size() == total for p in pools):
                break
            await asyncio.sleep(0.01)
        await asyncio.sleep(0.05)
        ids = [nd.node_id for nd in nodes]
        return {
            "pools": [p.reap_max_txs(-1) for p in pools],
            "receipts": [(r, ids.index(s), tx, n) for r, s, tx, n in receipts],
            "sends": [(s, ids.index(to), tx, n) for s, to, tx, n in sends],
        }
    finally:
        for node in nodes:
            await node.stop()


def _no_echo(res) -> bool:
    """No node sent a tx to a peer it had already got that tx from."""
    first = {}
    for r, s, tx, n in res["receipts"]:
        first.setdefault((r, s, tx), n)
    return not any(first.get((s, to, tx), n) < n for s, to, tx, n in res["sends"])


@pytest.mark.parametrize("n_nodes", [2, 3])
def test_gossip_between_nodes_equal_jax(n_nodes):
    txs = workloads.kv_txs(SEED, 1, 300, (100, 300))
    streams = {0: txs[:200]} if n_nodes == 2 else {0: txs[:150], 2: txs[150:]}
    out = {pkg: run(_gossip(pkg, n_nodes, streams)) for pkg in ("jax", "port")}
    for pkg, res in out.items():
        assert all(sorted(p) == sorted(sum(streams.values(), [])) for p in res["pools"]), pkg
        assert _no_echo(res), pkg
    port, jax = out["port"], out["jax"]
    if n_nodes == 2:
        # one link: the receiver holds the sender's order, once each
        assert port == jax
        assert port["pools"][1] == streams[0]
        assert [tx for _r, _s, tx, _n in port["receipts"]] == streams[0]
    else:
        for p, j in zip(port["pools"], jax["pools"]):
            assert sorted(p) == sorted(j)


def test_drive_mempool_heights_gossips_and_reaps(tmp_path):
    """workloads.drive_mempool_heights at 4 validators: the node's block
    is the stream's txs in order, the full node is sent nothing back,
    the late txs end in the node's pool and every height is round 0."""
    privs = workloads.seeded_keys(4, SEED)
    genesis = workloads.kv_genesis(CHAIN_ID, privs)
    own = workloads.first_proposer_height(privs)
    import chip_smoke

    node_priv = chip_smoke.consensus_node_priv(privs, own + 1, own)
    gossiped = workloads.kv_txs(SEED + 1, own, 120, (100, 300))
    late = workloads.kv_txs(SEED + 1, own + 1, 30, (100, 300))
    txs = [gossiped if h == own else workloads.kv_txs(SEED, h, 20, (100, 300)) for h in range(1, own + 2)]
    chain = workloads.build_consensus_chain(genesis, privs, node_priv, txs, SEED, node_reaps=True)
    node = workloads.consensus_node(genesis, node_priv, str(tmp_path / "a"),
                                    ConsensusConfig(skip_timeout_commit=True, timeout_commit=0.2),
                                    mempool_cfg=MempoolConfig())
    pool_b = workloads.kv_mempool(PortKVStore(), MempoolConfig())
    echoed = []
    inner = pool_b.check_tx_batch

    async def counting(batch, tx_info=None):
        if tx_info is not None and tx_info.sender_id:
            echoed.extend(batch)
        return await inner(batch, tx_info)

    pool_b.check_tx_batch = counting
    try:
        res = run(workloads.drive_mempool_heights(node, pool_b, chain, gossiped, late, SEED, timeout_s=30))
        assert list(node.block_store.load_block(own).txs) == gossiped
        assert [r.round for r in res.runs] == [0] * len(chain)
        assert [o.code for o in res.outcomes] == [0] * len(gossiped)
        assert res.pool_end == late and echoed == []
        assert res.own_height_s > 0 and res.gossip_s > 0 and res.admit_s > 0
    finally:
        node.close()


# -- the proposer harness --


class JaxNode:
    """A JAX-package node with a TxMempool, like
    workloads.consensus_node(mempool_cfg=...): FilePV in home, WAL,
    evidence pool, event bus, the kvstore app, MemKV stores, private
    metrics registries."""

    def __init__(self, genesis_json: str, seed32: bytes, home: str):
        for d in ("config", "data"):
            os.makedirs(os.path.join(home, d), exist_ok=True)
        state = jax_state_from_genesis(JaxGenesisDoc.from_json(genesis_json))
        self.state_store = JaxStateStore(JaxMemKV())
        self.state_store.save(state)
        self.block_store = JaxBlockStore(JaxMemKV())
        self.evpool = JaxEvidencePool(
            JaxMemKV(), self.state_store, self.block_store, metrics=EvidenceMetrics(Registry())
        )
        self.event_bus = JaxEventBus()
        self.app = JaxKVStore()
        self.mempool = JaxTxMempool(JaxLocalClient(self.app), JaxMempoolConfig(),
                                    metrics=MempoolMetrics(Registry()))
        self.executor = JaxBlockExecutor(
            self.state_store, JaxLocalClient(self.app), self.mempool, self.evpool,
            self.block_store, self.event_bus, metrics=StateMetrics(Registry()),
        )
        self.privval = JaxFilePV.from_priv_key(
            JaxPrivKey.from_seed(seed32),
            os.path.join(home, "config", "priv_validator_key.json"),
            os.path.join(home, "data", "priv_validator_state.json"),
        )
        self.privval.save()
        metrics = ConsensusMetrics(Registry())
        with workloads.pinned_clock(lambda: 0):
            self.cs = JaxConsensusState(
                JaxConsensusConfig(**SLOW), state, self.executor, self.block_store,
                privval=self.privval, event_bus=self.event_bus,
                wal=JaxWAL(os.path.join(home, "data", "cs.wal", "wal")),
                evidence_pool=self.evpool, metrics=metrics,
                timeline=TimelineRecorder(enabled=False, metrics=metrics),
            )
        self.msgs = jax_msgs

    def close(self) -> None:
        pass


class Step:
    """The receive loop run by hand (tests/test_torch_consensus_state.py
    Step): a burst pre-verified, then each message handled after the own
    messages queued; own messages written with write_sync."""

    def __init__(self, node):
        self.node, self.cs, self.m = node, node.cs, node.msgs
        self.sent = []

    async def start(self) -> None:
        cs = self.cs
        cs.privval_pub_key = await cs.privval.get_pub_key()
        await cs.wal.start()
        await cs.ticker.start()
        await cs._catchup_replay(cs.rs.height)
        await self.own()

    async def stop(self) -> None:
        await self.cs.ticker.stop()
        await self.cs.wal.stop()

    async def own(self) -> None:
        q = self.cs.internal_msg_queue
        while not q.empty():
            mi = q.get_nowait()
            self.sent.append(self.m.encode_msg(mi.msg))
            self.cs.wal.write_sync(mi)
            await self.cs._handle_msg(mi)

    async def peers(self, wires) -> None:
        batch = [self.m.MsgInfo(msg=self.m.decode_msg(w), peer_id="peer") for w in wires]
        self.cs._preverify_votes(batch)
        for mi in batch:
            await self.own()
            self.cs.wal.write(mi)
            await self.cs._handle_msg(mi)
        await self.own()

    async def timeout(self, step: int, round_: int) -> None:
        rs = self.cs.rs
        ti = self.m.TimeoutInfo(duration_s=0.5, height=rs.height, round=round_, step=step)
        self.cs.wal.write(ti)
        await self.cs._handle_timeout(ti)
        await self.own()


def test_proposer_reaps_its_mempool_equal_jax(tmp_path):
    """Heights 1..own+1 at 6 validators (2 sr25519); the node's pool
    holds 40 txs before height 1 and proposes them at its height; 10
    late txs reach its pool after its proposal and stay through the
    recheck at its commit. Both packages leave the same bytes."""
    privs = workloads.seeded_keys(6, SEED, 2)
    genesis = workloads.kv_genesis(CHAIN_ID, privs)
    own = workloads.first_proposer_height(privs)
    import chip_smoke

    node_priv = chip_smoke.consensus_node_priv(privs, own + 1, own)
    pooled = workloads.kv_txs(SEED + 1, own, 40, (40, 90))
    late = workloads.kv_txs(SEED + 1, own + 1, 10, (40, 90))
    txs = [pooled if h == own else workloads.kv_txs(SEED, h, 8, (40, 90)) for h in range(1, own + 2)]
    chain = workloads.build_consensus_chain(genesis, privs, node_priv, txs, SEED, node_reaps=True)
    assert [ch.node_proposes for ch in chain].count(True) == 1
    out = {}
    port = workloads.consensus_node(genesis, node_priv, str(tmp_path / "port"), ConsensusConfig(**SLOW),
                                    mempool_cfg=MempoolConfig())
    port.msgs = port_msgs
    jax = JaxNode(genesis, node_priv.bytes()[:32], str(tmp_path / "jax"))
    for node in (port, jax):
        step = Step(node)
        recheck_sizes = []
        update = node.mempool.update

        async def updating(height, block_txs, responses, _pool=node.mempool, _update=update):
            await _update(height, block_txs, responses)
            recheck_sizes.append((height, _pool.size()))

        node.mempool.update = updating

        async def go():
            with workloads.pinned_clock(lambda: node.cs.rs.height):
                for lo in range(0, len(pooled), 16):
                    res = await node.mempool.check_tx_batch(pooled[lo : lo + 16])
                    assert all(r.code == 0 for r in res)
                await step.start()
                for ch in chain:
                    if ch.height == 1:
                        await step.timeout(RoundStep.NEW_HEIGHT, 0)
                    if ch.proposal is not None:
                        await step.peers([ch.proposal] + ch.parts)
                    if ch.height == own:
                        assert node.cs.rs.proposal is not None  # its own, made as it entered
                        await node.mempool.check_tx_batch(late)
                    for wires in (ch.prevotes, ch.precommits):
                        for i in range(0, len(wires), 256):
                            await step.peers(wires[i : i + 256])
                    assert node.cs.rs.height == ch.height + 1
                    assert node.block_store.load_seen_commit().round == 0
                await step.stop()

        run(go())
        bs = node.block_store
        out[node is port] = {
            "blocks": [bs.load_block(h).to_proto() for h in range(1, own + 2)],
            "metas": [bs.load_block_meta(h).to_proto() for h in range(1, own + 2)],
            "seen": bs.load_seen_commit().to_proto(),
            "state": node.state_store.load().to_proto(),
            "app_hash": node.app.app_hash,
            "own": step.sent,
            "end_heights": workloads.end_height_records(node.cs.wal.path),
            "pool": node.mempool.reap_max_txs(-1),
            "own_txs": list(bs.load_block(own).txs),
            "sizes": recheck_sizes,
        }
        node.close()
    assert out[True] == out[False]
    res = out[True]
    assert res["own_txs"] == pooled
    assert res["pool"] == late
    assert (own, len(late)) in res["sizes"]
    assert len(res["end_heights"]) == own + 1
