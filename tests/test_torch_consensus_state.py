"""The port's step machine held against the JAX package's.

Both packages' ConsensusState are driven through the same inputs: wire
bytes made by the port's harness (workloads.build_consensus_chain: a
seeded kvstore chain, each height's signed proposal and parts and every
other validator's prevote and precommit), or the votes of scripted
validators, or the messages of in-process peers. Each node's clock is
pinned (workloads.pinned_clock: time.time_ns() is a function of the
node's height), so each package's node writes the same bytes: blocks,
seen commits, state, app hash, its own votes and proposals, the WAL's
EndHeight records, its evidence. Tolerance: zero.

Most cases run the receive loop's steps by hand (`Step`: a burst is
pre-verified, then each message handled after any own message queued,
own messages written with write_sync), which is what the loop does with
one burst a turn, and fire the timeouts a case names; the timers
themselves never fire (30 s). The real loops run in
test_single_validator_heights_equal_jax and in the divergence cases.
Covered: tests/test_consensus_state.py's scenarios (a single validator's
heights, four validators over an in-process relay, a dropped proposal's
nil round, an invalid proposal prevoted nil, the WAL's EndHeight records
and a restart with catch-up replay), tests/test_consensus_lock.py's lock,
relock, unlock and POL cases, a 64-validator mixed set, a forged
proposal, an equivocation committed as evidence in a later block, and
the catches the port narrows (a launch error in apply_block reaches
wait_idle where the JAX package logs it; a non-check error of
validate_block at prevote does too, where the JAX package prevotes nil).

The JAX side runs on its CPU verifiers with its verified-signature
cache off and its metrics on private registries, so nothing is left in
the process for a later test; no socket is opened.
"""

import asyncio
import os
from types import SimpleNamespace

import pytest

from tendermint_tpu.abci.client import LocalClient as JaxLocalClient
from tendermint_tpu.abci.kvstore import KVStoreApplication as JaxKVStore
from tendermint_tpu.config import ConsensusConfig as JaxConsensusConfig
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
from tendermint_tpu.mempool.nop import NopMempool as JaxNopMempool
from tendermint_tpu.privval.file import FilePV as JaxFilePV
from tendermint_tpu.state.execution import BlockExecutor as JaxBlockExecutor
from tendermint_tpu.state.metrics import StateMetrics
from tendermint_tpu.state.store import StateStore as JaxStateStore
from tendermint_tpu.state.types import state_from_genesis as jax_state_from_genesis
from tendermint_tpu.store.block_store import BlockStore as JaxBlockStore
from tendermint_tpu.store.kv import MemKV as JaxMemKV
from tendermint_tpu.types.genesis import GenesisDoc as JaxGenesisDoc
from tendermint_tpu_torch import workloads
from tendermint_tpu_torch.config import ConsensusConfig
from tendermint_tpu_torch.consensus import msgs as port_msgs
from tendermint_tpu_torch.consensus.types import RoundStep
from tendermint_tpu_torch.crypto import breaker, gpu_verifier, sigcache
from tendermint_tpu_torch.types.block_id import BlockID, PartSetHeader
from tendermint_tpu_torch.types.canonical import PRECOMMIT_TYPE, PREVOTE_TYPE
from tendermint_tpu_torch.types.proposal import Proposal
from tendermint_tpu_torch.types.vote import Vote

from .test_torch_isolation import jax_device_plane_paused  # noqa: F401 (autouse)

CHAIN_ID = "torch-cs-chain"
SEED = 41
TXS = 6

# timers that never fire within a case: the cases fire timeouts by hand
SLOW = dict(
    timeout_propose=30.0, timeout_prevote=30.0, timeout_precommit=30.0,
    timeout_commit=30.0, skip_timeout_commit=True,
)
# a real loop's: height 1 starts 20 ms after the start
LOOP = dict(SLOW, timeout_commit=0.02)


@pytest.fixture(autouse=True)
def _isolated():
    sigcache.reset()
    with jax_sigcache.disabled():
        yield
    sigcache.reset()


def run(coro):
    return asyncio.run(coro)


# -- the two packages' nodes --


class JaxNode:
    """A JAX-package node like workloads.ConsensusNode: FilePV in home,
    WAL, evidence pool, event bus, the kvstore app, MemKV stores,
    private metrics registries."""

    def __init__(self, genesis_json: str, seed32: bytes, home: str, cfg_kw: dict):
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
        self.executor = JaxBlockExecutor(
            self.state_store, JaxLocalClient(self.app), JaxNopMempool(), self.evpool,
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
                JaxConsensusConfig(**cfg_kw), state, self.executor, self.block_store,
                privval=self.privval, event_bus=self.event_bus,
                wal=JaxWAL(os.path.join(home, "data", "cs.wal", "wal")),
                evidence_pool=self.evpool, metrics=metrics,
                timeline=TimelineRecorder(enabled=False, metrics=metrics),
            )
        self.msgs = jax_msgs

    def close(self) -> None:
        pass


def port_node(genesis_json: str, priv, home: str, cfg_kw: dict):
    node = workloads.consensus_node(genesis_json, priv, home, ConsensusConfig(**cfg_kw))
    node.msgs = port_msgs
    return node


def both_nodes(genesis_json, priv, tmp_path, name: str, cfg_kw=SLOW):
    """(port node, JAX node) of one validator key (ed25519)."""
    return (
        port_node(genesis_json, priv, str(tmp_path / f"port-{name}"), cfg_kw),
        JaxNode(genesis_json, priv.bytes()[:32], str(tmp_path / f"jax-{name}"), cfg_kw),
    )


def snapshot(node, heights) -> dict:
    """What the heights left on a node, as bytes."""
    out = {"state": node.state_store.load().to_proto(), "app_hash": node.app.app_hash}
    seen = node.block_store.load_seen_commit()
    out["seen_commit"] = seen.to_proto() if seen is not None else None
    for h in heights:
        block = node.block_store.load_block(h)
        out[h] = (block.to_proto(), node.block_store.load_block_meta(h).to_proto())
    return out


end_heights = workloads.end_height_records


# -- the receive loop's steps, by hand --


class Step:
    """One node's receive loop run by hand: `peers(wires)` handles one
    burst as the loop does (pre-verify, then each message after the own
    messages queued, each written to the WAL), `own()` the own messages
    queued, `timeout(step)` a timeout of the node's height and round;
    `sent` holds every own message's wire bytes, in order, and
    `outbox` those not yet relayed."""

    def __init__(self, node, peer_id: str = "peer"):
        self.node, self.cs, self.m = node, node.cs, node.msgs
        self.peer_id = peer_id
        self.sent, self.outbox = [], []

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
            self.outbox.append(self.sent[-1])
            self.cs.wal.write_sync(mi)
            await self.cs._handle_msg(mi)

    async def peers(self, wires, peer_id: str = None) -> None:
        batch = [self.m.MsgInfo(msg=self.m.decode_msg(w), peer_id=peer_id or self.peer_id) for w in wires]
        self.cs._preverify_votes(batch)
        for mi in batch:
            await self.own()
            self.cs.wal.write(mi)
            await self.cs._handle_msg(mi)
        await self.own()

    async def timeout(self, step: int, round_: int = None) -> None:
        rs = self.cs.rs
        ti = self.m.TimeoutInfo(duration_s=0.5, height=rs.height,
                                round=rs.round if round_ is None else round_, step=step)
        self.cs.wal.write(ti)
        await self.cs._handle_timeout(ti)
        await self.own()


async def feed(step: Step, ch, extra=(), burst: int = 256) -> None:
    """A harness height into a node run by hand, as drive_heights feeds
    it; the height 1 start timeout first."""
    if step.cs.rs.height == ch.height and step.cs.rs.step == RoundStep.NEW_HEIGHT and ch.height == 1:
        await step.timeout(RoundStep.NEW_HEIGHT, 0)
    head = list(extra) + ([ch.proposal] + ch.parts if ch.proposal is not None else [])
    if head:
        await step.peers(head)
    for wires in (ch.prevotes, ch.precommits):
        for i in range(0, len(wires), burst):
            await step.peers(wires[i : i + burst])


def _chain(n: int, n_sr: int, heights: int, proposes_at: int = 0, equivocate_at: int = 0, seed=SEED):
    privs = workloads.seeded_keys(n, seed, n_sr)
    genesis = workloads.kv_genesis(CHAIN_ID, privs)
    import chip_smoke

    node_priv = chip_smoke.consensus_node_priv(privs, heights, proposes_at)
    txs = [workloads.kv_txs(seed, h, TXS, (40, 90)) for h in range(1, heights + 1)]
    chain = workloads.build_consensus_chain(genesis, privs, node_priv, txs, seed, equivocate_at)
    return genesis, privs, node_priv, chain


def _forged(ch) -> bytes:
    p = port_msgs.decode_msg(ch.proposal).proposal
    sig = bytearray(p.signature)
    sig[5] ^= 0x04
    p.signature = bytes(sig)
    return port_msgs.encode_msg(port_msgs.ProposalMessage(p))


@pytest.mark.parametrize(
    "n, n_sr, proposes_at",
    [(4, 0, 3), (64, 32, 0)],
    ids=["4-ed25519-proposer-at-3", "64-mixed"],
)
def test_harness_heights_equal_jax(tmp_path, n, n_sr, proposes_at):
    """Three heights of the harness into both packages: a forged
    proposal ahead of the genuine one at height 2 is ignored, an
    equivocating precommit there becomes DuplicateVoteEvidence, which
    (4 validators) the node commits in the block it proposes at height
    3; every height commits in round 0 and leaves the same bytes."""
    genesis, privs, node_priv, chain = _chain(n, n_sr, 3, proposes_at, equivocate_at=2)
    extra = {2: [_forged(chain[1])]}
    out = {}
    for node in both_nodes(genesis, node_priv, tmp_path, f"h{n}"):
        step = Step(node)

        async def go():
            with workloads.pinned_clock(lambda: node.cs.rs.height):
                await step.start()
                for ch in chain:
                    await feed(step, ch, extra.get(ch.height, ()))
                    assert node.cs.rs.height == ch.height + 1
                    assert node.block_store.load_seen_commit().round == 0
                await step.stop()

        run(go())
        pending = node.evpool.pending_evidence(1 << 20)[0]
        out[node.msgs is port_msgs] = {
            **snapshot(node, (1, 2, 3)),
            "own": step.sent,
            "end_heights": end_heights(node.cs.wal.path),
            "pending": [ev.bytes() for ev in pending],
            "evidence_in_3": len(node.block_store.load_block(3).evidence),
        }
        node.close()
    port, jax = out[True], out[False]
    assert port == jax
    assert len(port["end_heights"]) == 3 and len(port["own"]) >= 6
    if proposes_at:
        assert port["evidence_in_3"] == 1 and port["pending"] == []
    else:
        assert port["evidence_in_3"] == 0 and len(port["pending"]) == 1


def test_single_validator_heights_equal_jax(tmp_path):
    """A single validator's real receive loop (its own proposals and
    votes, skip_timeout_commit) to height 4 in both packages, the clock
    pinned: the same blocks of heights 1-3, their metas and commits, the
    stored validator sets and the same EndHeight records."""
    priv = workloads.seeded_keys(1, SEED + 1)[0]
    genesis = workloads.kv_genesis(CHAIN_ID, [priv])
    out = {}
    for node in both_nodes(genesis, priv, tmp_path, "single", LOOP):
        async def go():
            with workloads.pinned_clock(lambda: node.cs.rs.height):
                await node.cs.start()
                try:
                    await node.cs.wait_for_height(4, timeout=30)
                finally:
                    await node.cs.stop()

        run(go())
        # the loop ran on past height 4: what heights 1-3 left
        bs = node.block_store
        out[node.msgs is port_msgs] = {
            "blocks": [bs.load_block(h).to_proto() for h in (1, 2, 3)],
            "metas": [bs.load_block_meta(h).to_proto() for h in (1, 2, 3)],
            "commits": [bs.load_block_commit(h).to_proto() for h in (1, 2)],
            "states": [node.state_store.load_validators(h).to_proto() for h in (1, 2, 3)],
            "end_heights": end_heights(node.cs.wal.path)[:3],
        }
        node.close()
    assert out[True] == out[False]
    assert len(out[True]["end_heights"]) == 3


def test_restart_replays_the_wal_as_jax(tmp_path):
    """Height 1 committed and height 2's proposal and prevotes handled,
    then the node stops (its WAL flushed) and a new node on the same
    stores and WAL replays height 2's inputs (catch-up replay): both
    packages stand in the same round state, sign the same own votes,
    and commit the same height 2."""
    genesis, privs, node_priv, chain = _chain(4, 0, 2)
    out = {}
    for pkg in ("port", "jax"):
        home = tmp_path / pkg
        node = (port_node(genesis, node_priv, str(home), SLOW) if pkg == "port"
                else JaxNode(genesis, node_priv.bytes()[:32], str(home), SLOW))
        step = Step(node)

        async def first():
            with workloads.pinned_clock(lambda: node.cs.rs.height):
                await step.start()
                await feed(step, chain[0])
                await step.peers([chain[1].proposal] + chain[1].parts)
                await step.peers(chain[1].prevotes)
                node.cs.wal.flush_and_sync()
                # the crash: the WAL's file closed unrepaired, nothing stopped
                node.cs.wal._f.close()
                node.cs.wal._f = None
                await node.cs.ticker.stop()

        run(first())
        # the restarted node: the same stores, a fresh app replayed to
        # the stored height (the JAX tests' stand-in for the handshake)
        if pkg == "port":
            node.close()
            node2 = _reopen_port(genesis, node_priv, str(home))
        else:
            node2 = _reopen_jax(node, genesis, node_priv, str(home))
        step2 = Step(node2)

        async def second():
            with workloads.pinned_clock(lambda: node2.cs.rs.height):
                await _replay_app(node2)
                await step2.start()
                rs = node2.cs.rs
                state = (rs.height, rs.round, rs.step, rs.locked_round,
                         rs.proposal_block.hash() if rs.proposal_block else None)
                for i in range(0, len(chain[1].precommits), 256):
                    await step2.peers(chain[1].precommits[i : i + 256])
                await step2.stop()
                return state

        state = run(second())
        out[pkg] = {"rs": state, "own": step.sent + step2.sent, **snapshot(node2, (1, 2))}
        node2.close()
    assert out["port"] == out["jax"]
    assert out["port"]["rs"][:3] == (2, 0, RoundStep.PRECOMMIT)


def _reopen_port(genesis, priv, home):
    """A port node on the stores and WAL a node left in home."""
    from tendermint_tpu_torch.abci.client import LocalClient
    from tendermint_tpu_torch.abci.kvstore import KVStoreApplication
    from tendermint_tpu_torch.consensus.state import ConsensusState
    from tendermint_tpu_torch.consensus.wal import WAL
    from tendermint_tpu_torch.eventbus import EventBus
    from tendermint_tpu_torch.evidence.pool import EvidencePool
    from tendermint_tpu_torch.mempool.nop import NopMempool
    from tendermint_tpu_torch.privval.file import FilePV
    from tendermint_tpu_torch.state.execution import BlockExecutor
    from tendermint_tpu_torch.state.store import StateStore
    from tendermint_tpu_torch.store.block_store import BlockStore
    from tendermint_tpu_torch.store.kv import SqliteKV

    data = os.path.join(home, "data")
    dbs = tuple(SqliteKV(os.path.join(data, f)) for f in
                ("state.sqlite", "blockstore.sqlite", "evidence.sqlite"))
    state_store, block_store = StateStore(dbs[0]), BlockStore(dbs[1])
    evpool = EvidencePool(dbs[2], state_store, block_store)
    app = KVStoreApplication()
    bus = EventBus()
    executor = BlockExecutor(state_store, LocalClient(app), NopMempool(), evpool, block_store, bus)
    privval = FilePV.load(os.path.join(home, "config", "priv_validator_key.json"),
                          os.path.join(data, "priv_validator_state.json"))
    with workloads.pinned_clock(lambda: 0):
        cs = ConsensusState(ConsensusConfig(**SLOW), state_store.load(), executor, block_store,
                            privval=privval, event_bus=bus,
                            wal=WAL(os.path.join(data, "cs.wal", "wal")), evidence_pool=evpool)
    node = workloads.ConsensusNode(cs, executor, state_store, block_store, evpool, bus,
                                   privval, app, home, dbs)
    node.msgs = port_msgs
    return node


def _reopen_jax(old, genesis, priv, home):
    node = SimpleNamespace(state_store=old.state_store, block_store=old.block_store,
                           evpool=old.evpool, event_bus=old.event_bus, msgs=jax_msgs,
                           close=lambda: None)
    node.app = JaxKVStore()
    node.executor = JaxBlockExecutor(
        old.state_store, JaxLocalClient(node.app), JaxNopMempool(), old.evpool,
        old.block_store, old.event_bus, metrics=StateMetrics(Registry()),
    )
    node.privval = JaxFilePV.load(os.path.join(home, "config", "priv_validator_key.json"),
                                  os.path.join(home, "data", "priv_validator_state.json"))
    metrics = ConsensusMetrics(Registry())
    with workloads.pinned_clock(lambda: 0):
        node.cs = JaxConsensusState(
            JaxConsensusConfig(**SLOW), old.state_store.load(), node.executor, old.block_store,
            privval=node.privval, event_bus=old.event_bus,
            wal=JaxWAL(os.path.join(home, "data", "cs.wal", "wal")), evidence_pool=old.evpool,
            metrics=metrics, timeline=TimelineRecorder(enabled=False, metrics=metrics),
        )
    return node


async def _replay_app(node) -> None:
    """Re-execute the stored blocks on the node's fresh app (the JAX
    tests' stand-in for the Handshaker, consensus/replay.py)."""
    abci = __import__(
        "tendermint_tpu_torch.abci.types" if node.msgs is port_msgs else "tendermint_tpu.abci.types",
        fromlist=["x"],
    )
    client = node.executor.app
    for h in range(1, node.block_store.height() + 1):
        block = node.block_store.load_block(h)
        await client.begin_block(abci.RequestBeginBlock(hash=block.hash()))
        for tx in block.txs:
            await client.deliver_tx(abci.RequestDeliverTx(tx=tx))
        await client.end_block(abci.RequestEndBlock(height=h))
        await client.commit()


# -- four validators over an in-process relay --


class Relay:
    """Four nodes of one package, every own message delivered to the
    other three, one message a burst, in one FIFO: the same order in
    both packages. `drop(wire)` suppresses a message's gossip."""

    def __init__(self, nodes, last_height: int):
        self.steps = [Step(n, peer_id=f"node{i}") for i, n in enumerate(nodes)]
        self.fifo = []
        self.drop = lambda wire: False
        self.last_height = last_height

    def _gossiped(self, wire) -> bool:
        """Not dropped, and of a height up to the last one run."""
        msg = port_msgs.decode_msg(wire)
        height = msg.proposal.height if isinstance(msg, port_msgs.ProposalMessage) else (
            msg.vote.height if isinstance(msg, port_msgs.VoteMessage) else msg.height)
        return height <= self.last_height and not self.drop(wire)

    def _collect(self) -> None:
        for i, st in enumerate(self.steps):
            for wire in st.outbox:
                if self._gossiped(wire):
                    self.fifo += [(j, wire, i) for j in range(len(self.steps)) if j != i]
            st.outbox.clear()

    async def settle(self) -> None:
        self._collect()
        while self.fifo:
            j, wire, i = self.fifo.pop(0)
            await self.steps[j].peers([wire], peer_id=f"node{i}")
            self._collect()

    async def fire_pending(self) -> None:
        """Each node's pending timeout (the ticker's last schedule)."""
        for st in self.steps:
            ti = st.cs.ticker._pending
            if ti is None:
                continue
            st.cs.ticker._stop_timer()
            st.cs.ticker._pending = None
            st.cs.wal.write(ti)
            await st.cs._handle_timeout(ti)
            await st.own()
        await self.settle()


def _four(tmp_path, name, seed, make_nodes_hook=None):
    privs = workloads.seeded_keys(4, seed)
    genesis = workloads.kv_genesis(CHAIN_ID, privs)
    out = {}
    for pkg in ("port", "jax"):
        nodes = [
            port_node(genesis, p, str(tmp_path / f"{pkg}-{name}-{i}"), SLOW) if pkg == "port"
            else JaxNode(genesis, p.bytes()[:32], str(tmp_path / f"{pkg}-{name}-{i}"), SLOW)
            for i, p in enumerate(privs)
        ]
        if make_nodes_hook:
            make_nodes_hook(pkg, nodes)
        out[pkg] = nodes
    return out


async def _run_relay(relay: Relay, height: int) -> None:
    for st in relay.steps:
        await st.start()
    for st in relay.steps:
        await st.timeout(RoundStep.NEW_HEIGHT, 0)
    await relay.settle()
    for _ in range(12):
        if all(st.cs.rs.height > height for st in relay.steps):
            break
        await relay.fire_pending()
    for st in relay.steps:
        await st.stop()


def _relay_outcome(relay: Relay, heights) -> list:
    return [
        {**snapshot(st.node, heights), "own": st.sent, "end_heights": end_heights(st.cs.wal.path)}
        for st in relay.steps
    ]


def _drop_proposal_at(height: int):
    def drop(wire) -> bool:
        msg = port_msgs.decode_msg(wire)
        if isinstance(msg, port_msgs.ProposalMessage):
            return msg.proposal.height == height and msg.proposal.round == 0
        if isinstance(msg, port_msgs.BlockPartMessage):
            return msg.height == height and msg.round == 0
        return False

    return drop


@pytest.mark.parametrize("case", ["clean", "dropped_proposal", "invalid_proposal"])
def test_four_validators_relay_equal_jax(tmp_path, case):
    """Four validators of each package over the relay to height 3:
    clean, every height in round 0; with height 2's round-0 proposal
    and parts never gossiped, the others prevote and precommit nil at
    their timeouts and height 2 commits in round 1; with the round-0
    proposal at height 2 carrying a wrong app hash, every validator
    (the proposer too) prevotes it nil and height 2 commits in round 1.
    Every node's blocks, seen commit, state, own messages and EndHeight
    records equal the JAX package's."""

    def corrupt(pkg, nodes):
        if case != "invalid_proposal":
            return
        for n in nodes:
            orig = n.executor.create_proposal_block

            def create(height, state, commit, proposer, _orig=orig, _n=n):
                block, parts = _orig(height, state, commit, proposer)
                if height == 2 and _n.cs.rs.round == 0:
                    block.header.app_hash = b"\xbd" * 32
                    block.fill_header()
                    parts = block.make_part_set()
                return block, parts

            n.executor.create_proposal_block = create

    nodes = _four(tmp_path, case, SEED + 7, corrupt)
    out = {}
    for pkg, ns in nodes.items():
        relay = Relay(ns, 3)
        if case == "dropped_proposal":
            relay.drop = _drop_proposal_at(2)

        async def go():
            with workloads.pinned_clock(lambda: min(st.cs.rs.height for st in relay.steps)):
                await _run_relay(relay, 3)

        run(go())
        out[pkg] = _relay_outcome(relay, (1, 2, 3))
    assert out["port"] == out["jax"]
    seen2 = [n.block_store.load_block_commit(2).round for n in nodes["port"]]
    assert seen2 == [0 if case == "clean" else 1] * 4


# -- locks: one real validator (cs1, height 1's round-0 proposer) and
# three scripted ones (tests/test_consensus_lock.py's cells) --

_UNKNOWN = BlockID(b"\xc0" * 32, PartSetHeader(1, b"\xc1" * 32))
_LOCK_CASES = {
    # TestStateLockNoPOL: locked on B1, cs1 prevotes B1 in round 1 at
    # its propose timeout (no proposal); two nil prevotes are +2/3 any
    # but no majority: a nil precommit at the prevote-wait timeout, the
    # lock kept
    "lock_no_pol": [("prevote", 0, "b1", 2), ("precommit", 0, "nil", 2), ("timeout",),
                    ("timeout",), ("prevote", 1, "nil", 2), ("timeout",)],
    # TestStateLockPOLRelock: a round-1 POL for B1 (no proposal in
    # round 1: cs1 precommits at its prevote-wait timeout) relocks, and
    # the height commits in round 1
    "relock": [("prevote", 0, "b1", 2), ("precommit", 0, "nil", 2), ("timeout",),
               ("timeout",), ("prevote", 1, "b1", 2), ("timeout",), ("precommit", 1, "b1", 2)],
    # TestStateLockPOLUnlock: a round-1 nil polka unlocks
    "unlock_nil_polka": [("prevote", 0, "b1", 2), ("precommit", 0, "nil", 2), ("timeout",),
                         ("timeout",), ("prevote", 1, "nil", 3)],
    # the same polka delivered while cs1 is still in round 0
    "unlock_before_round_entry": [("prevote", 0, "b1", 2), ("prevote", 1, "nil", 3),
                                  ("timeout",)],
    # TestStateLockPOLUnlockOnUnknownBlock
    "unlock_unknown_block": [("prevote", 0, "b1", 2), ("precommit", 0, "nil", 2), ("timeout",),
                             ("timeout",), ("prevote", 1, "unknown", 3)],
    # a round-1 POL for the round-1 proposer's block C moves the lock
    "lock_switches_on_higher_pol": [("prevote", 0, "b1", 2), ("precommit", 0, "nil", 2),
                                    ("timeout",), ("proposal_c", 1), ("prevote", 1, "c", 3),
                                    ("precommit", 1, "c", 3)],
}


async def _lock_script(step: Step, privs, node_priv, genesis, script) -> list:
    """Run one cell on a node run by hand; after each action, cs1's new
    own messages and its round, step, lock, valid block and proposal."""
    from tendermint_tpu_torch.state.types import state_from_genesis
    from tendermint_tpu_torch.types.commit import Commit
    from tendermint_tpu_torch.types.genesis import GenesisDoc

    cs = step.cs
    stubs = [p for p in privs if p is not node_priv]
    ids = {"nil": BlockID(), "unknown": _UNKNOWN}
    trace, mark = [], 0

    def sign_vote(priv, vtype, round_, block_id):
        idx, _ = cs.rs.validators.get_by_address(priv.pub_key().address())
        vote = Vote(type=vtype, height=1, round=round_, block_id=block_id,
                    timestamp_ns=workloads.clock_at(1) + idx, validator_address=priv.pub_key().address(),
                    validator_index=idx)
        vote.signature = priv.sign(vote.sign_bytes(CHAIN_ID))
        return port_msgs.encode_msg(port_msgs.VoteMessage(vote))

    await step.start()
    await step.timeout(RoundStep.NEW_HEIGHT, 0)
    own_prevote = next(port_msgs.decode_msg(w).vote for w in step.sent
                       if isinstance(port_msgs.decode_msg(w), port_msgs.VoteMessage))
    ids["b1"] = own_prevote.block_id
    for action in script:
        kind = action[0]
        if kind in ("prevote", "precommit"):
            _, round_, target, n = action
            vtype = PREVOTE_TYPE if kind == "prevote" else PRECOMMIT_TYPE
            await step.peers([sign_vote(p, vtype, round_, ids[target]) for p in stubs[:n]])
        elif kind == "timeout":
            ti = cs.ticker._pending
            cs.ticker._stop_timer()
            cs.ticker._pending = None
            cs.wal.write(ti)
            await cs._handle_timeout(ti)
            await step.own()
        else:  # the round's proposer (a scripted validator) proposes C
            round_ = action[1]
            proposer = cs.rs.validators.get_proposer().address
            priv = next(p for p in stubs if p.pub_key().address() == proposer)
            state = state_from_genesis(GenesisDoc.from_json(genesis))
            block, parts = state.make_block(1, [], Commit(height=0, round=0, block_id=BlockID(),
                                                          signatures=[]), [], proposer)
            ids["c"] = BlockID(block.hash(), parts.header())
            p = Proposal(height=1, round=round_, pol_round=-1, block_id=ids["c"],
                         timestamp_ns=workloads.clock_at(1))
            p.signature = priv.sign(p.sign_bytes(CHAIN_ID))
            await step.peers([port_msgs.encode_msg(port_msgs.ProposalMessage(p))] + [
                port_msgs.encode_msg(port_msgs.BlockPartMessage(1, round_, parts.get_part(i)))
                for i in range(parts.total)])
        rs = cs.rs
        trace.append({
            "own": step.sent[mark:],
            "hrs": (rs.height, rs.round, rs.step),
            "locked": (rs.locked_round, rs.locked_block.hash() if rs.locked_block else None),
            "valid": (rs.valid_round, rs.valid_block.hash() if rs.valid_block else None),
            "proposal": rs.proposal_block.hash() if rs.proposal_block else None,
            "parts": rs.proposal_block_parts.header().to_proto() if rs.proposal_block_parts else None,
        })
        mark = len(step.sent)
    await step.stop()
    return trace


@pytest.mark.parametrize("cell", sorted(_LOCK_CASES))
def test_lock_cells_equal_jax(tmp_path, cell):
    """Each lock, relock, unlock and POL cell of
    tests/test_consensus_lock.py driven into both packages: cs1's own
    votes (wire bytes), its round and step, its locked and valid blocks
    and its proposal after every action are the JAX package's."""
    privs = workloads.seeded_keys(4, SEED + 11)
    genesis = workloads.kv_genesis(CHAIN_ID, privs)
    import chip_smoke

    node_priv = chip_smoke.consensus_node_priv(privs, 1, 1)
    out = {}
    for node in both_nodes(genesis, node_priv, tmp_path, cell):
        step = Step(node)

        async def go():
            with workloads.pinned_clock(lambda: node.cs.rs.height):
                return await _lock_script(step, privs, node_priv, genesis, _LOCK_CASES[cell])

        out[node.msgs is port_msgs] = run(go())
        node.close()
    assert out[True] == out[False]
    last = out[True][-1]
    if cell in ("lock_no_pol",):
        assert last["locked"][0] == 0
    if cell.startswith("unlock"):
        assert last["locked"] == (-1, None)
    if cell == "relock":
        assert last["hrs"][0] == 2  # committed in round 1
    if cell == "lock_switches_on_higher_pol":
        assert out[True][-2]["locked"][0] == 1 and last["hrs"][0] == 2


# -- the catches the port narrows --


def _wait_probes():
    for route in gpu_verifier.ROUTES:
        t = breaker.breaker_for(route)._probe_thread
        if t is not None:
            t.join(10.0)
            assert not t.is_alive()


def _launch_error_in(owner, attr: str, during, message: str):
    """owner.attr raises RuntimeError(message) while during[0] is set."""
    inner = getattr(owner, attr)

    def wrapper(self, *args):
        if during[0]:
            raise RuntimeError(message)
        return inner(self, *args)

    return wrapper


LAUNCH_ERROR = "CUDA error: an illegal memory access was encountered"


def test_launch_error_in_apply_block_reaches_wait_idle_where_jax_logs_it(tmp_path, monkeypatch):
    """A launch error inside apply_block (the LastCommit's device window
    at height 2 fails with a CUDA error that is not a DeviceFault): the
    port's receive loop ends and drive_heights' wait_idle raises it; the
    JAX package's _handle_msg logs it (consensus/state.py:508) and its
    node stays at height 2 with the block stored and EndHeight written."""
    from tendermint_tpu.state import execution as jax_execution
    from tendermint_tpu_torch.ops.ed25519_kernel import Ed25519Verifier

    genesis, privs, node_priv, chain = _chain(4, 0, 2)
    during = [False]
    port, jax = both_nodes(genesis, node_priv, tmp_path, "launch", LOOP)
    for node in (port, jax):
        inner = node.executor.apply_block

        async def apply(state, block_id, block, _inner=inner):
            during[0] = block.header.height == 2
            try:
                return await _inner(state, block_id, block)
            finally:
                during[0] = False

        node.executor.apply_block = apply
    # the port: the device plane (plain versions), the 4-signature
    # LastCommits on it (a burst's 3 peer votes below its gate)
    gpu_verifier.install(device="cpu", min_batch=4, gather_deadline_s=None)
    try:
        _wait_probes()
        monkeypatch.setattr(Ed25519Verifier, "dispatch",
                            _launch_error_in(Ed25519Verifier, "dispatch", during, LAUNCH_ERROR))
        # the counter runs since the process started: none contained here
        before = gpu_verifier.stats()["faults"]
        with pytest.raises(RuntimeError, match="illegal memory access"):
            run(workloads.drive_heights(port, chain))
        assert gpu_verifier.stats()["faults"] == before
    finally:
        gpu_verifier.uninstall()
    assert port.block_store.height() == 2 and port.cs.rs.height == 2
    port.close()
    # the JAX package: the same error at its verify_commit, logged
    real = jax_execution.verify_commit

    def verify_commit(*args):
        if during[0]:
            raise RuntimeError(LAUNCH_ERROR)
        return real(*args)

    monkeypatch.setattr(jax_execution, "verify_commit", verify_commit)
    step = Step(jax)

    async def go():
        with workloads.pinned_clock(lambda: jax.cs.rs.height):
            await step.start()
            for ch in chain:
                await feed(step, ch)
            await step.stop()

    run(go())
    assert jax.block_store.height() == 2 and jax.cs.rs.height == 2
    assert len(end_heights(jax.cs.wal.path)) == 2


def test_runtime_error_of_validate_block_at_prevote_is_not_a_nil_prevote(tmp_path):
    """A non-check error of validate_block at prevote (a launch error):
    the JAX package prevotes nil (consensus/state.py:716); the port's
    do_prevote lets it through. A check error (the invalid proposal of
    test_four_validators_relay_equal_jax) is a nil prevote in both."""
    genesis, privs, node_priv, chain = _chain(4, 0, 1)
    out = {}
    for node in both_nodes(genesis, node_priv, tmp_path, "prevote"):
        inner = node.executor.validate_block

        def validate(state, block, _inner=inner):
            raise RuntimeError(LAUNCH_ERROR)

        node.executor.validate_block = validate
        step = Step(node)

        async def go():
            with workloads.pinned_clock(lambda: node.cs.rs.height):
                await step.start()
                await step.timeout(RoundStep.NEW_HEIGHT, 0)
                try:
                    await step.peers([chain[0].proposal] + chain[0].parts)
                except RuntimeError as e:
                    return str(e)
                finally:
                    await step.stop()
                return [port_msgs.decode_msg(w).vote.block_id.is_zero() for w in step.sent]

        out[node.msgs is port_msgs] = run(go())
        node.close()
    assert out[False] == [True]  # the JAX package: one prevote, for nil
    assert out[True] == LAUNCH_ERROR


def test_device_fault_in_the_step_machine_is_contained(tmp_path):
    """A DeviceFault at a window's dispatch (crypto/faults.py
    gpu.dispatch) inside the step machine is contained by the device
    verifier's fault policy: the height commits in round 0 and leaves
    the bytes it leaves on the native CPU plane."""
    from tendermint_tpu_torch.crypto import faults

    genesis, privs, node_priv, chain = _chain(4, 0, 2)
    out = {}
    for name in ("faulted", "cpu"):
        node = port_node(genesis, node_priv, str(tmp_path / name), LOOP)
        if name == "faulted":
            # the 4-signature LastCommits on the device plane's plain
            # versions, a burst's 3 peer votes below the gate
            gpu_verifier.install(device="cpu", min_batch=4, gather_deadline_s=None)
            _wait_probes()
        try:
            before = gpu_verifier.stats()["faults"]
            with faults.inject("gpu.dispatch", "raise", times=1) as rule:
                runs = run(workloads.drive_heights(node, chain))
            if name == "faulted":
                assert rule.fired == 1 and gpu_verifier.stats()["faults"] == before + 1
        finally:
            gpu_verifier.uninstall()
            breaker.reset_all()
        assert [r.round for r in runs] == [0, 0]
        out[name] = {**snapshot(node, (1, 2)), "end_heights": node.end_heights()}
        node.close()
    assert out["faulted"] == out["cpu"]


def test_signer_refusal_is_logged_and_nothing_signed_as_jax(tmp_path):
    """The node's FilePV has signed another prevote at height 1, round
    0: its prevote is refused ("conflicting data"), logged, and nothing
    is sent in both packages (consensus/state.py:1258); its precommit
    still follows the others' prevotes."""
    genesis, privs, node_priv, chain = _chain(4, 0, 1)
    out = {}
    for node in both_nodes(genesis, node_priv, tmp_path, "signer"):
        pv = node.privval
        lss = pv.last_sign_state
        lss.height, lss.round, lss.step = 1, 0, 2
        lss.sign_bytes = b"\x05other"
        lss.signature = b"\x01" * 64
        lss.save()
        step = Step(node)

        async def go():
            with workloads.pinned_clock(lambda: node.cs.rs.height):
                await step.start()
                await feed(step, chain[0])
                await step.stop()

        run(go())
        out[node.msgs is port_msgs] = {"own": step.sent, **snapshot(node, (1,))}
        node.close()
    assert out[True] == out[False]
    votes = [port_msgs.decode_msg(w).vote for w in out[True]["own"]]
    assert [v.type for v in votes] == [PRECOMMIT_TYPE]
