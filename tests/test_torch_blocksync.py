"""The port's block sync held against the JAX package's.

- the five messages: the same message gives the same wire bytes, and the
  same wire, seeded mutations of it among them (truncated, a bit
  flipped, a stray field, bytes spliced in, a byte set to 0xff), decodes
  to the same message or the same error;
- BlockPool: seeded sequences of actions (peer ranges, removals, bans,
  blocks added, pops, redos and peer picks, the RNG reseeded alike)
  leave equal fields after every action, and a started pool sends the
  same requests to the same peers;
- _verify_apply on a chain of 4 ed25519 validators (made by the port,
  carried as genesis JSON and block bytes): a block whose LastCommit has
  a flipped signature inside the first 2/3 of power is refused with the
  JAX message, bans the same peers with the same errors and drops the
  same blocks; the honest pair then applies to equal state bytes;
- a failed launch under verify_commit_light (a RuntimeError of the
  device verifier's dispatch) bans nobody and ends the pool routine:
  failure() returns it and stop() raises it, where the JAX package bans
  both peers; a DeviceFault is contained by the fault policy, the block
  applies and nobody is banned.

The four-validator localnets, in which fresh nodes block-sync and
state-sync, are in tests/test_torch_statesync.py. Every event loop runs
under a deadline over the whole body, stops included. Tolerance: zero.
"""

import asyncio

import numpy as np
import pytest

from tendermint_tpu import blocksync as jax_bs
from tendermint_tpu.blocksync import reactor as jax_bs_reactor
from tendermint_tpu.crypto import sigcache as jax_sigcache
from tendermint_tpu.libs import rng as jax_rng
from tendermint_tpu.p2p import channel as jax_channel
from tendermint_tpu.types.block import Block as JaxBlock
from tendermint_tpu_torch import blocksync as port_bs
from tendermint_tpu_torch import workloads
from tendermint_tpu_torch.blocksync import pool as port_pool
from tendermint_tpu_torch.crypto import faults, gpu_verifier
from tendermint_tpu_torch.libs import rng as port_rng
from tendermint_tpu_torch.ops.ed25519_kernel import Ed25519Verifier
from tendermint_tpu_torch.p2p import channel as port_channel

from .test_torch_execution import _JaxNode
from .test_torch_isolation import jax_device_plane_paused  # noqa: F401 (autouse)

CHAIN_ID = "torch-blocksync-chain"
SEED = 71
DEADLINE_S = 20.0


@pytest.fixture(autouse=True)
def _isolated():
    with jax_sigcache.disabled():
        yield
    port_rng.reseed(None)
    jax_rng.reseed(None)


def run(coro, deadline_s: float = DEADLINE_S):
    """asyncio.run with a deadline over the whole body, stops included."""
    return asyncio.run(asyncio.wait_for(coro, deadline_s))


def outcome(fn):
    try:
        return "ok", fn()
    except Exception as e:  # the outcome compared IS the exception
        return type(e).__name__, str(e)


def mutants(wire: bytes, seed: int, n: int) -> list:
    """n seeded mutations of wire: truncated, a bit flipped, a stray
    field appended, random bytes spliced in, a byte set to 0xff, the
    tail repeated."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        kind = i % 6
        w = bytearray(wire)
        if kind == 0:
            w = w[: int(rng.integers(0, len(w) + 1))]
        elif kind == 1 and w:
            at = int(rng.integers(0, len(w)))
            w[at] ^= 1 << int(rng.integers(0, 8))
        elif kind == 2:
            w += bytes([int(rng.integers(1, 16)) << 3 | int(rng.integers(0, 3))]) + rng.bytes(3)
        elif kind == 3:
            at = int(rng.integers(0, len(w) + 1))
            w[at:at] = rng.bytes(int(rng.integers(1, 6)))
        elif kind == 4 and w:
            w[int(rng.integers(0, len(w)))] = 0xFF
        else:
            w += w[len(w) // 2:]
        out.append(bytes(w))
    return out


def decoded(codec, wire: bytes):
    """The decode outcome as (message class, re-encoded bytes) or the
    error's type and text."""
    def go():
        msg = codec.decode(wire)
        return type(msg).__name__, codec.encode(msg)

    return outcome(go)


# -- a chain of 4 ed25519 validators, made by the port --


@pytest.fixture(scope="module")
def chain():
    privs = workloads.seeded_keys(4, SEED)
    genesis = workloads.kv_genesis(CHAIN_ID, privs)
    txs = [workloads.kv_txs(SEED, h, 6, (34, 90)) for h in range(1, 5)]
    return genesis, privs, workloads.build_block_chain(genesis, privs, txs, SEED)


def _messages(pkg, block_bytes: bytes):
    m = pkg
    block = (JaxBlock if pkg is jax_bs else port_bs.msgs.Block).from_proto(block_bytes)
    return [
        m.BlockRequestMessage(height=7),
        m.NoBlockResponseMessage(height=1 << 40),
        m.BlockResponseMessage(block=block),
        m.BlockResponseMessage(),
        m.StatusRequestMessage(),
        m.StatusResponseMessage(height=10, base=2),
    ]


def test_messages_encode_and_decode_equal_jax(chain):
    block_bytes = chain[2][1].block.to_proto()
    ports = _messages(port_bs, block_bytes)
    jaxes = _messages(jax_bs, block_bytes)
    n = 0
    for i, (p, j) in enumerate(zip(ports, jaxes)):
        wire = port_bs.BlocksyncCodec.encode(p)
        assert wire == jax_bs.BlocksyncCodec.encode(j)
        assert port_bs.BlocksyncCodec.decode(wire) == p
        for w in [wire] + mutants(wire, SEED + i, 60 if len(wire) < 100 else 24):
            got = decoded(port_bs.BlocksyncCodec, w)
            assert got == decoded(jax_bs.BlocksyncCodec, w), (i, w.hex()[:80])
            n += got[0] != "ok"
    assert n > 20  # the mutations reach the error paths
    for bad in (b"", b"\x32\x00", b"\x08\x01"):
        assert decoded(port_bs.BlocksyncCodec, bad) == decoded(jax_bs.BlocksyncCodec, bad)
    with pytest.raises(TypeError, match="unknown blocksync message"):
        port_bs.BlocksyncCodec.encode(object())


# -- BlockPool --


def _pool_fields(pool) -> tuple:
    return (
        pool.height,
        pool.max_peer_height,
        tuple((p.peer_id, p.height, p.base, p.banned) for p in pool.peers.values()),
        tuple(sorted((h, b.header.height, peer) for h, (b, peer) in pool._blocks.items())),
        tuple(sorted(pool._requesters)),
        pool.first_block_peer(),
        pool.second_block_peer(),
        tuple(b.header.height if b else None for b in pool.peek_two_blocks()),
    )


def _pool_actions(seed: int, count: int = 240) -> list:
    rng = np.random.default_rng(seed)
    peers = [f"peer{i}" for i in range(5)]
    out = []
    for _ in range(count):
        kind = rng.choice(7, p=(0.2, 0.05, 0.05, 0.3, 0.1, 0.05, 0.25))
        peer = peers[int(rng.integers(0, len(peers)))]
        h = int(rng.integers(1, 12))
        if kind == 0:
            out.append(("range", peer, int(rng.integers(0, 3)), int(rng.integers(0, 14))))
        elif kind == 1:
            out.append(("remove", peer))
        elif kind == 2:
            out.append(("ban", peer))
        elif kind == 3:
            out.append(("add", peer, h))
        elif kind == 4:
            out.append(("pop",))
        elif kind == 5:
            out.append(("redo", h))
        else:
            tried = tuple(p for p in peers if rng.random() < 0.3)
            out.append(("pick", h, tried))
    return out


def _run_pool(pkg: str, actions: list, blocks: dict) -> list:
    """The actions on an unstarted pool, a requester slot standing for
    each height 1..13 (as the started pool's routine makes them)."""
    mod = port_pool if pkg == "port" else jax_bs.pool
    (port_rng if pkg == "port" else jax_rng).reseed(SEED)
    pool = mod.BlockPool(1, lambda h, p: None)
    for h in range(1, 14):
        pool._requesters[h] = None
        pool._block_events[h] = asyncio.Event()
    out = []
    for a in actions:
        if a[0] == "range":
            pool.set_peer_range(a[1], a[2], a[3])
        elif a[0] == "remove":
            pool.remove_peer(a[1])
        elif a[0] == "ban":
            pool.ban_peer(a[1])
        elif a[0] == "add":
            pool.add_block(a[1], blocks[a[2]])
        elif a[0] == "pop":
            if pool.peek_two_blocks()[0] is not None:
                pool.pop_request()
                pool._requesters.setdefault(pool.height + 12, None)
        elif a[0] == "redo":
            pool.redo_request(a[1])
        else:
            picked = pool._pick_peer(a[1], set(a[2]))
            out.append(("picked", picked.peer_id if picked else None))
        out.append(_pool_fields(pool))
    return out


class _H:
    def __init__(self, height):
        self.height = height


class _B:
    """A block as the pool reads it: its header's height."""

    def __init__(self, height):
        self.header = _H(height)


@pytest.mark.parametrize("seed", [SEED, SEED + 1, SEED + 2])
def test_pool_action_sequences_equal_jax(seed):
    blocks = {h: _B(h) for h in range(1, 14)}
    actions = _pool_actions(seed)
    port = _run_pool("port", actions, blocks)
    jax = _run_pool("jax", actions, blocks)
    assert port == jax
    assert sum(1 for r in port if r[0] == "picked" and r[1] is not None) > 5


def _requests(pkg: str, seed: int) -> list:
    """A started pool of three peer ranges: the requests its requesters
    send, then those after a ban and a redo of height 2."""
    mod = port_pool if pkg == "port" else jax_bs.pool
    (port_rng if pkg == "port" else jax_rng).reseed(seed)
    sent = []

    async def go():
        pool = mod.BlockPool(1, lambda h, p: sent.append((h, p)))
        for i, height in enumerate((5, 7, 6)):
            pool.set_peer_range(f"peer{i}", 0, height)
        await pool.start()
        try:
            while len(sent) < 7:
                await asyncio.sleep(0.01)
            first = list(sent)
            for h in (1, 2, 3):
                pool.add_block(dict(sent)[h] if h in dict(sent) else "peer0", _B(h))
            pool.pop_request()
            pool.ban_peer(dict(first)[2])
            pool.redo_request(2)
            while len(sent) < len(first) + 1:
                await asyncio.sleep(0.01)
            return first, list(sent[len(first):]), _pool_fields(pool)
        finally:
            await pool.stop()

    return run(go())


@pytest.mark.parametrize("seed", [SEED, SEED + 5])
def test_started_pool_sends_the_same_requests_as_jax(seed):
    port = _requests("port", seed)
    jax = _requests("jax", seed)
    assert port == jax
    first, after, _ = port
    assert sorted(h for h, _ in first) == list(range(1, 8))
    assert after[0][0] == 2 and after[0][1] != dict(first)[2]


# -- _verify_apply: the forged LastCommit, a failed launch, a device fault --


def _forged(block_bytes: bytes, pkg: str, index: int = 0):
    """The block of block_bytes with its LastCommit's signature at index
    flipped (its header re-hashed over the forged commit)."""
    cls = JaxBlock if pkg == "jax" else port_bs.msgs.Block
    block = cls.from_proto(block_bytes)
    commit_cls = type(block.last_commit)
    commit = commit_cls.from_proto(block.last_commit.to_proto())
    sig = bytearray(commit.signatures[index].signature)
    sig[0] ^= 0x01
    commit.signatures[index].signature = bytes(sig)
    block.last_commit = commit
    block.header.last_commit_hash = commit.hash()
    return block


def _reactor(pkg: str, genesis: str):
    if pkg == "port":
        node = workloads.block_exec_node(genesis)
        ch = port_channel.Channel(port_bs.blocksync_channel_descriptor())
        reactor = port_bs.BlocksyncReactor(node.state, node.executor, node.block_store, ch,
                                           asyncio.Queue(), block_sync=False)
    else:
        node = _JaxNode(genesis)
        ch = jax_channel.Channel(jax_bs.blocksync_channel_descriptor())
        reactor = jax_bs.BlocksyncReactor(node.state, node.executor, node.block_store, ch,
                                          asyncio.Queue(), block_sync=False)
    return node, reactor


def _errors(ch) -> list:
    out = []
    while not ch.error_queue.empty():
        e = ch.error_queue.get_nowait()
        out.append((e.node_id, e.err))
    return out


def _sync_pair(pkg: str, genesis: str, chain, forged_first: bool):
    """Heights 1-2 through _verify_apply: height 1 from peer0 and a
    forged height 2 from peer1 (when forged_first), refused; then both
    again from peer2, applied. What each step left."""
    cls = JaxBlock if pkg == "jax" else port_bs.msgs.Block
    blocks = [cls.from_proto(cb.block.to_proto()) for cb in chain]

    async def go():
        node, reactor = _reactor(pkg, genesis)
        pool = reactor.pool
        for i in range(3):
            pool.set_peer_range(f"peer{i}", 0, len(chain))
        for h in range(1, len(chain) + 1):
            pool._requesters[h] = None
            pool._block_events[h] = asyncio.Event()
        steps = []
        if forged_first:
            pool.add_block("peer0", blocks[0])
            pool.add_block("peer1", _forged(chain[1].block.to_proto(), pkg))
            first, second = pool.peek_two_blocks()
            await reactor._verify_apply(first, second)
            steps.append((_pool_fields(pool), _errors(reactor.channel)))
        pool.add_block("peer2", blocks[0])
        pool.add_block("peer2", blocks[1])
        first, second = pool.peek_two_blocks()
        await reactor._verify_apply(first, second)
        steps.append((_pool_fields(pool), _errors(reactor.channel), node.state_store.load().to_proto(),
                      node.app.app_hash, node.block_store.load_block(1).to_proto()))
        return steps

    return run(go())


def test_forged_last_commit_bans_the_peers_jax_bans(chain):
    genesis, _privs, blocks = chain
    port = _sync_pair("port", genesis, blocks, True)
    jax = _sync_pair("jax", genesis, blocks, True)
    assert port == jax
    fields, errors = port[0]
    banned = {p for p, _h, _b, ban in fields[2] if ban}
    assert banned == {"peer0", "peer1"}
    assert [e[0] for e in errors] == ["peer0", "peer1"]
    assert all(e[1].startswith("bad block: wrong signature (#0)") for e in errors)
    assert fields[3] == ()  # both heights dropped for a refetch
    assert port[1][0][0] == 2  # then the honest pair applies height 1


def test_honest_pair_applies_on_the_device_plane_plain_versions(chain):
    genesis, _privs, blocks = chain
    want = _sync_pair("port", genesis, blocks, False)
    gpu_verifier.install(device="cpu", min_batch=2, gather_deadline_s=None)
    try:
        before = gpu_verifier.stats()
        got = _sync_pair("port", genesis, blocks, False)
        after = gpu_verifier.stats()
    finally:
        gpu_verifier.uninstall()
    assert got == want
    assert after["batches_ed25519"] == before["batches_ed25519"] + 1
    assert after["faults"] == before["faults"]


def _failed_launch(self, *args):
    raise RuntimeError("CUDA error: an illegal memory access was encountered")


def test_failed_launch_raises_from_the_pool_routine_and_bans_nobody(chain, monkeypatch):
    genesis, _privs, blocks = chain

    async def go():
        node, reactor = _reactor("port", genesis)
        pool = reactor.pool
        for i in range(2):
            pool.set_peer_range(f"peer{i}", 0, len(blocks))
        await reactor.start()
        await reactor._start_sync_routines()
        while 2 not in pool._requesters:
            await asyncio.sleep(0.01)
        pool.add_block("peer0", blocks[0].block)
        pool.add_block("peer1", blocks[1].block)
        while reactor.failure() is None:
            await asyncio.sleep(0.01)
        assert isinstance(reactor.failure(), RuntimeError)
        banned = [p.peer_id for p in pool.peers.values() if p.banned]
        with pytest.raises(RuntimeError, match="illegal memory access"):
            await reactor.stop()
        return banned, node.block_store.height()

    gpu_verifier.install(device="cpu", min_batch=2, gather_deadline_s=None)
    monkeypatch.setattr(Ed25519Verifier, "dispatch", _failed_launch)
    try:
        banned, stored = run(go())
    finally:
        gpu_verifier.uninstall()
    assert banned == [] and stored == 0

    # the JAX package bans both peers for the same error
    def jax_launch_error(*args):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(jax_bs_reactor, "verify_commit_light", jax_launch_error)

    async def jax_go():
        node, reactor = _reactor("jax", genesis)
        pool = reactor.pool
        for i in range(2):
            pool.set_peer_range(f"peer{i}", 0, len(blocks))
        for h in range(1, 3):
            pool._requesters[h] = None
            pool._block_events[h] = asyncio.Event()
        cls = JaxBlock
        pool.add_block("peer0", cls.from_proto(blocks[0].block.to_proto()))
        pool.add_block("peer1", cls.from_proto(blocks[1].block.to_proto()))
        await reactor._verify_apply(*pool.peek_two_blocks())
        return [p.peer_id for p in pool.peers.values() if p.banned]

    assert run(jax_go()) == ["peer0", "peer1"]


def test_device_fault_is_contained_and_bans_nobody(chain):
    genesis, _privs, blocks = chain
    want = _sync_pair("port", genesis, blocks, False)
    gpu_verifier.install(device="cpu", min_batch=2, gather_deadline_s=None)
    try:
        before = gpu_verifier.stats()
        with faults.inject("gpu.dispatch", "raise", times=1) as rule:
            got = _sync_pair("port", genesis, blocks, False)
        after = gpu_verifier.stats()
    finally:
        gpu_verifier.uninstall()
    assert rule.fired == 1
    assert after["faults"] == before["faults"] + 1
    assert got == want
    assert not any(ban for _p, _h, _b, ban in got[0][0][2])


def test_forged_commit_is_refused_with_the_jax_message_on_the_device_plane(chain):
    genesis, _privs, blocks = chain
    want = _sync_pair("jax", genesis, blocks, True)
    gpu_verifier.install(device="cpu", min_batch=2, gather_deadline_s=None)
    try:
        got = _sync_pair("port", genesis, blocks, True)
    finally:
        gpu_verifier.uninstall()
    assert got == want


def test_switch_to_consensus_publishes_and_hands_over(chain):
    """A pool caught up at the chain's tip: the reactor saves and applies
    the verified heights, publishes BlockSyncStatus and switches the
    consensus reactor on at the next height."""
    genesis, _privs, blocks = chain
    calls = []

    class _CS:
        def _reconstruct_last_commit_from_store(self, state):
            calls.append(("reconstruct", state.last_block_height))

        def _update_to_state(self, state):
            calls.append(("update", state.last_block_height))

    class _ConsensusReactor:
        cs = _CS()

        async def switch_to_consensus(self, state):
            calls.append(("switch", state.last_block_height))

    class _Bus:
        def publish_block_sync_status(self, data):
            calls.append(("status", data.complete, data.height))

    async def go():
        node, reactor = _reactor("port", genesis)
        reactor.consensus_reactor = _ConsensusReactor()
        reactor.event_bus = _Bus()
        monkey = port_pool._CAUGHT_UP_GRACE_S
        port_pool._CAUGHT_UP_GRACE_S = 0.0
        try:
            reactor.pool.set_peer_range("peer0", 0, len(blocks))
            await reactor.start()
            await reactor._start_sync_routines()
            while reactor.pool.height <= len(blocks) and not reactor.synced:
                for h, cb in enumerate(blocks, start=1):
                    if h in reactor.pool._requesters:
                        reactor.pool.add_block("peer0", cb.block)
                await asyncio.sleep(0.01)
            while reactor._pool_task is not None and not reactor._pool_task.done():
                await asyncio.sleep(0.01)
            assert reactor.failure() is None
            await reactor.stop()
        finally:
            port_pool._CAUGHT_UP_GRACE_S = monkey
        return node

    node = run(go())
    last = len(blocks) - 1
    assert calls == [("status", True, last), ("reconstruct", last), ("update", last), ("switch", last)]
    assert node.block_store.height() == last
    assert node.block_store.load_block(last).to_proto() == blocks[last - 1].block.to_proto()
    assert node.block_store.load_seen_commit().to_proto() == blocks[last].block.last_commit.to_proto()
