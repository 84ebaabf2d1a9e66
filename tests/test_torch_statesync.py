"""The port's state sync, the kvstore app's snapshots and the stores'
state-sync writes, held against the JAX package's.

- the eight messages: the same message gives the same wire bytes, and
  the same wire, seeded mutations among them, decodes to the same
  message or the same error;
- the chunk queue and _apply_chunks: tests/test_statesync.py's seven
  chunk cases (the spool, refetch and retry, memory independent of the
  snapshot's size, a terminal result before any refetch, an out-of-range
  refetch, rejected senders refetched, the real fetch path skipping
  them) run on both packages' reactors with the same scripted app, and
  the app's calls, the fetches and the outcomes are equal;
- the kvstore app: snapshots every 2 heights of seeded txs give equal
  listings, blobs and chunks, and a restore chunk by chunk (also out of
  order, corrupt, unoffered, of a wrong format) equal results and app
  hashes;
- StateStore.bootstrap and save_validators and
  BlockStore.save_signed_header write the same bytes under the same
  keys;
- backfill stores the same signed headers and validator sets below a
  restored height; a peer whose light block has a flipped signature is
  passed over for the next one in both packages; a failed launch under
  its commit check raises to backfill()'s caller, where the JAX package
  passes the peer over; a DeviceFault is contained and the height
  stored;
- a four-validator localnet of each package (p2ptest.TestNetwork, MemKV,
  MockPV), in which a fresh node block-syncs from genesis and follows
  consensus, and another state-syncs a snapshot through the embedded
  light client, backfills the headers below it, block-syncs and
  follows: each fresh node's blocks equal its validators', and the txs
  and app hashes of every height equal across the packages (the clock
  is not pinned, so block hashes are compared within a package).

JAX nodes run on private metrics registries, with their
verified-signature cache off. Every event loop runs under a deadline
over the whole body, stops included; no socket is opened. Tolerance:
zero.
"""

import asyncio
import os

import numpy as np
import pytest

from tendermint_tpu import statesync as jax_ss
from tendermint_tpu.abci import types as jax_abci
from tendermint_tpu.abci.client import LocalClient as JaxLocalClient
from tendermint_tpu.abci.kvstore import KVStoreApplication as JaxKVStore
from tendermint_tpu.blocksync import BlocksyncReactor as JaxBlocksyncReactor
from tendermint_tpu.blocksync import blocksync_channel_descriptor as jax_bs_descriptor
from tendermint_tpu.config import StateSyncConfig as JaxStateSyncConfig
from tendermint_tpu.crypto import sigcache as jax_sigcache
from tendermint_tpu.crypto.ed25519 import PrivKeyEd25519 as JaxPrivKey
from tendermint_tpu.libs import rng as jax_rng
from tendermint_tpu.p2p import p2ptest as jax_p2ptest
from tendermint_tpu.state.store import StateStore as JaxStateStore
from tendermint_tpu.state.types import State as JaxState
from tendermint_tpu.statesync import chunks as jax_chunks
from tendermint_tpu.statesync import reactor as jax_ss_reactor
from tendermint_tpu.store.block_store import BlockStore as JaxBlockStore
from tendermint_tpu.store.kv import MemKV as JaxMemKV
from tendermint_tpu.types.block_id import BlockID as JaxBlockID
from tendermint_tpu.types.light import LightBlock as JaxLightBlock
from tendermint_tpu.types.light import SignedHeader as JaxSignedHeader
from tendermint_tpu.types.validator import ValidatorSet as JaxValidatorSet
from tendermint_tpu_torch import statesync as port_ss
from tendermint_tpu_torch import workloads
from tendermint_tpu_torch.abci import types as port_abci
from tendermint_tpu_torch.abci.client import LocalClient
from tendermint_tpu_torch.abci.kvstore import KVStoreApplication
from tendermint_tpu_torch.blocksync import BlocksyncReactor, blocksync_channel_descriptor
from tendermint_tpu_torch.config import StateSyncConfig
from tendermint_tpu_torch.crypto import faults, gpu_verifier
from tendermint_tpu_torch.libs import rng as port_rng
from tendermint_tpu_torch.light.provider import LocalProvider
from tendermint_tpu_torch.ops.ed25519_kernel import Ed25519Verifier
from tendermint_tpu_torch.p2p import p2ptest as port_p2ptest
from tendermint_tpu_torch.state.store import StateStore
from tendermint_tpu_torch.statesync import chunks as port_chunks
from tendermint_tpu_torch.statesync import reactor as port_ss_reactor
from tendermint_tpu_torch.store.block_store import BlockStore
from tendermint_tpu_torch.store.kv import MemKV
from tendermint_tpu_torch.types.block_id import BlockID

from .test_torch_blocksync import decoded, mutants, outcome, run
from .test_torch_consensus_reactor import CHAIN_ID as LOCALNET_CHAIN
from .test_torch_consensus_reactor import _genesis, _JaxNode, _PortNode, _txs
from .test_torch_execution import _replay_port
from .test_torch_isolation import jax_device_plane_paused  # noqa: F401 (autouse)

CHAIN_ID = "torch-statesync-chain"
SEED = 83
# the localnet's genesis time is workloads.BASE_TIME_NS, in the past:
# the trust root (height 1, at the genesis time) must stay trusted
TRUST_PERIOD_S = 10 * 365 * 24 * 3600.0


@pytest.fixture(autouse=True)
def _isolated():
    with jax_sigcache.disabled():
        yield
    port_rng.reseed(None)
    jax_rng.reseed(None)


PKGS = {
    "port": (port_ss, port_ss_reactor, port_chunks, port_abci),
    "jax": (jax_ss, jax_ss_reactor, jax_chunks, jax_abci),
}


# -- messages --


def _messages(pkg: str, lb_bytes: bytes):
    ss = PKGS[pkg][0]
    lb_cls = JaxLightBlock if pkg == "jax" else port_ss.msgs.LightBlock
    return [
        ss.SnapshotsRequestMessage(),
        ss.SnapshotsResponseMessage(height=5, format=1, chunks=3, hash=b"\x01" * 32, metadata=b"m"),
        ss.ChunkRequestMessage(height=5, format=1, index=2),
        ss.ChunkResponseMessage(height=5, format=1, index=2, chunk=b"data" * 9),
        ss.ChunkResponseMessage(height=5, format=1, index=0, missing=True),
        ss.LightBlockRequestMessage(height=9),
        ss.LightBlockResponseMessage(light_block=lb_cls.from_proto(lb_bytes)),
        ss.LightBlockResponseMessage(),
        ss.ParamsRequestMessage(height=4),
        ss.ParamsResponseMessage(height=4, consensus_params=b"\x0a\x02\x08\x01"),
    ]


@pytest.fixture(scope="module")
def served():
    """A chain of 6 heights of 4 ed25519 validators, made and applied by
    the port: (genesis, privs, blocks, the node holding its stores)."""
    privs = workloads.seeded_keys(4, SEED)
    genesis = workloads.kv_genesis(CHAIN_ID, privs)
    txs = [workloads.kv_txs(SEED, h, 5, (34, 90)) for h in range(1, 7)]
    blocks = workloads.build_block_chain(genesis, privs, txs, SEED)
    _records, node, _state = _replay_port(genesis, blocks)
    return genesis, privs, blocks, node


def _light_block(node, height: int):
    return run(LocalProvider(node.block_store, node.state_store).light_block(height))


def test_messages_encode_and_decode_equal_jax(served):
    lb_bytes = _light_block(served[3], 3).to_proto()
    n = 0
    codecs = (port_ss.StatesyncCodec, jax_ss.StatesyncCodec)
    for i, (p, j) in enumerate(zip(_messages("port", lb_bytes), _messages("jax", lb_bytes))):
        wire = codecs[0].encode(p)
        assert wire == codecs[1].encode(j)
        assert codecs[0].encode(codecs[0].decode(wire)) == wire
        for w in [wire] + mutants(wire, SEED + i, 48 if len(wire) < 100 else 24):
            got = decoded(codecs[0], w)
            assert got == decoded(codecs[1], w), (i, w.hex()[:80])
            n += got[0] != "ok"
    assert n > 20
    for bad in (b"", b"\x4a\x00", b"\x08\x01"):
        assert decoded(codecs[0], bad) == decoded(codecs[1], bad)


# -- the chunk queue and _apply_chunks (tests/test_statesync.py's seven) --


def _bare_reactor(pkg: str):
    _ss, mod, _chunks, _abci = PKGS[pkg]
    return mod.StatesyncReactor(
        CHAIN_ID, None, None, None, None,
        {c: None for c in (mod.SNAPSHOT_CHANNEL, mod.CHUNK_CHANNEL, mod.LIGHT_BLOCK_CHANNEL,
                           mod.PARAMS_CHANNEL)},
        asyncio.Queue(),
    )


def _spool(pkg: str, tmp_path) -> list:
    tmp_path.mkdir()
    q = PKGS[pkg][2].ChunkQueue(3, dir=str(tmp_path))
    out = []
    try:
        out.append(q.put(0, b"a" * 100, sender="p1"))
        out.append(q.put(0, b"zzz", sender="p2"))
        out.append(q.put(1, b"b" * 100, sender="p2"))
        out.append(q.put(2, b"c" * 100, sender="p3"))
        out.append((q.get(0), q.sender(0), q.missing(), len(os.listdir(q._dir))))
        out.append(q.next_up())
        q.mark_returned(0)
        out.append(q.next_up())
        q.mark_returned(1)
        q.mark_returned(2)
        out.append(q.next_up())
        q.retry(1)
        out.append((q.next_up(), q.has(1)))
        q.mark_returned(1)
        q.discard(0)
        out.append((q.has(0), q.next_up(), q.missing(), len(os.listdir(q._dir)), len(q)))
        out.append(outcome(lambda: q.get(0)))
        out.append(outcome(lambda: q.put(3, b"x")))
        out.append(outcome(lambda: q.has(-1)))
    finally:
        q.close()
    out.append((os.path.exists(q._dir), outcome(lambda: q.put(0, b"x"))))
    out.append(outcome(lambda: PKGS[pkg][2].ChunkQueue(-1)))
    return out


def test_chunk_queue_spools_to_disk_as_jax(tmp_path):
    port = _spool("port", tmp_path / "port")
    jax = _spool("jax", tmp_path / "jax")
    assert port == jax
    assert port[:4] == [True, False, True, True]
    assert port[-2] == (False, ("RuntimeError", "chunk queue is closed"))


def _snapshot(pkg, chunks, peers):
    return PKGS[pkg][1]._Snapshot(height=5, format=1, chunks=chunks, hash=b"h", metadata=b"",
                                  peers=set(peers))


def _scripted(pkg: str, case: str):
    """One of the JAX file's _apply_chunks cases on pkg's reactor: the
    app's calls, the fetches and the outcome."""
    _ss, mod, chunks, abci = PKGS[pkg]
    reactor = _bare_reactor(pkg)
    applied, fetches = [], []
    n = {"refetch": 4, "terminal": 3, "range": 2, "reject": 3}[case]
    source = {i: b"chunk-%d" % i for i in range(n)}
    snapshot = _snapshot(pkg, n, {"good", "bad"} if case == "reject" else {"p1"})

    async def fake_fetch(snap, queue, indexes=None):
        providers = [p for p in sorted(snap.peers) if p not in reactor._rejected_senders]
        todo = list(indexes) if indexes is not None else list(range(snap.chunks))
        fetches.append((tuple(todo), tuple(providers)))
        for i in todo:
            queue.put(i, (b"fresh-%d" % i) if case == "reject" else source[i], sender=providers[0])

    reactor._fetch_chunks = fake_fetch

    class App:
        async def apply_snapshot_chunk(self, req):
            applied.append((req.index, req.sender, req.chunk))
            R = abci.ResponseApplySnapshotChunk
            if case == "refetch" and req.index == 2 and sum(a[0] == 2 for a in applied) == 1:
                return R(result=abci.APPLY_CHUNK_RETRY, refetch_chunks=(1,))
            if case == "terminal":
                return R(result=abci.APPLY_CHUNK_ABORT, refetch_chunks=(0, 1))
            if case == "range":
                return R(result=abci.APPLY_CHUNK_ACCEPT, refetch_chunks=(7,))
            if case == "reject" and req.index == 0:
                return R(result=abci.APPLY_CHUNK_ACCEPT, reject_senders=("bad",))
            return R(result=abci.APPLY_CHUNK_ACCEPT)

    reactor.app = App()

    async def go():
        queue = chunks.ChunkQueue(n)
        try:
            if case == "reject":
                queue.put(0, b"ok-0", sender="good")
                queue.put(1, b"bad-1", sender="bad")
                queue.put(2, b"bad-2", sender="bad")
            else:
                await reactor._fetch_chunks(snapshot, queue)
            res = await asyncio.wait_for(reactor._apply_chunks(snapshot, queue), 10.0)
            return "ok", res
        except Exception as e:  # the outcome compared IS the exception
            return type(e).__name__, str(e)
        finally:
            queue.close()

    result = run(go())
    return applied, fetches, result, sorted(reactor._rejected_senders)


@pytest.mark.parametrize("case", ["refetch", "terminal", "range", "reject"])
def test_apply_chunks_cases_equal_jax(case):
    port = _scripted("port", case)
    assert port == _scripted("jax", case)
    applied, fetches, result, rejected = port
    if case == "refetch":
        assert [i for i, _s, _c in applied] == [0, 1, 2, 1, 2, 3]
        assert fetches == [((0, 1, 2, 3), ("p1",)), ((1,), ("p1",))] and result == ("ok", None)
    elif case == "terminal":
        assert fetches == [((0, 1, 2), ("p1",))] and result == ("SyncError", "chunk 0 rejected: 2")
    elif case == "range":
        assert result[0] == "SyncError" and "out-of-range" in result[1]
    else:
        assert rejected == ["bad"]
        assert fetches == [((1,), ("good",)), ((2,), ("good",))]
        assert applied == [(0, "good", b"ok-0"), (1, "good", b"fresh-1"), (2, "good", b"fresh-2")]


def test_restore_memory_independent_of_snapshot_size():
    """tests/test_statesync.py's memory case on the port: a 64 MB
    snapshot restores with a peak of a few chunks in Python memory."""
    import tracemalloc

    chunk_size, n_chunks = 1 << 20, 64
    reactor = _bare_reactor("port")
    snapshot = _snapshot("port", n_chunks, {"p1"})

    async def fake_fetch(snap, queue, indexes=None):
        for i in indexes if indexes is not None else range(snap.chunks):
            queue.put(i, bytes([i % 256]) * chunk_size, sender="p1")

    reactor._fetch_chunks = fake_fetch

    class App:
        async def apply_snapshot_chunk(self, req):
            assert len(req.chunk) == chunk_size
            return port_abci.ResponseApplySnapshotChunk(result=port_abci.APPLY_CHUNK_ACCEPT)

    reactor.app = App()

    async def go():
        queue = port_chunks.ChunkQueue(n_chunks)
        try:
            tracemalloc.start()
            await reactor._fetch_chunks(snapshot, queue)
            await reactor._apply_chunks(snapshot, queue)
            return tracemalloc.get_traced_memory()[1]
        finally:
            tracemalloc.stop()
            queue.close()

    peak = run(go())
    assert peak < 8 * chunk_size, f"peak {peak / 1e6:.1f} MB"


def _real_fetch(pkg: str) -> list:
    """The real _fetch_chunks: with "bad" rejected every request goes to
    "good"; with both rejected it raises before asking anyone."""
    reactor = _bare_reactor(pkg)
    chunks = PKGS[pkg][2]
    snapshot = _snapshot(pkg, 2, {"good", "bad"})
    reactor._rejected_senders.add("bad")
    asked = []

    class ChunkCh:
        def try_send(self, env):
            asked.append((env.to, env.message.index))
            key = (env.to, env.message.height, env.message.format, env.message.index)
            fut = reactor._chunk_waiters.pop(key)

            class Res:
                missing = False
                chunk = b"payload-%d" % env.message.index

            fut.set_result(Res())

    reactor.chunk_ch = ChunkCh()

    async def go():
        out = []
        q = chunks.ChunkQueue(2)
        try:
            await reactor._fetch_chunks(snapshot, q)
            out.append((q.get(0), q.get(1), q.sender(0), sorted(asked)))
        finally:
            q.close()
        reactor._rejected_senders.add("good")
        asked.clear()
        q2 = chunks.ChunkQueue(1)
        try:
            await reactor._fetch_chunks(snapshot, q2)
        except Exception as e:  # the outcome compared IS the exception
            out.append((type(e).__name__, str(e), list(asked)))
        finally:
            q2.close()
        return out

    return run(go())


def test_fetch_chunks_real_path_skips_rejected_senders_as_jax():
    port = _real_fetch("port")
    assert port == _real_fetch("jax")
    assert port[0][3] == [("good", 0), ("good", 1)]
    assert port[1] == ("SyncError", "no remaining snapshot providers", [])


# -- the kvstore app's snapshots --


def _kv_app(pkg: str, txs_per_height: list):
    app = (KVStoreApplication if pkg == "port" else JaxKVStore)(snapshot_interval=2)
    abci = PKGS[pkg][3]
    for txs in txs_per_height:
        app.begin_block(abci.RequestBeginBlock())
        for tx in txs:
            app.deliver_tx(abci.RequestDeliverTx(tx=tx))
        app.end_block(abci.RequestEndBlock())
        app.commit()
    return app


def _restore(pkg: str, src, snap, order, corrupt_at=None, offer=True, fmt=1) -> list:
    abci = PKGS[pkg][3]
    app = (KVStoreApplication if pkg == "port" else JaxKVStore)()
    out = []
    if offer:
        s = abci.Snapshot(height=snap.height, format=fmt, chunks=snap.chunks, hash=snap.hash)
        out.append(app.offer_snapshot(abci.RequestOfferSnapshot(snapshot=s, app_hash=b"")).result)
    for i in order:
        chunk = src.load_snapshot_chunk(abci.RequestLoadSnapshotChunk(
            height=snap.height, format=snap.format, chunk=i)).chunk
        if i == corrupt_at:
            chunk = chunk[:-3] + b"!!!"
        res = app.apply_snapshot_chunk(abci.RequestApplySnapshotChunk(index=i, chunk=chunk))
        out.append((res.result, res.refetch_chunks, res.reject_senders))
    out.append((app.height, app.app_hash, len(app.state), app.info(abci.RequestInfo()).last_block_app_hash))
    return out


def test_kvstore_snapshots_and_restores_equal_jax():
    rng = np.random.default_rng(SEED)
    txs = [workloads.kv_txs(SEED, h, int(rng.integers(150, 300)), (100, 300)) for h in range(1, 6)]
    txs[1].append(b"val:%s!5" % (b"ab" * 32))
    apps = {pkg: _kv_app(pkg, txs) for pkg in PKGS}
    snaps = {}
    for pkg, app in apps.items():
        abci = PKGS[pkg][3]
        listed = app.list_snapshots(abci.RequestListSnapshots()).snapshots
        snaps[pkg] = [(s.height, s.format, s.chunks, s.hash, s.metadata) for s in listed]
    assert snaps["port"] == snaps["jax"]
    assert [s[0] for s in snaps["port"]] == [2, 4] and snaps["port"][1][2] >= 3
    assert apps["port"]._snapshots == apps["jax"]._snapshots
    for pkg in PKGS:
        took = apps[pkg].take_snapshot()
        assert (took.height, took.chunks, took.hash) == (5, *snaps["port"][1][2:4]) or took.height == 5
    assert apps["port"].take_snapshot() == port_abci.Snapshot(**vars(apps["jax"].take_snapshot()))
    listed = apps["port"].list_snapshots(port_abci.RequestListSnapshots()).snapshots
    snap = next(s for s in listed if s.height == 4)
    n = snap.chunks
    for kwargs in ({"order": range(n)}, {"order": range(n), "corrupt_at": n - 1},
                   {"order": [0, 2, 1] + list(range(3, n))}, {"order": range(n), "offer": False},
                   {"order": range(n), "fmt": 2}, {"order": range(n - 1)}):
        port = _restore("port", apps["port"], snap, **kwargs)
        assert port == _restore("jax", apps["jax"], snap, **kwargs), kwargs
    restored = _restore("port", apps["port"], snap, range(n))
    assert restored[-1][0] == 4 and restored[-1][2] > 600
    for pkg in PKGS:
        abci = PKGS[pkg][3]
        missing = apps[pkg].load_snapshot_chunk(abci.RequestLoadSnapshotChunk(height=3, format=1, chunk=0))
        assert missing.chunk == b""


# -- the stores' state-sync writes --


def test_bootstrap_save_validators_and_signed_headers_write_jax_bytes(served):
    _genesis_json, _privs, blocks, node = served
    state = node.state_store.load()
    lbs = [_light_block(node, h) for h in (2, 3, 4)]
    dbs = {}
    for pkg in PKGS:
        kv = (MemKV if pkg == "port" else JaxMemKV)()
        bkv = (MemKV if pkg == "port" else JaxMemKV)()
        ss = (StateStore if pkg == "port" else JaxStateStore)(kv)
        bs = (BlockStore if pkg == "port" else JaxBlockStore)(bkv)
        st = state if pkg == "port" else JaxState.from_proto(state.to_proto())
        ss.bootstrap(st)
        vcls = type(state.validators) if pkg == "port" else JaxValidatorSet
        for lb in lbs:
            ss.save_validators(lb.height, vcls.from_proto(lb.validator_set.to_proto()))
            sh = (type(lb.signed_header) if pkg == "port" else JaxSignedHeader).from_proto(
                lb.signed_header.to_proto())
            bid = (BlockID if pkg == "port" else JaxBlockID).from_proto(
                blocks[lb.height].block.header.last_block_id.to_proto())
            bs.save_signed_header(sh, bid)
        dup = outcome(lambda: bs.save_signed_header(sh, bid))
        dbs[pkg] = (dict(kv.iterate()), dict(bkv.iterate()), dup, bs.base(), bs.height(),
                    ss.load_validators(3).to_proto(), ss.load().to_proto())
    assert dbs["port"] == dbs["jax"]
    assert dbs["port"][2] == ("ValueError", "block meta already exists at height 4")
    assert (dbs["port"][3], dbs["port"][4]) == (2, 4)


# -- backfill --


def _flipped(lb, pkg: str):
    """lb with its commit's first signature flipped."""
    cls = JaxLightBlock if pkg == "jax" else type(lb)
    out = cls.from_proto(lb.to_proto())
    sig = bytearray(out.signed_header.commit.signatures[0].signature)
    sig[0] ^= 1
    out.signed_header.commit.signatures[0].signature = bytes(sig)
    return out


def _backfill(pkg: str, served, bad_at=(), launch_error=None, base: int = 5):
    """A node restored at `base` (its signed header and bootstrapped
    state from the served chain) backfills from peers "a-bad" (its light
    block at each height of bad_at has a flipped signature) and "b-good".
    Returns the stored metas, commits and validator sets below base,
    the count, the fetches and the outcome."""
    _genesis_json, _privs, blocks, node = served
    _ss, mod, _chunks, _abci = PKGS[pkg]
    reactor = _bare_reactor(pkg)
    kv, bkv = (MemKV() if pkg == "port" else JaxMemKV()), (MemKV() if pkg == "port" else JaxMemKV())
    reactor.state_store = (StateStore if pkg == "port" else JaxStateStore)(kv)
    reactor.block_store = (BlockStore if pkg == "port" else JaxBlockStore)(bkv)
    lb_cls = type(_light_block(node, 1)) if pkg == "port" else JaxLightBlock
    served_lbs = {h: lb_cls.from_proto(_light_block(node, h).to_proto()) for h in range(1, base + 1)}
    top = served_lbs[base]
    bid = (BlockID if pkg == "port" else JaxBlockID).from_proto(
        blocks[base].block.header.last_block_id.to_proto())
    reactor.block_store.save_signed_header(top.signed_header, bid)
    state = node.state_store.load()
    state = state if pkg == "port" else JaxState.from_proto(state.to_proto())
    reactor.peers = {"a-bad", "b-good"}
    fetched = []

    async def fetch_from(height, peer):
        fetched.append((height, peer))
        lb = served_lbs[height]
        return _flipped(lb, pkg) if peer == "a-bad" and height in bad_at else lb

    reactor._fetch_light_block_from = fetch_from

    async def go():
        try:
            return "ok", await reactor.backfill(state)
        except Exception as e:  # the outcome compared IS the exception
            return type(e).__name__, str(e)

    result = run(go())
    stored = {
        h: ((lambda m: (m.header.to_proto(), m.block_id.to_proto(), m.block_size, m.num_txs))(
                reactor.block_store.load_block_meta(h)),
            reactor.block_store.load_block_commit(h).to_proto(),
            reactor.state_store.load_validators(h).to_proto())
        for h in range(1, base) if reactor.block_store.load_block_meta(h) is not None
    }
    return stored, result, fetched


def test_backfill_stores_the_headers_jax_stores(served):
    port = _backfill("port", served)
    jax = _backfill("jax", served)
    assert port[:2] == jax[:2]
    assert port[1] == ("ok", 4) and sorted(port[0]) == [1, 2, 3, 4]
    # the headers and commits are the served chain's, without the blocks
    node = served[3]
    for h, (meta, commit, vals) in port[0].items():
        want = node.block_store.load_block_meta(h)
        assert meta == (want.header.to_proto(), want.block_id.to_proto(), -1, -1)
        # save_signed_header keeps a header's commit under the height
        # below it, as the JAX package writes it
        assert commit == node.block_store.load_block_commit(h + 1).to_proto()
        assert vals == node.state_store.load_validators(h).to_proto()


def test_backfill_passes_over_a_peer_with_a_flipped_signature(served):
    port = _backfill("port", served, bad_at=(2, 3))
    jax = _backfill("jax", served, bad_at=(2, 3))
    assert port[:2] == jax[:2] == _backfill("port", served)[:2]
    # the port tries the peers in sorted order: the bad one first
    assert port[2] == [(4, "a-bad"), (3, "a-bad"), (3, "b-good"), (2, "a-bad"), (2, "b-good"), (1, "a-bad")]


def test_backfill_raises_a_failed_launch_and_contains_a_device_fault(served, monkeypatch):
    want = _backfill("port", served)
    gpu_verifier.install(device="cpu", min_batch=2, gather_deadline_s=None)
    try:
        before = gpu_verifier.stats()
        with faults.inject("gpu.dispatch", "raise", times=1) as rule:
            contained = _backfill("port", served)
        after = gpu_verifier.stats()
    finally:
        gpu_verifier.uninstall()

    def failed_launch(self, *args):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    # a fresh install: the contained fault left the ed25519 breaker open
    gpu_verifier.install(device="cpu", min_batch=2, gather_deadline_s=None)
    monkeypatch.setattr(Ed25519Verifier, "dispatch", failed_launch)
    try:
        failed = _backfill("port", served)
    finally:
        gpu_verifier.uninstall()
    assert rule.fired == 1 and after["faults"] == before["faults"] + 1
    assert contained[:2] == want[:2]
    assert failed[1] == ("RuntimeError", "CUDA error: an illegal memory access was encountered")
    assert failed[0] == {} and failed[2] == [(4, "a-bad")]

    # the JAX package passes the peer over for the same error, and then
    # every other one: no header is stored
    def jax_launch_error(*args):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(jax_ss_reactor, "verify_commit_light", jax_launch_error)
    jax = _backfill("jax", served)
    assert jax[1] == ("ok", 0) and jax[0] == {}


def test_sync_requires_a_trust_root_as_jax():
    async def go(pkg):
        r = _bare_reactor(pkg)
        try:
            await r.sync()
        except Exception as e:  # the outcome compared IS the exception
            return type(e).__name__, str(e)

    port = run(go("port"))
    assert port == run(go("jax"))
    assert port[0] == "SyncError" and "trust_height" in port[1]


# -- four-validator localnets with a block-syncing and a state-syncing node --


class _PortFull(_PortNode):
    """PR 16's localnet node with the block sync and state sync reactors.
    A fresh node holds a key outside the set and starts consensus only
    when block sync hands over."""

    def __init__(self, p2p, priv, genesis_json, fresh: bool = False, state_sync: bool = False):
        super().__init__(p2p, priv if priv is not None else workloads.seeded_keys(1, SEED)[0],
                         genesis_json)
        self.cs_reactor.wait_sync = fresh
        state = self.state_store.load()
        self.bs_reactor = BlocksyncReactor(
            state, self.cs.block_exec, self.block_store,
            p2p.open_channel(blocksync_channel_descriptor()), p2p.peer_manager.subscribe(),
            block_sync=fresh and not state_sync, consensus_reactor=self.cs_reactor, event_bus=self.bus)
        self.ss_reactor = port_ss.StatesyncReactor(
            LOCALNET_CHAIN, state, LocalClient(self.app), self.state_store, self.block_store,
            {cid: p2p.open_channel(d) for cid, d in port_ss.statesync_channel_descriptors().items()},
            p2p.peer_manager.subscribe(), cfg=StateSyncConfig(discovery_time=0.5, trust_period=TRUST_PERIOD_S))

    async def start(self):
        await self.bus.start()
        await self.cs_reactor.start()
        await self.mp_reactor.start()
        await self.ev_reactor.start()
        await self.bs_reactor.start()
        await self.ss_reactor.start()

    async def stop(self):
        await self.ss_reactor.stop()
        await self.bs_reactor.stop()
        await _PortNode.stop(self)


class _JaxFull(_JaxNode):
    def __init__(self, p2p, priv, genesis_json, fresh: bool = False, state_sync: bool = False):
        key = priv if priv is not None else workloads.seeded_keys(1, SEED)[0]
        super().__init__(p2p, JaxPrivKey.from_seed(key.bytes()[:32]), genesis_json)
        self.cs_reactor.wait_sync = fresh
        state = self.state_store.load()
        self.bs_reactor = JaxBlocksyncReactor(
            state, self.cs.block_exec, self.block_store,
            p2p.open_channel(jax_bs_descriptor()), p2p.peer_manager.subscribe(),
            block_sync=fresh and not state_sync, consensus_reactor=self.cs_reactor, event_bus=self.bus)
        self.ss_reactor = jax_ss.StatesyncReactor(
            LOCALNET_CHAIN, state, JaxLocalClient(self.app), self.state_store, self.block_store,
            {cid: p2p.open_channel(d) for cid, d in jax_ss.statesync_channel_descriptors().items()},
            p2p.peer_manager.subscribe(), cfg=JaxStateSyncConfig(discovery_time=0.5, trust_period=TRUST_PERIOD_S))

    start = _PortFull.start
    stop = _PortFull.stop


async def _catchup_localnet(pkg: str) -> dict:
    genesis, privs = _genesis(4)
    cls, net_mod = (_PortFull, port_p2ptest) if pkg == "port" else (_JaxFull, jax_p2ptest)
    net = net_mod.TestNetwork(6, chain_id=LOCALNET_CHAIN)
    vals = [cls(net.nodes[i], privs[i], genesis) for i in range(4)]
    fresh_bs = cls(net.nodes[4], None, genesis, fresh=True)
    fresh_ss = cls(net.nodes[5], None, genesis, fresh=True, state_sync=True)
    for node in vals:
        for tx in _txs():
            await node.mempool.check_tx(tx)
    for node in vals:
        await node.start()
    await net.start()
    out = {}
    try:
        await asyncio.gather(*(n.cs.wait_for_height(6, timeout=30.0) for n in vals))
        snap_height = max(v.app.take_snapshot().height for v in vals)
        await asyncio.gather(*(n.cs.wait_for_height(snap_height + 4, timeout=30.0) for n in vals))
        await fresh_bs.start()
        await fresh_ss.start()
        fresh_ss.ss_reactor.cfg.trust_height = 1
        fresh_ss.ss_reactor.cfg.trust_hash = vals[0].block_store.load_block_meta(1).header.hash().hex()
        state = await fresh_ss.ss_reactor.sync()
        out["restored"] = (state.last_block_height, fresh_ss.app.height, fresh_ss.app.app_hash)
        out["backfilled"] = await fresh_ss.ss_reactor.backfill(state)
        await fresh_ss.bs_reactor.start_sync(state)
        while not (fresh_bs.bs_reactor.synced and fresh_ss.bs_reactor.synced):
            await asyncio.sleep(0.05)
        target = vals[0].cs.rs.height + 2
        await asyncio.gather(fresh_bs.cs.wait_for_height(target, timeout=30.0),
                             fresh_ss.cs.wait_for_height(target, timeout=30.0))
    finally:
        for node in vals + [fresh_bs, fresh_ss]:
            await node.stop()
        await net.stop()
    out["snap"] = snap_height
    out["target"] = target
    out["nodes"] = (vals, fresh_bs, fresh_ss)
    return out


def _heights(res: dict) -> list:
    """Per height up to the fresh nodes' target: the txs, the app hash
    after it (block h + 1's), and whether each fresh node holds the
    validators' block (the state-synced node from the snapshot's height
    on, its backfilled metas below)."""
    vals, fresh_bs, fresh_ss = res["nodes"]
    out = []
    for h in range(1, res["target"] - 1):
        block = vals[0].block_store.load_block(h)
        nxt = vals[0].block_store.load_block(h + 1)
        meta = vals[0].block_store.load_block_meta(h)
        ss_meta = fresh_ss.block_store.load_block_meta(h)
        ss_block = fresh_ss.block_store.load_block(h)
        out.append({
            "txs": tuple(bytes(t) for t in block.txs),
            "app_hash": nxt.header.app_hash,
            "bs_equal": fresh_bs.block_store.load_block(h).hash() == block.hash(),
            "ss_equal": (ss_block.hash() == block.hash()) if h > res["snap"] else
                        (ss_meta is not None and ss_meta.header.hash() == meta.header.hash()),
        })
    return out


def test_localnets_block_sync_and_state_sync_fresh_nodes_equal_jax():
    port = run(_catchup_localnet("port"), 90.0)
    jax = run(_catchup_localnet("jax"), 90.0)
    p, j = _heights(port), _heights(jax)
    n = min(len(p), len(j))
    assert n >= 8
    assert [(x["txs"], x["app_hash"]) for x in p[:n]] == [(x["txs"], x["app_hash"]) for x in j[:n]]
    assert all(x["bs_equal"] and x["ss_equal"] for x in p + j)
    for res in (port, jax):
        vals = res["nodes"][0]
        assert res["restored"][:2] == (res["snap"], res["snap"])
        assert res["restored"][2] == vals[0].block_store.load_block(res["snap"] + 1).header.app_hash
        assert res["backfilled"] == res["snap"] - 1
    assert sorted(t for x in p for t in x["txs"]) == sorted(_txs())
