"""The port's ABCI handshake (consensus/replay.py) held against the JAX
package's Handshaker.

A chain of 4 validators (2 ed25519, 2 sr25519) that starts from the
app's InitChain is made by the port (workloads.serve_chain), and each
case's stores are copied key by key into the JAX package's MemKV, so
both Handshakers meet the same bytes. The five cases of
tests/test_consensus_replay.py:
- a fresh chain: InitChain delivers the set, nothing is replayed;
- an app behind the store: every block replays into a fresh app;
- a crash before apply: the store one height above the state and the
  app, the last block applied with the real app;
- a crash after Commit: the app at the store's height, the state one
  below, the last block applied on the recorded responses (the real app
  is not driven again);
- an app ahead of the store: HandshakeError with the JAX message.
Each compares the returned app hash, the stored state's bytes, the
blocks replayed and the app's height. Then: a failed launch under
_replay_block's apply_block (a RuntimeError of the device verifier's
dispatch) raises to the caller and leaves the state where it was; a
DeviceFault there is contained by the fault policy and the outcome is
the JAX package's. Tolerance: zero (bytes).
"""

import asyncio

import pytest

from tendermint_tpu.abci import types as JT
from tendermint_tpu.abci.client import LocalClient as JaxLocalClient
from tendermint_tpu.abci.kvstore import KVStoreApplication as JaxKVStore
from tendermint_tpu.consensus.replay import Handshaker as JaxHandshaker
from tendermint_tpu.consensus.replay import HandshakeError as JaxHandshakeError
from tendermint_tpu.crypto import sigcache as jax_sigcache
from tendermint_tpu.crypto import sr25519 as _jax_sr  # noqa: F401  (registers the key type)
from tendermint_tpu.state.store import StateStore as JaxStateStore
from tendermint_tpu.state.types import state_from_genesis as jax_state_from_genesis
from tendermint_tpu.store.block_store import BlockStore as JaxBlockStore
from tendermint_tpu.store.kv import MemKV as JaxMemKV
from tendermint_tpu.types.genesis import GenesisDoc as JaxGenesisDoc
from tendermint_tpu_torch import workloads
from tendermint_tpu_torch.abci import types as T
from tendermint_tpu_torch.abci.client import LocalClient
from tendermint_tpu_torch.abci.kvstore import KVStoreApplication
from tendermint_tpu_torch.consensus.replay import Handshaker, HandshakeError
from tendermint_tpu_torch.crypto import faults, gpu_verifier
from tendermint_tpu_torch.ops.ed25519_kernel import Ed25519Verifier
from tendermint_tpu_torch.state.store import StateStore
from tendermint_tpu_torch.state.types import state_from_genesis
from tendermint_tpu_torch.store.block_store import BlockStore
from tendermint_tpu_torch.store.kv import MemKV
from tendermint_tpu_torch.types.genesis import GenesisDoc

from .test_torch_isolation import jax_device_plane_paused  # noqa: F401 (autouse)

CHAIN_ID = "torch-replay-chain"
SEED = 83
N = 4


@pytest.fixture(autouse=True)
def _isolated():
    with jax_sigcache.disabled():
        yield


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, 30.0))


@pytest.fixture(scope="module")
def chain():
    privs = workloads.seeded_keys(4, SEED, 2)
    genesis = workloads.kv_genesis(CHAIN_ID, privs)
    txs = [workloads.kv_txs(SEED, h, 5, (34, 90)) for h in range(1, N + 1)]
    full = workloads.serve_chain(genesis, privs, txs, SEED, init_chain=True)
    below = workloads.serve_chain(genesis, privs, txs[:N - 1], SEED, init_chain=True)
    return genesis, full, below


def _copy(db, cls):
    out = cls()
    for k, v in db.iterate():
        out.set(k, v)
    return out


class _Side:
    """One package's stores (copies of `dbs`), genesis and classes."""

    def __init__(self, pkg: str, genesis_json: str, dbs):
        self.pkg = pkg
        if pkg == "port":
            kv, ss, bs, gen, self.hs, self.app_cls, self.client = (
                MemKV, StateStore, BlockStore, GenesisDoc, Handshaker, KVStoreApplication, LocalClient)
        else:
            kv, ss, bs, gen, self.hs, self.app_cls, self.client = (
                JaxMemKV, JaxStateStore, JaxBlockStore, JaxGenesisDoc, JaxHandshaker, JaxKVStore,
                JaxLocalClient)
        self.state_store = ss(_copy(dbs[0], kv))
        self.block_store = bs(_copy(dbs[1], kv))
        self.genesis = gen.from_json(genesis_json)

    async def handshake(self, app):
        h = self.hs(self.state_store, self.state_store.load(), self.block_store, self.genesis)
        app_hash = await h.handshake(self.client(app))
        return app_hash, h.n_blocks

    async def app_at_store(self):
        """A fresh app caught up with the stores by a handshake."""
        app = self.app_cls()
        await self.handshake(app)
        return app


def _genesis_dbs(genesis_json: str):
    state_db, block_db = MemKV(), MemKV()
    StateStore(state_db).save(state_from_genesis(GenesisDoc.from_json(genesis_json)))
    return state_db, block_db


def _record(side, app, app_hash, n_blocks) -> tuple:
    return (app_hash, side.state_store.load().to_proto(), n_blocks, app.height, app.app_hash,
            len(app.validator_set))


def _case(name: str, chain, pkg: str):
    genesis, (blocks, full, states), (_b, below, _s) = chain

    async def go():
        if name == "fresh":
            side = _Side(pkg, genesis, _genesis_dbs(genesis))
            app = side.app_cls()
        elif name == "app_behind_store":
            side = _Side(pkg, genesis, (full.state_store._db, full.block_store._db))
            app = side.app_cls()
        elif name == "crash_before_apply":
            side = _Side(pkg, genesis, (below.state_store._db, below.block_store._db))
            app = await side.app_at_store()
            last = _convert(blocks[N - 1], pkg)
            side.block_store.save_block(*last)
        elif name == "crash_after_commit":
            app = await _Side(pkg, genesis, (full.state_store._db, full.block_store._db)).app_at_store()
            side = _Side(pkg, genesis, (below.state_store._db, below.block_store._db))
            side.block_store.save_block(*_convert(blocks[N - 1], pkg))
            side.state_store.save_abci_responses(N, _responses(full, N, side))
            committed = app.height
        app_hash, n_blocks = await side.handshake(app)
        out = _record(side, app, app_hash, n_blocks)
        if name == "crash_after_commit":
            # the recorded responses served the block: the app ran no
            # second Commit
            assert app.height == committed == N
        return out

    return run(go())


def _convert(cb, pkg: str) -> tuple:
    if pkg == "port":
        return cb.block, cb.parts, cb.seen_commit
    from tendermint_tpu.types.block import Block as JaxBlock
    from tendermint_tpu.types.commit import Commit as JaxCommit

    block = JaxBlock.from_proto(cb.block.to_proto())
    return block, block.make_part_set(), JaxCommit.from_proto(cb.seen_commit.to_proto())


def _responses(full, height: int, side):
    resp = full.state_store.load_abci_responses(height)
    if side.pkg == "port":
        return resp
    from tendermint_tpu.state.store import ABCIResponses as JaxResponses

    return JaxResponses.from_proto(resp.to_proto())


@pytest.mark.parametrize("name", ["fresh", "app_behind_store", "crash_before_apply", "crash_after_commit"])
def test_handshake_case_equals_jax(chain, name):
    got = _case(name, chain, "port")
    want = _case(name, chain, "jax")
    assert got == want
    _genesis, (blocks, _full, states), _below = chain
    app_hash, state, n_blocks, height, _h, n_vals = got
    expect = {"fresh": (0, 0), "app_behind_store": (N, N), "crash_before_apply": (1, N),
              "crash_after_commit": (1, N)}[name]
    assert (n_blocks, height) == expect
    assert n_vals == 4
    if name != "fresh":
        assert state == states[N - 1].to_proto() and app_hash == states[N - 1].app_hash


def test_app_ahead_of_store_is_refused_alike(chain):
    genesis, _full, (_b, below, _s) = chain

    class Ahead(KVStoreApplication):
        def info(self, req):
            return T.ResponseInfo(last_block_height=99)

    class JaxAhead(JaxKVStore):
        def info(self, req):
            return JT.ResponseInfo(last_block_height=99)

    dbs = (below.state_store._db, below.block_store._db)
    with pytest.raises(HandshakeError) as got:
        run(_Side("port", genesis, dbs).handshake(Ahead()))
    with pytest.raises(JaxHandshakeError) as want:
        run(_Side("jax", genesis, dbs).handshake(JaxAhead()))
    assert str(got.value) == str(want.value) == f"app height 99 ahead of store {N - 1}"


def _failed_launch(self, *args):
    raise RuntimeError("CUDA error: an illegal memory access was encountered")


def test_a_failed_launch_under_replay_block_reaches_the_caller(chain, monkeypatch):
    genesis, _full, (_b, below, _s) = chain
    blocks = chain[1][0]

    async def go():
        side = _Side("port", genesis, (below.state_store._db, below.block_store._db))
        app = await side.app_at_store()
        side.block_store.save_block(*_convert(blocks[N - 1], "port"))
        gpu_verifier.install(device="cpu", min_batch=2, gather_deadline_s=None)
        monkeypatch.setattr(Ed25519Verifier, "dispatch", _failed_launch)
        try:
            with pytest.raises(RuntimeError, match="illegal memory access"):
                await side.handshake(app)
        finally:
            gpu_verifier.uninstall()
        return side.state_store.load().last_block_height

    assert run(go()) == N - 1


def test_a_device_fault_under_replay_block_is_contained(chain):
    want = _case("crash_before_apply", chain, "jax")
    gpu_verifier.install(device="cpu", min_batch=2, gather_deadline_s=None)
    try:
        before = gpu_verifier.stats()
        with faults.inject("gpu.dispatch", "raise", times=1) as rule:
            got = _case("crash_before_apply", chain, "port")
        after = gpu_verifier.stats()
    finally:
        gpu_verifier.uninstall()
    assert rule.fired == 1
    assert after["faults"] == before["faults"] + 1
    assert got == want
