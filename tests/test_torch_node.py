"""The port's node: make_node from a home, its start, stop and restart,
localnets, catch-up, and the CLI's `start` as a process
(after tests/test_node.py:91-343).

- a single validator produces blocks from an `init` home, its status
  read through rpc.LocalClient.from_node; its stop releases the data
  lock and closes every DB;
- a restart from the same home (a fresh kvstore app) resumes through the
  ABCI handshake: every stored block replays into the app, and the
  chain goes on;
- a four-validator localnet on memory transports, and a two-validator
  one over TCP on 127.0.0.1 ports taken free, commit the same blocks;
- a node block-syncs a chain served by three peers and switches to
  consensus; its state and app hash equal the chain's, and the JAX
  package's Handshaker replaying its stores into a JAX kvstore app
  reaches the same app hash; after a staged "crash before apply" (the
  next block saved, the state one below) the restart's handshake
  applies that block with the real app;
- a node state-syncs a snapshot, backfills, block-syncs and switches to
  consensus, publishing StateSyncStatus on its event bus;
- with [gpu] enable = true and no CUDA, make_node raises at the
  install; it never runs on the CPU plane; prometheus = true serves
  /metrics and /healthz on a port taken free; a second node with the same [gpu] config reuses
  the install, one with another config installs its own;
- a failed launch under the handshake raises out of start(), and the
  failed start has released the data lock;
- a `start` process whose block sync meets a failed launch (peers over
  TCP serving the chain) stops its node and exits non-zero, unsignalled;
- two `python3 -m tendermint_tpu_torch.cmd start` processes of a
  `testnet` reach height 2 over TCP and exit 0 on SIGTERM;
- a node run by `start`'s loop (cmd/commands.py `_run_until_stopped`)
  answers JSON-RPC requests whose params are "x", 7 or true as the JAX
  server does and keeps serving; one whose step machine ends on the
  `wal.fsync` fault's OSError logs "task receive failed" at once, as the
  JAX `_run_guarded` does, and that loop stops it with the OSError.

Every node runs on device="cpu" or with [gpu] enable = false; every
event loop runs under a deadline. Tolerance: zero (bytes).
"""

import asyncio
import json
import logging
import os
import signal
import socket
import sys
import time

import pytest

from tendermint_tpu.abci.client import LocalClient as JaxLocalClient
from tendermint_tpu.abci.kvstore import KVStoreApplication as JaxKVStore
from tendermint_tpu.consensus.replay import Handshaker as JaxHandshaker
from tendermint_tpu.crypto import sigcache as jax_sigcache
from tendermint_tpu.crypto import sr25519 as _jax_sr  # noqa: F401  (registers the key type)
from tendermint_tpu.state.store import StateStore as JaxStateStore
from tendermint_tpu.store.block_store import BlockStore as JaxBlockStore
from tendermint_tpu.store.kv import MemKV as JaxMemKV
from tendermint_tpu.types.genesis import GenesisDoc as JaxGenesisDoc
from tendermint_tpu_torch import workloads
from tendermint_tpu_torch.abci.kvstore import KVStoreApplication
from tendermint_tpu_torch.blocksync import pool as port_pool
from tendermint_tpu_torch.config import GPUConfig, load_config, write_config
from tendermint_tpu_torch.crypto import gpu_verifier
from tendermint_tpu_torch.crypto.ed25519 import PrivKeyEd25519
from tendermint_tpu_torch.node import NodeKey, make_node
from tendermint_tpu_torch.node import device as device_plane
from tendermint_tpu_torch.node.node import acquire_pid_lock, release_pid_lock
from tendermint_tpu_torch.ops.ed25519_kernel import Ed25519Verifier
from tendermint_tpu_torch.p2p.transport import MemoryNetwork, MemoryTransport, TCPTransport
from tendermint_tpu_torch.rpc.client import LocalClient as RPCLocalClient
from tendermint_tpu_torch.store.kv import SqliteKV
from tendermint_tpu_torch.types.genesis import GenesisDoc, GenesisValidator

from .test_torch_isolation import jax_device_plane_paused  # noqa: F401 (autouse)

CHAIN_ID = "torch-node-chain"
SEED = 97
DEADLINE_S = 60.0
# node_key indexes of run_node_start's three serving peers
SERVERS = (61, 62, 63)

FAST = {
    "timeout_propose": 2.0, "timeout_prevote": 1.0, "timeout_precommit": 1.0, "timeout_commit": 0.1,
    "peer_gossip_sleep_duration": 0.01, "peer_query_maj23_sleep_duration": 0.5,
}


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    # block sync switches to consensus once caught up for this long
    monkeypatch.setattr(port_pool, "_CAUGHT_UP_GRACE_S", 0.3)
    with jax_sigcache.disabled():
        yield
    device_plane.uninstall_device_plane()


def run(coro, deadline_s: float = DEADLINE_S):
    return asyncio.run(asyncio.wait_for(coro, deadline_s))


def _genesis(privs) -> GenesisDoc:
    return GenesisDoc(chain_id=CHAIN_ID, genesis_time_ns=1_760_000_000_000_000_000,
                      validators=[GenesisValidator(pub_key=p.pub_key(), power=10) for p in privs])


def _home(tmp_path, i: int, genesis: GenesisDoc, priv, **settings):
    """An `init` home holding `genesis`, priv's FilePV and the settings
    (section -> {key: value}); [gpu] off, RPC on 127.0.0.1:0, fast
    consensus timeouts unless the settings say otherwise."""
    from tendermint_tpu_torch.privval.file import FilePV

    home = str(tmp_path / f"node{i}")
    base = {"gpu": {"enable": False}, "rpc": {"laddr": "tcp://127.0.0.1:0"},
            "p2p": {"laddr": "tcp://127.0.0.1:0"}, "consensus": dict(FAST), "base": {"moniker": f"node{i}"}}
    for section, values in settings.items():
        base.setdefault(section, {}).update(values)
    workloads.init_home(home, genesis.to_json(), base)
    if priv is not None:
        FilePV.from_priv_key(priv, os.path.join(home, "config", "priv_validator_key.json"),
                             os.path.join(home, "data", "priv_validator_state.json")).save()
    return home


def _cfg(home: str):
    cfg = load_config(os.path.join(home, "config", "config.toml"))
    cfg.base.home = home
    return cfg


def _privs(n: int, at: int):
    return [PrivKeyEd25519.from_seed(bytes([at + i]) * 32) for i in range(n)]


def test_single_validator_node_produces_blocks_and_stops_clean(tmp_path):
    priv = _privs(1, 1)[0]
    home = _home(tmp_path, 0, _genesis([priv]), priv)

    async def go():
        node = make_node(_cfg(home), device="cpu")
        await node.start()
        try:
            await node.consensus.wait_for_height(4, timeout=30.0)
            assert not node.consensus_reactor.wait_sync  # the only validator: no block sync
            status = await RPCLocalClient.from_node(node).call("status")
            assert int(status["sync_info"]["latest_block_height"]) >= 3
        finally:
            dbs = list(node._dbs)
            await node.stop()
        return dbs, node

    dbs, node = run(go())
    assert all(workloads._db_closed(db) for db in dbs) and len(dbs) == 5
    assert not node.data_locked
    lock = os.path.join(home, "data", "LOCK")
    release_pid_lock(lock, acquire_pid_lock(lock))
    db = SqliteKV(os.path.join(home, "data", "blockstore.sqlite"))
    from tendermint_tpu_torch.store.block_store import BlockStore

    bs = BlockStore(db)
    tip = bs.height()
    assert tip >= 3
    for h in range(1, tip):
        assert bs.load_block(h).header.height == h and bs.load_block_commit(h).height == h
    db.close()


def test_restart_resumes_through_the_handshake(tmp_path):
    priv = _privs(1, 5)[0]
    home = _home(tmp_path, 0, _genesis([priv]), priv)

    async def first():
        node = make_node(_cfg(home), device="cpu")
        await node.start()
        try:
            await node.consensus.wait_for_height(3, timeout=30.0)
            return node.block_store.height()
        finally:
            await node.stop()

    async def second():
        app = KVStoreApplication()
        node = make_node(_cfg(home), app=app, device="cpu")
        await node.start()
        try:
            replayed = node.handshaker.n_blocks
            at_start = app.height
            await node.consensus.wait_for_height(tip + 2, timeout=30.0)
        finally:
            await node.stop()
        return replayed, at_start, app.height

    tip = run(first())
    replayed, at_start, height = run(second())
    assert replayed == tip and at_start == tip
    assert height >= tip + 1


def test_four_validator_localnet_on_memory_transports(tmp_path):
    privs = _privs(4, 10)
    genesis = _genesis(privs)
    net = MemoryNetwork()
    addrs = [f"node{i}.mem:{i + 1}" for i in range(4)]
    homes = [_home(tmp_path, i, genesis, p, p2p={"laddr": f"tcp://{addrs[i]}"}) for i, p in enumerate(privs)]
    ids = [NodeKey.load(os.path.join(h, "config", "node_key.json")).node_id for h in homes]
    for i, home in enumerate(homes):
        cfg = load_config(os.path.join(home, "config", "config.toml"))
        cfg.p2p.persistent_peers = ",".join(f"{ids[j]}@{addrs[j]}" for j in range(4) if j != i)
        write_config(cfg, os.path.join(home, "config", "config.toml"))

    async def go():
        nodes = [make_node(_cfg(h), transport=MemoryTransport(net, a), device="cpu") for h, a in zip(homes, addrs)]
        for n in nodes:
            await n.start()
        try:
            await asyncio.gather(*(n.consensus.wait_for_height(3, timeout=45.0) for n in nodes))
            return [[n.block_store.load_block(h).hash() for h in (1, 2)] for n in nodes]
        finally:
            for n in nodes:
                await n.stop()

    hashes = run(go())
    assert all(h == hashes[0] for h in hashes)


def test_two_validator_localnet_over_tcp(tmp_path):
    privs = _privs(2, 20)
    genesis = _genesis(privs)
    socks = [socket.socket() for _ in range(2)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    homes = [_home(tmp_path, i, genesis, p, p2p={"laddr": f"tcp://127.0.0.1:{ports[i]}"})
             for i, p in enumerate(privs)]
    ids = [NodeKey.load(os.path.join(h, "config", "node_key.json")).node_id for h in homes]
    for i, home in enumerate(homes):
        cfg = load_config(os.path.join(home, "config", "config.toml"))
        cfg.p2p.persistent_peers = f"{ids[1 - i]}@127.0.0.1:{ports[1 - i]}"
        write_config(cfg, os.path.join(home, "config", "config.toml"))

    async def go():
        nodes = [make_node(_cfg(h), device="cpu") for h in homes]
        for n in nodes:
            await n.start()
        try:
            await asyncio.gather(*(n.consensus.wait_for_height(3, timeout=45.0) for n in nodes))
            return [n.block_store.load_block(2).hash() for n in nodes]
        finally:
            for n in nodes:
                await n.stop()

    a, b = run(go())
    assert a == b


# -- catch-up from served peers --


@pytest.fixture(scope="module")
def served():
    privs = workloads.seeded_keys(4, SEED, 2)
    genesis = workloads.kv_genesis(CHAIN_ID, privs)
    txs = [workloads.kv_txs(SEED, h, 6, (34, 90)) for h in range(1, 6)]
    chain, node, states = workloads.serve_chain(genesis, privs, txs, SEED, snapshot_interval=2, init_chain=True)
    return genesis, chain, node, states


def _catchup_home(tmp_path, genesis: str, **settings) -> str:
    home = str(tmp_path / "catchup")
    base = {"blocksync": {"enable": True}, "statesync": {"enable": False},
            "p2p": {"laddr": "tcp://" + workloads.NODE_MEM_ADDR,
                    "persistent_peers": workloads.catchup_peers(SERVERS, SEED)},
            "rpc": {"laddr": "tcp://127.0.0.1:0"}, "gpu": {"enable": True}}
    for section, values in settings.items():
        base.setdefault(section, {}).update(values)
    workloads.init_home(home, genesis, base)
    return home


def _jax_replay(home: str, genesis: str):
    """The JAX Handshaker replaying the home's stores into a fresh JAX
    kvstore app: (the app hash it returns, the blocks it replayed)."""
    stores = []
    for name in ("state", "blockstore"):
        db = SqliteKV(os.path.join(home, "data", f"{name}.sqlite"))
        out = JaxMemKV()
        for k, v in db.iterate():
            out.set(k, v)
        db.close()
        stores.append(out)
    state_store, block_store = JaxStateStore(stores[0]), JaxBlockStore(stores[1])
    hs = JaxHandshaker(state_store, state_store.load(), block_store, JaxGenesisDoc.from_json(genesis))
    app_hash = asyncio.run(hs.handshake(JaxLocalClient(JaxKVStore())))
    return app_hash, hs.n_blocks


def test_block_sync_then_consensus_and_a_crash_replayed(tmp_path, served):
    genesis, chain, node, states = served
    tip = len(chain)
    home = _catchup_home(tmp_path, genesis)
    run1 = workloads.run_node_start(home, node, SERVERS, SEED, device="cpu", timeout_s=40.0)
    assert (run1.applied, run1.replayed) == (tip - 1, 0)
    assert run1.state.to_proto() == states[tip - 2].to_proto()
    assert run1.app_hash == chain[tip - 1].block.header.app_hash
    assert run1.lock_released and run1.dbs_closed == run1.dbs == 5
    assert run1.node.consensus.rs.height == tip
    assert _jax_replay(home, genesis) == (run1.app_hash, tip - 1)
    plane = device_plane.installed_plane()
    assert plane == (GPUConfig(), "cpu")
    verifier = gpu_verifier._VERIFIERS["ed25519"]

    workloads.stage_crash(home, chain[tip - 1])
    run2 = workloads.run_node_start(home, node, SERVERS, SEED, device="cpu", app=KVStoreApplication(),
                                    timeout_s=40.0)
    assert (run2.applied, run2.replayed) == (0, tip)
    assert run2.state.to_proto() == states[tip - 1].to_proto()
    assert run2.app_hash == states[tip - 1].app_hash
    assert run2.lock_released and run2.dbs_closed == run2.dbs
    # the same [gpu] config: the second node reused the install
    assert gpu_verifier._VERIFIERS["ed25519"] is verifier


def test_a_block_synced_node_is_scraped_before_its_stop(tmp_path, served):
    """The checks chip_smoke's node_start part (1) makes on its scrape, on
    the plain versions: the gpu_* counters moved as stats() did (the
    gate of 2 sends each block's LastCommit to the device plane), no
    fault, one block_processing observation a block applied, /healthz at
    the store's height, three peers."""
    genesis, chain, node, states = served
    home = _catchup_home(tmp_path, genesis, gpu={"min_batch_size": 2, "bucket_sizes": [4]},
                         instrumentation={"prometheus": True, "prometheus_listen_addr": "127.0.0.1:0"})
    stats0, series0 = gpu_verifier.stats(), workloads.gpu_series()
    run1 = workloads.run_node_start(home, node, SERVERS, SEED, device="cpu", timeout_s=60.0)
    report = workloads.check_node_scrape(run1, stats0, series0, peers=len(SERVERS))
    assert report["gpu_deltas"]["batches"] > 0 and report["blocks_processed"] == len(chain) - 1
    assert run1.scraped.health["height"] == len(chain) - 1 and run1.scraped.nbytes > 0
    with pytest.raises(AssertionError, match="p2p_peers"):
        workloads.check_node_scrape(run1, stats0, series0, peers=2)


def test_state_sync_then_block_sync_then_consensus(tmp_path, served):
    genesis, chain, node, states = served
    tip = len(chain)
    trust = node.block_store.load_block_meta(1).header.hash().hex()
    home = _catchup_home(tmp_path, genesis, gpu={"enable": False}, statesync={
        "enable": True, "trust_height": 1, "trust_hash": trust, "trust_period": 10 * 365 * 24 * 3600.0,
        "discovery_time": 0.5})
    published = []

    def instrument(n):
        inner = n.event_bus.publish_state_sync_status
        n.event_bus.publish_state_sync_status = lambda data: (published.append(data), inner(data))[1]

    got = workloads.run_node_start(home, node, SERVERS, SEED, device="cpu", timeout_s=40.0,
                                   instrument=instrument)
    assert got.node.genesis_state_synced
    snapshot_height = published[0].height
    assert [(d.complete, d.height) for d in published] == [(True, snapshot_height)]
    assert snapshot_height in (2, 4)
    assert got.state.last_block_height == tip - 1
    # a bootstrapped state marks the restored height + 1 as the last
    # change of the set and the params
    want = states[tip - 2].copy()
    want.last_height_validators_changed = want.last_height_consensus_params_changed = snapshot_height + 1
    assert got.state.to_proto() == want.to_proto()
    assert got.app_hash == chain[tip - 1].block.header.app_hash


# -- the device plane at node start --


def test_gpu_enable_without_cuda_raises_at_install(tmp_path):
    priv = _privs(1, 30)[0]
    home = _home(tmp_path, 0, _genesis([priv]), priv, gpu={"enable": True})
    with pytest.raises(Exception) as err:
        make_node(_cfg(home))
    assert "CUDA" in str(err.value) or "NVIDIA" in str(err.value) or "cuda" in str(err.value)
    assert device_plane.installed_plane() is None and gpu_verifier.installed() is None


async def _http_get(port: int, path: str):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(f"GET {path} HTTP/1.1\r\nHost: x\r\n\r\n".encode())
    await writer.drain()
    data = await reader.read(-1)
    writer.close()
    head, _, body = data.decode().partition("\r\n\r\n")
    return head.splitlines()[0], body


def test_prometheus_is_refused_until_item_11(tmp_path):
    """Item 11a ported the metrics plane, so prometheus = true is no
    longer refused: the node serves its series on /metrics and its height
    on /healthz, on the port it was given (127.0.0.1:0, taken free), and
    closes that port when it stops."""
    priv = _privs(1, 31)[0]
    home = _home(tmp_path, 0, _genesis([priv]), priv,
                 instrumentation={"prometheus": True, "prometheus_listen_addr": "127.0.0.1:0"})

    async def go():
        node = make_node(_cfg(home), device="cpu")
        await node.start()
        try:
            await node.consensus.wait_for_height(3, timeout=30.0)
            status, text = await _http_get(node.metrics_port, "/metrics")
            assert "200 OK" in status
            for needle in ("tendermint_tpu_consensus_height ", "tendermint_tpu_gpu_verify_batches_total ",
                           "tendermint_tpu_state_block_processing_seconds_count "):
                assert needle in text, needle
            status, body = await _http_get(node.metrics_port, "/healthz")
            health = json.loads(body)
            assert "200 OK" in status and health["node_id"] == node.node_key.node_id
            assert 2 <= health["height"] <= node.block_store.height() and health["syncing"] is False
            port = node.metrics_port
        finally:
            await node.stop()
        with pytest.raises(OSError):
            await _http_get(port, "/healthz")

    run(go())


def test_a_second_node_reuses_the_install_or_overrides_it(tmp_path, caplog):
    priv = _privs(1, 32)[0]
    genesis = _genesis([priv])
    homes = [_home(tmp_path, i, genesis, priv, gpu={"enable": True, "min_batch_size": mb})
             for i, mb in enumerate((32, 32, 16))]
    caplog.set_level(logging.INFO, logger="tendermint_tpu_torch.node")
    make_node(_cfg(homes[0]), device="cpu")
    verifier = gpu_verifier._VERIFIERS["ed25519"]
    make_node(_cfg(homes[1]), device="cpu")
    assert gpu_verifier._VERIFIERS["ed25519"] is verifier
    assert "overriding" not in caplog.text
    make_node(_cfg(homes[2]), device="cpu")
    assert gpu_verifier._VERIFIERS["ed25519"] is not verifier and gpu_verifier.installed() == 16
    assert "already installed with another [gpu] config" in caplog.text


def test_a_failed_launch_under_the_handshake_raises_from_start(tmp_path, served, monkeypatch):
    genesis, chain, node, _states = served
    tip = len(chain)
    home = _catchup_home(tmp_path, genesis, gpu={"enable": False})
    workloads.run_node_start(home, node, SERVERS, SEED, device="cpu", timeout_s=40.0)
    workloads.stage_crash(home, chain[tip - 1])
    cfg = load_config(os.path.join(home, "config", "config.toml"))
    cfg.gpu.enable, cfg.gpu.min_batch_size = True, 2
    write_config(cfg, os.path.join(home, "config", "config.toml"))
    monkeypatch.setattr(Ed25519Verifier, "dispatch",
                        lambda self, *a: (_ for _ in ()).throw(RuntimeError("CUDA error: launch failed")))

    async def go():
        n = make_node(_cfg(home), app=KVStoreApplication(), transport=MemoryTransport(MemoryNetwork(), "x.mem:1"),
                      device="cpu")
        with pytest.raises(RuntimeError, match="launch failed"):
            await n.start()
        return n

    n = run(go())
    assert not n.data_locked
    lock = os.path.join(home, "data", "LOCK")
    release_pid_lock(lock, acquire_pid_lock(lock))


_FAILING_START = """
import sys
from tendermint_tpu_torch.ops.ed25519_kernel import Ed25519Verifier
def dispatch(self, *args):
    raise RuntimeError("CUDA error: launch failed")
Ed25519Verifier.dispatch = dispatch
from tendermint_tpu_torch.cmd import main
sys.exit(main(sys.argv[1:]))
"""


def test_a_failed_launch_under_block_sync_ends_the_start_process(tmp_path, served):
    """A `start` process whose block sync meets a failed launch stops its
    node and exits non-zero, with no signal sent to it."""
    genesis, _chain, node, _states = served
    base = workloads._free_port_base(len(SERVERS) + 1)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))

    async def go():
        peers = [workloads.serving_node(node, workloads.node_key(SEED, k), TCPTransport(), CHAIN_ID,
                                        f"127.0.0.1:{base + i}") for i, k in enumerate(SERVERS)]
        for peer in peers:
            await peer.start()
        try:
            home = _catchup_home(tmp_path, genesis, gpu={"enable": True, "min_batch_size": 2}, p2p={
                "laddr": f"tcp://127.0.0.1:{base + len(SERVERS)}",
                "persistent_peers": ",".join(f"{p.node_id}@127.0.0.1:{base + i}" for i, p in enumerate(peers))})
            proc = await asyncio.create_subprocess_exec(
                sys.executable, "-c", _FAILING_START, "--home", home, "start", "--device", "cpu",
                cwd=root, env=env, stdout=asyncio.subprocess.PIPE, stderr=asyncio.subprocess.STDOUT)
            try:
                out, _ = await asyncio.wait_for(proc.communicate(), 45.0)
            finally:
                if proc.returncode is None:
                    proc.kill()
                    await proc.wait()
            return proc.returncode, out.decode(errors="replace")
        finally:
            for peer in peers:
                await peer.stop()

    rc, out = run(go())
    assert rc not in (0, -signal.SIGTERM, -signal.SIGKILL), out
    assert "CUDA error: launch failed" in out
    assert "node started" in out


def test_malformed_params_leave_a_started_node_serving(tmp_path):
    """A single validator under `start`'s loop answers the three requests
    of params "x", 7 and true INTERNAL_ERROR and goes on: no failure()
    ends the loop, and its RPC answers /status after them."""
    from tendermint_tpu_torch.cmd.commands import _FAILURE_POLL_S, _run_until_stopped

    from .test_torch_rpc import MALFORMED_PARAMS, post_request, raw_http

    priv = _privs(1, 11)[0]
    home = _home(tmp_path, 0, _genesis([priv]), priv)

    async def go():
        node = make_node(_cfg(home), device="cpu")
        await node.start()
        loop_task = asyncio.ensure_future(_run_until_stopped(node))
        addr = f"127.0.0.1:{node.rpc_server.bound_port}"
        answers = [await raw_http(addr, post_request(req)) for req in MALFORMED_PARAMS]
        await asyncio.sleep(3 * _FAILURE_POLL_S)
        running = not loop_task.done()
        status = await raw_http(addr, b"GET /status HTTP/1.1\r\nHost: x\r\nConnection: close\r\n\r\n")
        loop_task.cancel()
        with pytest.raises(asyncio.CancelledError):
            await loop_task
        return answers, running, status, node

    answers, running, status, node = run(go())
    for a in answers:
        err = json.loads(a.split(b"\r\n\r\n", 1)[1])["error"]
        assert err["code"] == -32603 and err["message"].startswith("AttributeError(")
    assert running and node.failure() is None
    assert json.loads(status.split(b"\r\n\r\n", 1)[1])["result"]["node_info"]["network"] == CHAIN_ID
    assert not node.data_locked


def test_a_step_machine_ended_by_an_error_ends_start(tmp_path, monkeypatch):
    """A single validator with TM_TPU_FAULT="wal.fsync:io_error:p=0.05:
    seed=3:times=1": the fsync of an own message raises OSError in the
    step machine's receive loop; "task receive failed" is logged at ERROR
    when the loop ends, before the stop, and `start`'s loop stops the
    node and raises that OSError within seconds."""
    from tendermint_tpu_torch.cmd.commands import _run_until_stopped
    from tendermint_tpu_torch.crypto import faults

    priv = _privs(1, 13)[0]
    home = _home(tmp_path, 0, _genesis([priv]), priv)
    events = []

    class _Record(logging.Handler):
        def emit(self, record):
            if record.levelno >= logging.ERROR:
                events.append(("log", record.getMessage(), record.exc_info))

    async def go():
        node = make_node(_cfg(home), device="cpu")
        await node.start()
        stop = node.stop

        async def recorded_stop():
            events.append(("stop",))
            await stop()

        node.stop = recorded_stop
        t0 = time.monotonic()
        with pytest.raises(OSError) as err:
            await _run_until_stopped(node)
        return time.monotonic() - t0, err.value, node

    handler = _Record()
    logger = logging.getLogger("tendermint_tpu_torch.consensus.state")
    logger.addHandler(handler)
    monkeypatch.setenv("TM_TPU_FAULT", "wal.fsync:io_error:p=0.05:seed=3:times=1")
    faults.load_env()
    try:
        elapsed, error, node = run(go(), 30.0)
    finally:
        logger.removeHandler(handler)
        faults.reset()
    assert elapsed < 10.0
    assert events[0][:2] == ("log", "task receive failed") and events[0][2][1] is error
    assert events[1] == ("stop",)
    assert not node.data_locked


def test_cli_testnet_processes_reach_height_2_and_exit_0(tmp_path):
    nodes = workloads.cli_localnet(str(tmp_path / "net"), 2, 2, gpu=False, device="cpu", timeout_s=90.0,
                                   settings={"consensus": FAST}, prometheus=True)
    assert [nd.rc for nd in nodes] == [0] * 2
    assert all(nd.height >= 2 for nd in nodes)
    assert all(any("node started" in line for line in nd.log) for nd in nodes)
    # each process served /metrics on its own port, scraped at height 2
    assert len({nd.metrics_port for nd in nodes}) == 2
    for nd in nodes:
        assert workloads.check_cli_scrape(nd, 2)["consensus_height"] >= 2
