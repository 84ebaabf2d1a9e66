"""The operator CLI: `python3 -m tendermint_tpu_torch.cmd <command>`.

Counterpart: tendermint_tpu/cmd/commands.py (reference:
cmd/tendermint/commands/): the node's own commands init (:45), signer
(:91, the remote signer over TCP, or its gRPC server with --grpc),
start (:151), gen-validator (:187), gen-node-key (:210), show-node-id
(:227), show-validator (:236), rollback (:258), unsafe-reset-all (:287),
testnet (:311), light (:362, a verifying proxy over HTTPProvider with
the routes header, commit, light_block and status), inspect (:465,
_inspect_serve :485: read-only RPC over a stopped node's stores, its
lock held), replay and replay --console (:550, _stdin_reader_queue
:633, _console_rs :669, _replay_console :702), e2e generate and run
[--processes] (:1059), key-migrate (:1115), version (:1150),
reindex-event (:1188) and abci (:1284, :1337: the kvstore app behind a
socket or --grpc server, a client sending one request, or the
interactive `abci console`), with build_parser (:1418) and main (:1651). argparse in place of cobra; every
command works on a --home laid out as make_node reads it
(config/config.toml, config/genesis.json, config/node_key.json,
config/priv_validator_key.json, data/). The default home is
~/.tendermint_tpu_torch ($TMHOME overrides it).

`start` runs the node with its device plane on the card
(make_node(..., device="cuda")) when [gpu] enable is true; the kernels
are built from the repository's sources into build/torch_kernels/ (or
loaded from there) at the install. SIGINT and SIGTERM stop the node, and
the command exits 0 after a clean stop. A part of the node that ends on
an error while it runs (block sync's pool routine, the step machine's
receive loop, the evidence loop, an RPC route, the state sync task:
Node.failure) stops the node too, and
the command raises that error, so it exits non-zero without a signal.

`light` and `replay` install the device plane too, from the home's
[gpu] (defaults where the home has no config.toml), on `--device`
(cuda; cpu runs the kernels' plain versions); the JAX commands install
none. A failed install or launch ends the command with an error: neither
carries on on the CPU. Each prints, as the last line of its standard
output (an error's traceback follows on stderr), "device plane:" and
node/device.py plane_report() as JSON: its launches, and the faults
and rerouted signatures of TM_TPU_FAULT (crypto/faults.py), which arms
any command's process. `light` serves until SIGINT or SIGTERM, or until
a route raises an error that is not the route's own answer (the
server's failure(), polled as `start` polls its node), and then raises
it.

Left out: `debug` (ROADMAP item 11c, with its device profile).
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import shutil
import signal
import sys
import time
from typing import List, Optional

from .. import version as _version
from ..config import DEFAULT_HOME, Config, load_config, write_config
from ..crypto.ed25519 import PrivKeyEd25519


def _config_path(home: str) -> str:
    return os.path.join(os.path.expanduser(home), "config", "config.toml")


def _load_home(home: str) -> Config:
    path = _config_path(home)
    cfg = load_config(path) if os.path.exists(path) else Config()
    cfg.base.home = home
    return cfg


# -- init (reference: commands/init.go) -------------------------------------


def cmd_init(args) -> int:
    from ..node.key import NodeKey
    from ..privval.file import FilePV
    from ..types.genesis import GenesisDoc, GenesisValidator

    cfg = Config()
    cfg.base.home = args.home
    cfg.base.mode = args.mode
    cfg.base.moniker = args.moniker
    cfg.ensure_dirs()

    genesis_path = cfg.base.path(cfg.base.genesis_file)
    pv = None
    if args.mode == "validator":
        try:
            pv = FilePV.load_or_generate(
                cfg.base.path(cfg.priv_validator.key_file),
                cfg.base.path(cfg.priv_validator.state_file),
                key_type=getattr(args, "key", None) or "ed25519",
            )
        except ValueError as e:  # a key type the port does not sign with
            print(str(e), file=sys.stderr)
            return 1
    if os.path.exists(genesis_path):
        print(f"found genesis file {genesis_path}")
        genesis = GenesisDoc.from_file(genesis_path)
    else:
        chain_id = args.chain_id or f"test-chain-{os.urandom(3).hex()}"
        validators = []
        if pv is not None:
            validators.append(GenesisValidator(pub_key=pv.key.pub_key, power=10))
        genesis = GenesisDoc(chain_id=chain_id, genesis_time_ns=time.time_ns(), validators=validators)
        genesis.save_as(genesis_path)
        print(f"generated genesis file {genesis_path}")
    cfg.base.chain_id = genesis.chain_id
    NodeKey.load_or_generate(cfg.base.path(cfg.base.node_key_file))
    write_config(cfg, _config_path(args.home))
    print(f"initialized {args.mode} node in {cfg.base.root()}")
    return 0


# -- signer and start (reference: commands/run_node.go) ---------------------


def cmd_signer(args) -> int:
    """The external signing process for a node's [priv_validator]
    listen_addr: this home's FilePV (its key and its double-sign state)
    serving signing requests over SecretConnection, dialing the node, or
    with --grpc as a gRPC server the node dials (reference:
    privval/signer_server.go, privval/grpc/server.go)."""
    from ..libs.log import configure
    from ..privval.file import FilePV
    from ..privval.signer import SignerServer

    cfg = _load_home(args.home)
    configure(level=cfg.base.log_level, json_format=cfg.base.log_format == "json")
    pv = FilePV.load(
        cfg.base.path(cfg.priv_validator.key_file),
        cfg.base.path(cfg.priv_validator.state_file),
    )
    if args.grpc and args.node_id:
        print("--node-id applies to the socket transport only (gRPC has no identity check)",
              file=sys.stderr)
        return 2
    print(f"signer for validator {pv.key.address.hex()} -> {args.addr}", flush=True)

    async def run() -> None:
        if args.grpc:
            from ..privval.grpc import GRPCSignerServer

            srv = GRPCSignerServer(args.addr, cfg.base.chain_id, pv)
        else:
            srv = SignerServer(args.addr, pv, expected_node_id=args.node_id, chain_id=cfg.base.chain_id)
        loop = asyncio.get_running_loop()
        stop = asyncio.Event()
        for sig in (signal.SIGINT, signal.SIGTERM):
            loop.add_signal_handler(sig, stop.set)
        await srv.start()
        try:
            await stop.wait()
        finally:
            await srv.stop()

    asyncio.run(run())
    return 0


# how often `start` asks the running node whether a part of it ended on
# an error (Node.failure)
_FAILURE_POLL_S = 0.2


def cmd_start(args) -> int:
    from ..libs.log import configure
    from ..node import make_node

    cfg = _load_home(args.home)
    if args.moniker:
        cfg.base.moniker = args.moniker
    configure(level=cfg.base.log_level, json_format=cfg.base.log_format == "json")

    async def run() -> None:
        node = make_node(cfg, device=args.device)
        # a failed start tears itself down: only a started node owes a stop
        await node.start()
        await _run_until_stopped(node)

    asyncio.run(run())
    return 0


async def _run_until_stopped(part) -> None:
    """Wait for SIGINT or SIGTERM, or for an error a part of `part` ended
    on (its failure(), polled every _FAILURE_POLL_S), then stop it; raise
    that error. stop() of a node raises it too."""
    loop = asyncio.get_running_loop()
    stop = asyncio.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop.set)
    failed = None
    try:
        while failed is None and not stop.is_set():
            try:
                await asyncio.wait_for(stop.wait(), _FAILURE_POLL_S)
            except asyncio.TimeoutError:
                failed = part.failure()
    finally:
        await part.stop()
    if failed is not None:
        raise failed


# -- keys and identity ------------------------------------------------------


def cmd_gen_validator(args) -> int:
    """Print a fresh validator key (reference: commands/gen_validator.go)."""
    from ..crypto.keys import generate_priv_key

    key_type = getattr(args, "key", None) or "ed25519"
    try:
        priv = generate_priv_key(key_type)
    except ValueError as e:
        print(str(e), file=sys.stderr)
        return 1
    out = {
        "address": priv.pub_key().address().hex().upper(),
        "pub_key": {"type": key_type, "value": priv.pub_key().bytes().hex()},
        "priv_key": {"type": key_type, "value": priv.bytes().hex()},
    }
    # the command's contract is the fresh private key on stdout, for the
    # operator to install
    print(json.dumps(out, indent=2))
    return 0


def cmd_gen_node_key(args) -> int:
    """Write a fresh node key into --home and print its ID; an existing
    key is not overwritten (reference: commands/gen_node_key.go)."""
    from ..node.key import NodeKey

    cfg = _load_home(args.home)
    cfg.ensure_dirs()
    path = cfg.base.path(cfg.base.node_key_file)
    if os.path.exists(path):
        print(f"node key file already exists at {path}", file=sys.stderr)
        return 1
    nk = NodeKey(priv_key=PrivKeyEd25519.generate())
    nk.save_as(path)
    print(nk.node_id)
    return 0


def cmd_show_node_id(args) -> int:
    from ..node.key import NodeKey

    cfg = _load_home(args.home)
    print(NodeKey.load_or_generate(cfg.base.path(cfg.base.node_key_file)).node_id)
    return 0


def cmd_show_validator(args) -> int:
    from ..privval.file import FilePV

    cfg = _load_home(args.home)
    pv = FilePV.load_or_generate(
        cfg.base.path(cfg.priv_validator.key_file),
        cfg.base.path(cfg.priv_validator.state_file),
    )
    print(json.dumps({"type": pv.key.pub_key.type(), "value": pv.key.pub_key.bytes().hex()}))
    return 0


# -- offline data commands (reference: commands/rollback.go, reset.go) ------


class _ensure_node_stopped:
    """For an offline data-dir command: refuse while a running node
    holds the data dir's LOCK, and hold it for the command, so that a
    node started meanwhile fails fast (node.Node._acquire_data_lock)."""

    def __init__(self, cfg: Config) -> None:
        self.lock = os.path.join(cfg.base.path(cfg.base.db_dir), "LOCK")
        self._fd: Optional[int] = None

    def __enter__(self) -> "_ensure_node_stopped":
        from ..node.node import acquire_pid_lock

        try:
            self._fd = acquire_pid_lock(self.lock)
        except RuntimeError as e:
            raise RuntimeError(f"node appears to be running ({e}); stop it first") from None
        return self

    def __exit__(self, *exc) -> None:
        if self._fd is not None:
            from ..node.node import release_pid_lock

            release_pid_lock(self.lock, self._fd)
            self._fd = None


def cmd_rollback(args) -> int:
    from ..state.store import StateStore
    from ..store.block_store import BlockStore
    from ..store.kv import open_db

    cfg = _load_home(args.home)
    try:
        with _ensure_node_stopped(cfg):
            db_dir = cfg.base.path(cfg.base.db_dir)
            state_db = open_db("state", cfg.base.db_backend, db_dir)
            block_db = open_db("blockstore", cfg.base.db_backend, db_dir)
            try:
                new_state = StateStore(state_db).rollback(BlockStore(block_db))
                print(
                    "rolled back state to height "
                    f"{new_state.last_block_height} "
                    f"app_hash {new_state.app_hash.hex()}"
                )
            finally:
                state_db.close()
                block_db.close()
    except RuntimeError as e:
        print(str(e), file=sys.stderr)
        return 1
    return 0


def cmd_reset_unsafe(args) -> int:
    """Remove every DB, keep the config and the keys (reference:
    commands/reset.go UnsafeResetAll)."""
    cfg = _load_home(args.home)
    try:
        with _ensure_node_stopped(cfg):
            data = cfg.base.path("data")
            if os.path.isdir(data):
                shutil.rmtree(data)
            os.makedirs(data, exist_ok=True)
            os.makedirs(os.path.dirname(cfg.base.path(cfg.consensus.wal_file)), exist_ok=True)
    except RuntimeError as e:
        print(str(e), file=sys.stderr)
        return 1
    print(f"removed all data in {data} (config and keys kept)")
    return 0


def cmd_key_migrate(args) -> int:
    """Rewrite the legacy string-prefixed DB keys in the binary layout
    (reference: commands/key_migrate.go, scripts/keymigrate); keys
    already migrated are skipped, so a cut run resumes."""
    from ..store.keymigrate import CONTEXTS, migrate_db
    from ..store.kv import open_db

    cfg = _load_home(args.home)
    try:
        with _ensure_node_stopped(cfg):
            db_dir = cfg.base.path(cfg.base.db_dir)
            total = 0
            # the migrator's own table: a context born in the current
            # layout has no entry and is not opened
            for i, ctx in enumerate(CONTEXTS):
                db = open_db(ctx, cfg.base.db_backend, db_dir)
                try:
                    n = migrate_db(db, ctx)
                finally:
                    db.close()
                print(f"[{i + 1}/{len(CONTEXTS)}] {ctx}: {n} key(s) migrated")
                total += n
            print(f"completed database migration: {total} key(s)")
    except RuntimeError as e:
        print(str(e), file=sys.stderr)
        return 1
    return 0


def cmd_reindex_event(args) -> int:
    """Rebuild the tx and block event indexes from the stored blocks and
    ABCI responses (reference: commands/reindex_event.go)."""
    cfg = _load_home(args.home)
    try:
        with _ensure_node_stopped(cfg):
            return _reindex_events(cfg, args)
    except RuntimeError as e:
        print(str(e), file=sys.stderr)
        return 1


def _reindex_events(cfg: Config, args) -> int:
    from ..state.indexer import KVSink, TxResult
    from ..state.store import StateStore
    from ..store.block_store import BlockStore
    from ..store.kv import open_db

    db_dir = cfg.base.path(cfg.base.db_dir)
    bdb = open_db("blockstore", cfg.base.db_backend, db_dir)
    sdb = open_db("state", cfg.base.db_backend, db_dir)
    idb = open_db("tx_index", cfg.base.db_backend, db_dir)
    try:
        bs = BlockStore(bdb)
        st = StateStore(sdb)
        sink = KVSink(idb)
        base, tip = bs.base(), bs.height()
        start = args.start_height or base
        end = args.end_height or tip
        if start < base or end > tip or start > end:
            print(f"invalid range [{start}, {end}]: stored blocks span [{base}, {tip}]", file=sys.stderr)
            return 1
        done = skipped = 0
        for height in range(start, end + 1):
            block = bs.load_block(height)
            resp = st.load_abci_responses(height)
            if block is None or resp is None:
                skipped += 1
                continue
            if len(resp.deliver_txs) != len(block.txs):
                # a truncated zip would drop txs while claiming success
                print(
                    f"height {height}: {len(block.txs)} txs but "
                    f"{len(resp.deliver_txs)} saved results; skipped",
                    file=sys.stderr,
                )
                skipped += 1
                continue
            events = list(getattr(resp.begin_block_obj, "events", ()) or ())
            events += list(getattr(resp.end_block_obj, "events", ()) or ())
            sink.index_block_events(height, events)
            results = [
                TxResult(height=height, index=i, tx=tx, result=r)
                for i, (tx, r) in enumerate(zip(block.txs, resp.deliver_tx_objs))
            ]
            if results:
                sink.index_tx_events(results)
            done += 1
        if done == 0:
            print(
                f"no heights reindexed in [{start}, {end}]: stored "
                "blocks or ABCI responses are missing (pruned?)",
                file=sys.stderr,
            )
            return 1
        print(
            f"reindexed {done} heights in [{start}, {end}]"
            + (f" ({skipped} skipped: missing data)" if skipped else "")
        )
        return 0
    finally:
        bdb.close()
        sdb.close()
        idb.close()


# -- the device plane of light and replay -----------------------------------


def _install_plane(cfg: Config, device: str) -> None:
    """install_device_plane(cfg.gpu, device); it raises when CUDA, a
    kernel or the native CPU plane is missing."""
    from ..node.device import install_device_plane

    if install_device_plane(cfg.gpu, device):
        print(f"device plane installed on {device} (min_batch {cfg.gpu.min_batch_size})", flush=True)


def _print_plane_report() -> None:
    from ..node.device import plane_report

    print("device plane: " + json.dumps(plane_report(), sort_keys=True), flush=True)


# -- light (reference: commands/light.go, the verifying proxy) ---------------


def cmd_light(args) -> int:
    from ..light import Client, LightStore, TrustOptions
    from ..light.provider import HTTPProvider
    from ..node.device import uninstall_device_plane
    from ..rpc.core import encode
    from ..rpc.jsonrpc import INVALID_PARAMS, JSONRPCServer, RPCError
    from ..rpc.server import _split_laddr
    from ..store.kv import open_db

    cfg = _load_home(args.home)
    home = os.path.expanduser(args.home)
    os.makedirs(os.path.join(home, "light"), exist_ok=True)
    _install_plane(cfg, args.device)
    db = open_db("light", "sqlite", os.path.join(home, "light"))

    async def run() -> None:
        primary = HTTPProvider(args.primary)
        witnesses = [HTTPProvider(w) for w in args.witness or []]
        client = Client(
            args.chain_id,
            TrustOptions(
                period_ns=int(args.trust_period * 1e9),
                height=args.trust_height,
                hash=bytes.fromhex(args.trust_hash),
            ),
            primary,
            witnesses,
            LightStore(db),
            sequential=args.sequential,
        )

        def height_of(req) -> int:
            h = int(req.params.get("height", 0))
            if h <= 0:
                raise RPCError(INVALID_PARAMS, "height required")
            return h

        async def verified(req):
            return await client.verify_light_block_at_height(height_of(req), time.time_ns())

        async def route_header(req):
            lb = await verified(req)
            return {"header": encode(lb.signed_header.header)}

        async def route_commit(req):
            lb = await verified(req)
            return {"signed_header": encode(lb.signed_header), "canonical": True}

        async def route_light_block(req):
            lb = await verified(req)
            return {"height": lb.height, "light_block": lb.to_proto().hex()}

        async def route_status(req):
            lb = client.store.latest_light_block()
            return {
                "chain_id": args.chain_id,
                "trusted_height": lb.height if lb is not None else 0,
                "primary": args.primary,
                "witnesses": [w.id() for w in witnesses],
            }

        server = JSONRPCServer(
            {
                "header": route_header,
                "commit": route_commit,
                "light_block": route_light_block,
                "status": route_status,
            }
        )
        host, port = _split_laddr(args.laddr)
        await server.start(host, port)
        print(f"light client proxy for {args.chain_id} on {host}:{server.bound_port} "
              f"(primary {args.primary})", flush=True)
        try:
            await _run_until_stopped(server)
        finally:
            for p in [primary, *witnesses]:
                await p.close()

    try:
        asyncio.run(run())
    finally:
        db.close()
        _print_plane_report()
        uninstall_device_plane()
    return 0


# -- inspect (reference: internal/inspect) ------------------------------------

# the routes inspect serves: those that read the stores alone
INSPECT_ROUTES = (
    "health", "status", "genesis", "genesis_chunked", "blockchain",
    "header", "header_by_hash", "block", "block_by_hash",
    "block_results", "commit", "validators", "consensus_params",
    "tx", "tx_search", "block_search", "light_block",
)


def cmd_inspect(args) -> int:
    """Read-only RPC over a stopped node's stores. The data dir's lock
    is held while it serves, so that a node (or rollback, or a reset)
    started meanwhile fails fast; only taking the lock maps to the
    one-line refusal."""
    cfg = _load_home(args.home)
    guard = _ensure_node_stopped(cfg)
    try:
        guard.__enter__()
    except RuntimeError as e:
        print(str(e), file=sys.stderr)
        return 1
    try:
        return _inspect_serve(cfg, args)
    finally:
        guard.__exit__(None, None, None)


def _inspect_serve(cfg: Config, args) -> int:
    from ..rpc.core import Environment
    from ..rpc.jsonrpc import JSONRPCServer
    from ..rpc.server import _split_laddr
    from ..state.indexer import KVSink
    from ..state.store import StateStore
    from ..store.block_store import BlockStore
    from ..store.kv import open_db
    from ..types.genesis import GenesisDoc

    db_dir = cfg.base.path(cfg.base.db_dir)
    dbs = [open_db(n, cfg.base.db_backend, db_dir) for n in ("blockstore", "state", "tx_index")]
    try:
        gpath = cfg.base.path(cfg.base.genesis_file)
        genesis = GenesisDoc.from_file(gpath) if os.path.exists(gpath) else None
        env = Environment(
            chain_id=genesis.chain_id if genesis else "",
            block_store=BlockStore(dbs[0]),
            state_store=StateStore(dbs[1]),
            genesis=genesis,
            event_sinks=[KVSink(dbs[2])],
            cfg=cfg,
        )
        read_only = {k: v for k, v in env.routes().items() if k in INSPECT_ROUTES}

        async def run() -> None:
            server = JSONRPCServer(read_only)
            host, port = _split_laddr(args.laddr)
            await server.start(host, port)
            print(f"inspect server on {host}:{server.bound_port} "
                  f"(read-only routes: {', '.join(sorted(read_only))})", flush=True)
            await _run_until_stopped(server)

        asyncio.run(run())
    finally:
        for db in dbs:
            db.close()
    return 0


# -- replay (reference: commands/replay.go, consensus/replay_file.go) --------


def cmd_replay(args) -> int:
    """Re-execute the stored blocks through a fresh builtin app, with the
    device plane installed from the home's [gpu] (the app's roots take
    X4); print the final state's height and app hash. With --console,
    step the WAL's records after the last height one at a time
    (reference: replay_file.go:54, 188-193)."""
    from ..abci.client import local_creator
    from ..abci.kvstore import KVStoreApplication
    from ..abci.proxy import AppConns
    from ..consensus.replay import Handshaker
    from ..node.device import uninstall_device_plane
    from ..state.store import StateStore
    from ..state.types import state_from_genesis
    from ..store.block_store import BlockStore
    from ..store.kv import open_db
    from ..types.genesis import GenesisDoc

    cfg = _load_home(args.home)
    try:
        guard = _ensure_node_stopped(cfg)
        guard.__enter__()
    except RuntimeError as e:
        print(str(e), file=sys.stderr)
        return 1
    try:
        _install_plane(cfg, args.device)
        db_dir = cfg.base.path(cfg.base.db_dir)
        block_db = open_db("blockstore", cfg.base.db_backend, db_dir)
        state_db = open_db("state", cfg.base.db_backend, db_dir)
        genesis = GenesisDoc.from_file(cfg.base.path(cfg.base.genesis_file))

        async def run() -> None:
            block_store = BlockStore(block_db)
            # the node's own state store, as the reference's
            # newConsensusStateForReplay (replay_file.go:295) uses it
            state_store = StateStore(state_db)
            state = state_store.load()
            if state is None:
                state = state_from_genesis(genesis)
                state_store.save(state)
            proxy = AppConns(local_creator(KVStoreApplication()))
            await proxy.start()
            try:
                await Handshaker(state_store, state, block_store, genesis).handshake(proxy.consensus)
                final = state_store.load()
                print(f"replayed {block_store.height()} blocks; final height "
                      f"{final.last_block_height} app_hash {final.app_hash.hex()}", flush=True)
                if args.console:
                    await _replay_console(cfg, final, proxy, block_store)
            finally:
                await proxy.stop()

        try:
            asyncio.run(run())
        finally:
            block_db.close()
            state_db.close()
            _print_plane_report()
            uninstall_device_plane()
    finally:
        guard.__exit__(None, None, None)
    return 0


async def _build_replay_cs(cfg: Config, state, proxy, block_store):
    """A playback-only ConsensusState (replay_mode) over the handshaken
    state: no signer, no live WAL; its ticker runs so that scheduled
    timeouts are tracked, and the console feeds the recorded
    TimeoutInfo records."""
    from ..config import MempoolConfig
    from ..consensus.state import ConsensusState
    from ..mempool.mempool import TxMempool
    from ..state.execution import BlockExecutor
    from ..state.store import StateStore
    from ..store.kv import MemKV

    state_store = StateStore(MemKV())
    state_store.save(state)
    mempool = TxMempool(proxy.mempool, MempoolConfig())
    block_exec = BlockExecutor(state_store, proxy.consensus, mempool, block_store=block_store)
    cs = ConsensusState(cfg.consensus, state, block_exec, block_store, privval=None, replay_mode=True)
    await cs.ticker.start()
    return cs


def _stdin_reader_queue(loop, prompt: str = "") -> "asyncio.Queue":
    """Stdin lines into an asyncio.Queue from a daemon thread, so that a
    console never parks the event loop it shares with the ABCI clients,
    and asyncio.run's teardown never joins a thread parked in input().
    EOF (or a closed loop) ends the stream with None."""
    import threading

    lines: asyncio.Queue = asyncio.Queue()

    def post(item) -> None:
        try:
            loop.call_soon_threadsafe(lines.put_nowait, item)
        except RuntimeError:
            pass  # the loop closed: the console is gone

    def reader() -> None:
        while True:
            try:
                raw = input(prompt)
            except Exception:  # EOF, a closed or broken stdin
                post(None)
                return
            post(raw)

    threading.Thread(target=reader, daemon=True).start()
    return lines


def _console_rs(cs, field: str) -> str:
    """One view of the round state (reference: replay_file.go:259-287)."""
    rs = cs.rs
    if field in ("short", ""):
        return f"{rs.height}/{rs.round}/{rs.step}"
    if field == "locked_round":
        return str(rs.locked_round)
    if field == "locked_block":
        return rs.locked_block.hash().hex() if rs.locked_block is not None else "nil"
    if field == "proposal":
        return repr(rs.proposal)
    if field == "validators":
        return "\n".join(f"{v.address.hex()} power={v.voting_power}" for v in rs.validators.validators)
    if field == "votes":
        out = []
        for r in range(rs.round + 1):
            pv = rs.votes.prevotes(r)
            pc = rs.votes.precommits(r)
            out.append(f"round {r}: prevotes={pv.bit_array() if pv else None} "
                       f"precommits={pc.bit_array() if pc else None}")
        return "\n".join(out)
    return f"unknown rs field {field!r}"


async def _replay_console(cfg: Config, state, proxy, block_store) -> None:
    """WAL playback (reference: replay_file.go console: next [N], back
    [N], rs [field], n, quit): the records after the last EndHeight, one
    at a time through a replay-mode ConsensusState. `back` rebuilds the
    state machine and replays to count - N, as the reference does."""
    from ..consensus.wal import WAL

    wal = WAL(cfg.base.path(cfg.consensus.wal_file))
    end_height = state.last_block_height
    msgs = wal.search_for_end_height(end_height)
    if msgs is None:
        print(f"cannot replay: WAL has no EndHeight({end_height}) marker (missing or corrupt WAL)")
        return
    print(f"console: {len(msgs)} WAL records after EndHeight({end_height}); commands: next [N] | "
          "back [N] | rs [short|locked_round|locked_block|proposal|validators|votes] | n | quit")
    cs = await _build_replay_cs(cfg, state, proxy, block_store)
    pos = 0

    async def apply_one() -> bool:
        nonlocal pos
        if pos >= len(msgs):
            print("end of WAL")
            return False
        m = msgs[pos]
        pos += 1
        try:
            await cs.replay_one(m)
        except RuntimeError as e:  # an EndHeight in the tail: store and WAL disagree
            print(f"replay error at #{pos}: {e}")
            return False
        print(f"#{pos}: {type(m).__name__} -> {_console_rs(cs, 'short')}")
        return True

    lines = _stdin_reader_queue(asyncio.get_running_loop(), prompt="> ")
    while True:
        line = await lines.get()
        if line is None:
            break
        tokens = line.split()
        if not tokens:
            continue
        cmd, rest = tokens[0], tokens[1:]
        count = int(rest[0]) if rest and rest[0].isdigit() else 1
        if cmd in ("quit", "q"):
            break
        elif cmd == "next":
            for _ in range(count):
                if not await apply_one():
                    break
        elif cmd == "back":
            target = max(0, pos - count)
            await cs.ticker.stop()
            cs = await _build_replay_cs(cfg, state, proxy, block_store)
            pos = 0
            for _ in range(target):
                await apply_one()
            print(f"rewound to #{pos}")
        elif cmd == "rs":
            print(_console_rs(cs, rest[0] if rest else ""))
        elif cmd == "n":
            print(pos)
        else:
            print(f"unknown command {cmd!r}")
    await cs.ticker.stop()


# -- e2e (reference: the test/e2e runner and generator) ----------------------


def cmd_e2e(args) -> int:
    """`e2e generate` writes seeded manifests; `e2e run` runs one, in
    process or (--processes) a `start` process a node, and prints the
    report as JSON. The nodes' device plane runs on --device (cuda; cpu
    writes [gpu] enable = false)."""
    from ..e2e import Manifest, generate, run_manifest

    if args.e2e_cmd == "generate":
        if args.manifest:
            print("e2e generate takes no manifest argument", file=sys.stderr)
            return 1
        out = os.path.expanduser(args.output_dir)
        os.makedirs(out, exist_ok=True)
        for i, m in enumerate(generate(seed=args.seed, count=args.count)):
            path = os.path.join(out, f"gen-{args.seed}-{i}.toml")
            with open(path, "w") as f:
                f.write(m.to_toml())
            print(path)
        return 0
    if not args.manifest:
        print("e2e run requires a manifest path", file=sys.stderr)
        return 1
    import tempfile

    m = Manifest.from_toml(os.path.expanduser(args.manifest))
    home = args.home_dir or tempfile.mkdtemp(prefix="tt-e2e-")
    mode = "processes" if args.processes else "in-process"
    print(f"running {m.chain_id}: {len(m.nodes)} nodes ({mode}) -> {home}")
    if args.processes:
        from ..e2e.process_runner import run_manifest_processes

        rep = run_manifest_processes(m, home, timeout=args.timeout, device=args.device)
    else:
        rep = run_manifest(m, home, timeout=args.timeout, device=args.device)
    print(json.dumps({
        "ok": rep.ok,
        "reached_height": rep.reached_height,
        "blocks": rep.blocks,
        "block_interval_avg_s": round(rep.interval_avg, 3),
        "block_interval_stddev_s": round(rep.interval_stddev, 3),
        "txs_submitted": rep.txs_submitted,
        "txs_committed": rep.txs_committed,
        "evidence_heights": rep.evidence_heights,
        "state_synced": rep.state_synced,
        "failures": rep.failures,
    }, indent=2))
    return 0 if rep.ok else 1


# -- testnet (reference: commands/testnet.go) -------------------------------


def cmd_testnet(args) -> int:
    from ..node.key import NodeKey
    from ..privval.file import FilePV
    from ..types.genesis import GenesisDoc, GenesisValidator

    n = args.validators
    out = os.path.expanduser(args.output_dir)
    privs = [PrivKeyEd25519.generate() for _ in range(n)]
    genesis = GenesisDoc(
        chain_id=args.chain_id or f"testnet-{os.urandom(3).hex()}",
        genesis_time_ns=time.time_ns(),
        validators=[GenesisValidator(pub_key=p.pub_key(), power=10) for p in privs],
    )
    cfgs: List[Config] = []
    node_ids: List[str] = []
    for i in range(n):
        cfg = Config()
        cfg.base.home = os.path.join(out, f"node{i}")
        cfg.base.chain_id = genesis.chain_id
        cfg.base.moniker = f"node{i}"
        cfg.p2p.laddr = f"tcp://127.0.0.1:{args.starting_port + 2 * i}"
        cfg.rpc.laddr = f"tcp://127.0.0.1:{args.starting_port + 2 * i + 1}"
        cfg.ensure_dirs()
        genesis.save_as(cfg.base.path(cfg.base.genesis_file))
        FilePV.from_priv_key(
            privs[i],
            cfg.base.path(cfg.priv_validator.key_file),
            cfg.base.path(cfg.priv_validator.state_file),
        ).save()
        node_ids.append(NodeKey.load_or_generate(cfg.base.path(cfg.base.node_key_file)).node_id)
        cfgs.append(cfg)
    for i, cfg in enumerate(cfgs):
        cfg.p2p.persistent_peers = ",".join(
            f"{node_ids[j]}@127.0.0.1:{args.starting_port + 2 * j}" for j in range(n) if j != i
        )
        write_config(cfg, _config_path(cfg.base.home))
    print(f"wrote {n}-validator testnet for chain {genesis.chain_id} under {out}")
    return 0


def cmd_version(args) -> int:
    print(_version.__version__)
    return 0


# -- abci (reference: abci/cmd/abci-cli) ------------------------------------


def _parse_tx(s: str) -> bytes:
    """0x-prefixed hex, else the string's bytes (reference: abci-cli
    stringOrHexToBytes)."""
    if s.startswith("0x") or s.startswith("0X"):
        return bytes.fromhex(s[2:])
    return s.encode()


async def _abci_exec(client, cmd: str, operand: str, path: str) -> None:
    """One abci-cli request and its answer."""
    from ..abci import types as T

    def show(code=None, data=None, log="", info=""):
        if code is not None:
            print(f"-> code: {'OK' if code == 0 else code}")
        if log:
            print(f"-> log: {log}")
        if info:
            print(f"-> info: {info}")
        if data:
            try:
                print(f"-> data: {data.decode()}")
            except UnicodeDecodeError:
                pass
            print(f"-> data.hex: 0x{data.hex().upper()}")

    if cmd == "echo":
        resp = await client.echo(operand)
        print(f"-> data: {resp.message}")
    elif cmd == "info":
        resp = await client.info(T.RequestInfo())
        print(f"-> data: {resp.data}")
        print(f"-> version: {resp.version}")
        print(f"-> last_block_height: {resp.last_block_height}")
        print(f"-> last_block_app_hash: 0x{resp.last_block_app_hash.hex()}")
    elif cmd == "deliver-tx":
        resp = await client.deliver_tx(T.RequestDeliverTx(tx=_parse_tx(operand)))
        show(resp.code, resp.data, resp.log, resp.info)
    elif cmd == "check-tx":
        resp = await client.check_tx(T.RequestCheckTx(tx=_parse_tx(operand)))
        show(resp.code, resp.data, resp.log, resp.info)
    elif cmd == "commit":
        resp = await client.commit()
        show(0, resp.data)
    elif cmd == "query":
        resp = await client.query(T.RequestQuery(data=_parse_tx(operand), path=path))
        show(resp.code, None, resp.log, resp.info)
        print(f"-> key: {resp.key.decode(errors='replace')}")
        print(f"-> value: {resp.value.decode(errors='replace')}")
    else:
        raise ValueError(f"unknown abci command {cmd!r}")


def cmd_abci(args) -> int:
    """Serve the builtin kvstore app (`abci kvstore`), send an
    out-of-process app one request, or read requests from stdin (`abci
    console`), over a socket or with --grpc over gRPC (reference:
    abci/cmd/, the abci-cli tool, its console and example-app server)."""
    from ..abci.kvstore import KVStoreApplication

    if args.grpc:
        from ..abci.grpc_transport import GRPCClient as make_client
        from ..abci.grpc_transport import GRPCServer as make_server
    else:
        from ..abci.client import SocketClient as make_client
        from ..abci.server import SocketServer as make_server

    async def serve_kvstore() -> int:
        srv = make_server(args.addr, KVStoreApplication(snapshot_interval=args.snapshot_interval))
        loop = asyncio.get_running_loop()
        stop = asyncio.Event()
        for sig in (signal.SIGINT, signal.SIGTERM):
            loop.add_signal_handler(sig, stop.set)
        await srv.start()
        print(f"kvstore app listening on {args.addr}", flush=True)
        try:
            await stop.wait()
        finally:
            await srv.stop()
        return 0

    async def console(client) -> None:
        print("abci console: echo|info|deliver-tx|check-tx|commit|query <operand>  (ctrl-d to exit)",
              flush=True)
        lines = _stdin_reader_queue(asyncio.get_running_loop())
        while True:
            line = await lines.get()
            if line is None:
                break
            parts = line.strip().split(None, 1)
            if not parts:
                continue
            try:
                await _abci_exec(client, parts[0], parts[1] if len(parts) > 1 else "", args.path)
            except Exception as e:  # the console answers and reads on
                print(f"-> error: {e}", flush=True)

    async def drive() -> int:
        client = make_client(args.addr, must_connect=True)
        await client.start()
        try:
            if args.abci_cmd == "console":
                await console(client)
                return 0
            try:
                await _abci_exec(client, args.abci_cmd, args.operand, args.path)
            except ValueError as e:
                print(f"-> error: {e}", file=sys.stderr)
                return 1
            return 0
        finally:
            await client.stop()

    if args.abci_cmd == "kvstore":
        return asyncio.run(serve_kvstore())
    return asyncio.run(drive())


# -- the parser --------------------------------------------------------------


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tendermint_tpu_torch",
        description="BFT consensus node, its device plane on an NVIDIA GPU (tendermint-compatible)",
    )
    p.add_argument("--home", default=os.environ.get("TMHOME", DEFAULT_HOME), help="node home directory")
    sub = p.add_subparsers(dest="command", required=True)

    sp = sub.add_parser("init", help="initialize a node home directory")
    sp.add_argument("mode", nargs="?", default="validator", choices=["validator", "full", "seed"])
    sp.add_argument("--chain-id", default="")
    sp.add_argument("--moniker", default="anonymous")
    sp.add_argument(
        "--key", default="ed25519", choices=["ed25519", "secp256k1"],
        help="validator key type (reference: commands/init.go --key)",
    )
    sp.set_defaults(fn=cmd_init)

    sp = sub.add_parser("start", help="run the node")
    sp.add_argument("--moniker", default="")
    sp.add_argument(
        "--device", default="cuda",
        help="where the device plane runs when [gpu] enable is true (cuda; cpu runs the "
        "kernels' plain versions)",
    )
    sp.set_defaults(fn=cmd_start)

    sp = sub.add_parser(
        "signer",
        help="run an external signing process (dials a node's [priv_validator] listen_addr, "
        "serves this home's FilePV)",
    )
    sp.add_argument("--addr", default="tcp://127.0.0.1:26659", help="the node's priv_validator listen address")
    sp.add_argument("--node-id", default="", help="the node identity the SecretConnection expects (empty: any)")
    sp.add_argument(
        "--grpc", action="store_true",
        help="serve the gRPC privval transport on --addr (the node dials grpc://<addr>)",
    )
    sp.set_defaults(fn=cmd_signer)

    sp = sub.add_parser("gen-validator", help="print a fresh validator key")
    sp.add_argument(
        "--key", default="ed25519", choices=["ed25519", "secp256k1"],
        help="key type (reference: commands/gen_validator.go --key)",
    )
    sp.set_defaults(fn=cmd_gen_validator)

    sp = sub.add_parser("gen-node-key", help="generate a node key")
    sp.set_defaults(fn=cmd_gen_node_key)

    sp = sub.add_parser("show-node-id", help="print this node's p2p ID")
    sp.set_defaults(fn=cmd_show_node_id)

    sp = sub.add_parser("show-validator", help="print this node's validator pubkey")
    sp.set_defaults(fn=cmd_show_validator)

    sp = sub.add_parser("rollback", help="rewind state one height (after an app hash panic)")
    sp.set_defaults(fn=cmd_rollback)

    sp = sub.add_parser("unsafe-reset-all", help="wipe data, keep config and keys")
    sp.set_defaults(fn=cmd_reset_unsafe)

    sp = sub.add_parser("testnet", help="write N-validator testnet homes")
    sp.add_argument("--validators", "-v", type=int, default=4)
    sp.add_argument("--output-dir", "-o", default="./testnet")
    sp.add_argument("--chain-id", default="")
    sp.add_argument("--starting-port", type=int, default=26656)
    sp.set_defaults(fn=cmd_testnet)

    sp = sub.add_parser("reindex-event", help="rebuild tx/block event indexes from stored blocks")
    sp.add_argument("--start-height", type=int, default=0)
    sp.add_argument("--end-height", type=int, default=0)
    sp.set_defaults(fn=cmd_reindex_event)

    sp = sub.add_parser("abci", help="abci-cli: drive an ABCI app socket or serve the kvstore")
    sp.add_argument(
        "abci_cmd", choices=["kvstore", "console", "echo", "info", "deliver-tx", "check-tx", "commit", "query"]
    )
    sp.add_argument("operand", nargs="?", default="")
    sp.add_argument("--addr", default="tcp://127.0.0.1:26658")
    sp.add_argument("--path", default="/store", help="query path")
    sp.add_argument(
        "--snapshot-interval", type=int, default=0,
        help="kvstore server: take a state snapshot every N heights (0 disables; needed for "
        "state-sync providers)",
    )
    sp.add_argument("--grpc", action="store_true", help="use the gRPC ABCI transport instead of the socket one")
    sp.set_defaults(fn=cmd_abci)

    device_help = ("where the device plane runs when [gpu] enable is true (cuda; cpu runs the "
                   "kernels' plain versions)")
    sp = sub.add_parser("light", help="run a verifying light-client RPC proxy")
    sp.add_argument("chain_id")
    sp.add_argument("--primary", required=True, help="full node RPC addr")
    sp.add_argument("--witness", action="append", help="witness RPC addr (repeatable)")
    sp.add_argument("--trust-height", type=int, required=True)
    sp.add_argument("--trust-hash", required=True)
    sp.add_argument("--trust-period", type=float, default=168 * 3600.0, help="seconds")
    sp.add_argument("--sequential", action="store_true")
    sp.add_argument("--laddr", default="tcp://127.0.0.1:8888")
    sp.add_argument("--device", default="cuda", help=device_help)
    sp.set_defaults(fn=cmd_light)

    sp = sub.add_parser("inspect", help="read-only RPC over a stopped node's data")
    sp.add_argument("--laddr", default="tcp://127.0.0.1:26657")
    sp.set_defaults(fn=cmd_inspect)

    sp = sub.add_parser("replay", help="re-execute stored blocks through a fresh app")
    sp.add_argument(
        "--console", action="store_true",
        help="interactive WAL playback after block replay (next/back/rs/n/quit)",
    )
    sp.add_argument("--device", default="cuda", help=device_help)
    sp.set_defaults(fn=cmd_replay)

    sp = sub.add_parser("e2e", help="run or generate manifest-driven e2e testnets")
    sp.add_argument("e2e_cmd", choices=["run", "generate"])
    sp.add_argument("manifest", nargs="?", default="")
    sp.add_argument("--home-dir", default="")
    sp.add_argument("--timeout", type=float, default=240.0)
    sp.add_argument("--seed", type=int, default=1)
    sp.add_argument("--count", type=int, default=4)
    sp.add_argument("--output-dir", "-o", default="./e2e-manifests")
    sp.add_argument(
        "--processes", action="store_true",
        help="run each node as a separate OS process over TCP with a socket ABCI app; "
        "perturbations use real signals (SIGKILL/SIGSTOP)",
    )
    sp.add_argument("--device", default="cuda", help="where the nodes' device plane runs (cpu: [gpu] off)")
    sp.set_defaults(fn=cmd_e2e)

    sp = sub.add_parser("key-migrate", help="migrate legacy database key formats to the current layout")
    sp.set_defaults(fn=cmd_key_migrate)

    sp = sub.add_parser("version", help="print the version")
    sp.set_defaults(fn=cmd_version)

    # --home after the command too (`init --home DIR`); the global one
    # stands where a command is given none
    for sp in sub.choices.values():
        sp.add_argument("--home", default=argparse.SUPPRESS, help="node home directory")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)
