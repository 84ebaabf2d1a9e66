"""The operator CLI: `python3 -m tendermint_tpu_torch.cmd <command>`.

Counterpart: tendermint_tpu/cmd/commands.py (reference:
cmd/tendermint/commands/): the node's own commands init (:45), signer
(:91, the remote signer over TCP), start (:151), gen-validator (:187),
gen-node-key (:210), show-node-id (:227), show-validator (:236),
rollback (:258), unsafe-reset-all (:287), testnet (:311), key-migrate
(:1115), version (:1150), reindex-event (:1188) and abci (:1337, the
kvstore app behind a SocketServer, or a SocketClient driving one), with
build_parser (:1418) and main (:1651). argparse in place of cobra; every
command works on a --home laid out as make_node reads it
(config/config.toml, config/genesis.json, config/node_key.json,
config/priv_validator_key.json, data/). The default home is
~/.tendermint_tpu_torch ($TMHOME overrides it).

`start` runs the node with its device plane on the card
(make_node(..., device="cuda")) when [gpu] enable is true; the kernels
are built from the repository's sources into build/torch_kernels/ (or
loaded from there) at the install. SIGINT and SIGTERM stop the node, and
the command exits 0 after a clean stop. A part of the node that ends on
an error while it runs (block sync's pool routine, the evidence loop,
an RPC route, the state sync task: Node.failure) stops the node too, and
the command raises that error, so it exits non-zero without a signal.

Left out: the commands light, inspect, replay and replay-console, debug
and e2e (ROADMAP item 21b; debug's device profile is item 11), and the
gRPC transports of signer and abci (item 21b).
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
    serving signing requests over SecretConnection (reference:
    privval/signer_server.go)."""
    from ..libs.log import configure
    from ..privval.file import FilePV
    from ..privval.signer import SignerServer

    cfg = _load_home(args.home)
    configure(level=cfg.base.log_level, json_format=cfg.base.log_format == "json")
    pv = FilePV.load(
        cfg.base.path(cfg.priv_validator.key_file),
        cfg.base.path(cfg.priv_validator.state_file),
    )
    print(f"signer for validator {pv.key.address.hex()} -> {args.addr}", flush=True)

    async def run() -> None:
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
        loop = asyncio.get_running_loop()
        stop = asyncio.Event()
        for sig in (signal.SIGINT, signal.SIGTERM):
            loop.add_signal_handler(sig, stop.set)
        # a failed start tears itself down: only a started node owes a stop
        await node.start()
        failed = None
        try:
            while failed is None and not stop.is_set():
                try:
                    await asyncio.wait_for(stop.wait(), _FAILURE_POLL_S)
                except asyncio.TimeoutError:
                    failed = node.failure()
        finally:
            # raises the error a part ended on
            await node.stop()
        if failed is not None:
            raise failed

    asyncio.run(run())
    return 0


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
    """Serve the builtin kvstore app on a socket (`abci kvstore`), or
    send an out-of-process app one request (reference: abci/cmd/, the
    abci-cli tool and its example-app server). The interactive console
    is left out with the other item 21b commands."""
    from ..abci.client import SocketClient
    from ..abci.kvstore import KVStoreApplication
    from ..abci.server import SocketServer

    async def serve_kvstore() -> int:
        srv = SocketServer(args.addr, KVStoreApplication(snapshot_interval=args.snapshot_interval))
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

    async def drive() -> int:
        client = SocketClient(args.addr, must_connect=True)
        await client.start()
        try:
            await _abci_exec(client, args.abci_cmd, args.operand, args.path)
        except ValueError as e:
            print(f"-> error: {e}", file=sys.stderr)
            return 1
        finally:
            await client.stop()
        return 0

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
    sp.add_argument("abci_cmd", choices=["kvstore", "echo", "info", "deliver-tx", "check-tx", "commit", "query"])
    sp.add_argument("operand", nargs="?", default="")
    sp.add_argument("--addr", default="tcp://127.0.0.1:26658")
    sp.add_argument("--path", default="/store", help="query path")
    sp.add_argument(
        "--snapshot-interval", type=int, default=0,
        help="kvstore server: take a state snapshot every N heights (0 disables; needed for "
        "state-sync providers)",
    )
    sp.set_defaults(fn=cmd_abci)

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
