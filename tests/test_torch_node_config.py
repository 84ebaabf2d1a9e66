"""The port's node configuration, home files and offline CLI commands
held against the JAX package's.

- config.toml round-trips through write_config and load_config, and for
  the same settings every section but [gpu] (the JAX package's [tpu])
  is the JAX write_config's, line for line; each package loads the
  other's file;
- the node key, FilePV and genesis files written by the JAX `init` and
  `testnet` are read by the port, and the port's by the JAX package,
  to the same node IDs, keys, genesis JSON and peers;
- show-node-id, show-validator, gen-validator (a seeded key in both)
  and version print the same for the same home;
- rollback leaves the state bytes JAX StateStore.rollback leaves on the
  same stores, through the CLI on a home's SQLite files, and refuses
  alike; reindex-event writes the JAX command's index rows;
- unsafe-reset-all empties data/ and keeps the config and keys, and
  refuses while a node holds the data dir's lock.

Tolerance: zero (bytes, lines).
"""

import json
import os
import shutil

import pytest

from tendermint_tpu import config as jax_config
from tendermint_tpu.cmd import commands as jax_cmd
from tendermint_tpu.crypto import sr25519 as _jax_sr  # noqa: F401  (registers the key type)
from tendermint_tpu.crypto.ed25519 import PrivKeyEd25519 as JaxPriv
from tendermint_tpu.node.key import NodeKey as JaxNodeKey
from tendermint_tpu.privval.file import FilePV as JaxFilePV
from tendermint_tpu.state.store import StateStore as JaxStateStore
from tendermint_tpu.store.block_store import BlockStore as JaxBlockStore
from tendermint_tpu.store.kv import MemKV as JaxMemKV
from tendermint_tpu.store.kv import SqliteKV as JaxSqliteKV
from tendermint_tpu.types.genesis import GenesisDoc as JaxGenesisDoc
from tendermint_tpu_torch import config as port_config
from tendermint_tpu_torch import workloads
from tendermint_tpu_torch.cmd import commands as port_cmd
from tendermint_tpu_torch.crypto.ed25519 import PrivKeyEd25519
from tendermint_tpu_torch.node.key import NodeKey
from tendermint_tpu_torch.node.node import acquire_pid_lock, release_pid_lock
from tendermint_tpu_torch.privval.file import FilePV
from tendermint_tpu_torch.state.store import StateStore
from tendermint_tpu_torch.store.block_store import BlockStore
from tendermint_tpu_torch.store.kv import MemKV, SqliteKV
from tendermint_tpu_torch.types.genesis import GenesisDoc

from .test_torch_isolation import jax_device_plane_paused  # noqa: F401 (autouse)

CHAIN_ID = "torch-node-config"
SEED = 29
N = 4

SETTINGS = {
    "base": {"moniker": "m-1", "db_backend": "memdb", "log_level": "debug", "home": "/h"},
    "p2p": {"laddr": "tcp://127.0.0.1:0", "persistent_peers": "a@b:1,c@d:2", "pex": False,
            "slow_peer_ban": 12.5},
    "consensus": {"timeout_commit": 0.25, "skip_timeout_commit": True, "wal_file": "data/w/wal"},
    "statesync": {"enable": True, "rpc_servers": ["x:1", "y:2"], "trust_hash": 'q"\\z'},
    "tx_index": {"indexer": ["kv", "psql"]},
    "instrumentation": {"profiler": True, "profiler_hz": 13.0},
    "mempool": {"size": 17, "ttl_duration": 1.5},
}


def _apply(cfg, settings):
    for section, values in settings.items():
        for k, v in values.items():
            setattr(getattr(cfg, section), k, v)
    return cfg


def _sections(path: str) -> dict:
    out, cur = {}, None
    with open(path) as f:
        for line in f.read().split("\n"):
            if line.startswith("["):
                cur = line
                out[cur] = []
            elif cur is not None:
                out[cur].append(line)
    return out


@pytest.mark.parametrize("settings", [{}, SETTINGS], ids=["defaults", "settings"])
def test_config_toml_equals_jax_but_the_device_section(tmp_path, settings):
    port = _apply(port_config.Config(), settings)
    jax = _apply(jax_config.Config(), settings)
    port.base.home = jax.base.home = settings.get("base", {}).get("home", "~/h")
    port_config.write_config(port, str(tmp_path / "p.toml"))
    jax_config.write_config(jax, str(tmp_path / "j.toml"))
    p, j = _sections(str(tmp_path / "p.toml")), _sections(str(tmp_path / "j.toml"))
    assert list(p) == [k if k != "[tpu]" else "[gpu]" for k in j]
    assert {k: v for k, v in p.items() if k != "[gpu]"} == {k: v for k, v in j.items() if k != "[tpu]"}
    assert p["[gpu]"] == ["enable = true", "min_batch_size = 32",
                          "bucket_sizes = [8, 32, 128, 512, 2048, 8192, 12288, 16384]", "devices = 1", ""]
    # round trips, and each package loads the other's file
    assert port_config.load_config(str(tmp_path / "p.toml")) == port
    from_jax = port_config.load_config(str(tmp_path / "j.toml"))
    assert from_jax == _apply(port_config.Config(), {**settings, "base": {**settings.get("base", {}),
                                                                          "home": port.base.home}})
    back = jax_config.load_config(str(tmp_path / "p.toml"))
    assert back.tpu == jax_config.TPUConfig()
    back.tpu = jax.tpu
    assert back == jax


def test_the_subset_parser_reads_what_write_config_writes(tmp_path):
    cfg = _apply(port_config.Config(), SETTINGS)
    port_config.write_config(cfg, str(tmp_path / "c.toml"))
    text = (tmp_path / "c.toml").read_text()
    assert port_config._parse_toml_subset(text) == jax_config._parse_toml_subset(text)
    with pytest.raises(ValueError, match="unparseable TOML line"):
        port_config._parse_toml_subset("[base]\njunk\n")


def test_the_default_home_is_the_ports_own():
    assert port_config.Config().base.home == "~/.tendermint_tpu_torch"
    assert jax_config.Config().base.home == "~/.tendermint_tpu"


def _home_files(home: str, pkg: str) -> dict:
    """What a home's files say, read by `pkg`'s classes."""
    cfg = (port_config if pkg == "port" else jax_config).load_config(os.path.join(home, "config", "config.toml"))
    nk, pv, gen = (NodeKey, FilePV, GenesisDoc) if pkg == "port" else (JaxNodeKey, JaxFilePV, JaxGenesisDoc)
    key = pv.load(os.path.join(home, cfg.priv_validator.key_file), os.path.join(home, cfg.priv_validator.state_file))
    return {
        "node_id": nk.load(os.path.join(home, cfg.base.node_key_file)).node_id,
        "pub_key": key.key.pub_key.bytes(),
        "address": key.key.address,
        "last_sign": (key.last_sign_state.height, key.last_sign_state.round, key.last_sign_state.step),
        "genesis": gen.from_file(os.path.join(home, cfg.base.genesis_file)).to_json(),
        "chain_id": cfg.base.chain_id,
        "peers": cfg.p2p.persistent_peers,
        "p2p": cfg.p2p.laddr,
        "rpc": cfg.rpc.laddr,
    }


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_init_home_files_read_by_the_other_package(tmp_path, writer, capsys):
    home = str(tmp_path / "home")
    main = jax_cmd.main if writer == "jax" else port_cmd.main
    assert main(["--home", home, "init", "--chain-id", CHAIN_ID, "--moniker", "m"]) == 0
    assert _home_files(home, "port") == _home_files(home, "jax")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_testnet_homes_read_by_the_other_package(tmp_path, writer, capsys):
    out = str(tmp_path / "net")
    main = jax_cmd.main if writer == "jax" else port_cmd.main
    assert main(["testnet", "-v", "3", "-o", out, "--chain-id", CHAIN_ID, "--starting-port", "30100"]) == 0
    homes = [os.path.join(out, f"node{i}") for i in range(3)]
    port = [_home_files(h, "port") for h in homes]
    assert port == [_home_files(h, "jax") for h in homes]
    assert len({h["genesis"] for h in port}) == 1
    for i, h in enumerate(port):
        assert h["p2p"] == f"tcp://127.0.0.1:{30100 + 2 * i}"
        want = [f"{port[j]['node_id']}@127.0.0.1:{30100 + 2 * j}" for j in range(3) if j != i]
        assert h["peers"] == ",".join(want)


def _seeded(monkeypatch):
    seed = bytes(range(7, 39))
    monkeypatch.setattr(PrivKeyEd25519, "generate", classmethod(lambda cls: cls(seed)))
    monkeypatch.setattr(JaxPriv, "generate", classmethod(lambda cls: cls(seed)))


@pytest.mark.parametrize("command", [["show-node-id"], ["show-validator"], ["gen-validator"], ["version"],
                                     ["gen-node-key"]])
def test_identity_commands_print_alike(tmp_path, capsys, monkeypatch, command):
    _seeded(monkeypatch)
    home = str(tmp_path / "home")
    assert jax_cmd.main(["--home", home, "init", "--chain-id", CHAIN_ID]) == 0
    if command == ["gen-node-key"]:
        os.remove(os.path.join(home, "config", "node_key.json"))
    capsys.readouterr()
    outs = []
    for main in (jax_cmd.main, port_cmd.main):
        if command == ["gen-node-key"] and outs:
            os.remove(os.path.join(home, "config", "node_key.json"))
        rc = main(["--home", home, *command])
        outs.append((rc, capsys.readouterr()))
    assert outs[0] == outs[1]
    assert outs[0][0] == 0 and outs[0][1].out


def test_secp256k1_keys_are_refused_until_the_port_has_them(tmp_path, capsys):
    """The port has the secp256k1 keys now (ROADMAP item 22): both
    commands take the type as the JAX ones do. gen-validator prints a
    FilePV key of that type; init writes a home whose key file each
    package loads, with the address of its public key, and whose
    genesis carries the key; an unknown type is still refused by the
    key dispatch."""
    capsys.readouterr()
    outs = {}
    for name, main in (("port", port_cmd.main), ("jax", jax_cmd.main)):
        assert main(["gen-validator", "--key", "secp256k1"]) == 0
        outs[name] = json.loads(capsys.readouterr().out)
    assert outs["port"].keys() == outs["jax"].keys()
    for out in outs.values():
        assert out["pub_key"]["type"] == out["priv_key"]["type"] == "secp256k1"
    for name, main in (("port", port_cmd.main), ("jax", jax_cmd.main)):
        home = str(tmp_path / name)
        assert main(["--home", home, "init", "--key", "secp256k1", "--chain-id", CHAIN_ID]) == 0
        paths = (os.path.join(home, "config", "priv_validator_key.json"),
                 os.path.join(home, "data", "priv_validator_state.json"))
        port_pv, jax_pv = FilePV.load(*paths), JaxFilePV.load(*paths)
        assert port_pv.key.pub_key.type() == "secp256k1" == jax_pv.key.pub_key.type()
        assert port_pv.key.address == jax_pv.key.address == port_pv.key.pub_key.address()
        genesis = json.load(open(os.path.join(home, "config", "genesis.json")))
        assert genesis["validators"][0]["pub_key"]["type"].endswith("secp256k1")
    with pytest.raises(ValueError, match="key type: rsa is not supported"):
        FilePV.generate(*paths, key_type="rsa")


# -- the offline data commands --


@pytest.fixture(scope="module")
def chain():
    privs = workloads.seeded_keys(4, SEED)
    genesis = workloads.kv_genesis(CHAIN_ID, privs)
    txs = [workloads.kv_txs(SEED, h, 5, (34, 90)) for h in range(1, N + 1)]
    return genesis, workloads.serve_chain(genesis, privs, txs, SEED, init_chain=True)


def _copy(db, out):
    for k, v in db.iterate():
        out.set(k, v)
    return out


def _sqlite_home(tmp_path, chain, name: str) -> str:
    """A port `init` home whose data/ holds the chain's stores."""
    genesis, (_blocks, node, _states) = chain
    home = str(tmp_path / name)
    workloads.init_home(home, genesis, {})
    data = os.path.join(home, "data")
    for db_name, src in (("state", node.state_store._db), ("blockstore", node.block_store._db)):
        db = SqliteKV(os.path.join(data, f"{db_name}.sqlite"))
        _copy(src, db)
        db.close()
    return home


def test_rollback_leaves_the_jax_state_bytes(tmp_path, chain, capsys):
    _genesis, (blocks, node, states) = chain
    home = _sqlite_home(tmp_path, chain, "home")
    assert port_cmd.main(["--home", home, "rollback"]) == 0
    out = capsys.readouterr().out
    db = SqliteKV(os.path.join(home, "data", "state.sqlite"))
    got = StateStore(db).load().to_proto()
    db.close()
    jax_store = JaxStateStore(_copy(node.state_store._db, JaxMemKV()))
    want = jax_store.rollback(JaxBlockStore(_copy(node.block_store._db, JaxMemKV())))
    assert got == want.to_proto()
    # the JAX rollback takes the app hash of the rolled-back height's own
    # header (the hash after the height below it), where the reference
    # takes the next header's (internal/state/rollback.go latestBlock);
    # the port keeps the JAX bytes (ROADMAP §3)
    assert (want.last_block_height, want.app_hash) == (N - 1, blocks[N - 2].block.header.app_hash)
    assert out == f"rolled back state to height {N - 1} app_hash {want.app_hash.hex()}\n"
    # the port's StateStore.rollback on the same MemKV stores, too
    port_store = StateStore(_copy(node.state_store._db, MemKV()))
    assert port_store.rollback(BlockStore(_copy(node.block_store._db, MemKV()))).to_proto() == got


def _outcome(fn):
    try:
        return "ok", fn().to_proto()
    except Exception as e:  # the outcome compared IS the exception
        return type(e).__name__, str(e)


def test_rollback_refuses_and_passes_alike(chain):
    _genesis, (blocks, node, _states) = chain
    cases = {}
    for name in ("store_one_ahead", "store_behind", "no_state"):
        out = []
        for kv, ss, bs in ((MemKV, StateStore, BlockStore), (JaxMemKV, JaxStateStore, JaxBlockStore)):
            state_db = kv() if name == "no_state" else _copy(node.state_store._db, kv())
            block_db = kv() if name == "store_behind" else _copy(node.block_store._db, kv())
            state_store, block_store = ss(state_db), bs(block_db)
            if name == "store_one_ahead":
                state_store.rollback(block_store)  # the state one below the store
            out.append(_outcome(lambda: state_store.rollback(block_store)))
        cases[name] = out
    for name, (got, want) in cases.items():
        assert got == want, name
    assert cases["store_one_ahead"][0][0] == "ok"
    assert cases["store_behind"][0] == (
        "ValueError", f"statestore height ({N}) is not one below or equal to blockstore height (0)")
    assert cases["no_state"][0] == ("ValueError", "no state found")


def test_reindex_event_writes_the_jax_rows(tmp_path, chain, capsys):
    home = _sqlite_home(tmp_path, chain, "port")
    twin = str(tmp_path / "jax")
    shutil.copytree(home, twin)
    assert port_cmd.main(["--home", home, "reindex-event"]) == 0
    assert jax_cmd.main(["--home", twin, "reindex-event"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out == [f"reindexed {N} heights in [1, {N}]"] * 2
    port_db = SqliteKV(os.path.join(home, "data", "tx_index.sqlite"))
    jax_db = JaxSqliteKV(os.path.join(twin, "data", "tx_index.sqlite"))
    try:
        rows = list(port_db.iterate())
        assert rows == list(jax_db.iterate()) and len(rows) > N
    finally:
        port_db.close()
        jax_db.close()


def test_unsafe_reset_all_keeps_config_and_keys_and_refuses_a_running_node(tmp_path, chain, capsys):
    home = _sqlite_home(tmp_path, chain, "home")
    keys = [os.path.join(home, "config", f) for f in ("config.toml", "genesis.json", "node_key.json",
                                                        "priv_validator_key.json")]
    before = [open(p).read() for p in keys]
    lock = os.path.join(home, "data", "LOCK")
    fd = acquire_pid_lock(lock)
    try:
        assert port_cmd.main(["--home", home, "unsafe-reset-all"]) == 1
        assert "node appears to be running" in capsys.readouterr().err
        assert port_cmd.main(["--home", home, "rollback"]) == 1
    finally:
        release_pid_lock(lock, fd)
    assert port_cmd.main(["--home", home, "unsafe-reset-all"]) == 0
    assert sorted(os.listdir(os.path.join(home, "data"))) == ["cs.wal"]
    assert [open(p).read() for p in keys] == before
    assert json.loads(open(keys[1]).read())["chain_id"] == CHAIN_ID
