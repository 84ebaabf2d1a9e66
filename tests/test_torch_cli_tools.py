"""The operator's tools of the port's CLI, held against the JAX CLI
(after tests/test_cmd.py: test_replay_console,
test_light_proxy_serves_verified_headers,
test_abci_cli_against_kvstore_socket,
test_offline_commands_refuse_running_node and
test_e2e_cli_generate_and_run).

- `replay` of a home a port node wrote ends in the JAX `replay`'s final
  height and app hash; `replay --console` steps the WAL's records
  (next, rs, back, n);
- `light`, the verifying proxy: the port's and the JAX's processes over
  the same primary serve equal answers for header, commit, light_block
  and status, and the light blocks are the bytes of an in-process
  light.Client over the primary; under TM_TPU_FAULT="gpu.dispatch:raise"
  with every batch sent to the plane (min_batch_size 1, a sequential
  window of 4 hops) the bytes are the same and the exit line reports
  the faulted, rerouted batches;
- `inspect` over a home the JAX package wrote answers every read-only
  route as the JAX `inspect` does;
- `abci` over a socket and over gRPC: the one-shot commands answer as
  the JAX CLI's, and `abci console` prints what the JAX console prints
  for the same script;
- a launch that fails under the proxy's route ends the `light` process
  non-zero with the error (no CPU run);
- `inspect` and `replay` refuse a data dir a live process locks, as the
  JAX commands do;
- `e2e generate` writes the JAX generator's files, byte for byte, and
  `e2e run` runs one to its invariants.

Nodes run with [gpu] enable = false or device="cpu"; servers bind
127.0.0.1:0 or ports taken free; every loop runs under a deadline.
"""

import asyncio
import io
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import time
from contextlib import redirect_stdout

import pytest

from tendermint_tpu.cmd import main as jax_cli
from tendermint_tpu.config import load_config as jax_load_config
from tendermint_tpu.config import write_config as jax_write_config
from tendermint_tpu.crypto import sigcache as jax_sigcache
from tendermint_tpu.node import make_node as jax_make_node
from tendermint_tpu_torch import workloads
from tendermint_tpu_torch.cmd import main as cli
from tendermint_tpu_torch.config import load_config
from tendermint_tpu_torch.crypto.ed25519 import PrivKeyEd25519
from tendermint_tpu_torch.light import Client, LightStore, TrustOptions
from tendermint_tpu_torch.light.provider import HTTPProvider
from tendermint_tpu_torch.node import device as device_plane
from tendermint_tpu_torch.node import make_node
from tendermint_tpu_torch.privval.file import FilePV
from tendermint_tpu_torch.rpc.client import HTTPClient
from tendermint_tpu_torch.store.kv import MemKV
from tendermint_tpu_torch.types.genesis import GenesisDoc, GenesisValidator

from .test_torch_isolation import jax_device_plane_paused  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE_S = 90.0
ADDR = re.compile(r" on (127\.0\.0\.1):(\d+)")


@pytest.fixture(autouse=True)
def _isolated():
    with jax_sigcache.disabled():
        yield
    device_plane.uninstall_device_plane()


def run(coro, deadline_s: float = DEADLINE_S):
    return asyncio.run(asyncio.wait_for(coro, deadline_s))


def _env(**extra) -> dict:
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    env.update(extra)
    return env


def _quiet(fn, *argv) -> tuple:
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = fn(list(argv))
    return rc, buf.getvalue()


def _home(tmp_path, name: str, priv, chain_id: str, **settings) -> str:
    """An `init` home of one validator holding priv: [gpu] off, RPC and
    p2p on 127.0.0.1:0, a 0.2 s timeout_commit."""
    genesis = GenesisDoc(chain_id=chain_id, genesis_time_ns=time.time_ns(),
                         validators=[GenesisValidator(pub_key=priv.pub_key(), power=10)])
    home = str(tmp_path / name)
    base = {"gpu": {"enable": False}, "rpc": {"laddr": "tcp://127.0.0.1:0"}, "p2p": {"laddr": "tcp://127.0.0.1:0"},
            "consensus": {"timeout_commit": 0.2}}
    for section, values in settings.items():
        base.setdefault(section, {}).update(values)
    workloads.init_home(home, genesis.to_json(), base)
    FilePV.from_priv_key(priv, os.path.join(home, "config", "priv_validator_key.json"),
                         os.path.join(home, "data", "priv_validator_state.json")).save()
    return home


def _cfg(home: str):
    cfg = load_config(os.path.join(home, "config", "config.toml"))
    cfg.base.home = home
    return cfg


def _produce(home: str, height: int) -> None:
    async def go():
        node = make_node(_cfg(home), device="cpu")
        await node.start()
        try:
            await node.consensus.wait_for_height(height, timeout=60.0)
        finally:
            await node.stop()

    run(go())


async def _spawn(*argv, env=None, stdin=None):
    """A CLI process (`python -m <argv>`, or `python -c` when argv
    starts with "-c"); returns it and the (host, port) its first
    ' on 127.0.0.1:<port>' line names, with the lines before it."""
    flag = [] if argv[0] == "-c" else ["-m"]
    proc = await asyncio.create_subprocess_exec(
        sys.executable, *flag, *argv, env=env or _env(), cwd=REPO, stdin=stdin,
        stdout=asyncio.subprocess.PIPE, stderr=asyncio.subprocess.STDOUT,
    )
    lines = []
    while True:
        line = (await proc.stdout.readline()).decode()
        if not line:
            raise AssertionError(f"{argv} exited {await proc.wait()}: {lines}")
        lines.append(line)
        m = ADDR.search(line)
        if m:
            return proc, f"{m.group(1)}:{m.group(2)}", lines


async def _stop(proc) -> tuple:
    """SIGTERM, then the exit code and the rest of the output."""
    if proc.returncode is None:
        proc.send_signal(signal.SIGTERM)
    out = (await proc.stdout.read()).decode()
    return await asyncio.wait_for(proc.wait(), 30), out


def test_replay_ends_at_the_jax_state_and_steps_the_wal(tmp_path, monkeypatch, capsys):
    home = _home(tmp_path, "rc", PrivKeyEd25519.from_seed(b"\x21" * 32), "rc-chain")
    _produce(home, 3)
    jax_home = str(tmp_path / "rc-jax")
    shutil.copytree(home, jax_home)
    rc, jax_out = _quiet(jax_cli, "--home", jax_home, "replay")
    assert rc == 0
    script = iter(["n", "next 3", "rs", "rs locked_round", "back 1", "n", "quit"])
    monkeypatch.setattr("builtins.input", lambda prompt="": next(script))
    capsys.readouterr()
    assert cli(["--home", home, "replay", "--console", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    replayed = [line for line in out.splitlines() if line.startswith("replayed ")]
    assert replayed == [line for line in jax_out.splitlines() if line.startswith("replayed ")]
    assert re.match(r"replayed \d+ blocks; final height \d+ app_hash [0-9a-f]{64}$", replayed[0])
    assert "WAL records after EndHeight" in out and "rewound to #" in out
    assert re.search(r"^\d+/\d+/\d+$", out, re.M), out
    report = json.loads(out.splitlines()[-1].split("device plane: ", 1)[1])
    assert report["installed"] is None and not any(report["launches"].values())


def _light_home(tmp_path, name: str, **gpu) -> str:
    home = str(tmp_path / name)
    if gpu:
        cfg_path = os.path.join(home, "config", "config.toml")
        os.makedirs(os.path.dirname(cfg_path))
        from tendermint_tpu_torch.config import Config, write_config

        cfg = Config()
        for k, v in gpu.items():
            setattr(cfg.gpu, k, v)
        write_config(cfg, cfg_path)
    return home


def test_light_proxy_serves_the_jax_proxys_answers(tmp_path):
    """The primary serves a built chain of 4 validators (3 signatures a
    light check) over RPC."""
    from tendermint_tpu_torch.rpc.core import Environment

    privs = workloads.seeded_keys(4, 5)
    chain_id = "light-cli"
    _chain, served, _states = workloads.serve_chain(workloads.kv_genesis(chain_id, privs), privs,
                                                     [[] for _ in range(6)], 5)
    env = Environment(chain_id=chain_id, block_store=served.block_store, state_store=served.state_store)
    # the last first: a sequential sync of 4 hops merges their
    # signatures, which min_batch_size 1 sends to the plane
    heights = (5, 2, 3, 4)
    trust_period_s = 10 * 365 * 24 * 3600.0

    async def go():
        procs = []
        async with workloads.rpc_serving([env]) as (primary,):
            try:
                provider = HTTPProvider(primary)
                lb1 = await provider.light_block(1)
                trust = ["--trust-height", "1", "--trust-hash", lb1.signed_header.hash().hex(), "--primary",
                         primary, "--laddr", "tcp://127.0.0.1:0", "--sequential",
                         "--trust-period", str(trust_period_s)]
                runs = [
                    ("tendermint_tpu_torch.cmd", _light_home(tmp_path, "port"), ["--device", "cpu"], _env()),
                    ("tendermint_tpu.cmd", str(tmp_path / "jax"), [], _env()),
                    ("tendermint_tpu_torch.cmd", _light_home(tmp_path, "faulted", min_batch_size=1),
                     ["--device", "cpu"], _env(TM_TPU_FAULT="gpu.dispatch:raise")),
                ]
                procs.extend(await asyncio.gather(*(
                    _spawn(mod, "--home", light_home, "light", chain_id, *trust, *extra, env=penv)
                    for mod, light_home, extra, penv in runs)))
                answers = []
                for _proc, addr, _lines in procs:
                    client = HTTPClient(addr, timeout=60.0)
                    try:
                        got = {f"light_block {h}": await client.call("light_block", height=h) for h in heights}
                        got["header 3"] = await client.call("header", height=3)
                        got["commit 4"] = await client.call("commit", height=4)
                        status = await client.call("status")
                        got["trusted_height"] = status["trusted_height"]
                    finally:
                        await client.close()
                    answers.append(got)
                # an in-process client over the same primary
                client = Client(chain_id, TrustOptions(period_ns=int(trust_period_s * 1e9), height=1,
                                                       hash=lb1.signed_header.hash()),
                                provider, [], LightStore(MemKV()), sequential=True)
                want = {h: (await client.verify_light_block_at_height(h, time.time_ns())).to_proto().hex()
                        for h in heights}
                await provider.close()
                exits = [await _stop(p) for p, _a, _l in procs]
                return answers, want, exits, [lines for _p, _a, lines in procs]
            finally:
                for p, _a, _l in procs:
                    if p.returncode is None:
                        p.kill()
                        await p.wait()

    (port, jax, faulted), want, exits, first_lines = run(go())
    assert port == jax == faulted
    assert {h: port[f"light_block {h}"]["light_block"] for h in heights} == want
    assert port["trusted_height"] == max(heights)
    reports = []
    for rc, out in (exits[0], exits[2]):
        assert rc == 0, out
        reports.append(json.loads(out.strip().splitlines()[-1].split("device plane: ", 1)[1]))
    assert [r["installed"] for r in reports] == ["cpu", "cpu"]
    assert "device plane installed on cpu (min_batch 1)" in "".join(first_lines[2])
    # below the gate of 32 the proxy launches nothing; the faulted one
    # reroutes its first batch and its breaker keeps the rest on the CPU
    assert reports[0]["stats"]["faults"] == 0 and not any(reports[0]["launches"].values())
    assert reports[1]["stats"]["faults"] >= 1 and reports[1]["stats"]["rerouted_sigs"] >= 3
    assert exits[1][0] == 0


def test_a_failed_launch_ends_the_light_process(tmp_path):
    """A launch error under a route (not a contained DeviceFault) is
    answered INTERNAL_ERROR, and the proxy then stops and exits non-zero
    with it: it never carries on on the CPU plane."""
    from tendermint_tpu_torch.rpc.client import RPCClientError
    from tendermint_tpu_torch.rpc.core import Environment

    privs = workloads.seeded_keys(4, 6)
    _chain, served, _states = workloads.serve_chain(workloads.kv_genesis("light-fail", privs), privs,
                                                     [[] for _ in range(6)], 6)
    env = Environment(chain_id="light-fail", block_store=served.block_store, state_store=served.state_store)
    home = _light_home(tmp_path, "failing", min_batch_size=1)
    code = (
        "import sys\n"
        "from tendermint_tpu_torch.ops.ed25519_kernel import Ed25519Verifier\n"
        "def dispatch(self, *args):\n"
        "    raise RuntimeError('CUDA error: launch failed')\n"
        "Ed25519Verifier.dispatch = dispatch\n"
        "from tendermint_tpu_torch.cmd import main\n"
        "sys.exit(main(sys.argv[1:]))\n"
    )

    async def go():
        async with workloads.rpc_serving([env]) as (primary,):
            lb1 = await HTTPProvider(primary).light_block(1)
            proc, addr, _lines = await _spawn(
                "-c", code, "--home", home, "light", "light-fail", "--primary", primary, "--trust-height", "1",
                "--trust-hash", lb1.signed_header.hash().hex(), "--trust-period", str(10 * 365 * 24 * 3600.0),
                "--laddr", "tcp://127.0.0.1:0", "--sequential", "--device", "cpu")
            client = HTTPClient(addr, timeout=30.0)
            try:
                with pytest.raises(RPCClientError) as err:
                    await client.call("light_block", height=5)
            finally:
                await client.close()
            out = (await proc.stdout.read()).decode()
            return await asyncio.wait_for(proc.wait(), 30), str(err.value), out

    rc, answer, out = run(go())
    assert rc != 0 and rc != -signal.SIGTERM
    assert "launch failed" in answer and "RuntimeError: CUDA error: launch failed" in out
    (report,) = [x for x in out.splitlines() if x.startswith("device plane: ")]
    assert json.loads(report.split("device plane: ", 1)[1])["stats"]["faults"] == 0


def _jax_home(tmp_path, chain_id: str) -> str:
    """A home `init` of the JAX CLI wrote, its node run to height 3 by
    the JAX package (p2p and RPC on 127.0.0.1 ports taken free)."""
    home = str(tmp_path / "jax-home")
    assert _quiet(jax_cli, "--home", home, "init", "validator", "--chain-id", chain_id)[0] == 0
    path = os.path.join(home, "config", "config.toml")
    cfg = jax_load_config(path)
    cfg.consensus.timeout_commit = 0.2
    cfg.rpc.laddr = "tcp://127.0.0.1:0"
    cfg.p2p.laddr = f"tcp://127.0.0.1:{_free_port()}"
    cfg.tpu.enable = False
    cfg.instrumentation.prometheus = False
    jax_write_config(cfg, path)

    async def go():
        cfg2 = jax_load_config(path)
        cfg2.base.home = home
        node = jax_make_node(cfg2)
        await node.start()
        try:
            await node.consensus.wait_for_height(4, timeout=60.0)
        finally:
            await node.stop()

    run(go())
    return home


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_inspect_over_a_jax_home_answers_as_the_jax_inspect(tmp_path):
    home = _jax_home(tmp_path, "inspect-chain")
    routes = [("block", {"height": h}) for h in (1, 2, 3)]
    routes += [("commit", {"height": 2}), ("light_block", {"height": 3}), ("header", {"height": 2}),
               ("validators", {"height": 2}), ("block_results", {"height": 2}), ("genesis", {}),
               ("consensus_params", {"height": 2}), ("blockchain", {"minHeight": 1, "maxHeight": 3}),
               ("health", {})]

    async def serve(mod):
        proc, addr, _lines = await _spawn(mod, "--home", home, "inspect", "--laddr", "tcp://127.0.0.1:0")
        client = HTTPClient(addr, timeout=30.0)
        try:
            return {f"{m} {p}": await client.call(m, **p) for m, p in routes}, await _stop(proc)
        finally:
            await client.close()
            if proc.returncode is None:
                proc.kill()
                await proc.wait()

    async def go():
        return await serve("tendermint_tpu_torch.cmd"), await serve("tendermint_tpu.cmd")

    (port, port_exit), (jax, _) = run(go())
    assert port == jax
    assert port_exit[0] == 0
    assert port["block {'height': 3}"]["block"]["header"]["height"] == 3


@pytest.mark.parametrize("transport", ["socket", "grpc"])
def test_abci_cli_and_console_answer_as_the_jax_cli(tmp_path, capsys, transport):
    flag = ["--grpc"] if transport == "grpc" else []
    script = "echo hi\ninfo\ndeliver-tx name=satoshi\ncheck-tx 0x6b3d76\ncommit\nquery name\nbogus x\n"

    async def go():
        async def serve():
            addr = f"tcp://127.0.0.1:{_free_port()}"
            proc = await asyncio.create_subprocess_exec(
                sys.executable, "-m", "tendermint_tpu_torch.cmd", "abci", "kvstore", "--addr", addr, *flag,
                env=_env(), cwd=REPO, stdout=asyncio.subprocess.PIPE, stderr=asyncio.subprocess.STDOUT)
            line = (await proc.stdout.readline()).decode()
            assert "listening" in line, line
            return proc, addr

        async def console(mod, addr):
            proc = await asyncio.create_subprocess_exec(
                sys.executable, "-m", mod, "abci", "console", "--addr", addr, *flag, env=_env(), cwd=REPO,
                stdin=asyncio.subprocess.PIPE, stdout=asyncio.subprocess.PIPE, stderr=asyncio.subprocess.PIPE)
            out, _err = await proc.communicate(script.encode())
            return proc.returncode, out.decode()

        servers = await asyncio.gather(serve(), serve(), serve())
        try:
            one_shot = []
            for argv in (["echo", "ping"], ["deliver-tx", "name=satoshi"], ["commit"], ["query", "name"], ["info"]):
                outs = []
                for fn in (cli, jax_cli):
                    # the JAX CLI reads what the port's wrote; it writes nothing itself
                    if fn is jax_cli and argv[0] in ("deliver-tx", "commit"):
                        continue
                    rc, out = await asyncio.to_thread(_quiet, fn, "abci", *argv, "--addr", servers[0][1], *flag)
                    outs.append((rc, out))
                one_shot.append(outs)
            consoles = await asyncio.gather(console("tendermint_tpu_torch.cmd", servers[1][1]),
                                            console("tendermint_tpu.cmd", servers[2][1]))
            return one_shot, consoles
        finally:
            for proc, _addr in servers:
                proc.send_signal(signal.SIGTERM)
                await asyncio.wait_for(proc.wait(), 15)

    one_shot, (port_console, jax_console) = run(go())
    for outs in one_shot:
        assert outs[0][0] == 0
        if len(outs) == 2:
            assert outs[0] == outs[1]
    assert "-> data: ping" in one_shot[0][0][1] and "-> value: satoshi" in one_shot[3][0][1]
    assert port_console == jax_console
    assert port_console[0] == 0 and "-> error: unknown abci command 'bogus'" in port_console[1]


def test_inspect_and_replay_refuse_a_locked_data_dir(tmp_path, capsys):
    home = _home(tmp_path, "locked", PrivKeyEd25519.from_seed(b"\x51" * 32), "lock-chain")
    lock = os.path.join(home, "data", "LOCK")
    other = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(60)"])
    try:
        with open(lock, "w") as f:
            f.write(str(other.pid))
        capsys.readouterr()
        assert cli(["--home", home, "inspect"]) == 1
        assert cli(["--home", home, "replay", "--device", "cpu"]) == 1
        err = capsys.readouterr().err
        assert err.count("node appears to be running") == 2 and str(other.pid) in err
        assert jax_cli(["--home", home, "inspect"]) == 1
    finally:
        other.kill()
        other.wait()
    # a dead pid is a stale lock: replay runs (nothing stored yet)
    with open(lock, "w") as f:
        f.write(str(other.pid))
    capsys.readouterr()
    assert cli(["--home", home, "replay", "--device", "cpu"]) == 0
    assert "replayed 0 blocks; final height 0" in capsys.readouterr().out


def test_e2e_cli_generates_the_jax_files_and_runs_one(tmp_path, capsys):
    out, jax_out = str(tmp_path / "manifests"), str(tmp_path / "jax-manifests")
    assert cli(["e2e", "generate", "--seed", "2", "--count", "3", "-o", out]) == 0
    assert _quiet(jax_cli, "e2e", "generate", "--seed", "2", "--count", "3", "-o", jax_out)[0] == 0
    names = sorted(os.listdir(out))
    assert names == sorted(os.listdir(jax_out)) and len(names) == 3
    for name in names:
        with open(os.path.join(out, name), "rb") as a, open(os.path.join(jax_out, name), "rb") as b:
            assert a.read() == b.read()
    from tendermint_tpu_torch.e2e import Manifest

    manifests = [(os.path.join(out, n), Manifest.from_toml(os.path.join(out, n))) for n in names]
    small = min(manifests, key=lambda pm: (len(pm[1].nodes), pm[1].target_height))
    capsys.readouterr()
    rc = cli(["e2e", "run", small[0], "--home-dir", str(tmp_path / "net"), "--timeout", "120", "--device", "cpu"])
    text = capsys.readouterr().out
    assert rc == 0, text
    report = json.loads(text[text.index("{"):])
    assert report["ok"] and report["reached_height"] >= small[1].target_height
    assert cli(["e2e", "generate", "extra-arg"]) == 1
    assert cli(["e2e", "run"]) == 1
