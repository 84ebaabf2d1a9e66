"""The real-process e2e testnet runner.

Counterpart: tendermint_tpu/e2e/process_runner.py:1-669 (reference:
test/e2e/runner/perturb.go:43-77, benchmark.go:14-34). Every node is a
separate OS process, `python3 -m tendermint_tpu_torch.cmd --home H start
--device D`, over TCP p2p, each with its own kvstore app process (`abci
kvstore`) over socket ABCI, and perturbations are signals:

    kill        SIGKILL the node and start it again at once (docker kill
                and up): the app process survives, so the new node
                replays its WAL and handshakes against an app ahead of
                or behind its stores.
    restart     SIGTERM, wait for the exit, start again.
    pause       SIGSTOP, then SIGCONT after 3 s.
    disconnect  a longer SIGSTOP (8 s): a process's sockets cannot be
                cut from outside without network namespaces.
    partition   the node's moniker goes into its own group of the
    heal        partition file every child polls (TM_TPU_PARTITION_FILE,
                crypto/faults.py): it serves RPC while its links drop.

The invariants are read over live RPC: each node's height from `status`,
hash agreement from `block`, committed keys from `abci_query`. A state
sync node must stand at the tip and answer "no block at height 1" (a
restored node holds headers and commits below its snapshot, never the
genesis block). The benchmark is the block-interval avg, stddev, min and
max over the reference node's `header` times, the first 2 intervals left
out past 10 (process boot and dialing): a run to height 103 gives the
100-block window of BASELINE.md's "e2e block interval".

The device plane: the children run `start --device <device>` with `[gpu]
enable = true`, each installing the plane in its own process on the
card. Only a runner asked for the CPU (device="cpu", the tests) writes
`[gpu] enable = false` into the homes. Under the gate of 32 a
4-validator net's commits verify on the CPU plane either way. Where the
JAX `_child_env` pins JAX to the CPU, the port's children import no JAX:
their environment is the parent's (TM_TPU_FAULT passes on) with the
repository root on PYTHONPATH.

Limits, as the JAX runner's: `misbehaviors` are refused (the in-process
runner arms them); databases are sqlite, so a killed node finds its
stores on disk.
"""

from __future__ import annotations

import asyncio
import base64
import os
import signal
import socket
import subprocess
import sys
import time
from typing import Dict, List, Optional

from ..config import Config, write_config
from ..node.key import NodeKey
from ..privval.file import FilePV
from ..rpc.client import HTTPClient, RPCClientError
from ..types.genesis import GenesisDoc, GenesisValidator
from .manifest import Manifest
from .runner import RunReport, interval_stats, validator_key

__all__ = ["ProcessRunner", "child_env", "run_manifest_processes"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def child_env(extra: Optional[Dict[str, str]] = None) -> dict:
    """The children's environment: this one, with the repository root
    first on PYTHONPATH (so `-m tendermint_tpu_torch.cmd` resolves),
    and `extra` on top."""
    env = dict(os.environ)
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    path = env.get("PYTHONPATH", "")
    env["PYTHONPATH"] = root + (os.pathsep + path if path else "")
    env.update(extra or {})
    return env


class _ProcHandle:
    def __init__(self, name: str, cfg: Config):
        self.name = name
        self.cfg = cfg
        self.node_proc: Optional[subprocess.Popen] = None
        self.app_proc: Optional[subprocess.Popen] = None
        self.paused = False
        self.starts = 0  # node processes spawned
        self.rpc = HTTPClient(cfg.rpc.laddr, timeout=5.0)

    @property
    def live(self) -> bool:
        return self.node_proc is not None and self.node_proc.poll() is None and not self.paused

    @property
    def log_path(self) -> str:
        return os.path.join(self.cfg.base.home, "node.log")


class ProcessRunner:
    """The phases of runner.Runner, a process a node; see the module
    docstring."""

    # every app serves snapshots when a node will state sync
    SNAPSHOT_INTERVAL = 2

    def __init__(self, manifest: Manifest, home: str, timeout: float = 300.0, device="cuda"):
        for name, spec in manifest.nodes.items():
            if spec.misbehaviors:
                raise ValueError(
                    f"{name}: misbehaviors are only supported by the in-process runner "
                    "(the Byzantine plane is armed in its process)"
                )
        self.m = manifest
        self.home = home
        self.timeout = timeout
        self.device = str(device)
        self.handles: Dict[str, _ProcHandle] = {}
        self.report = RunReport()
        self._tx_seq = 0
        self._sent_keys: List[bytes] = []
        self._resume_tasks: List[asyncio.Task] = []
        # the partition every child polls; partition and heal rewrite it
        self._partition_file = os.path.join(home, "partition.spec")
        self._partitioned: set = set()

    # -- setup (reference: setup.go; cmd testnet's genesis and keys) --

    def setup(self) -> None:
        m = self.m
        privs = {name: validator_key(name) for name in m.validators}
        genesis = GenesisDoc(
            chain_id=m.chain_id,
            genesis_time_ns=time.time_ns(),
            initial_height=m.initial_height,
            validators=[
                GenesisValidator(pub_key=privs[n].pub_key(), power=p)
                for n, p in sorted(m.validators.items())
            ],
        )
        os.makedirs(self.home, exist_ok=True)
        with open(self._partition_file, "w") as f:
            f.write("")  # no partition at boot
        node_ids: Dict[str, str] = {}
        p2p_port: Dict[str, int] = {}
        for name, spec in m.sorted_nodes():
            cfg = Config()
            cfg.base.home = os.path.join(self.home, name)
            cfg.base.chain_id = m.chain_id
            cfg.base.mode = spec.mode
            # the moniker is the node's label in the partition file
            cfg.base.moniker = name
            cfg.base.db_backend = "sqlite"  # the stores outlive a SIGKILL
            cfg.base.abci = "socket"
            cfg.base.proxy_app = f"tcp://127.0.0.1:{_free_port()}"
            cfg.gpu.enable = self.device != "cpu"
            cfg.consensus.timeout_propose = 2.0
            cfg.consensus.timeout_prevote = 1.0
            cfg.consensus.timeout_precommit = 1.0
            cfg.consensus.timeout_commit = 0.2
            if spec.state_sync:
                cfg.statesync.enable = True
                cfg.statesync.discovery_time = 2.0
                cfg.statesync.chunk_request_timeout = 10.0
            cfg.rpc.laddr = f"tcp://127.0.0.1:{_free_port()}"
            p2p_port[name] = _free_port()
            cfg.p2p.laddr = f"tcp://127.0.0.1:{p2p_port[name]}"
            cfg.ensure_dirs()
            genesis.save_as(cfg.base.path(cfg.base.genesis_file))
            priv = privs.get(name)
            if priv is not None:
                FilePV.from_priv_key(
                    priv,
                    cfg.base.path(cfg.priv_validator.key_file),
                    cfg.base.path(cfg.priv_validator.state_file),
                ).save()
            node_ids[name] = NodeKey.load_or_generate(cfg.base.path(cfg.base.node_key_file)).node_id
            self.handles[name] = _ProcHandle(name, cfg)
        for name, h in self.handles.items():
            h.cfg.p2p.persistent_peers = ",".join(
                f"{node_ids[o]}@127.0.0.1:{p2p_port[o]}" for o in self.handles if o != name
            )
            write_config(h.cfg, os.path.join(h.cfg.base.home, "config", "config.toml"))

    # -- start (reference: start.go) --

    def _spawn_app(self, h: _ProcHandle) -> None:
        cmd = [sys.executable, "-m", "tendermint_tpu_torch.cmd", "abci", "kvstore", "--addr", h.cfg.base.proxy_app]
        if any(s.state_sync for s in self.m.nodes.values()):
            cmd += ["--snapshot-interval", str(self.SNAPSHOT_INTERVAL)]
        with open(os.path.join(h.cfg.base.home, "app.log"), "ab") as log:
            h.app_proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT, env=child_env())

    def _spawn_node(self, h: _ProcHandle) -> None:
        env = child_env({"TM_TPU_PARTITION_FILE": self._partition_file})
        cmd = [sys.executable, "-m", "tendermint_tpu_torch.cmd", "--home", h.cfg.base.home, "start",
               "--device", self.device]
        with open(h.log_path, "ab") as log:
            h.node_proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT, env=env)
        h.paused = False
        h.starts += 1

    async def _start_node(self, name: str) -> None:
        h = self.handles[name]
        if self.m.nodes[name].state_sync and not h.cfg.statesync.trust_hash:
            await self._seed_state_sync_trust(h)
        if h.app_proc is None or h.app_proc.poll() is not None:
            self._spawn_app(h)
        self._spawn_node(h)

    async def _seed_state_sync_trust(self, h: _ProcHandle) -> None:
        """The late joiner's trust root, as an operator sets it: block
        1's hash over a running node's RPC, written into the joiner's
        config before its process starts."""
        for other in self.handles.values():
            if other is h or not other.live:
                continue
            try:
                res = await other.rpc.call("block", height=1)
            except (OSError, asyncio.TimeoutError, RPCClientError, ValueError):
                continue
            h.cfg.statesync.trust_height = 1
            h.cfg.statesync.trust_hash = res["block_id"]["hash"]
            write_config(h.cfg, os.path.join(h.cfg.base.home, "config", "config.toml"))
            return
        raise RuntimeError(f"{h.name}: no live node answered for the state-sync trust root")

    # -- load over live RPC (reference: load.go) --

    async def _load_loop(self) -> None:
        rate = self.m.load.tx_rate
        if rate <= 0:
            return
        period = 1.0 / rate
        i = 0
        while True:
            await asyncio.sleep(period)
            live = [h for h in self.handles.values() if h.live]
            if not live:
                continue
            h = live[i % len(live)]
            i += 1
            self._tx_seq += 1
            key = f"load-{self._tx_seq}".encode()
            val = os.urandom(max(1, self.m.load.tx_size // 2)).hex().encode()
            tx = (key + b"=" + val)[: self.m.load.tx_size]
            try:
                # a short cap: a busy or restarting node must not stall the loop
                await asyncio.wait_for(
                    h.rpc.call("broadcast_tx_async", tx=base64.b64encode(tx).decode()), timeout=1.0
                )
                self.report.txs_submitted += 1
                self._sent_keys.append(tx.split(b"=", 1)[0])
            except asyncio.TimeoutError:
                # the cancelled call may have left half a request on the
                # kept-alive socket: reconnect on the next call
                await h.rpc.close()
            except Exception:
                pass  # a node down or restarting: load is best effort

    # -- perturb with signals (reference: perturb.go:43-77) --

    async def _apply_perturbation(self, name: str, action: str) -> None:
        h = self.handles[name]
        if h.node_proc is None:
            return
        if action == "kill":
            if h.node_proc.poll() is None:
                h.node_proc.send_signal(signal.SIGKILL)
                h.node_proc.wait()
            await self._start_node(name)
        elif action == "restart":
            if h.node_proc.poll() is None:
                h.node_proc.send_signal(signal.SIGTERM)
                try:
                    await asyncio.get_running_loop().run_in_executor(None, h.node_proc.wait, 30)
                except subprocess.TimeoutExpired:
                    h.node_proc.kill()
                    h.node_proc.wait()
            await self._start_node(name)
        elif action in ("partition", "heal"):
            if action == "partition":
                self._partitioned.add(name)
            else:
                self._partitioned.discard(name)
            self._write_partition_spec()
        elif action in ("pause", "disconnect"):
            if h.node_proc.poll() is None:
                h.node_proc.send_signal(signal.SIGSTOP)
                h.paused = True

                async def resume(hold: float) -> None:
                    await asyncio.sleep(hold)
                    if h.node_proc and h.node_proc.poll() is None:
                        h.node_proc.send_signal(signal.SIGCONT)
                    h.paused = False

                self._resume_tasks.append(
                    asyncio.get_running_loop().create_task(resume(3.0 if action == "pause" else 8.0))
                )

    def _write_partition_spec(self) -> None:
        """Each isolated node its own group, the rest one group; no
        isolated node heals the net."""
        isolated = sorted(self._partitioned)
        rest = [n for n in self.handles if n not in self._partitioned]
        groups = [[n] for n in isolated]
        if isolated and rest:
            groups.append(rest)
        with open(self._partition_file, "w") as f:
            f.write("|".join(",".join(g) for g in groups) if isolated else "")

    # -- orchestration --

    async def _height_of(self, h: _ProcHandle) -> int:
        try:
            res = await h.rpc.call("status")
            return int(res["sync_info"]["latest_block_height"])
        except Exception:
            return -1

    async def _network_height(self) -> int:
        hs = [await self._height_of(h) for h in self.handles.values() if h.live]
        return max((x for x in hs if x >= 0), default=0)

    async def run(self) -> RunReport:
        self.setup()
        try:
            return await self._run_inner()
        finally:
            await self._teardown()

    async def _run_inner(self) -> RunReport:
        for name, spec in self.m.sorted_nodes():
            if spec.start_at == 0:
                await self._start_node(name)
        load_task = asyncio.get_running_loop().create_task(self._load_loop())
        pending_starts = {name: s.start_at for name, s in self.m.sorted_nodes() if s.start_at > 0}
        schedule: List[tuple] = []
        for name in self.handles:
            for p in self.m.nodes[name].perturb:
                schedule.append((p.height, name, p.action))
        schedule.sort()

        deadline = time.monotonic() + self.timeout
        try:
            while True:
                if time.monotonic() > deadline:
                    self.report.failures.append(
                        f"timeout before height {self.m.target_height} (at {await self._network_height()})"
                    )
                    break
                await asyncio.sleep(0.5)
                height = await self._network_height()
                for name, at in list(pending_starts.items()):
                    if height >= at:
                        del pending_starts[name]
                        await self._start_node(name)
                while schedule and schedule[0][0] <= height:
                    _, name, action = schedule.pop(0)
                    await self._apply_perturbation(name, action)
                if height >= self.m.target_height and not pending_starts and not schedule:
                    # a process alive but mute (no RPC answer, or stopped)
                    # is a laggard: it holds the run open to the timeout
                    laggard = False
                    for h in self.handles.values():
                        alive = h.node_proc is not None and h.node_proc.poll() is None
                        if alive and (h.paused or await self._height_of(h) < self.m.target_height):
                            laggard = True
                    if not laggard:
                        break
        finally:
            load_task.cancel()
            # the resumes are awaited (<= 8 s each): a cancelled one would
            # leave its node stopped and out of the checks
            await asyncio.gather(load_task, *self._resume_tasks, return_exceptions=True)

        await self._check_invariants()
        await self._benchmark()
        return self.report

    async def _teardown(self) -> None:
        """SIGTERM every node and wait for it (15 s, then SIGKILL), then
        SIGKILL the apps: a node stops before the app it talks to goes.
        The JAX runner signals both at once."""
        loop = asyncio.get_running_loop()
        for h in self.handles.values():
            await h.rpc.close()
        for procs, sig in (([h.node_proc for h in self.handles.values()], signal.SIGTERM),
                           ([h.app_proc for h in self.handles.values()], signal.SIGKILL)):
            live = [p for p in procs if p is not None and p.poll() is None]
            for proc in live:
                proc.send_signal(signal.SIGCONT)  # a paused node hears the SIGTERM
                proc.send_signal(sig)
            for proc in live:
                try:
                    await loop.run_in_executor(None, proc.wait, 15)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()

    # -- test over live RPC (reference: test/e2e/tests/) --

    async def _check_invariants(self) -> None:
        rep = self.report
        live = [h for h in self.handles.values() if h.live]
        if not live:
            rep.failures.append("no live nodes at end of run")
            return
        heights = {}
        for h in live:
            hh = await self._height_of(h)
            if hh >= 0:
                heights[h.name] = hh
        if not heights:
            rep.failures.append("no node answered /status at end of run")
            return
        rep.reached_height = min(heights.values())
        for h in live:
            if h.name not in heights:
                rep.failures.append(f"{h.name} RPC unreachable at end of run")
        if rep.reached_height < self.m.target_height:
            rep.failures.append(f"converged height {rep.reached_height} < target {self.m.target_height}")
        # hash agreement and the committed txs, against a node with the
        # whole history (never a state-synced one)
        full_history = [h for h in live if not self.m.nodes[h.name].state_sync]
        ref = (full_history or live)[0]
        committed = 0
        for height in range(1, rep.reached_height + 1):
            try:
                want = await ref.rpc.call("block", height=height)
            except Exception:
                continue
            committed += len(want["block"]["txs"] or [])
            for h in live:
                if h is ref:
                    continue
                try:
                    got = await h.rpc.call("block", height=height)
                except Exception:
                    continue
                if got["block_id"]["hash"] != want["block_id"]["hash"]:
                    rep.failures.append(f"fork at height {height}: {h.name} disagrees with {ref.name}")
        # a state-sync node restored: it holds no genesis block
        for name, spec in self.m.nodes.items():
            if not spec.state_sync:
                continue
            h = self.handles[name]
            synced = False
            try:
                res = await h.rpc.call("status")
                if int(res["sync_info"]["latest_block_height"]) >= 1:
                    try:
                        await h.rpc.call("block", height=1)
                    except RPCClientError as e:
                        # only a JSON-RPC answer proves the restore; a
                        # transport failure proves nothing
                        synced = e.code is not None and e.code < 0
            except Exception:
                pass
            rep.state_synced[name] = synced
            if not synced:
                rep.failures.append(
                    f"{name} was configured for state sync but holds the full genesis block "
                    "(blocksynced instead?) or did not answer RPC"
                )
        if self.m.load.tx_rate > 0:
            rep.txs_committed = committed
            if rep.txs_submitted > 0 and committed == 0:
                rep.failures.append("load ran but no txs were committed")
            # the app's state holds committed keys, not only the blocks
            found = 0
            for key in self._sent_keys[:10]:
                try:
                    res = await ref.rpc.call("abci_query", path="/store", data=key.hex())
                    if res["response"].get("log") == "exists":
                        found += 1
                except Exception:
                    pass
            if committed > 0 and self._sent_keys and found == 0:
                rep.failures.append("no submitted kvstore key is queryable in app state")

    # -- benchmark (reference: benchmark.go:14-34, the 100-block window) --

    async def _benchmark(self) -> None:
        live = [h for h in self.handles.values() if h.live]
        if not live:
            return
        ref = live[0]
        times: List[int] = []
        for height in range(1, self.report.reached_height + 1):
            try:
                res = await ref.rpc.call("header", height=height)
                times.append(int(res["header"]["time_ns"]))
            except Exception:
                pass
        interval_stats(self.report, times, skip_warmup=True)


def run_manifest_processes(manifest: Manifest, home: str, timeout: float = 300.0, device="cuda") -> RunReport:
    """ProcessRunner(...).run() in a fresh event loop (`e2e run
    --processes`)."""
    return asyncio.run(ProcessRunner(manifest, home, timeout=timeout, device=device).run())
