"""The in-process e2e testnet runner.

Counterpart: tendermint_tpu/e2e/runner.py:1-549 (reference:
test/e2e/runner/{setup,start,load,perturb,wait,test,benchmark}.go). The
network is hosted in one asyncio loop: real port Nodes (node/node.py
make_node) over a p2p MemoryNetwork, so delayed starts, double-signers,
kills and disconnects run in one process.

Phases (Runner.run()):
  setup     the workdir, the genesis, each node's config and keys
  start     start_at = 0 nodes boot; late nodes join at their heights
  load      a background tx generator at `load.tx_rate`
  perturb   kill, restart, disconnect, pause, partition and heal at
            their heights
  wait      every live node reaches target_height
  test      the invariants: equal block hashes over the common prefix,
            committed DuplicateVoteEvidence for every double-signer,
            committed txs under load, a snapshot restore for every
            state_sync node
  benchmark block-interval avg, stddev, min and max (benchmark.go:14-23)

Where the JAX runner differs:
- the device plane: `device` ("cuda" by default) is where each node's
  [gpu] plane runs, installed once for the process by the first node
  (node/device.py). device="cpu" (the tests) writes `[gpu] enable =
  false`: the nodes verify on the native CPU plane. Below the gate of 32
  a 4-validator net's commits verify on the CPU plane either way;
- a double-prevote misbehavior is the port's Byzantine plane
  (consensus/byzantine.py): while the run lasts an `equivocate` rule at
  step prevote from the manifest's height names the node's moniker, and
  the node installs the harness as it is assembled, where the JAX runner
  swaps in a MockPV and wraps `cs.do_prevote` itself. The harness sends
  the conflicting prevote to half the peers; the evidence is the same
  DuplicateVoteEvidence.
"""

from __future__ import annotations

import asyncio
import contextlib
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List

from ..config import Config
from ..consensus import byzantine
from ..crypto import faults
from ..crypto.ed25519 import PrivKeyEd25519
from ..node import NodeKey, make_node
from ..p2p.transport import MemoryNetwork, MemoryTransport
from ..privval.file import FilePV
from ..types.evidence import DuplicateVoteEvidence
from ..types.genesis import GenesisDoc, GenesisValidator
from .manifest import Manifest, NodeSpec

__all__ = ["RunReport", "Runner", "interval_stats", "run_manifest", "validator_key"]


@dataclass
class RunReport:
    """What a manifest run found (Runner.run(), ProcessRunner.run())."""

    reached_height: int = 0
    blocks: int = 0
    interval_avg: float = 0.0
    interval_stddev: float = 0.0
    interval_min: float = 0.0
    interval_max: float = 0.0
    txs_submitted: int = 0
    txs_committed: int = 0
    evidence_heights: Dict[str, int] = field(default_factory=dict)
    state_synced: Dict[str, bool] = field(default_factory=dict)
    failures: List[str] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.failures


def validator_key(name: str) -> PrivKeyEd25519:
    """A manifest validator's key, the JAX runners' seed for the name."""
    return PrivKeyEd25519.from_seed(name.encode().ljust(32, b"\x9e")[:32])


def interval_stats(rep: RunReport, times: List[int], skip_warmup: bool) -> None:
    """Fill rep's block-interval stats from block times in ns. With
    skip_warmup, more than 10 intervals drop their first 2 (process boot
    and peer dialing, not steady consensus: the process runner's
    window)."""
    if len(times) < 2:
        return
    deltas = [(b - a) / 1e9 for a, b in zip(times, times[1:])]
    if skip_warmup and len(deltas) > 10:
        deltas = deltas[2:]
    rep.blocks = len(deltas)
    rep.interval_avg = sum(deltas) / len(deltas)
    mean = rep.interval_avg
    rep.interval_stddev = (sum((d - mean) ** 2 for d in deltas) / len(deltas)) ** 0.5
    rep.interval_min = min(deltas)
    rep.interval_max = max(deltas)


class _NodeHandle:
    def __init__(self, spec: NodeSpec, cfg: Config, priv=None):
        self.spec = spec
        self.cfg = cfg
        self.priv = priv  # the validator key, if any
        self.node = None
        # kept across kill and restart: the flag lives on the Node, and
        # a restarted node (with history on disk) skips state sync
        self.state_synced_once = False

    def note_sync(self) -> None:
        if self.node is not None and self.node.genesis_state_synced:
            self.state_synced_once = True

    @property
    def live(self) -> bool:
        return self.node is not None and self.node.is_running


class Runner:
    # every app serves snapshots when a node will state sync (the
    # reference e2e app's snapshot_interval)
    SNAPSHOT_INTERVAL = 2

    def __init__(self, manifest: Manifest, home: str, timeout: float = 240.0, device="cuda"):
        self.m = manifest
        self.home = home
        self.timeout = timeout
        self.device = device
        self.net = MemoryNetwork()
        self.handles: Dict[str, _NodeHandle] = {}
        self._tx_seq = 0
        self._resume_tasks: List[asyncio.Task] = []
        # the nodes the partition perturbation isolates, each its own group
        self._partitioned: set = set()
        self.report = RunReport()

    # -- setup (reference: test/e2e/runner/setup.go) --

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
        node_ids: Dict[str, str] = {}
        for name, spec in m.sorted_nodes():
            cfg = Config()
            cfg.base.home = os.path.join(self.home, name)
            cfg.base.chain_id = m.chain_id
            cfg.base.moniker = name  # the Byzantine plane's victim label
            cfg.base.db_backend = spec.database
            cfg.base.mode = spec.mode
            cfg.gpu.enable = str(self.device) != "cpu"
            cfg.consensus.timeout_propose = 2.0
            cfg.consensus.timeout_prevote = 1.0
            cfg.consensus.timeout_precommit = 1.0
            cfg.consensus.timeout_commit = 0.2
            cfg.consensus.peer_gossip_sleep_duration = 0.01
            cfg.rpc.laddr = "tcp://127.0.0.1:0"
            cfg.p2p.laddr = f"{name}:26656"
            cfg.statesync.enable = spec.state_sync
            if spec.state_sync:
                cfg.statesync.discovery_time = 1.0
                cfg.statesync.chunk_request_timeout = 5.0
            cfg.ensure_dirs()
            genesis.save_as(cfg.base.path(cfg.base.genesis_file))
            priv = privs.get(name)
            if priv is not None:
                FilePV.from_priv_key(
                    priv,
                    cfg.base.path(cfg.priv_validator.key_file),
                    cfg.base.path(cfg.priv_validator.state_file),
                ).save()
            self.handles[name] = _NodeHandle(spec, cfg, priv)
            node_ids[name] = NodeKey.load_or_generate(cfg.base.path(cfg.base.node_key_file)).node_id
        for name, h in self.handles.items():
            h.cfg.p2p.persistent_peers = ",".join(
                f"{node_ids[o]}@{o}:26656" for o in self.handles if o != name
            )

    # -- start (reference: test/e2e/runner/start.go) --

    def _make_app(self):
        if not any(s.state_sync for s in self.m.nodes.values()):
            return None  # make_node's default app
        from ..abci.kvstore import KVStoreApplication

        return KVStoreApplication(snapshot_interval=self.SNAPSHOT_INTERVAL)

    async def _start_node(self, name: str) -> None:
        h = self.handles[name]
        if h.spec.state_sync and h.node is None:
            self._seed_state_sync_trust(h)
        h.node = make_node(
            h.cfg,
            app=self._make_app(),
            transport=MemoryTransport(self.net, f"{name}:26656"),
            device=self.device,
        )
        await h.node.start()

    def _seed_state_sync_trust(self, h: _NodeHandle) -> None:
        """The late joiner's trust root: block 1 of a live node's chain
        (an operator's in production)."""
        for other in self.handles.values():
            if other.live and other.node.block_store.height() >= 1:
                bm = other.node.block_store.load_block_meta(1)
                if bm is not None:
                    h.cfg.statesync.trust_height = 1
                    h.cfg.statesync.trust_hash = bm.block_id.hash.hex()
                    return

    # -- load (reference: test/e2e/runner/load.go) --

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
            val = os.urandom(max(1, self.m.load.tx_size // 2)).hex()
            tx = f"load-{self._tx_seq}={val}".encode()[: self.m.load.tx_size]
            try:
                await h.node.mempool.check_tx(tx)
                self.report.txs_submitted += 1
            except Exception:
                pass  # a full mempool, a stopping node: load is best effort

    # -- perturb (reference: test/e2e/runner/perturb.go) --

    async def _apply_perturbation(self, name: str, action: str) -> None:
        h = self.handles[name]
        h.note_sync()
        if action == "kill":
            if h.live:
                await h.node.stop()
        elif action == "restart":
            if h.live:
                await h.node.stop()
            await self._start_node(name)
        elif action == "disconnect":
            if h.live:
                router = h.node.router
                for pid in list(router._peer_conns):
                    router._peer_down(pid)
        elif action in ("partition", "heal"):
            # a p2p-level cut: the node runs on and its links drop frames
            if action == "partition":
                self._partitioned.add(name)
            else:
                self._partitioned.discard(name)
            self._set_partition_groups()
        elif action == "pause":
            if h.live:
                await h.node.stop()

                async def resume():
                    await asyncio.sleep(3.0)
                    if not h.live:
                        await self._start_node(name)

                self._resume_tasks.append(asyncio.get_running_loop().create_task(resume()))

    def _set_partition_groups(self) -> None:
        """Each isolated node its own group, the rest one group, by node
        ID; no isolated node heals the net."""

        def nid(name):
            return self.handles[name].node.node_info.node_id

        isolated = sorted(self._partitioned)
        rest = [n for n in self.handles if n not in self._partitioned]
        groups = [[nid(n)] for n in isolated]
        if isolated and rest:
            groups.append([nid(n) for n in rest])
        faults.set_partition("|".join(",".join(g) for g in groups) if isolated else "")

    # -- orchestration --

    def _network_height(self) -> int:
        return max((h.node.block_store.height() for h in self.handles.values() if h.live), default=0)

    def _misbehaviors(self) -> contextlib.ExitStack:
        """The manifest's double-signers as Byzantine rules for the run."""
        stack = contextlib.ExitStack()
        for name, h in sorted(self.handles.items()):
            at = h.spec.misbehaviors.get("double-prevote")
            if at is not None and h.priv is not None:
                stack.enter_context(byzantine.inject("equivocate", h_lo=at, victim=name, step="prevote"))
        return stack

    async def run(self) -> RunReport:
        self.setup()
        with self._misbehaviors():
            try:
                await self._run_inner()
            finally:
                if self._partitioned:
                    faults.set_partition("")
                for h in self.handles.values():
                    if h.live:
                        await h.node.stop()
        return self.report

    async def _run_inner(self) -> None:
        for name, h in self.m.sorted_nodes():
            if self.handles[name].spec.start_at == 0:
                await self._start_node(name)
        load_task = asyncio.get_running_loop().create_task(self._load_loop())
        pending_starts = {name: h.spec.start_at for name, h in self.handles.items() if h.spec.start_at > 0}
        schedule: List[tuple] = []
        for name, h in self.handles.items():
            for p in h.spec.perturb:
                schedule.append((p.height, name, p.action))
        schedule.sort()

        deadline = time.monotonic() + self.timeout
        try:
            while True:
                if time.monotonic() > deadline:
                    self.report.failures.append(
                        f"timeout before height {self.m.target_height} (at {self._network_height()})"
                    )
                    break
                await asyncio.sleep(0.25)
                height = self._network_height()
                for name, at in list(pending_starts.items()):
                    if height >= at:
                        del pending_starts[name]
                        await self._start_node(name)
                while schedule and schedule[0][0] <= height:
                    _, name, action = schedule.pop(0)
                    await self._apply_perturbation(name, action)
                if height >= self.m.target_height and not pending_starts and not schedule:
                    # every live node must reach the target itself
                    if all(
                        h.node.block_store.height() >= self.m.target_height
                        for h in self.handles.values()
                        if h.live
                    ):
                        break
        finally:
            load_task.cancel()
            for t in self._resume_tasks:
                t.cancel()
            await asyncio.gather(load_task, *self._resume_tasks, return_exceptions=True)
        self._check_invariants()
        self._benchmark()

    # -- test (reference: test/e2e/tests/) --

    def _live_nodes(self):
        return [h for h in self.handles.values() if h.live]

    def _check_invariants(self) -> None:
        rep = self.report
        live = self._live_nodes()
        if not live:
            rep.failures.append("no live nodes at end of run")
            return
        rep.reached_height = min(h.node.block_store.height() for h in live)
        if rep.reached_height < self.m.target_height:
            rep.failures.append(f"converged height {rep.reached_height} < target {self.m.target_height}")
        # equal blocks over the common prefix
        ref = live[0]
        base = max(h.node.block_store.base() for h in live)
        for height in range(max(base, 1), rep.reached_height + 1):
            want = ref.node.block_store.load_block_meta(height)
            for h in live[1:]:
                got = h.node.block_store.load_block_meta(height)
                if got is None or want is None:
                    continue  # a pruned or state-synced node
                if got.block_id.hash != want.block_id.hash:
                    rep.failures.append(f"fork at height {height}: {h.spec.name} disagrees with {ref.spec.name}")
        if self.m.load.tx_rate > 0:
            committed = 0
            for height in range(1, rep.reached_height + 1):
                block = ref.node.block_store.load_block(height)
                if block is not None:
                    committed += len(block.txs)
            rep.txs_committed = committed
            if rep.txs_submitted > 0 and committed == 0:
                rep.failures.append("load ran but no txs were committed")
        # a state_sync node restored a snapshot (it did not block-sync
        # from genesis)
        for name, h in self.handles.items():
            if not h.spec.state_sync:
                continue
            h.note_sync()
            rep.state_synced[name] = h.state_synced_once
            if not h.state_synced_once:
                rep.failures.append(f"{name} was configured for state sync but never restored a snapshot")
        # evidence for every double-signer
        for name, h in self.handles.items():
            if "double-prevote" not in h.spec.misbehaviors:
                continue
            addr = h.priv.pub_key().address()
            found = None
            for height in range(1, rep.reached_height + 1):
                block = ref.node.block_store.load_block(height)
                if block is None:
                    continue
                for ev in block.evidence:
                    if isinstance(ev, DuplicateVoteEvidence) and ev.vote_a.validator_address == addr:
                        found = height
            if found is None:
                rep.failures.append(f"no DuplicateVoteEvidence committed for {name}")
            else:
                rep.evidence_heights[name] = found

    # -- benchmark (reference: test/e2e/runner/benchmark.go:14-23) --

    def _benchmark(self) -> None:
        live = self._live_nodes()
        if not live:
            return
        store = live[0].node.block_store
        times = []
        for height in range(1, self.report.reached_height + 1):
            bm = store.load_block_meta(height)
            if bm is not None:
                times.append(bm.header.time_ns)
        interval_stats(self.report, times, skip_warmup=False)


def run_manifest(manifest: Manifest, home: str, timeout: float = 240.0, device="cuda") -> RunReport:
    """Runner(...).run() in a fresh event loop."""
    return asyncio.run(Runner(manifest, home, timeout=timeout, device=device).run())
