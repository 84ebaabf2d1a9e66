"""Testnet manifests: declarative descriptions of e2e networks.

Counterpart: tendermint_tpu/e2e/manifest.py:1-234 (reference:
test/e2e/pkg/manifest.go). The TOML shape, the defaults, the checks and
their messages, and the writer's bytes are the JAX package's, so one
manifest file drives the runners of either package. The in-process
runner (e2e/runner.py) hosts every node as a real `node.Node` over a
MemoryNetwork; the process runner (e2e/process_runner.py) runs each as
a `start` process over TCP.

Manifest shape (TOML; every section optional but validators):

    chain_id = "e2e-net"
    initial_height = 1
    target_height = 6            # run until every live node is here

    [validators]                 # name -> voting power
    validator01 = 10
    validator02 = 10

    [node.validator01]
    mode = "validator"           # validator | full | seed
    database = "memdb"           # memdb | sqlite
    start_at = 0                 # >0: boot only at that network height
    state_sync = false
    perturb = ["kill:4", "disconnect:3", "pause:5", "restart:6"]
    misbehaviors = { double-prevote = 3 }   # action -> height

    [load]
    tx_rate = 5                  # txs/second pushed at random nodes
    tx_size = 64
"""

from __future__ import annotations

import tomllib
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

__all__ = ["Manifest", "NodeSpec", "LoadSpec", "Perturbation"]

MODES = ("validator", "full", "seed")
# partition/heal are p2p-level cuts (crypto/faults.py partition sets;
# the process runner's children poll TM_TPU_PARTITION_FILE), unlike
# `disconnect`'s SIGSTOP: the process keeps serving RPC while its links
# drop everything.
PERTURBATIONS = ("kill", "restart", "disconnect", "pause", "partition", "heal")
MISBEHAVIORS = ("double-prevote",)


@dataclass
class Perturbation:
    """A fault applied to one node when the network reaches `height`."""

    action: str
    height: int

    @classmethod
    def parse(cls, s: str) -> "Perturbation":
        action, _, h = s.partition(":")
        if action not in PERTURBATIONS:
            raise ValueError(f"unknown perturbation {action!r}")
        return cls(action=action, height=int(h or 1))


@dataclass
class NodeSpec:
    name: str
    mode: str = "validator"
    database: str = "memdb"
    start_at: int = 0
    state_sync: bool = False
    perturb: List[Perturbation] = field(default_factory=list)
    misbehaviors: Dict[str, int] = field(default_factory=dict)

    def validate(self) -> None:
        if self.mode not in MODES:
            raise ValueError(f"{self.name}: unknown mode {self.mode!r}")
        for m in self.misbehaviors:
            if m not in MISBEHAVIORS:
                raise ValueError(f"{self.name}: unknown misbehavior {m!r}")
        if self.state_sync and self.start_at == 0:
            raise ValueError(
                f"{self.name}: state_sync requires start_at > 0 "
                "(there must be history to sync)"
            )


@dataclass
class LoadSpec:
    tx_rate: float = 0.0
    tx_size: int = 64


@dataclass
class Manifest:
    chain_id: str = "e2e-net"
    initial_height: int = 1
    target_height: int = 5
    validators: Dict[str, int] = field(default_factory=dict)
    nodes: Dict[str, NodeSpec] = field(default_factory=dict)
    load: LoadSpec = field(default_factory=LoadSpec)

    @classmethod
    def parse(cls, data: dict) -> "Manifest":
        m = cls(
            chain_id=data.get("chain_id", "e2e-net"),
            initial_height=int(data.get("initial_height", 1)),
            target_height=int(data.get("target_height", 5)),
            validators={
                k: int(v) for k, v in data.get("validators", {}).items()
            },
        )
        for name, nd in data.get("node", {}).items():
            spec = NodeSpec(
                name=name,
                mode=nd.get(
                    "mode",
                    "validator" if name in m.validators else "full",
                ),
                database=nd.get("database", "memdb"),
                start_at=int(nd.get("start_at", 0)),
                state_sync=bool(nd.get("state_sync", False)),
                perturb=[
                    Perturbation.parse(p) for p in nd.get("perturb", [])
                ],
                misbehaviors={
                    k: int(v)
                    for k, v in nd.get("misbehaviors", {}).items()
                },
            )
            m.nodes[name] = spec
        ld = data.get("load", {})
        m.load = LoadSpec(
            tx_rate=float(ld.get("tx_rate", 0.0)),
            tx_size=int(ld.get("tx_size", 64)),
        )
        m.validate()
        return m

    @classmethod
    def from_toml(cls, path: str) -> "Manifest":
        with open(path, "rb") as f:
            return cls.parse(tomllib.load(f))

    def validate(self) -> None:
        if not self.validators:
            raise ValueError("manifest needs at least one validator")
        # validators without an explicit node section get a default one
        for name in self.validators:
            self.nodes.setdefault(name, NodeSpec(name=name))
        for name in self.validators:
            if self.nodes[name].mode != "validator":
                raise ValueError(f"{name} has power but is not a validator")
        for spec in self.nodes.values():
            spec.validate()
            # a schedule past the target would keep a runner waiting to
            # its timeout after the chain converged
            if spec.start_at > self.target_height:
                raise ValueError(
                    f"{spec.name}: start_at {spec.start_at} is beyond "
                    f"target_height {self.target_height}"
                )
            for p in spec.perturb:
                if p.height > self.target_height:
                    raise ValueError(
                        f"{spec.name}: perturbation {p.action}:{p.height} "
                        f"is beyond target_height {self.target_height}"
                    )
        live_from_start = [
            s for s in self.nodes.values()
            if s.start_at == 0 and s.mode == "validator"
        ]
        power_up = sum(self.validators[s.name] for s in live_from_start)
        if power_up * 3 <= sum(self.validators.values()) * 2:
            raise ValueError(
                "validators online at genesis hold <=2/3 power; "
                "the network could never start"
            )

    def sorted_nodes(self) -> List[Tuple[str, NodeSpec]]:
        return sorted(self.nodes.items())

    def to_toml(self) -> str:
        """The TOML from_toml reads (tomllib only reads: this is the
        writer half, kept beside the reader)."""
        lines = [
            f'chain_id = "{self.chain_id}"',
            f"initial_height = {self.initial_height}",
            f"target_height = {self.target_height}",
            "",
            "[validators]",
        ]
        for name, power in sorted(self.validators.items()):
            lines.append(f"{name} = {power}")
        for name, spec in self.sorted_nodes():
            lines += [
                "",
                f"[node.{name}]",
                f'mode = "{spec.mode}"',
                f'database = "{spec.database}"',
            ]
            if spec.start_at:
                lines.append(f"start_at = {spec.start_at}")
            if spec.state_sync:
                lines.append("state_sync = true")
            if spec.perturb:
                entries = ", ".join(
                    f'"{p.action}:{p.height}"' for p in spec.perturb
                )
                lines.append(f"perturb = [{entries}]")
            if spec.misbehaviors:
                entries = ", ".join(
                    f"{k} = {v}"
                    for k, v in sorted(spec.misbehaviors.items())
                )
                lines.append(f"misbehaviors = {{ {entries} }}")
        if self.load.tx_rate:
            lines += [
                "",
                "[load]",
                f"tx_rate = {self.load.tx_rate}",
                f"tx_size = {self.load.tx_size}",
            ]
        return "\n".join(lines) + "\n"
