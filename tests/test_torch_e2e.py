"""The port's e2e harness, held against the JAX package's
(after tests/test_e2e.py and tests/test_e2e_process.py).

- a manifest's TOML parses to the same manifest in both packages, and
  the writer's bytes are equal; an invalid manifest raises the same
  ValueError text;
- generate(seed) draws the same manifests as the JAX generator for seeds
  0-49, byte for byte in TOML;
- the in-process runner hosts four port Nodes under load with a
  double-signer (the Byzantine plane's equivocation, armed for the run
  only), and the JAX runner's invariants hold: no fork, txs committed,
  DuplicateVoteEvidence committed, block-interval stats;
- the process runner: a 2-validator net of `start` processes to height
  3 over TCP (unmarked), and the slow nets of the JAX file (SIGKILL
  recovery under load, a state-synced joiner);
- the process runner refuses misbehaviors, its children run without
  the plane only when asked for the CPU, and partition and heal rewrite
  the file every child polls.

Runs are timing-dependent: they are held to the invariants, not to
bytes. Every node runs with [gpu] enable = false (device="cpu").
"""

import asyncio
import os
import signal
import textwrap

import pytest

from tendermint_tpu.e2e import Manifest as JaxManifest
from tendermint_tpu.e2e import generate as jax_generate
from tendermint_tpu_torch.config import load_config
from tendermint_tpu_torch.consensus import byzantine
from tendermint_tpu_torch.crypto import faults
from tendermint_tpu_torch.e2e import Manifest, NodeSpec, Perturbation, generate, run_manifest
from tendermint_tpu_torch.e2e import process_runner as pr
from tendermint_tpu_torch.e2e.process_runner import ProcessRunner
from tendermint_tpu_torch.node import device as device_plane

from .test_torch_isolation import jax_device_plane_paused  # noqa: F401 (autouse)

TOML = textwrap.dedent(
    """
    chain_id = "toml-net"
    initial_height = 7
    target_height = 9

    [validators]
    validator01 = 10
    validator02 = 20

    [node.validator01]
    database = "sqlite"
    perturb = ["kill:8", "restart:9"]

    [node.full01]
    mode = "full"
    start_at = 8
    state_sync = true

    [node.validator02]
    misbehaviors = { double-prevote = 8 }

    [load]
    tx_rate = 3.5
    tx_size = 32
    """
)

INVALID = (
    {"validators": {}},
    {"validators": {"a": 10}, "node": {"a": {"mode": "bogus"}}},
    {"validators": {"a": 10}, "node": {"a": {"misbehaviors": {"amnesia": 2}}}},
    {"validators": {"a": 10}, "node": {"b": {"state_sync": True}}},
    {"validators": {"a": 10}, "target_height": 4, "node": {"b": {"start_at": 5}}},
    {"validators": {"a": 10}, "target_height": 4, "node": {"a": {"perturb": ["kill:6"]}}},
    {"validators": {"a": 10}, "node": {"a": {"perturb": ["explode:2"]}}},
    {"validators": {"a": 10}, "node": {"a": {"mode": "full"}}},
    {"validators": {"a": 10, "b": 10, "c": 10}, "node": {"a": {"start_at": 2}, "b": {"start_at": 2}}},
)


@pytest.fixture(autouse=True)
def _clean():
    yield
    byzantine.reset()
    faults.reset()
    device_plane.uninstall_device_plane()


def test_manifest_toml_parses_and_writes_as_jax(tmp_path):
    p = tmp_path / "m.toml"
    p.write_text(TOML)
    m, jm = Manifest.from_toml(str(p)), JaxManifest.from_toml(str(p))
    assert m.to_toml() == jm.to_toml()
    assert m.nodes["validator01"].perturb == [Perturbation("kill", 8), Perturbation("restart", 9)]
    assert m.nodes["validator02"].mode == "validator" and m.nodes["full01"].state_sync
    assert m.load.tx_rate == 3.5
    # the writer's output reads back to the same manifest
    p.write_text(m.to_toml())
    assert Manifest.from_toml(str(p)).to_toml() == m.to_toml()


@pytest.mark.parametrize("data", INVALID)
def test_invalid_manifest_raises_the_jax_error(data):
    errors = []
    for cls in (Manifest, JaxManifest):
        with pytest.raises(ValueError) as err:
            cls.parse(data)
        errors.append(str(err.value))
    assert errors[0] == errors[1]


def test_generate_draws_the_jax_manifests():
    for seed in range(50):
        got = [m.to_toml() for m in generate(seed)]
        assert got == [m.to_toml() for m in jax_generate(seed)], seed


def test_in_process_net_with_load_and_a_double_signer(tmp_path):
    """4 validators, 5 txs/s and validator04 double-prevoting from height
    2, to height 5: the JAX runner's invariants (reference:
    runner/{load,wait,test,benchmark}.go)."""
    m = Manifest(chain_id="e2e-basic", target_height=5,
                 validators={f"validator{i:02d}": 10 for i in range(1, 5)})
    m.load.tx_rate = 5.0
    m.validate()
    m.nodes["validator04"].misbehaviors = {"double-prevote": 2}
    rep = run_manifest(m, str(tmp_path), timeout=120.0, device="cpu")
    assert rep.ok, rep.failures
    assert rep.reached_height >= 5
    assert rep.txs_submitted > 0 and rep.txs_committed > 0
    assert 2 <= rep.evidence_heights["validator04"] <= rep.reached_height
    assert rep.blocks >= 4 and rep.interval_avg > 0 and rep.interval_min <= rep.interval_avg <= rep.interval_max
    # the Byzantine rule lived for the run only, and no plane was installed
    assert not byzantine.armed() and device_plane.installed_plane() is None
    (harness,) = byzantine.harnesses()
    assert harness.moniker == "validator04" and harness.fired
    assert {(f[0], f[3]) for f in harness.fired} == {("equivocate", 1)}


def test_process_net_of_two_validators_reaches_height_3(tmp_path):
    """Two `start` processes and their `abci kvstore` processes over TCP,
    [gpu] enable = false, to height 3: hash agreement over RPC, interval
    stats, every process gone."""
    m = Manifest.parse({"chain_id": "proc-2", "target_height": 3, "validators": {"v0": 10, "v1": 10}})
    runner = ProcessRunner(m, str(tmp_path), timeout=60.0, device="cpu")
    rep = asyncio.run(runner.run())
    assert rep.ok, rep.failures
    assert rep.reached_height >= 3 and rep.blocks >= 2
    for h in runner.handles.values():
        assert not load_config(os.path.join(h.cfg.base.home, "config", "config.toml")).gpu.enable
        assert h.node_proc.returncode == 0 and h.app_proc.returncode is not None
        assert h.starts == 1


@pytest.mark.slow
def test_process_net_sigkill_recovery_under_load(tmp_path):
    """SIGKILL a validator mid-run (its app process survives), restart
    at once: WAL replay and the handshake against a live app."""
    m = Manifest.parse({
        "chain_id": "proc-kill", "target_height": 6,
        "validators": {f"v{i}": 10 for i in range(4)},
        "node": {"v1": {"perturb": ["kill:3"]}},
        "load": {"tx_rate": 2.0},
    })
    runner = ProcessRunner(m, str(tmp_path), timeout=240.0, device="cpu")
    rep = asyncio.run(runner.run())
    assert rep.ok, rep.failures
    assert runner.handles["v1"].starts == 2
    assert rep.txs_submitted > 0 and rep.txs_committed > 0


@pytest.mark.slow
def test_process_net_state_sync_joiner(tmp_path):
    m = Manifest.parse({
        "chain_id": "proc-ss", "target_height": 8,
        "validators": {f"v{i}": 10 for i in range(3)},
        "node": {"full01": {"mode": "full", "start_at": 4, "state_sync": True}},
    })
    rep = asyncio.run(ProcessRunner(m, str(tmp_path), timeout=240.0, device="cpu").run())
    assert rep.ok, rep.failures
    assert rep.state_synced == {"full01": True}


def test_process_runner_refuses_in_process_only_features(tmp_path):
    m = Manifest.parse({"chain_id": "p", "validators": {"v0": 10},
                        "node": {"v0": {"misbehaviors": {"double-prevote": 3}}}})
    with pytest.raises(ValueError, match="in-process"):
        ProcessRunner(m, str(tmp_path))


@pytest.mark.parametrize("device, enable", [("cuda", True), ("cpu", False)])
def test_children_run_the_plane_unless_asked_for_the_cpu(tmp_path, device, enable):
    m = Manifest.parse({"chain_id": "p", "validators": {"v0": 10, "v1": 10},
                        "node": {"full01": {"mode": "full", "start_at": 2}}})
    runner = ProcessRunner(m, str(tmp_path), device=device)
    runner.setup()
    for h in runner.handles.values():
        assert load_config(os.path.join(h.cfg.base.home, "config", "config.toml")).gpu.enable is enable
    env = pr.child_env({"X": "1"})
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert env["PYTHONPATH"].split(os.pathsep)[0] == root and env["X"] == "1"


def test_partition_and_heal_rewrite_the_polled_file(tmp_path):
    m = Manifest.parse({"chain_id": "p", "target_height": 6, "validators": {f"v{i}": 10 for i in range(4)},
                        "node": {"v1": {"perturb": ["partition:2", "heal:4"]},
                                 "v2": {"perturb": ["partition:3"]}}})
    assert Perturbation.parse("partition:4") == Perturbation("partition", 4)
    runner = ProcessRunner(m, str(tmp_path), device="cpu")
    runner.setup()
    spec = tmp_path / "partition.spec"
    assert spec.read_text() == ""

    class _Alive:
        def poll(self):
            return None

    for h in runner.handles.values():
        h.node_proc = _Alive()
    seen = []
    for name, action in (("v1", "partition"), ("v2", "partition"), ("v1", "heal"), ("v2", "heal")):
        asyncio.run(runner._apply_perturbation(name, action))
        seen.append(spec.read_text())
    assert seen == ["v1|v0,v2,v3", "v1|v2|v0,v3", "v2|v0,v1,v3", ""]
    # the children's plane reads the file's groups
    faults.reset()
    os.environ["TM_TPU_PARTITION_FILE"] = str(spec)
    try:
        spec.write_text("v1|v0,v2,v3")
        faults.load_env()
        assert faults.partition_blocked(("v1",), ("v0",))
    finally:
        del os.environ["TM_TPU_PARTITION_FILE"]
        faults.load_env()


def test_perturbations_map_to_signals():
    import inspect

    src = inspect.getsource(ProcessRunner._apply_perturbation)
    for sig in ("SIGKILL", "SIGTERM", "SIGSTOP", "SIGCONT"):
        assert sig in src and getattr(signal, sig)
    assert "TM_TPU_PARTITION_FILE" in inspect.getsource(ProcessRunner._spawn_node)
    assert NodeSpec(name="x").mode == "validator"
