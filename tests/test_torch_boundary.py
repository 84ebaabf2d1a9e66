"""The port's import boundary, and its refusal to fall back to the CPU.

tendermint_tpu_torch imports torch and numpy, never jax and nothing of
tendermint_tpu (not even the JAX package's framework-free modules), and
chip_smoke.py imports neither. Its entry points target CUDA unless the
caller passes device="cpu"; without a card they raise instead of running
the plain versions.
"""

import ast
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "tendermint_tpu_torch"


def _port_modules():
    mods = []
    for path in sorted(PKG.rglob("*.py")):
        parts = path.relative_to(ROOT).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def _forbidden(name: str) -> bool:
    return (
        name == "jax"
        or name.startswith("jax.")
        or name.startswith("jaxlib")
        or name == "tendermint_tpu"
        or name.startswith("tendermint_tpu.")
    )


def test_importing_every_module_loads_no_jax_and_no_jax_package():
    mods = _port_modules()
    assert len(mods) > 20
    code = (
        "import importlib, json, sys\n"
        "before = set(sys.modules)\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(set(sys.modules) - before)))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-c", code],
        cwd=ROOT,
        env=env,
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    added = json.loads(out.stdout.strip().splitlines()[-1])
    assert "tendermint_tpu_torch.ops.ed25519_kernel" in added
    for m in (
        "tendermint_tpu_torch.native",
        "tendermint_tpu_torch.node.device",
        "tendermint_tpu_torch.crypto.faults",
        "tendermint_tpu_torch.crypto.breaker",
        "tendermint_tpu_torch.light.client",
        "tendermint_tpu_torch.light.verifier",
        "tendermint_tpu_torch.light.provider",
        "tendermint_tpu_torch.light.store",
        "tendermint_tpu_torch.types.header",
        "tendermint_tpu_torch.types.light",
        "tendermint_tpu_torch.types.evidence",
        "tendermint_tpu_torch.store.kv",
        "tendermint_tpu_torch.workloads",
        "tendermint_tpu_torch.bench",
        "tendermint_tpu_torch.consensus",
        "tendermint_tpu_torch.consensus.msgs",
        "tendermint_tpu_torch.consensus.state",
        "tendermint_tpu_torch.consensus.types",
        "tendermint_tpu_torch.crypto.sigcache",
        "tendermint_tpu_torch.types.vote_set",
        "tendermint_tpu_torch.abci.client",
        "tendermint_tpu_torch.abci.kvstore",
        "tendermint_tpu_torch.abci.proxy",
        "tendermint_tpu_torch.libs.service",
        "tendermint_tpu_torch.mempool.nop",
        "tendermint_tpu_torch.state.execution",
        "tendermint_tpu_torch.state.store",
        "tendermint_tpu_torch.store.block_store",
        "tendermint_tpu_torch.types.block",
        "tendermint_tpu_torch.types.genesis",
        "tendermint_tpu_torch.types.part_set",
    ):
        assert m in added
    assert [m for m in added if _forbidden(m)] == []


def test_importing_the_device_plane_builds_and_starts_nothing():
    """Importing native/, node/, faults and breaker, the light client,
    the consensus vote path, the workloads and the bench compiles no
    library and starts no thread: the native plane builds at first use."""
    code = (
        "import json, threading\n"
        "from tendermint_tpu_torch import bench, consensus, light, native, workloads\n"
        "from tendermint_tpu_torch.consensus import msgs, state, types\n"
        "from tendermint_tpu_torch.node import device\n"
        "from tendermint_tpu_torch.crypto import breaker, faults, gpu_verifier\n"
        "print(json.dumps([native._LIB is None, threading.active_count(),\n"
        "                  faults.armed(), gpu_verifier.installed()]))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [True, 1, False, None]


def test_device_plane_without_cuda_raises():
    """install_device_plane targets the card: without one it raises and
    installs neither the verifiers nor the merkle hooks."""
    from tendermint_tpu_torch.config import GPUConfig
    from tendermint_tpu_torch.crypto import merkle
    from tendermint_tpu_torch.node.device import install_device_plane

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        install_device_plane(GPUConfig())
    assert merkle._device_root_hook is None and merkle._device_proofs_hook is None


@pytest.mark.parametrize(
    "path",
    sorted(str(p.relative_to(ROOT)) for p in PKG.rglob("*.py"))
    + ["chip_smoke.py"],
)
def test_source_names_no_forbidden_import(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        assert not [n for n in names if _forbidden(n)], (path, names)


def test_verifier_without_cuda_raises_instead_of_running_on_cpu():
    from tendermint_tpu_torch.crypto import batch, gpu_verifier
    from tendermint_tpu_torch.ops.ed25519_kernel import Ed25519Verifier

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Ed25519Verifier()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        gpu_verifier.install()
    assert gpu_verifier.installed() is None
    assert not batch.device_factory_installed("ed25519")


def test_wrappers_take_the_plain_version_only_on_cpu():
    """A tensor that is neither on the CPU nor on CUDA is refused: the
    plain version is chosen by the tensor's device, never as a fallback."""
    from tendermint_tpu_torch.ops import ed25519_cuda, sha512_kernel

    meta = torch.empty((64, 4), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        sha512_kernel.sha512_fixed(meta)
    with pytest.raises(ValueError, match="unsupported device"):
        ed25519_cuda.verify_tile(meta[:32], meta, meta)
    with pytest.raises(ValueError, match="unsupported device"):
        ed25519_cuda.dual_mult(
            torch.empty((4, 20, 4), dtype=torch.int32, device="meta"),
            meta.int(),
            meta.int(),
        )


def test_sr25519_verifier_without_cuda_raises():
    """The sr25519 verifier and the factories install() registers for
    both key types need the card unless device="cpu" is asked for."""
    from tendermint_tpu_torch.crypto import batch, gpu_verifier
    from tendermint_tpu_torch.ops.sr25519_kernel import Sr25519Verifier

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Sr25519Verifier()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        gpu_verifier.install(program="hybrid")
    assert not batch.device_factory_installed("sr25519")
    Sr25519Verifier(device="cpu")


def test_sr25519_wrapper_takes_the_plain_version_only_on_cpu():
    from tendermint_tpu_torch.ops import sr25519_cuda

    meta = torch.empty((64, 4), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        sr25519_cuda.verify_sr(meta[:32], meta, meta[:32])
    zeros = torch.zeros((64, 2), dtype=torch.uint8)
    assert sr25519_cuda.verify_sr(zeros[:32], zeros, zeros[:32]).tolist() == [False] * 2
    assert sr25519_cuda.LAUNCHES == {"sr25519_verify": 0}


def test_merkle_wrappers_take_the_plain_version_only_on_cpu():
    """X4's and X5's wrappers refuse a tensor that is neither on the CPU
    nor on CUDA, and run the plain version, counting no launch, on the
    CPU."""
    from tendermint_tpu_torch.ops import merkle_kernel, sha256_kernel

    meta = torch.empty((4, 32), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        sha256_kernel.sha256_rows(meta, 0)
    with pytest.raises(ValueError, match="unsupported device"):
        sha256_kernel.sha256_level(meta)
    with pytest.raises(ValueError, match="unsupported device"):
        sha256_kernel.sha256_tree(meta)
    with pytest.raises(ValueError, match="unsupported device"):
        merkle_kernel.merkle_proofs(
            meta,
            meta,
            torch.empty(5, dtype=torch.int32, device="meta"),
            torch.empty(4, dtype=torch.int64, device="meta"),
            meta[0],
            meta[:, 0],
        )
    sha256_kernel.reset_launches()
    merkle_kernel.reset_launches()
    level = torch.zeros((3, 32), dtype=torch.uint8)
    assert tuple(sha256_kernel.sha256_level(level).shape) == (2, 32)
    assert tuple(sha256_kernel.sha256_tree(level).shape) == (32,)
    assert sha256_kernel.LAUNCHES == {"sha256_rows": 0, "sha256_tree": 0}
    assert merkle_kernel.LAUNCHES == {"merkle_proofs": 0}
