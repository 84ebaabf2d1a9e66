"""The node's device seam: config.GPUConfig and node/device.py.

GPUConfig's defaults against the JAX package's TPUConfig, the `devices`
rules (one card; more is X6, refused), and install_device_plane on
device="cpu" putting crypto/gpu_verifier and ops/merkle_kernel behind
the port's seams from the config, then verifying a Commit as the JAX
package does. Tolerance: zero (exact outcomes and messages).
"""

import dataclasses

import pytest
import torch

from tendermint_tpu.config import TPUConfig
from tendermint_tpu.types import validation as jax_validation
from tendermint_tpu_torch import config
from tendermint_tpu_torch.crypto import batch, gpu_verifier, merkle
from tendermint_tpu_torch.crypto.sr25519 import PrivKeySr25519
from tendermint_tpu_torch.node import device as node_device
from tendermint_tpu_torch.ops import merkle_kernel
from tendermint_tpu_torch.types import validation as port_validation

from .test_torch_validation import CHAIN_ID, HEIGHT, _carry, _jax_commit


@pytest.fixture(autouse=True)
def _clean():
    yield
    node_device.uninstall_device_plane()


def test_gpu_config_defaults_against_tpu_config():
    """The same fields and defaults but donate_buffers (XLA's) and the
    min batch, measured on the card where the JAX package has its TPU
    figure."""
    gpu, tpu = config.GPUConfig(), TPUConfig()
    names = {f.name for f in dataclasses.fields(config.GPUConfig)}
    tpu_names = {f.name for f in dataclasses.fields(TPUConfig)}
    assert tpu_names - names == {"donate_buffers"}
    assert names - tpu_names == set()
    assert gpu.enable == tpu.enable is True
    assert list(gpu.bucket_sizes) == list(tpu.bucket_sizes)
    assert gpu.devices == tpu.devices == 1
    assert gpu.min_batch_size == config.DEFAULT_MIN_BATCH == gpu_verifier.DEFAULT_MIN_BATCH
    assert tpu.min_batch_size == 8
    assert config.GPUConfig().bucket_sizes is not gpu.bucket_sizes


def test_install_device_plane_installs_both_seams_and_uninstall_removes_them():
    cfg = config.GPUConfig()
    assert node_device.install_device_plane(cfg, device="cpu") is True
    assert gpu_verifier.installed() == cfg.min_batch_size
    assert merkle_kernel.installed() == 512
    assert batch.device_factory_installed("ed25519")
    assert batch.device_factory_installed("sr25519")
    assert merkle._device_root_hook is not None
    node_device.uninstall_device_plane()
    assert gpu_verifier.installed() is None and merkle_kernel.installed() is None
    assert not batch.device_factory_installed("ed25519")
    assert merkle._device_root_hook is None and merkle._device_proofs_hook is None


def test_disabled_config_installs_nothing():
    assert node_device.install_device_plane(config.GPUConfig(enable=False), "cpu") is False
    assert gpu_verifier.installed() is None and merkle_kernel.installed() is None


@pytest.mark.parametrize("devices", [2, 4])
def test_more_than_one_card_is_refused_naming_x6(devices):
    with pytest.raises(NotImplementedError, match="ROADMAP item 10"):
        node_device.install_device_plane(config.GPUConfig(devices=devices), "cpu")
    assert gpu_verifier.installed() is None


def test_every_visible_card_means_one_here_and_more_is_refused(monkeypatch):
    """devices = 0 takes every visible card: the CPU counts one; a host
    with four CUDA cards is refused before anything is installed."""
    assert node_device.visible_devices("cpu") == 1
    assert node_device.install_device_plane(config.GPUConfig(devices=0), "cpu")
    node_device.uninstall_device_plane()
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert node_device.visible_devices("cuda") == 4
    with pytest.raises(NotImplementedError, match="X6"):
        node_device.install_device_plane(config.GPUConfig(devices=0))
    assert gpu_verifier.installed() is None


def test_negative_devices_raise():
    with pytest.raises(ValueError, match="must be >= 0"):
        node_device.install_device_plane(config.GPUConfig(devices=-1), "cpu")


def test_one_card_without_cuda_raises_instead_of_running_on_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        node_device.install_device_plane(config.GPUConfig())
    assert gpu_verifier.installed() is None
    assert merkle_kernel.installed() is None


def test_config_gates_and_buckets_reach_the_verifiers():
    """min_batch_size gates both key types and bucket_sizes are the
    windows' widths: 5 signatures in a 32-lane window pad 27 lanes."""
    cfg = config.GPUConfig(min_batch_size=5, bucket_sizes=[32, 128])
    node_device.install_device_plane(cfg, device="cpu")
    vals, bid, commit = _jax_commit(set(range(6)))
    pvals, _pbid, pcommit = _carry(vals, bid, commit)
    pk = pvals.validators[0].pub_key
    assert not isinstance(batch.create_batch_verifier(pk, 4), gpu_verifier.GpuEd25519BatchVerifier)
    bv = batch.create_batch_verifier(pk, 5)
    assert isinstance(bv, gpu_verifier.GpuEd25519BatchVerifier)
    sbs = pcommit.sign_bytes_batch(CHAIN_ID)
    before = gpu_verifier.stats()
    for i in range(5):
        bv.add(pvals.validators[i].pub_key, sbs[i], pcommit.signatures[i].signature)
    assert bv.verify() == (True, [True] * 5)
    sr = PrivKeySr25519(bytes([3]) * 32).pub_key()
    assert not isinstance(batch.create_batch_verifier(sr, 4), gpu_verifier.GpuSr25519BatchVerifier)
    assert isinstance(batch.create_batch_verifier(sr, 5), gpu_verifier.GpuSr25519BatchVerifier)
    after = gpu_verifier.stats()
    assert after["pad_waste"] - before["pad_waste"] == 27
    assert after["cold_buckets"] - before["cold_buckets"] == 1


@pytest.mark.parametrize("bad", [None, 3])
def test_verify_commit_through_the_installed_plane_matches_the_jax_package(bad):
    """A 6-validator Commit through the plane installed from a config
    (min batch 2, so its batch is a device window): the JAX package's
    outcome and message, no fault and nothing rerouted."""
    node_device.install_device_plane(config.GPUConfig(min_batch_size=2), "cpu")
    vals, bid, commit = _jax_commit(set(range(6)), bad=bad)
    pvals, pbid, pcommit = _carry(vals, bid, commit)
    before = gpu_verifier.stats()

    def outcome(fn, *args):
        try:
            fn(*args)
            return "ok"
        except Exception as e:  # the outcome under test is the message
            return f"{type(e).__name__}: {e}"

    got = outcome(port_validation.verify_commit, CHAIN_ID, pvals, pbid, HEIGHT, pcommit)
    want = outcome(jax_validation.verify_commit, CHAIN_ID, vals, bid, HEIGHT, commit)
    assert got == want
    assert (got == "ok") == (bad is None)
    after = gpu_verifier.stats()
    assert after["batches_ed25519"] - before["batches_ed25519"] == 1
    assert after["faults"] == before["faults"]
    assert after["rerouted_sigs"] == before["rerouted_sigs"]
