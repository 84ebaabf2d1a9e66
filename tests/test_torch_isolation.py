"""A port test runs its JAX references on the JAX package's CPU verifiers,
whatever an earlier test of the same worker left installed.

The driver runs the tests with several workers, each running whole files
one after another. A JAX test file that ends with the JAX device
verifiers installed (crypto/tpu_verifier.py: its batch factories in
crypto/batch.py and the sr25519 single-verify route) sends every later
batch and sr25519 verify of that process through JAX programs compiled
for the CPU. A port test's JAX reference node then compiles them as it
goes: tests/test_torch_consensus_state.py's 64-validator mixed heights
took 5.5 s alone, 58.8 s after a JAX verifier install in the same
process, and 89.8 s and 210.7 s in two whole runs of the suite.

jax_device_plane_paused, an autouse fixture that the port test files
comparing with JAX nodes or JAX commit checks import, sets those
verifiers aside for the test and puts back, after it, exactly what it
found, so the JAX tests that follow meet the process as they would have.
"""

import contextlib

import pytest

from tendermint_tpu.crypto import batch as jax_batch
from tendermint_tpu.crypto import tpu_verifier


@contextlib.contextmanager
def jax_device_plane_set_aside():
    """For the block, no JAX device factory is registered and the JAX
    verifier reads as not installed (so sr25519 singles take the CPU
    path); then the factories and the flag are as they were."""
    factories = dict(jax_batch._DEVICE_FACTORIES)
    installed = tpu_verifier._INSTALLED
    jax_batch._DEVICE_FACTORIES.clear()
    tpu_verifier._INSTALLED = False
    try:
        yield
    finally:
        jax_batch._DEVICE_FACTORIES.clear()
        jax_batch._DEVICE_FACTORIES.update(factories)
        tpu_verifier._INSTALLED = installed


@pytest.fixture(autouse=True)
def jax_device_plane_paused():
    with jax_device_plane_set_aside():
        yield


def test_the_fixture_leaves_only_the_jax_cpu_verifiers():
    assert not jax_batch.device_factory_installed("ed25519")
    assert not jax_batch.device_factory_installed("sr25519")
    assert tpu_verifier.installed() is None
    assert tpu_verifier.single_sr_verifier() is None


def test_what_was_installed_is_put_back():
    def factory(n):
        return None

    jax_batch.register_device_factory("ed25519", factory)
    tpu_verifier._INSTALLED = True
    try:
        with jax_device_plane_set_aside():
            assert not jax_batch.device_factory_installed("ed25519")
            assert tpu_verifier.installed() is None
        assert jax_batch._DEVICE_FACTORIES["ed25519"] is factory
        assert tpu_verifier._INSTALLED is True
    finally:
        jax_batch.unregister_device_factory("ed25519")
        tpu_verifier._INSTALLED = False
