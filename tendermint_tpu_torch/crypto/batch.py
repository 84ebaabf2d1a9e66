"""Batch-verifier dispatch: the offload decision point.

Counterpart: tendermint_tpu/crypto/batch.py:43-170 and its defaults
:220-230 (ed25519 and sr25519; secp256k1 has no device path and is not
ported). A device factory registered here (crypto/gpu_verifier.install)
serves a key type's batches once the caller's size hint is large enough;
until then, and for key types without one, the registered CPU factory
does, as in the reference, where pure Go is the default.
"""

from __future__ import annotations

from typing import Callable, Optional

from .keys import BatchVerifier, PubKey

__all__ = [
    "cpu_factory",
    "create_batch_verifier",
    "device_factory_installed",
    "register_cpu_factory",
    "register_device_factory",
    "supports_batch_verifier",
    "unregister_device_factory",
]

# key type -> CPU batch verifier factory
_CPU_FACTORIES: dict[str, Callable[[], BatchVerifier]] = {}
# key type -> device batch verifier factory (size_hint -> verifier or None)
_DEVICE_FACTORIES: dict[str, Callable[[int], Optional[BatchVerifier]]] = {}


def register_cpu_factory(
    key_type: str, factory: Callable[[], BatchVerifier]
) -> None:
    _CPU_FACTORIES[key_type] = factory


def register_device_factory(
    key_type: str, factory: Callable[[int], Optional[BatchVerifier]]
) -> None:
    _DEVICE_FACTORIES[key_type] = factory


def unregister_device_factory(key_type: str) -> None:
    _DEVICE_FACTORIES.pop(key_type, None)


def device_factory_installed(key_type: str) -> bool:
    return key_type in _DEVICE_FACTORIES


def cpu_factory(key_type: str) -> Optional[Callable[[], BatchVerifier]]:
    """The registered CPU factory for a key type, or None: where
    crypto/gpu_verifier.py re-verifies a faulted device batch, with the
    same (all_ok, bitmap) contract (counterpart:
    tendermint_tpu/crypto/batch.py:63)."""
    return _CPU_FACTORIES.get(key_type)


def supports_batch_verifier(pk: Optional[PubKey]) -> bool:
    return pk is not None and pk.type() in _CPU_FACTORIES


def create_batch_verifier(pk: PubKey, size_hint: int = 0) -> BatchVerifier:
    """The batch verifier for this key type: the device one when a
    factory is installed and accepts `size_hint` (the expected number of
    add() calls), else the CPU one."""
    key_type = pk.type()
    dev = _DEVICE_FACTORIES.get(key_type)
    if dev is not None:
        verifier = dev(size_hint)
        if verifier is not None:
            return verifier
    cpu = _CPU_FACTORIES.get(key_type)
    if cpu is None:
        raise ValueError(f"key type {key_type!r} does not support batching")
    return cpu()


def _register_defaults() -> None:
    from .ed25519 import KEY_TYPE as ED, Ed25519BatchVerifier
    from .sr25519 import KEY_TYPE as SR, Sr25519BatchVerifier

    register_cpu_factory(ED, Ed25519BatchVerifier)
    register_cpu_factory(SR, Sr25519BatchVerifier)


_register_defaults()
