"""Batch-verifier dispatch: the offload decision point.

Counterpart: tendermint_tpu/crypto/batch.py:43-170, `drain_and_cache`
:172-201 and the defaults :220-232 (ed25519, sr25519 and secp256k1; secp256k1 has a CPU
factory only, as in the JAX package), with the group-affinity seam :77-145 and `native_cpu_affinity`
:204. A device factory registered here (crypto/gpu_verifier.install)
serves a key type's batches once the caller's size hint is large enough;
until then, and for key types without one, the registered CPU factory
does, as in the reference, where pure Go is the default.

The group affinity is how many independent commits' signatures a caller
with several at hand (the light client's sequential window) merges into
one batch verifier: 1 verifies each commit alone. gpu_verifier.install
sets it for its device (32 on CUDA, 1 for the plain versions on the
CPU); uninstall puts back the lazy default, native_cpu_affinity; an
operator's set_group_affinity wins over both.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

from .keys import BatchVerifier, PubKey

__all__ = [
    "cpu_factory",
    "create_batch_verifier",
    "device_factory_installed",
    "drain_and_cache",
    "group_affinity",
    "group_affinity_state",
    "native_cpu_affinity",
    "register_cpu_factory",
    "register_device_factory",
    "restore_group_affinity",
    "set_group_affinity",
    "set_group_affinity_fn",
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


# The affinity, or None while a deferred function (set_group_affinity_fn)
# has not been asked yet; whether an operator pinned it. One lock guards
# the triple: group_affinity()'s lazy resolution is a check-then-act.
_GROUP_AFFINITY: Optional[int] = 1
_GROUP_AFFINITY_FN: Optional[Callable[[], int]] = None
_GROUP_AFFINITY_EXPLICIT = False
_affinity_lock = threading.Lock()


def set_group_affinity(n: int) -> None:
    """An operator's value: wins over any install's default
    (set_group_affinity_fn does not replace it)."""
    global _GROUP_AFFINITY, _GROUP_AFFINITY_FN, _GROUP_AFFINITY_EXPLICIT
    with _affinity_lock:
        _GROUP_AFFINITY = max(1, int(n))
        _GROUP_AFFINITY_FN = None
        _GROUP_AFFINITY_EXPLICIT = True


def set_group_affinity_fn(fn: Callable[[], int]) -> None:
    """Decide the affinity with fn() at its first use; a no-op when an
    operator pinned a value."""
    global _GROUP_AFFINITY, _GROUP_AFFINITY_FN
    with _affinity_lock:
        if _GROUP_AFFINITY_EXPLICIT:
            return
        _GROUP_AFFINITY = None
        _GROUP_AFFINITY_FN = fn


def group_affinity() -> int:
    global _GROUP_AFFINITY
    while True:
        with _affinity_lock:
            value = _GROUP_AFFINITY
            fn = _GROUP_AFFINITY_FN
        if value is not None:
            return value
        # fn runs outside the lock: it may build the native plane
        computed = max(1, int(fn())) if fn is not None else 1
        with _affinity_lock:
            if _GROUP_AFFINITY is not None:
                return _GROUP_AFFINITY
            if _GROUP_AFFINITY_FN is fn:
                _GROUP_AFFINITY = computed
                return computed
            # another fn was set while this one ran: resolve that one


def group_affinity_state() -> tuple:
    """A snapshot for restore_group_affinity. Restoring a value through
    set_group_affinity instead would pin it as an operator's and disable
    every later install's default."""
    with _affinity_lock:
        return (_GROUP_AFFINITY, _GROUP_AFFINITY_FN, _GROUP_AFFINITY_EXPLICIT)


def restore_group_affinity(state: tuple) -> None:
    global _GROUP_AFFINITY, _GROUP_AFFINITY_FN, _GROUP_AFFINITY_EXPLICIT
    with _affinity_lock:
        _GROUP_AFFINITY, _GROUP_AFFINITY_FN, _GROUP_AFFINITY_EXPLICIT = state


def native_cpu_affinity() -> int:
    """The merged-window size when the native C plane serves batches: 32.
    Its batch equation is exact-size (no bucket padding) and cheaper a
    signature the larger the batch, so a merged window wins on the CPU
    too. The plane is built here on first use; a build failure raises,
    as the verifiers' first use does."""
    from .. import native

    native.ed25519_batch_lib()
    return 32


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


def drain_and_cache(verifier: BatchVerifier, cache_keys) -> tuple:
    """verifier.verify(), then every triple whose bit is True recorded
    in the verified-signature cache (crypto.sigcache): what a batch
    proves here, no later stage proves again. cache_keys align with the
    add() order; None entries are skipped. Returns verify()'s
    (all_ok, bitmap) unchanged.

    A batch the device faulted under (`faulted`, set by
    crypto/gpu_verifier.py's fault policy) caches nothing, though its
    CPU re-verify answered right: nothing learned while a device
    misbehaved outlives the batch."""
    from . import sigcache

    ok, bits = verifier.verify()
    if getattr(verifier, "faulted", False):
        return ok, bits
    if ok:
        sigcache.add_keys_bulk([key for key in cache_keys if key is not None])
    else:
        sigcache.add_keys_bulk(
            [key for key, bit in zip(cache_keys, bits) if bit and key is not None]
        )
    return ok, bits


def _register_defaults() -> None:
    from .ed25519 import KEY_TYPE as ED, Ed25519BatchVerifier
    from .sr25519 import KEY_TYPE as SR, Sr25519BatchVerifier

    from .secp256k1 import KEY_TYPE as SECP, Secp256k1BatchVerifier

    register_cpu_factory(ED, Ed25519BatchVerifier)
    register_cpu_factory(SR, Sr25519BatchVerifier)
    register_cpu_factory(SECP, Secp256k1BatchVerifier)


_register_defaults()
set_group_affinity_fn(native_cpu_affinity)
