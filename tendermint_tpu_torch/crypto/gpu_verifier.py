"""Device-backed BatchVerifier: the GPU side of the plugin boundary.

Counterpart: tendermint_tpu/crypto/tpu_verifier.py:387-720
(`_TpuBatchVerifier` add/verify, `install`, `uninstall`, `stats`).
install() registers a factory with crypto.batch so that
create_batch_verifier returns a GpuEd25519BatchVerifier for ed25519
batches of at least `min_batch` signatures; the verifier runs
ops/ed25519_kernel.Ed25519Verifier on the installed device.

Contract kept: verify() returns (all_ok, bitmap) in add order; malformed
sizes are reported False per index; full STREAM_CHUNK windows are
dispatched from add() as they fill, so host assembly overlaps device
work; stats() returns integer counters.

Left out on purpose: the circuit breaker, the gather watchdog, the
fault plane and the CPU re-verify. Here a device error raises out of
verify(); nothing re-runs the batch elsewhere.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from .batch import register_device_factory, unregister_device_factory
from .keys import BatchVerifier, PubKey

__all__ = [
    "DEFAULT_MIN_BATCH",
    "GpuEd25519BatchVerifier",
    "install",
    "installed",
    "stats",
    "uninstall",
]

DEFAULT_MIN_BATCH = 2

_STATS = {"batches": 0, "sigs": 0}
_VERIFIER = None  # the installed ops.ed25519_kernel.Ed25519Verifier
_MIN_BATCH = DEFAULT_MIN_BATCH


class GpuEd25519BatchVerifier(BatchVerifier):
    """Queues triples on the host, verifies them on the device."""

    KEY_TYPE = "ed25519"
    STREAM_CHUNK = 2048  # == a DEFAULT_BUCKET_SIZES entry

    def __init__(self, verifier) -> None:
        self._verifier = verifier
        self._pks: List[bytes] = []
        self._msgs: List[bytes] = []
        self._sigs: List[bytes] = []
        self._handles: List[tuple] = []  # dispatch handles, add order
        self._n = 0

    def _dispatch_pending(self) -> None:
        self._handles.append(
            self._verifier.dispatch(self._pks, self._msgs, self._sigs)
        )
        _STATS["batches"] += 1
        self._pks, self._msgs, self._sigs = [], [], []

    def add(self, pub_key: PubKey, message: bytes, signature: bytes) -> None:
        if pub_key.type() != self.KEY_TYPE:
            raise TypeError(
                f"{type(self).__name__} requires {self.KEY_TYPE} keys"
            )
        if len(signature) != 64:
            raise ValueError("malformed signature size")
        self._pks.append(pub_key.bytes())
        self._msgs.append(bytes(message))
        self._sigs.append(bytes(signature))
        self._n += 1
        if len(self._pks) >= self.STREAM_CHUNK:
            self._dispatch_pending()

    def verify(self) -> Tuple[bool, List[bool]]:
        """Dispatch the remainder, gather every window in add order.
        One-shot: a second call without new add()s returns (False, [])."""
        if self._n == 0:
            return False, []
        try:
            if self._pks:
                self._dispatch_pending()
            bits: List[bool] = []
            for handle in self._handles:
                bits.extend(self._verifier.gather(handle).tolist())
        finally:
            self._handles = []
            self._pks, self._msgs, self._sigs = [], [], []
            n, self._n = self._n, 0
        _STATS["sigs"] += n
        return all(bits), bits

    def __len__(self) -> int:
        return self._n


def _factory(size_hint: int) -> Optional[BatchVerifier]:
    if 0 < size_hint < _MIN_BATCH:
        return None  # a tiny batch stays on the CPU default
    return GpuEd25519BatchVerifier(_VERIFIER)


def install(
    device="cuda", min_batch: int = DEFAULT_MIN_BATCH, program: str = "tile"
) -> None:
    """Register the device factory for ed25519 on `device` (CUDA by
    default; raises when there is none). `program` is "tile" (kernel K2)
    or "hybrid" (kernel K1 inside plain torch)."""
    global _VERIFIER, _MIN_BATCH
    from ..ops.ed25519_kernel import Ed25519Verifier

    _VERIFIER = Ed25519Verifier(device=device, program=program)
    _MIN_BATCH = min_batch
    register_device_factory("ed25519", _factory)


def uninstall() -> None:
    """Remove the device factory: batches go back to the CPU default."""
    global _VERIFIER, _MIN_BATCH
    unregister_device_factory("ed25519")
    _VERIFIER = None
    _MIN_BATCH = DEFAULT_MIN_BATCH


def installed() -> Optional[int]:
    """The installed min_batch, or None when not installed."""
    return _MIN_BATCH if _VERIFIER is not None else None


def stats() -> dict:
    """Integer counters: device batches dispatched and signatures
    verified since the process started."""
    return dict(_STATS)
