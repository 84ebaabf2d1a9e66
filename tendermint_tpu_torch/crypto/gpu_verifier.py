"""Device-backed BatchVerifiers: the GPU side of the plugin boundary.

Counterpart: tendermint_tpu/crypto/tpu_verifier.py:387-720
(`_TpuBatchVerifier` add/verify and its ed25519 and sr25519 subclasses,
`stats`), :791-801 (`_factory_sr`) and :894-950 (`install`,
`uninstall`). install() registers a factory per key type with
crypto.batch, so that create_batch_verifier returns a
GpuEd25519BatchVerifier for ed25519 batches of at least `min_batch`
signatures and a GpuSr25519BatchVerifier for every sr25519 batch; they
run ops/ed25519_kernel.Ed25519Verifier and ops/sr25519_kernel.
Sr25519Verifier on the installed device.

sr25519's minimum batch is 1, as the JAX package's is on an
accelerator: the port's CPU sr25519 verifier is pure Python at several
ms per signature, so even one signature is cheaper on the card.

Contract kept: verify() returns (all_ok, bitmap) in add order; malformed
sizes are reported False per index; full STREAM_CHUNK windows are
dispatched from add() as they fill, so host assembly overlaps device
work; stats() returns integer counters.

Left out on purpose: the circuit breaker, the gather watchdog, the
fault plane, the CPU re-verify and the sr25519 single-verify route.
Here a device error raises out of verify(); nothing re-runs the batch
elsewhere.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from .batch import register_device_factory, unregister_device_factory
from .keys import BatchVerifier, PubKey

__all__ = [
    "DEFAULT_MIN_BATCH",
    "GpuEd25519BatchVerifier",
    "GpuSr25519BatchVerifier",
    "install",
    "installed",
    "stats",
    "uninstall",
]

DEFAULT_MIN_BATCH = 2
KEY_TYPES = ("ed25519", "sr25519")

# windows dispatched and signatures verified, in all and per key type
_STATS = {
    f"{count}{suffix}": 0
    for count in ("batches", "sigs")
    for suffix in ("", *(f"_{kt}" for kt in KEY_TYPES))
}
# the installed ops verifiers by key type (Ed25519Verifier, Sr25519Verifier)
_VERIFIERS: dict = {}
_MIN_BATCH = DEFAULT_MIN_BATCH


class _GpuBatchVerifier(BatchVerifier):
    """Queues triples on the host, verifies them on the device in
    STREAM_CHUNK windows, each one dispatch of the ops verifier."""

    KEY_TYPE = ""  # subclasses set
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
        _STATS[f"batches_{self.KEY_TYPE}"] += 1
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
        _STATS[f"sigs_{self.KEY_TYPE}"] += n
        return all(bits), bits

    def __len__(self) -> int:
        return self._n


class GpuEd25519BatchVerifier(_GpuBatchVerifier):
    """ed25519 on the device: kernels X1 and K2 (or K1, hybrid)."""

    KEY_TYPE = "ed25519"


class GpuSr25519BatchVerifier(_GpuBatchVerifier):
    """sr25519 on the device: merlin challenges on the host, then kernel
    X3 (or K1, hybrid)."""

    KEY_TYPE = "sr25519"


def _factory(size_hint: int) -> Optional[BatchVerifier]:
    if 0 < size_hint < _MIN_BATCH:
        return None  # a tiny batch stays on the CPU default
    return GpuEd25519BatchVerifier(_VERIFIERS["ed25519"])


def _factory_sr(size_hint: int) -> Optional[BatchVerifier]:
    # minimum batch 1: the CPU default is pure Python (module docstring)
    return GpuSr25519BatchVerifier(_VERIFIERS["sr25519"])


def install(
    device="cuda", min_batch: int = DEFAULT_MIN_BATCH, program: str = "tile"
) -> None:
    """Register the device factories for ed25519 and sr25519 on `device`
    (CUDA by default; raises when there is none). `program` is "tile"
    (kernels K2 and X3) or "hybrid" (kernel K1 inside plain torch, for
    both key types). `min_batch` gates ed25519 only."""
    global _MIN_BATCH
    from ..ops.ed25519_kernel import Ed25519Verifier
    from ..ops.sr25519_kernel import Sr25519Verifier

    verifiers = {
        "ed25519": Ed25519Verifier(device=device, program=program),
        "sr25519": Sr25519Verifier(device=device, program=program),
    }
    _VERIFIERS.clear()
    _VERIFIERS.update(verifiers)
    _MIN_BATCH = min_batch
    register_device_factory("ed25519", _factory)
    register_device_factory("sr25519", _factory_sr)


def uninstall() -> None:
    """Remove the device factories: batches go back to the CPU default."""
    global _MIN_BATCH
    for key_type in KEY_TYPES:
        unregister_device_factory(key_type)
    _VERIFIERS.clear()
    _MIN_BATCH = DEFAULT_MIN_BATCH


def installed() -> Optional[int]:
    """The installed ed25519 min_batch, or None when not installed."""
    return _MIN_BATCH if _VERIFIERS else None


def stats() -> dict:
    """Integer counters since the process started: device windows
    dispatched ("batches") and signatures verified ("sigs"), in all and
    per key type ("batches_sr25519", "sigs_ed25519", ...)."""
    return dict(_STATS)
