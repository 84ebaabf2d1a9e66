"""ed25519 keys with ZIP-215 verification semantics.

Counterpart: tendermint_tpu/crypto/ed25519.py (PubKeyEd25519,
PrivKeyEd25519, and the CPU batch verifier registered as the default).
Keygen and signing are RFC 8032 with the fixed-base multiplies A = aB
and R = rB in the native C plane (native.ed25519_basemul), where the
JAX package signs through OpenSSL (:143-145); the hashes and the scalar
arithmetic stay in Python. The pure-Python ed25519_math.mul_base_ct is
the tests' oracle for it, never a fallback. Verification is the JAX
package's native plane (:173-340) over the port's copy of its C
(tendermint_tpu_torch/native): a single verify is the batch equation at
n = 1 with weight 1, [8](sB - kA - R) == identity, exactly the
cofactored ZIP-215 check (`_native_verify_one_zip215`); a batch of n >= 2
is first tested whole by the random-linear-combination equation
(`_native_batch_all_valid`) and, when that fails, checked a signature at
a time, so the answer is always the per-index bitmap. An encoding the C
cannot decode (rc -1) is answered by the pure-Python ZIP-215 oracle
(ed25519_math.zip215_verify), as in the JAX package (:215-220): a route
the data chooses, not a caught failure. The oracle also stays the
tests' reference. A native library that fails to build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
from typing import List, Optional, Tuple

from . import ed25519_math
from .keys import (
    Address,
    BatchVerifier,
    PrivKey,
    PubKey,
    address_hash,
    register_key_type,
)

__all__ = [
    "KEY_TYPE",
    "Ed25519BatchVerifier",
    "PrivKeyEd25519",
    "PubKeyEd25519",
]

KEY_TYPE = "ed25519"
PUBKEY_SIZE = 32
PRIVKEY_SIZE = 64  # seed || pubkey, the Go ed25519 layout
SIGNATURE_SIZE = 64


class PubKeyEd25519(PubKey):
    __slots__ = ("_bytes", "_addr")

    def __init__(self, data: bytes) -> None:
        if len(data) != PUBKEY_SIZE:
            raise ValueError(f"ed25519 pubkey must be {PUBKEY_SIZE} bytes")
        self._bytes = bytes(data)
        self._addr: Optional[bytes] = None

    def address(self) -> Address:
        if self._addr is None:
            self._addr = address_hash(self._bytes)
        return self._addr

    def bytes(self) -> bytes:
        return self._bytes

    def type(self) -> str:
        return KEY_TYPE

    def verify_signature(self, msg: bytes, sig: bytes) -> bool:
        if len(sig) != SIGNATURE_SIZE:
            return False
        native = _native_verify_one_zip215(self._bytes, msg, sig)
        if native is not None:
            return native
        return ed25519_math.zip215_verify(self._bytes, msg, sig)


def _expand_seed(seed: bytes) -> Tuple[int, bytes]:
    """RFC 8032 5.1.5: SHA-512(seed) -> (clamped scalar, prefix)."""
    h = hashlib.sha512(seed).digest()
    a = int.from_bytes(h[:32], "little")
    a &= (1 << 254) - 8
    a |= 1 << 254
    return a, h[32:]


class PrivKeyEd25519(PrivKey):
    __slots__ = ("_seed", "_pub")

    def __init__(self, data: bytes) -> None:
        if len(data) == PRIVKEY_SIZE:
            seed = data[:32]
        elif len(data) == 32:
            seed = data
        else:
            raise ValueError("ed25519 privkey must be 32 or 64 bytes")
        self._seed = bytes(seed)
        a, _prefix = _expand_seed(self._seed)
        self._pub = _basemul(a)

    @classmethod
    def generate(cls) -> "PrivKeyEd25519":
        return cls(os.urandom(32))

    @classmethod
    def from_seed(cls, seed: bytes) -> "PrivKeyEd25519":
        return cls(seed)

    def bytes(self) -> bytes:
        return self._seed + self._pub

    def sign(self, msg: bytes) -> bytes:
        """RFC 8032 5.1.6, deterministic."""
        a, prefix = _expand_seed(self._seed)
        r = (
            int.from_bytes(hashlib.sha512(prefix + msg).digest(), "little")
            % ed25519_math.L
        )
        R = _basemul(r)
        k = ed25519_math.sha512_mod_l(R, self._pub, msg)
        s = (r + k * a) % ed25519_math.L
        return R + s.to_bytes(32, "little")

    def pub_key(self) -> PubKey:
        return PubKeyEd25519(self._pub)

    def type(self) -> str:
        return KEY_TYPE


# the native equation wins from n = 2 on (the JAX package's measured
# crossover, and the reference's batchVerifyThreshold)
_NATIVE_BATCH_MIN = 2


def _lib():
    from .. import native

    return native.ed25519_batch_lib()


def _basemul(scalar: int) -> bytes:
    """The encoding of scalar B, in C."""
    from .. import native

    return native.ed25519_basemul(scalar.to_bytes(32, "little"))


def _native_verify_one_zip215(
    pk_bytes: bytes, msg: bytes, sig: bytes
) -> Optional[bool]:
    """One ZIP-215 verify in C: the batch equation at n = 1 with weight
    1. None when the C cannot decode A or R (the oracle answers those)."""
    s = int.from_bytes(sig[32:], "little")
    if s >= ed25519_math.L:
        return False
    r = sig[:32]
    k = ed25519_math.sha512_mod_l(r, pk_bytes, msg)
    rc = _lib().tm_ed25519_batch_verify(
        pk_bytes,
        r,
        s.to_bytes(32, "little"),
        k.to_bytes(32, "little"),
        (1).to_bytes(32, "little"),
        1,
    )
    if rc == 1:
        return True
    if rc == 0:
        return False
    return None


def _call_verify_full(fn, items) -> bool:
    """Whether one tm_*_verify_full call accepts every (pk, msg, sig):
    keys and signatures concatenated, the messages as one blob with n + 1
    offsets, 128-bit random weights from os.urandom. Shared by the
    ed25519 and sr25519 batch verifiers."""
    n = len(items)
    offs = (ctypes.c_uint64 * (n + 1))()
    pos = 0
    for i, (_pk, msg, _sig) in enumerate(items):
        offs[i] = pos
        pos += len(msg)
    offs[n] = pos
    rc = fn(
        b"".join(pk.bytes() for pk, _m, _s in items),
        b"".join(sig for _pk, _m, sig in items),
        b"".join(msg for _pk, msg, _s in items),
        offs,
        os.urandom(16 * n),
        n,
    )
    return rc == 1


def _native_batch_all_valid(items) -> bool:
    """The cofactored random-linear-combination equation over the whole
    batch in one C call (challenges included): True when every signature
    is valid; False when at least one is not, or one is undecodable."""
    return _call_verify_full(_lib().tm_ed25519_verify_full, items)


class Ed25519BatchVerifier(BatchVerifier):
    """The CPU default: for n >= 2 the batch equation in C, and when it
    fails (or for one signature) a verify a signature, so the answer is
    the exact bitmap in add order. The device verifier
    (crypto/gpu_verifier.py) takes batches once installed."""

    def __init__(self) -> None:
        self._items: List[Tuple[PubKeyEd25519, bytes, bytes]] = []

    def add(self, pub_key: PubKey, message: bytes, signature: bytes) -> None:
        if not isinstance(pub_key, PubKeyEd25519):
            raise TypeError("Ed25519BatchVerifier requires ed25519 keys")
        if len(signature) != SIGNATURE_SIZE:
            raise ValueError("malformed signature size")
        self._items.append((pub_key, bytes(message), bytes(signature)))

    def verify(self) -> Tuple[bool, List[bool]]:
        """One-shot: a second call without new add()s returns
        (False, [])."""
        if not self._items:
            return False, []
        items, self._items = self._items, []
        if len(items) >= _NATIVE_BATCH_MIN and _native_batch_all_valid(items):
            return True, [True] * len(items)
        bitmap = [pk.verify_signature(msg, sig) for pk, msg, sig in items]
        return all(bitmap), bitmap

    def __len__(self) -> int:
        return len(self._items)


register_key_type(KEY_TYPE, PubKeyEd25519, proto_field=1)
