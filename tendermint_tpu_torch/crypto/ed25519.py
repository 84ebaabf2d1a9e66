"""ed25519 keys with ZIP-215 verification semantics.

Counterpart: tendermint_tpu/crypto/ed25519.py (PubKeyEd25519,
PrivKeyEd25519, and the CPU batch verifier registered as the default).
Only the pure-Python RFC 8032 path is kept (:143-155): keygen and
signing on ed25519_math's comb tables, verification by the host ZIP-215
oracle. No OpenSSL and no native library: the same bits on the wire,
slower.
"""

from __future__ import annotations

import hashlib
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
        self._pub = ed25519_math.compress(ed25519_math.mul_base_ct(a))

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
        R = ed25519_math.compress(ed25519_math.mul_base_ct(r))
        k = ed25519_math.sha512_mod_l(R, self._pub, msg)
        s = (r + k * a) % ed25519_math.L
        return R + s.to_bytes(32, "little")

    def pub_key(self) -> PubKey:
        return PubKeyEd25519(self._pub)

    def type(self) -> str:
        return KEY_TYPE


class Ed25519BatchVerifier(BatchVerifier):
    """The CPU default: one host-oracle verify per signature, the exact
    bitmap in add order. The device verifier (crypto/gpu_verifier.py)
    takes batches once installed."""

    def __init__(self) -> None:
        self._items: List[Tuple[PubKeyEd25519, bytes, bytes]] = []

    def add(self, pub_key: PubKey, message: bytes, signature: bytes) -> None:
        if not isinstance(pub_key, PubKeyEd25519):
            raise TypeError("Ed25519BatchVerifier requires ed25519 keys")
        if len(signature) != SIGNATURE_SIZE:
            raise ValueError("malformed signature size")
        self._items.append((pub_key, bytes(message), bytes(signature)))

    def verify(self) -> Tuple[bool, List[bool]]:
        if not self._items:
            return False, []
        items, self._items = self._items, []
        bitmap = [pk.verify_signature(msg, sig) for pk, msg, sig in items]
        return all(bitmap), bitmap

    def __len__(self) -> int:
        return len(self._items)


register_key_type(KEY_TYPE, PubKeyEd25519, proto_field=1)
