"""sr25519: schnorrkel Schnorr signatures over ristretto255.

Counterpart: tendermint_tpu/crypto/sr25519.py (`_basemul_encode` :54-66,
`_signing_transcript`, `_challenge`, `challenge_batch` :69-127 (its
lock-step transcripts are one C loop here, `challenge_rows`),
`_native_verify_one` :130-166, `PubKeySr25519.verify_signature` :198-252
and `verify_signature_cpu` :254-277, `_parse_signature` :280-292,
`PrivKeySr25519` :295-353, `Sr25519BatchVerifier` over the native
equation :356-424). MiniSecretKey expansion in Ed25519 mode, a merlin
transcript with an empty signing context, R || s signatures with the
schnorrkel v1 marker bit (bit 511).

The CPU plane is the JAX package's native C (tendermint_tpu_torch/
native): keygen's and signing's [k]B, every merlin challenge (the device
path's a window in one call, challenge_rows), a single verify as the
whole-batch entry at n = 1, and a batch of n >= 2 tested whole by the
random-linear-combination equation, then checked a signature at a time
when that fails: the answer is always the per-index bitmap. The pure-Python check on the host oracle (crypto/ristretto.py),
`verify_signature_oracle`, answers what the C cannot decode and is the
tests' reference. A single verify goes to the device when
crypto/gpu_verifier's sr25519-single route admits it
(`single_sr_verifier`), else to the CPU plane; the CPU batch verifier
and the device's fault checks use the host-only `verify_signature_cpu`.

The signing witness mixes in external randomness, as schnorrkel's does;
`sign` and `sign_batch` take the random source as an argument
(default os.urandom) so that a test can make its signatures from a seed.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from . import ristretto as rst
from .keys import (
    Address,
    BatchVerifier,
    PrivKey,
    PubKey,
    address_hash,
    register_key_type,
)
from .merlin import Transcript

__all__ = [
    "KEY_TYPE",
    "PrivKeySr25519",
    "PubKeySr25519",
    "Sr25519BatchVerifier",
    "challenge_batch",
    "challenge_rows",
    "sign_batch",
]

KEY_TYPE = "sr25519"
PUBKEY_SIZE = 32
PRIVKEY_SIZE = 32  # MiniSecretKey
SIGNATURE_SIZE = 64

L = rst.L

Rng = Callable[[int], bytes]

_SIGNING_PREFIX: Optional[Transcript] = None


def _prefix() -> Transcript:
    """signing_context([]) after its two constant appends, the same for
    every signature: computed once."""
    global _SIGNING_PREFIX
    if _SIGNING_PREFIX is None:
        t = Transcript(b"SigningContext")
        t.append_message(b"", b"")  # empty context
        _SIGNING_PREFIX = t
    return _SIGNING_PREFIX


def _signing_transcript(msg: bytes) -> Transcript:
    """signing_context([]).bytes(msg)."""
    t = _prefix().clone()
    t.append_message(b"sign-bytes", msg)
    return t


def _challenge(t: Transcript, pk_bytes: bytes, r_bytes: bytes) -> int:
    """The schnorrkel Fiat-Shamir challenge k: proto-name, sign:pk,
    sign:R, then a 512-bit scalar from sign:c, reduced mod L."""
    t.append_message(b"proto-name", b"Schnorr-sig")
    t.append_message(b"sign:pk", pk_bytes)
    t.append_message(b"sign:R", r_bytes)
    wide = t.challenge_bytes(b"sign:c", 64)
    return int.from_bytes(wide, "little") % L


def challenge_rows(
    pks: Sequence[bytes], msgs: Sequence[bytes], rs: Sequence[bytes]
) -> np.ndarray:
    """The challenges of a whole batch as an (n, 32) uint8 array, row i
    the little-endian scalar mod L of (pks[i], msgs[i], rs[i]), from one
    native C call (native.sr25519_challenge_batch: the lock-step
    transcripts of the JAX package's challenge_batch, a C loop here).
    pks and rs are 32 bytes each."""
    from .. import native

    return native.sr25519_challenge_batch(b"".join(pks), b"".join(rs), msgs)


def challenge_batch(
    pks: Sequence[bytes], msgs: Sequence[bytes], rs: Sequence[bytes]
) -> List[int]:
    """The challenges of a whole batch, one int mod L per (pk, msg, R)
    in input order: challenge_rows' one C call, read as integers."""
    raw = challenge_rows(pks, msgs, rs).tobytes()
    return [
        int.from_bytes(raw[i : i + 32], "little")
        for i in range(0, len(raw), 32)
    ]


def _parse_signature(sig: bytes) -> Optional[Tuple[bytes, int]]:
    """R bytes and the scalar s, or None: the schnorrkel v1 marker bit
    (sig[63] & 128) must be set and s < L."""
    if len(sig) != SIGNATURE_SIZE:
        return None
    if not sig[63] & 0x80:
        return None  # pre-v0.1.1 signature without the marker
    s_bytes = bytearray(sig[32:])
    s_bytes[31] &= 0x7F
    s = int.from_bytes(bytes(s_bytes), "little")
    if s >= L:
        return None
    return sig[:32], s


class PubKeySr25519(PubKey):
    __slots__ = ("_bytes", "_point", "_addr")

    def __init__(self, data: bytes) -> None:
        if len(data) != PUBKEY_SIZE:
            raise ValueError(f"sr25519 pubkey must be {PUBKEY_SIZE} bytes")
        self._bytes = bytes(data)
        self._point = None  # decoded lazily
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
        """Through the device's single-verify route when it admits one
        signature (crypto/gpu_verifier.single_sr_verifier), else the CPU
        plane. The device's outcome is reported to that route's breaker;
        a device fault inside the batch verifier is contained there and
        answered by the CPU factory."""
        from . import gpu_verifier

        bv = gpu_verifier.single_sr_verifier()
        if bv is None:
            return self.verify_signature_cpu(msg, sig)
        if len(sig) != SIGNATURE_SIZE:
            return False
        bv.add(self, msg, sig)
        _ok, bits = bv.verify()
        gpu_verifier.report_single(not bv.faulted)
        return bool(bits and bits[0])

    def verify_signature_cpu(self, msg: bytes, sig: bytes) -> bool:
        """The host-only verify: the C entry at n = 1, the pure-Python
        oracle for what it cannot decode. Never touches the device, so
        the device's fault checks can use it to disprove a device verdict."""
        native = _native_verify_one(self._bytes, msg, sig)
        if native is not None:
            return native
        return self.verify_signature_oracle(msg, sig)

    def verify_signature_oracle(self, msg: bytes, sig: bytes) -> bool:
        """The pure-Python check: accept iff encode([s]B - [k]A) == R's
        bytes (ristretto encoding is canonical)."""
        parsed = _parse_signature(sig)
        if parsed is None:
            return False
        r_bytes, s = parsed
        if self._point is None:
            self._point = rst.decode(self._bytes)
        A = self._point
        if A is None or rst.decode(r_bytes) is None:
            return False
        k = _challenge(_signing_transcript(msg), self._bytes, r_bytes)
        rp = rst.add(rst.mul_base(s), rst.scalar_mult((L - k) % L, A))
        return rst.encode(rp) == r_bytes


def _native_verify_one(pk_bytes: bytes, msg: bytes, sig: bytes) -> Optional[bool]:
    """One schnorrkel verify in C (the whole-batch entry at n = 1):
    parsing, the merlin challenge and [8](sB - kA - R) == identity. None
    when the C cannot decode A or R (the oracle answers those)."""
    from .. import native

    if len(sig) != SIGNATURE_SIZE:
        return False
    offs = (ctypes.c_uint64 * 2)(0, len(msg))
    rc = native.ed25519_batch_lib().tm_sr25519_verify_full(
        pk_bytes, sig, msg, offs, os.urandom(16), 1
    )
    if rc == 1:
        return True
    if rc == 0:
        return False
    return None


def _basemul_encode(k: int) -> bytes:
    """encode([k]B) in C (keygen's and signing's fixed-base multiply)."""
    from .. import native

    return native.ristretto_basemul(k.to_bytes(32, "little"))


def _scalar_divide_by_cofactor(b: bytes) -> int:
    """schnorrkel's divide_scalar_bytes_by_cofactor: the clamped
    ed25519-style scalar is stored right-shifted by 3 bits."""
    return int.from_bytes(b, "little") >> 3


class PrivKeySr25519(PrivKey):
    """MiniSecretKey, expanded in Ed25519 mode (schnorrkel's
    ExpansionMode::Ed25519, as curve25519-voi and substrate use)."""

    __slots__ = ("_mini", "_key", "_nonce", "_pub")

    def __init__(self, data: bytes) -> None:
        if len(data) != PRIVKEY_SIZE:
            raise ValueError(f"sr25519 privkey must be {PRIVKEY_SIZE} bytes")
        self._mini = bytes(data)
        h = hashlib.sha512(self._mini).digest()
        key = bytearray(h[:32])
        key[0] &= 248
        key[31] &= 63
        key[31] |= 64
        self._key = _scalar_divide_by_cofactor(bytes(key)) % L
        self._nonce = h[32:]
        self._pub = _basemul_encode(self._key)

    @classmethod
    def from_seed(cls, seed: bytes) -> "PrivKeySr25519":
        return cls(seed)

    def bytes(self) -> bytes:
        return self._mini

    def _witness(self, msg: bytes, rng: Optional[Rng]) -> Tuple[int, bytes]:
        """(r, encode(r B)): the nonce, the message and 32 random bytes
        hashed to a scalar (implementation-defined in schnorrkel too:
        verification depends only on R and s)."""
        fresh = (rng or os.urandom)(32)
        r_seed = hashlib.sha512(
            b"sr25519-witness" + self._nonce + msg + fresh
        ).digest()
        r = int.from_bytes(r_seed, "little") % L
        return r, _basemul_encode(r)

    def _finish(self, r: int, r_bytes: bytes, k: int) -> bytes:
        s_bytes = bytearray(((k * self._key + r) % L).to_bytes(32, "little"))
        s_bytes[31] |= 0x80  # schnorrkel v1 marker
        return r_bytes + bytes(s_bytes)

    def sign(self, msg: bytes, rng: Optional[Rng] = None) -> bytes:
        from .. import native

        r, r_bytes = self._witness(msg, rng)
        k = native.sr25519_challenge(self._pub, r_bytes, msg)
        return self._finish(r, r_bytes, int.from_bytes(k, "little"))

    def pub_key(self) -> PubKey:
        return PubKeySr25519(self._pub)

    def type(self) -> str:
        return KEY_TYPE


def sign_batch(
    privs: Sequence[PrivKeySr25519],
    msgs: Sequence[bytes],
    rng: Optional[Rng] = None,
) -> List[bytes]:
    """privs[i].sign(msgs[i], rng) for every i, with the same witness
    bytes drawn in the same order, but every R computed first and the
    challenges through challenge_batch: the way to sign thousands."""
    wits = [p._witness(m, rng) for p, m in zip(privs, msgs)]
    ks = challenge_batch(
        [p._pub for p in privs], msgs, [r_bytes for _r, r_bytes in wits]
    )
    return [p._finish(r, rb, k) for p, (r, rb), k in zip(privs, wits, ks)]


# the native equation wins from n = 2 on (the JAX package's choice)
_NATIVE_BATCH_MIN = 2


def _native_batch_all_valid(items) -> bool:
    """schnorrkel's batch verification in one C call: parsing, merlin
    challenges, the random-linear-combination products and the
    cofactored equation over ristretto decoding. True when every
    signature is valid; False when one is not, is malformed or is
    undecodable."""
    from .. import native
    from .ed25519 import _call_verify_full

    return _call_verify_full(
        native.ed25519_batch_lib().tm_sr25519_verify_full, items
    )


class Sr25519BatchVerifier(BatchVerifier):
    """The CPU default behind crypto.batch: for n >= 2 the batch equation
    in C, and when it fails (or for one signature) the host-only verify a
    signature, so the answer is the exact bitmap in add order. The device
    verifier (crypto/gpu_verifier.py) takes sr25519 batches once
    installed."""

    def __init__(self) -> None:
        self._items: List[Tuple[PubKeySr25519, bytes, bytes]] = []

    def add(self, pub_key: PubKey, message: bytes, signature: bytes) -> None:
        if not isinstance(pub_key, PubKeySr25519):
            raise TypeError("Sr25519BatchVerifier requires sr25519 keys")
        if len(signature) != SIGNATURE_SIZE:
            raise ValueError("malformed signature size")
        self._items.append((pub_key, bytes(message), bytes(signature)))

    def verify(self) -> Tuple[bool, List[bool]]:
        if not self._items:
            return False, []
        items, self._items = self._items, []
        if len(items) >= _NATIVE_BATCH_MIN and _native_batch_all_valid(items):
            return True, [True] * len(items)
        bitmap = [pk.verify_signature_cpu(msg, sig) for pk, msg, sig in items]
        return all(bitmap), bitmap

    def __len__(self) -> int:
        return len(self._items)


register_key_type(KEY_TYPE, PubKeySr25519, proto_field=3)
