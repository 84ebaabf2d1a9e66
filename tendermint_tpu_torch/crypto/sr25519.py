"""sr25519: schnorrkel Schnorr signatures over ristretto255.

Counterpart: tendermint_tpu/crypto/sr25519.py (`_signing_transcript`,
`_challenge`, `challenge_batch` :69-127, `PubKeySr25519.verify_signature`
:254-277 without its native branch, `_parse_signature` :280-297,
`PrivKeySr25519` keygen :300-311 and sign :325-347,
`Sr25519BatchVerifier`). MiniSecretKey expansion in Ed25519 mode, a
merlin transcript with an empty signing context, R || s signatures with
the schnorrkel v1 marker bit (bit 511).

Everything here is pure Python on the host oracle (crypto/ristretto.py),
a few ms per signature: it is the CPU default behind crypto.batch and
the reference the device verifier (ops/sr25519_kernel.py) is held
against. The JAX package's single-verify device route and its native
batch equation are not ported.

The signing witness mixes in external randomness, as schnorrkel's does;
`sign` and `sign_batch` take the random source as an argument
(default os.urandom) so that a test can make its signatures from a seed.
"""

from __future__ import annotations

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
from .merlin import Transcript, TranscriptBatch

__all__ = [
    "KEY_TYPE",
    "PrivKeySr25519",
    "PubKeySr25519",
    "Sr25519BatchVerifier",
    "challenge_batch",
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


def challenge_batch(
    pks: Sequence[bytes], msgs: Sequence[bytes], rs: Sequence[bytes]
) -> List[int]:
    """The challenges of a whole batch, one int mod L per (pk, msg, R)
    in input order: one TranscriptBatch per message-length group, so
    each permutation is one keccak_f over the group. pks and rs are 32
    bytes each."""
    out: List[int] = [0] * len(msgs)
    groups: dict = {}
    for i, m in enumerate(msgs):
        groups.setdefault(len(m), []).append(i)
    for mlen, idxs in groups.items():
        g = len(idxs)

        def rows(items, width):
            return np.frombuffer(b"".join(items), dtype=np.uint8).reshape(
                g, width
            )

        tb = TranscriptBatch(_prefix(), g)
        tb.append_messages(b"sign-bytes", rows([msgs[i] for i in idxs], mlen))
        tb.append_message_const(b"proto-name", b"Schnorr-sig")
        tb.append_messages(b"sign:pk", rows([pks[i] for i in idxs], 32))
        tb.append_messages(b"sign:R", rows([rs[i] for i in idxs], 32))
        wides = tb.challenge_bytes(b"sign:c", 64)
        for row, i in enumerate(idxs):
            out[i] = int.from_bytes(wides[row].tobytes(), "little") % L
    return out


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
        """The host oracle: accept iff encode([s]B - [k]A) == R's bytes
        (ristretto encoding is canonical)."""
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
        self._pub = rst.encode(rst.mul_base_ct(self._key))

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
        return r, rst.encode(rst.mul_base_ct(r))

    def _finish(self, r: int, r_bytes: bytes, k: int) -> bytes:
        s_bytes = bytearray(((k * self._key + r) % L).to_bytes(32, "little"))
        s_bytes[31] |= 0x80  # schnorrkel v1 marker
        return r_bytes + bytes(s_bytes)

    def sign(self, msg: bytes, rng: Optional[Rng] = None) -> bytes:
        r, r_bytes = self._witness(msg, rng)
        k = _challenge(_signing_transcript(msg), self._pub, r_bytes)
        return self._finish(r, r_bytes, k)

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


class Sr25519BatchVerifier(BatchVerifier):
    """The CPU default behind crypto.batch: one host-oracle verify per
    signature, the exact bitmap in add order. The device verifier
    (crypto/gpu_verifier.py) takes sr25519 batches once installed."""

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
        bitmap = [pk.verify_signature(msg, sig) for pk, msg, sig in items]
        return all(bitmap), bitmap

    def __len__(self) -> int:
        return len(self._items)


register_key_type(KEY_TYPE, PubKeySr25519, proto_field=3)
