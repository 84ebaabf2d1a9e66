"""SecretConnection: authenticated encryption for peer links.

Counterpart: tendermint_tpu/p2p/conn.py: X25519 (:71), the HKDF and key
derivation (:149-180), the auth signature (:181-193) and SecretConnection
(:195-277); reference: internal/p2p/conn/secret_connection.go.
Station-to-Station: X25519 ECDH, HKDF key derivation, a
ChaCha20-Poly1305 AEAD a direction with counter nonces, and each
identity proven by an ed25519 signature over the derived challenge.

Wire format (the JAX package's, not byte-compatible with the Go one):
  handshake: a 32-byte ephemeral X25519 pubkey each way (plaintext)
  then AEAD frames: 4-byte big-endian ciphertext length | ciphertext
  first frame each way: AuthSig{type=1, pubkey=2, sig=3} proto

The challenge hashes the ECDH secret with both ephemeral keys, so an
attacker that interposes its own ephemerals cannot replay either proof;
everything after the AuthSig frames rides the AEAD keyed by the same
transcript.

Only the pure-Python route of the JAX module (:32-59): the card's host
has no `cryptography` package, so X25519, HKDF and the AEAD are the RFC
7748, 5869 and 8439 code here and in crypto/symmetric.py. The bytes are
the same as the JAX module's OpenSSL route (tests/test_torch_p2p.py).
"""

from __future__ import annotations

import asyncio
import hashlib
import hmac as _hmac
import os
import struct
from typing import Tuple

from ..crypto.ed25519 import PubKeyEd25519  # noqa: F401  registers the key type
from ..crypto.keys import PrivKey, PubKey, pubkey_from_type_and_bytes
from ..crypto.symmetric import PureChaCha20Poly1305
from ..encoding.proto import FieldReader, ProtoWriter

__all__ = ["SecretConnection", "HandshakeError"]

MAX_FRAME = 1 << 22  # 4 MiB ciphertext cap per frame
_HKDF_INFO = b"TENDERMINT_TPU_SECRET_CONNECTION_KEY_AND_CHALLENGE_GEN"

_X25519_P = 2**255 - 19


def _x25519_scalarmult(k: bytes, u: bytes) -> bytes:
    """RFC 7748 §5 X25519 (Montgomery ladder): the JAX module's route
    without the `cryptography` package (:71)."""
    k_int = int.from_bytes(
        bytes([k[0] & 248]) + k[1:31] + bytes([(k[31] & 127) | 64]),
        "little",
    )
    x1 = int.from_bytes(u, "little") & ((1 << 255) - 1)
    x2, z2, x3, z3 = 1, 0, x1, 1
    swap = 0
    for t in reversed(range(255)):
        k_t = (k_int >> t) & 1
        if swap ^ k_t:
            x2, x3 = x3, x2
            z2, z3 = z3, z2
        swap = k_t
        a = (x2 + z2) % _X25519_P
        aa = a * a % _X25519_P
        b = (x2 - z2) % _X25519_P
        bb = b * b % _X25519_P
        e = (aa - bb) % _X25519_P
        c = (x3 + z3) % _X25519_P
        d = (x3 - z3) % _X25519_P
        da = d * a % _X25519_P
        cb = c * b % _X25519_P
        x3 = (da + cb) % _X25519_P
        x3 = x3 * x3 % _X25519_P
        z3 = (da - cb) % _X25519_P
        z3 = x1 * (z3 * z3) % _X25519_P
        x2 = aa * bb % _X25519_P
        z2 = e * ((aa + 121665 * e) % _X25519_P) % _X25519_P
    if swap:
        x2, x3 = x3, x2
        z2, z3 = z3, z2
    out = x2 * pow(z2, _X25519_P - 2, _X25519_P) % _X25519_P
    return out.to_bytes(32, "little")


class X25519PublicKey:
    """A raw X25519 public key (the `cryptography` class's surface)."""

    def __init__(self, data: bytes) -> None:
        if len(data) != 32:
            raise ValueError("x25519 pubkey must be 32 bytes")
        self._data = bytes(data)

    @classmethod
    def from_public_bytes(cls, data: bytes) -> "X25519PublicKey":
        return cls(data)

    def public_bytes(self, *_args) -> bytes:
        return self._data


class X25519PrivateKey:
    """A raw X25519 scalar; generate() draws it from os.urandom."""

    def __init__(self, k: bytes) -> None:
        self._k = k

    @classmethod
    def generate(cls) -> "X25519PrivateKey":
        return cls(os.urandom(32))

    def public_key(self) -> X25519PublicKey:
        return X25519PublicKey(
            _x25519_scalarmult(self._k, (9).to_bytes(32, "little"))
        )

    def exchange(self, peer: X25519PublicKey) -> bytes:
        out = _x25519_scalarmult(self._k, peer._data)
        if out == b"\x00" * 32:
            raise ValueError("x25519: low-order point")
        return out


class HandshakeError(Exception):
    pass


def _hkdf_sha256(ikm: bytes, length: int, info: bytes) -> bytes:
    """RFC 5869 HKDF-SHA256 with a zero salt (the JAX package's
    `cryptography` route takes salt=None, which is that salt)."""
    prk = _hmac.new(b"\x00" * 32, ikm, hashlib.sha256).digest()
    okm = b""
    t = b""
    i = 1
    while len(okm) < length:
        t = _hmac.new(prk, t + info + bytes([i]), hashlib.sha256).digest()
        okm += t
        i += 1
    return okm[:length]


def _derive(shared: bytes, local_eph: bytes, remote_eph: bytes):
    """→ (send_key, recv_key, challenge). Key order is fixed by sorting
    the ephemeral pubkeys, so both sides agree without a role bit
    (reference: secret_connection.go deriveSecrets + sort32)."""
    okm = _hkdf_sha256(
        shared + min(local_eph, remote_eph) + max(local_eph, remote_eph),
        96,
        _HKDF_INFO,
    )
    key_a, key_b, challenge = okm[:32], okm[32:64], okm[64:]
    if local_eph < remote_eph:
        return key_a, key_b, challenge
    return key_b, key_a, challenge


def _auth_sig_bytes(pub: PubKey, sig: bytes) -> bytes:
    w = ProtoWriter()
    w.string(1, pub.type())
    w.bytes(2, pub.bytes())
    w.bytes(3, sig)
    return w.finish()


def _parse_auth_sig(data: bytes) -> Tuple[PubKey, bytes]:
    r = FieldReader(data)
    pub = pubkey_from_type_and_bytes(r.string(1), r.bytes(2))
    return pub, r.bytes(3)


class SecretConnection:
    """Encrypted, authenticated framed stream over an asyncio socket."""

    def __init__(
        self,
        reader: asyncio.StreamReader,
        writer: asyncio.StreamWriter,
        send_key: bytes,
        recv_key: bytes,
        remote_pubkey: PubKey,
    ) -> None:
        self._reader = reader
        self._writer = writer
        self._send = PureChaCha20Poly1305(send_key)
        self._recv = PureChaCha20Poly1305(recv_key)
        self._send_nonce = 0
        self._recv_nonce = 0
        self.remote_pubkey = remote_pubkey
        self._write_lock = asyncio.Lock()

    # -- establishment --

    @classmethod
    async def handshake(
        cls,
        reader: asyncio.StreamReader,
        writer: asyncio.StreamWriter,
        local_priv: PrivKey,
    ) -> "SecretConnection":
        """Mutual-auth handshake; symmetric (no initiator role)."""
        eph_priv = X25519PrivateKey.generate()
        eph_pub = eph_priv.public_key().public_bytes()
        writer.write(eph_pub)
        await writer.drain()
        remote_eph = await reader.readexactly(32)
        if remote_eph == eph_pub:
            raise HandshakeError("remote echoed our ephemeral key")
        shared = eph_priv.exchange(X25519PublicKey.from_public_bytes(remote_eph))
        send_key, recv_key, challenge = _derive(shared, eph_pub, remote_eph)

        conn = cls(
            reader, writer, send_key, recv_key, remote_pubkey=None  # set below
        )
        # Exchange identity proofs over the encrypted link
        sig = local_priv.sign(challenge)
        await conn.write_frame(_auth_sig_bytes(local_priv.pub_key(), sig))
        remote_pub, remote_sig = _parse_auth_sig(await conn.read_frame())
        if not remote_pub.verify_signature(challenge, remote_sig):
            raise HandshakeError("challenge signature verification failed")
        conn.remote_pubkey = remote_pub
        return conn

    # -- framed AEAD I/O --

    def _nonce(self, counter: int) -> bytes:
        return struct.pack("<Q", counter) + b"\x00\x00\x00\x00"

    async def write_frame(self, plaintext: bytes) -> None:
        async with self._write_lock:
            ct = self._send.encrypt(
                self._nonce(self._send_nonce), plaintext, None
            )
            self._send_nonce += 1
            self._writer.write(struct.pack(">I", len(ct)) + ct)
            await self._writer.drain()

    async def read_frame(self) -> bytes:
        hdr = await self._reader.readexactly(4)
        (length,) = struct.unpack(">I", hdr)
        if length > MAX_FRAME:
            raise HandshakeError(f"frame too large: {length}")
        ct = await self._reader.readexactly(length)
        pt = self._recv.decrypt(self._nonce(self._recv_nonce), ct, None)
        self._recv_nonce += 1
        return pt

    def close(self) -> None:
        try:
            self._writer.close()
        except (OSError, RuntimeError):  # already closed, or its loop is gone
            pass
