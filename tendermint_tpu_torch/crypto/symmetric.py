"""Symmetric encryption: the ChaCha20 block, HChaCha20, Poly1305, the
RFC 8439 ChaCha20-Poly1305 AEAD, XChaCha20-Poly1305, and the
secretbox-style encrypt_symmetric / decrypt_symmetric.

Counterpart: tendermint_tpu/crypto/symmetric.py (the ChaCha permutation
:49-78, chacha20_block :81, hchacha20 :93, Poly1305 :119,
PureChaCha20Poly1305 :139, XChaCha20Poly1305 :175, encrypt_symmetric and
decrypt_symmetric :210-227); reference: crypto/xchacha20poly1305/
xchachapoly.go, crypto/xsalsa20symmetric/symmetric.go. The secretbox
helpers are built on XChaCha20-Poly1305, as the JAX package's are (one
cipher family for the stack).

Pure Python only. The JAX module uses the `cryptography` package's
AEAD when it can import it (:16-19); the card's host has no such
package, so the port has only the RFC 8439 route, and the CPU tests hold
its bytes against the JAX module's OpenSSL route and the RFC vectors.
"""

from __future__ import annotations

import hmac as _hmac
import os
import struct

__all__ = [
    "KEY_SIZE",
    "NONCE_SIZE",
    "PureChaCha20Poly1305",
    "XChaCha20Poly1305",
    "encrypt_symmetric",
    "decrypt_symmetric",
    "hchacha20",
]

KEY_SIZE = 32
NONCE_SIZE = 24  # XChaCha20 nonce


def _rotl32(x: int, n: int) -> int:
    return ((x << n) | (x >> (32 - n))) & 0xFFFFFFFF


def _quarter(st, a, b, c, d) -> None:
    st[a] = (st[a] + st[b]) & 0xFFFFFFFF
    st[d] = _rotl32(st[d] ^ st[a], 16)
    st[c] = (st[c] + st[d]) & 0xFFFFFFFF
    st[b] = _rotl32(st[b] ^ st[c], 12)
    st[a] = (st[a] + st[b]) & 0xFFFFFFFF
    st[d] = _rotl32(st[d] ^ st[a], 8)
    st[c] = (st[c] + st[d]) & 0xFFFFFFFF
    st[b] = _rotl32(st[b] ^ st[c], 7)


_SIGMA = struct.unpack("<4I", b"expand 32-byte k")


def _chacha_rounds(state: list) -> list:
    st = list(state)
    for _ in range(10):  # 20 rounds: 10 column+diagonal double-rounds
        _quarter(st, 0, 4, 8, 12)
        _quarter(st, 1, 5, 9, 13)
        _quarter(st, 2, 6, 10, 14)
        _quarter(st, 3, 7, 11, 15)
        _quarter(st, 0, 5, 10, 15)
        _quarter(st, 1, 6, 11, 12)
        _quarter(st, 2, 7, 8, 13)
        _quarter(st, 3, 4, 9, 14)
    return st


def chacha20_block(key: bytes, counter: int, nonce12: bytes) -> bytes:
    """One RFC 8439 ChaCha20 block: the keystream of the AEAD, and its
    one-time Poly1305 key at counter 0."""
    state = list(_SIGMA)
    state += list(struct.unpack("<8I", key))
    state.append(counter & 0xFFFFFFFF)
    state += list(struct.unpack("<3I", nonce12))
    working = _chacha_rounds(state)
    out = [(w + s) & 0xFFFFFFFF for w, s in zip(working, state)]
    return struct.pack("<16I", *out)


def hchacha20(key: bytes, nonce16: bytes) -> bytes:
    """HChaCha20 subkey derivation (draft-irtf-cfrg-xchacha §2.2):
    the ChaCha permutation without the final feed-forward addition;
    the subkey is words 0-3 and 12-15."""
    if len(key) != KEY_SIZE:
        raise ValueError("hchacha20 key must be 32 bytes")
    if len(nonce16) != 16:
        raise ValueError("hchacha20 input must be 16 bytes")
    state = list(_SIGMA)
    state += list(struct.unpack("<8I", key))
    state += list(struct.unpack("<4I", nonce16))
    st = _chacha_rounds(state)
    return struct.pack("<4I", *st[0:4]) + struct.pack("<4I", *st[12:16])


def _chacha20_xor(key: bytes, counter: int, nonce12: bytes, data: bytes) -> bytes:
    out = bytearray(len(data))
    for i in range(0, len(data), 64):
        block = chacha20_block(key, counter + i // 64, nonce12)
        chunk = data[i : i + 64]
        out[i : i + len(chunk)] = bytes(
            a ^ b for a, b in zip(chunk, block)
        )
    return bytes(out)


def _poly1305(key32: bytes, msg: bytes) -> bytes:
    """RFC 8439 §2.5 one-time authenticator."""
    r = (
        int.from_bytes(key32[:16], "little")
        & 0x0FFFFFFC0FFFFFFC0FFFFFFC0FFFFFFF
    )
    s = int.from_bytes(key32[16:32], "little")
    p = (1 << 130) - 5
    acc = 0
    for i in range(0, len(msg), 16):
        acc = (
            (acc + int.from_bytes(msg[i : i + 16] + b"\x01", "little")) * r
        ) % p
    return ((acc + s) & ((1 << 128) - 1)).to_bytes(16, "little")


def _pad16(b: bytes) -> bytes:
    return b"\x00" * ((16 - len(b) % 16) % 16)


class PureChaCha20Poly1305:
    """RFC 8439 §2.8 AEAD on the module's own ChaCha permutation, with
    the construct/encrypt/decrypt surface of the `cryptography` class."""

    def __init__(self, key: bytes) -> None:
        if len(key) != KEY_SIZE:
            raise ValueError("key must be 32 bytes")
        self._key = bytes(key)

    def _mac_data(self, aad: bytes, ct: bytes) -> bytes:
        return (
            aad + _pad16(aad) + ct + _pad16(ct)
            + len(aad).to_bytes(8, "little")
            + len(ct).to_bytes(8, "little")
        )

    def encrypt(self, nonce12: bytes, data: bytes, aad=None) -> bytes:
        aad = aad or b""
        otk = chacha20_block(self._key, 0, nonce12)[:32]
        ct = _chacha20_xor(self._key, 1, nonce12, data)
        return ct + _poly1305(otk, self._mac_data(aad, ct))

    def decrypt(self, nonce12: bytes, data: bytes, aad=None) -> bytes:
        aad = aad or b""
        if len(data) < 16:
            raise ValueError("ciphertext too short")
        ct, tag = data[:-16], data[-16:]
        otk = chacha20_block(self._key, 0, nonce12)[:32]
        if not _hmac.compare_digest(
            tag, _poly1305(otk, self._mac_data(aad, ct))
        ):
            raise ValueError("authentication failed")
        return _chacha20_xor(self._key, 1, nonce12, ct)


class XChaCha20Poly1305:
    """AEAD with a 24-byte nonce (reference:
    crypto/xchacha20poly1305/xchachapoly.go): derive a subkey with
    HChaCha20 over the first 16 nonce bytes, then run standard
    ChaCha20-Poly1305 with nonce 0x00000000 || nonce[16:24]."""

    def __init__(self, key: bytes) -> None:
        if len(key) != KEY_SIZE:
            raise ValueError("key must be 32 bytes")
        self._key = key

    def _inner(self, nonce: bytes) -> tuple:
        if len(nonce) != NONCE_SIZE:
            raise ValueError("nonce must be 24 bytes")
        subkey = hchacha20(self._key, nonce[:16])
        return PureChaCha20Poly1305(subkey), b"\x00\x00\x00\x00" + nonce[16:]

    def encrypt(
        self, nonce: bytes, plaintext: bytes, aad: bytes | None = None
    ) -> bytes:
        aead, n12 = self._inner(nonce)
        return aead.encrypt(n12, plaintext, aad)

    def decrypt(
        self, nonce: bytes, ciphertext: bytes, aad: bytes | None = None
    ) -> bytes:
        aead, n12 = self._inner(nonce)
        return aead.decrypt(n12, ciphertext, aad)


def encrypt_symmetric(plaintext: bytes, secret: bytes) -> bytes:
    """Seal with a fresh random 24-byte nonce; output nonce || box
    (reference shape: crypto/xsalsa20symmetric/symmetric.go:19-27)."""
    if len(secret) != KEY_SIZE:
        raise ValueError("secret must be 32 bytes")
    nonce = os.urandom(NONCE_SIZE)
    return nonce + XChaCha20Poly1305(secret).encrypt(nonce, plaintext)


def decrypt_symmetric(ciphertext: bytes, secret: bytes) -> bytes:
    """Inverse of encrypt_symmetric; raises on tampering or wrong key
    (reference: symmetric.go:30-46)."""
    if len(secret) != KEY_SIZE:
        raise ValueError("secret must be 32 bytes")
    if len(ciphertext) < NONCE_SIZE + 16:
        raise ValueError("ciphertext too short")
    nonce, box = ciphertext[:NONCE_SIZE], ciphertext[NONCE_SIZE:]
    return XChaCha20Poly1305(secret).decrypt(nonce, box)
