"""SHA-256 hashing helpers: full 32-byte digests and the 20-byte
truncated form used for addresses.

Counterpart: tendermint_tpu/crypto/tmhash.py.
"""

from __future__ import annotations

import hashlib

__all__ = ["SIZE", "TRUNCATED_SIZE", "sum256", "sum_truncated"]

SIZE = 32
TRUNCATED_SIZE = 20


def sum256(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


def sum_truncated(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()[:TRUNCATED_SIZE]
