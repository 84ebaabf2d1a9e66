"""RFC-6962-style SHA-256 merkle root, host only (the subset the types
need: Commit.hash and ValidatorSet.hash).

Counterpart: tendermint_tpu/crypto/merkle.py hash_from_byte_slices.
0x00/0x01 leaf/inner domain separation, split at the largest power of
two below n, empty tree = sha256(""). The device merkle kernels are a
later slice of the port.
"""

from __future__ import annotations

import hashlib
from typing import List, Sequence

__all__ = ["empty_hash", "hash_from_byte_slices", "inner_hash", "leaf_hash"]


def empty_hash() -> bytes:
    return hashlib.sha256(b"").digest()


def leaf_hash(leaf: bytes) -> bytes:
    return hashlib.sha256(b"\x00" + leaf).digest()


def inner_hash(left: bytes, right: bytes) -> bytes:
    return hashlib.sha256(b"\x01" + left + right).digest()


def _split_point(n: int) -> int:
    """Largest power of two strictly less than n (n >= 2)."""
    return 1 << ((n - 1).bit_length() - 1)


def _reduce(hashes: List[bytes]) -> bytes:
    if len(hashes) == 1:
        return hashes[0]
    k = _split_point(len(hashes))
    return inner_hash(_reduce(hashes[:k]), _reduce(hashes[k:]))


def hash_from_byte_slices(items: Sequence[bytes]) -> bytes:
    """Merkle root of the list."""
    if not items:
        return empty_hash()
    return _reduce([leaf_hash(it) for it in items])
