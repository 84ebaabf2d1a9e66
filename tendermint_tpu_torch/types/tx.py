"""Transactions and their merkle root.

Counterpart: tendermint_tpu/types/tx.py:16-35. Reference: types/tx.go
(Tx.Hash :24 = sha256, Txs.Hash :34 = merkle root of the tx hashes,
Txs.Proof), types/tx.go:60-90. With ops.merkle_kernel installed, the root
of a block of at least `min_leaves` transactions is computed on the card
(kernel X4), and a batch of their proofs verified there (kernel X5).
"""

from __future__ import annotations

from typing import List, Sequence

from ..crypto import merkle, tmhash

__all__ = ["tx_hash", "txs_hash", "tx_key", "txs_proofs"]


def tx_hash(tx: bytes) -> bytes:
    return tmhash.sum256(tx)


def tx_key(tx: bytes) -> bytes:
    """Index key for mempool/indexer maps (reference: types/tx.go TxKey)."""
    return tx_hash(tx)


def txs_hash(txs: Sequence[bytes]) -> bytes:
    """Merkle root over per-tx hashes (leaves are TxIDs)."""
    return merkle.hash_from_byte_slices([tx_hash(tx) for tx in txs])


def txs_proofs(txs: Sequence[bytes]) -> List[merkle.Proof]:
    """Merkle proof for each tx against txs_hash."""
    _, proofs = merkle.proofs_from_byte_slices(
        [tx_hash(tx) for tx in txs]
    )
    return proofs
