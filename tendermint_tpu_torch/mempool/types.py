"""The Mempool interface.

Counterpart: tendermint_tpu/mempool/types.py: tx_key (:17), MempoolError
(:22), TxInfo (:34) and Mempool (:70-109); reference:
internal/mempool/types.go:30-77. WrappedTx and the full-pool error belong
to the transaction pool, which is not ported yet.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import List, Optional, Sequence

__all__ = ["Mempool", "MempoolError", "TxInfo", "tx_key"]


def tx_key(tx: bytes) -> bytes:
    """SHA-256 key identifying a tx (reference: types/tx.go Tx.Key)."""
    return hashlib.sha256(tx).digest()


class MempoolError(Exception):
    pass


@dataclass(frozen=True)
class TxInfo:
    """Who sent us the tx (reference: internal/mempool/types.go:96-104)."""

    sender_id: int = 0
    sender_node_id: str = ""


class Mempool:
    """reference: internal/mempool/types.go:30-77."""

    async def check_tx(self, tx: bytes, tx_info: Optional[TxInfo] = None):
        raise NotImplementedError

    def remove_tx_by_key(self, key: bytes) -> None:
        raise NotImplementedError

    def reap_max_bytes_max_gas(self, max_bytes: int, max_gas: int) -> List[bytes]:
        raise NotImplementedError

    def reap_max_txs(self, max_txs: int) -> List[bytes]:
        raise NotImplementedError

    async def lock(self) -> None:
        raise NotImplementedError

    def unlock(self) -> None:
        raise NotImplementedError

    async def update(
        self,
        block_height: int,
        block_txs: Sequence[bytes],
        deliver_tx_responses: Sequence,
    ) -> None:
        raise NotImplementedError

    async def flush_app_conn(self) -> None:
        raise NotImplementedError

    def flush(self) -> None:
        raise NotImplementedError

    def size(self) -> int:
        raise NotImplementedError

    def size_bytes(self) -> int:
        raise NotImplementedError
