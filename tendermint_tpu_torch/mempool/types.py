"""The Mempool interface.

Counterpart: tendermint_tpu/mempool/types.py: tx_key (:17), MempoolError
(:22), TxMempoolFullError (:26), TxInfo (:34), WrappedTx (:45-67) and
Mempool (:70-109); reference: internal/mempool/types.go:30-77,
internal/mempool/tx.go.
"""

from __future__ import annotations

import hashlib
import itertools
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

__all__ = ["Mempool", "MempoolError", "TxInfo", "TxMempoolFullError", "WrappedTx", "tx_key"]


def tx_key(tx: bytes) -> bytes:
    """SHA-256 key identifying a tx (reference: types/tx.go Tx.Key)."""
    return hashlib.sha256(tx).digest()


class MempoolError(Exception):
    pass


class TxMempoolFullError(MempoolError):
    def __init__(self, num_txs: int, total_bytes: int) -> None:
        super().__init__(f"mempool is full: {num_txs} txs, {total_bytes} bytes")


@dataclass(frozen=True)
class TxInfo:
    """Who sent us the tx (reference: internal/mempool/types.go:96-104)."""

    sender_id: int = 0
    sender_node_id: str = ""


_seq = itertools.count(1)


@dataclass
class WrappedTx:
    """A pool-resident tx with its CheckTx verdict attached
    (reference: internal/mempool/tx.go:27-77)."""

    tx: bytes
    priority: int = 0
    sender: str = ""
    gas_wanted: int = 0
    height: int = 0  # the height at which it entered the pool
    timestamp: float = 0.0
    peers: set = field(default_factory=set)  # the peers that sent it
    seq: int = 0  # arrival order: the gossip cursor's and the reap's tie-break

    def __post_init__(self) -> None:
        if self.seq == 0:
            self.seq = next(_seq)

    @property
    def key(self) -> bytes:
        return tx_key(self.tx)

    def size(self) -> int:
        return len(self.tx)


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
