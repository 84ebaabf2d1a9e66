"""A mempool that holds nothing, for replay and for a BlockExecutor
driven without one.

Counterpart: tendermint_tpu/mempool/nop.py:12-45 (reference:
internal/consensus/replay_stubs.go emptyMempool).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from ..abci import types as abci
from .types import Mempool, TxInfo

__all__ = ["NopMempool"]


class NopMempool(Mempool):
    async def check_tx(self, tx: bytes, tx_info: Optional[TxInfo] = None):
        return abci.ResponseCheckTx()

    def remove_tx_by_key(self, key: bytes) -> None: ...

    def reap_max_bytes_max_gas(self, max_bytes: int, max_gas: int) -> List[bytes]:
        return []

    def reap_max_txs(self, max_txs: int) -> List[bytes]:
        return []

    async def lock(self) -> None: ...

    def unlock(self) -> None: ...

    async def update(
        self,
        block_height: int,
        block_txs: Sequence[bytes],
        deliver_tx_responses: Sequence[abci.ResponseDeliverTx],
    ) -> None: ...

    async def flush_app_conn(self) -> None: ...

    def flush(self) -> None: ...

    def size(self) -> int:
        return 0

    def size_bytes(self) -> int:
        return 0
