"""The mempool interface a BlockExecutor reaps from, and the no-op pool
(counterpart: tendermint_tpu/mempool/). The transaction pool itself, its
cache and reactor are not ported yet."""

from .nop import NopMempool  # noqa: F401
from .types import Mempool, MempoolError, TxInfo, tx_key  # noqa: F401
