"""The mempool: the transaction pool, its seen-cache and its gossip
reactor, and the no-op pool a replay runs with (counterpart:
tendermint_tpu/mempool/), with its metrics (mempool/metrics.py)."""

from .cache import LRUTxCache, NopTxCache  # noqa: F401
from .mempool import TxMempool  # noqa: F401
from .nop import NopMempool  # noqa: F401
from .types import Mempool, MempoolError, TxInfo, TxMempoolFullError, WrappedTx, tx_key  # noqa: F401
