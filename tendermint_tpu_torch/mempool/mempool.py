"""TxMempool: the priority mempool, sharded for concurrent admission.

Counterpart: tendermint_tpu/mempool/mempool.py:57-665: the admission
shards and _ShardedCache (:57-95), check_tx (:214) and check_tx_batch
(:258), the prevalidator seam (:52, :365), priority eviction (:411),
sender dedup, reap_max_bytes_max_gas (:498) and reap_max_txs (:519),
lock/unlock across shards (:184), update (:528), _recheck (:558), the
TTL purge (:600) and the FIFO gossip cursor (:620-664); reference:
internal/mempool/mempool.go. Transactions are validated through the ABCI
mempool connection, held with their priority and sender, reaped for a
proposal in priority order and gossiped in arrival order.

Admission is split into N tx-key-hashed shards, each with its own lock,
seen-cache and tx map. CheckTx takes only its shard's lock; consensus's
lock() is a barrier that takes every shard lock in ascending order (the
order batch admission uses too, so no cycle), so Commit+Update exclude
admission as one pool-wide lock would. Reap, recheck, expiry and
eviction run on the global (-priority, seq) and seq orders, which no
shard layout changes, since seq rises across the pool.

The pool takes no metrics (MempoolMetrics waits for ROADMAP item 11),
and no decision of it reads one.
"""

from __future__ import annotations

import asyncio
import logging
import time
from bisect import bisect_right
from typing import Callable, Dict, List, Optional, Sequence, Union

from ..abci import types as abci
from ..abci.client import ABCIClient
from ..config import MempoolConfig
from .cache import LRUTxCache, NopTxCache
from .types import (
    Mempool,
    MempoolError,
    TxInfo,
    TxMempoolFullError,
    WrappedTx,
    tx_key,
)

__all__ = ["Prevalidator", "TxMempool"]

_log = logging.getLogger(__name__)

# The batch prevalidator seam: takes a batch's raw txs and returns one
# truthy or falsy verdict a tx. It runs in the default executor, so the
# event loop never blocks on it.
Prevalidator = Callable[[Sequence[bytes]], Sequence[object]]


class _Shard:
    """One admission partition: a lock, a seen-cache and its txs."""

    __slots__ = ("lock", "txs", "cache")

    def __init__(self, cache) -> None:
        self.lock = asyncio.Lock()
        self.txs: Dict[bytes, WrappedTx] = {}
        self.cache = cache


class _ShardedCache:
    """The seen-cache over the per-shard LRU caches. A tx always hashes
    to the same shard, so membership is that of one global cache; only
    the order of capacity evictions is per shard."""

    def __init__(self, pool: "TxMempool") -> None:
        self._pool = pool

    def _cache_for(self, key: bytes):
        return self._pool._shard_for_key(key).cache

    def reset(self) -> None:
        for s in self._pool._shards:
            s.cache.reset()

    def push(self, tx: bytes) -> bool:
        return self._cache_for(tx_key(tx)).push(tx)

    def remove(self, tx: bytes) -> None:
        self._cache_for(tx_key(tx)).remove(tx)

    def remove_by_key(self, key: bytes) -> None:
        self._cache_for(key).remove_by_key(key)

    def has(self, tx: bytes) -> bool:
        return self._cache_for(tx_key(tx)).has(tx)

    def __len__(self) -> int:
        return sum(len(s.cache) for s in self._pool._shards)


class TxMempool(Mempool):
    def __init__(
        self,
        app_conn: ABCIClient,
        cfg: Optional[MempoolConfig] = None,
        height: int = 0,
        prevalidator: Optional[Prevalidator] = None,
    ) -> None:
        self.cfg = cfg or MempoolConfig()
        self.logger = _log
        self._app = app_conn
        self._height = height
        n = max(1, int(self.cfg.shards))
        if self.cfg.cache_size > 0:
            # the pool-wide capacity split across the shards
            per = -(-self.cfg.cache_size // n)
            caches = [LRUTxCache(per) for _ in range(n)]
        else:
            caches = [NopTxCache() for _ in range(n)]
        self._shards: List[_Shard] = [_Shard(c) for c in caches]
        self._senders: Dict[str, bytes] = {}  # sender -> tx key (pool-wide)
        # the FIFO index: seq -> wtx in insertion order (= seq order),
        # and the same seqs as a sorted list for bisect, deleted lazily
        # and compacted when dead entries outnumber live ones
        self._fifo_live: Dict[int, WrappedTx] = {}
        self._fifo_seqs: List[int] = []
        # live txs a priority: a full pool's insert asks "is anything
        # lower to evict?" without walking the pool
        self._prio_counts: Dict[int, int] = {}
        self._bytes = 0
        self._count = 0
        self.cache = _ShardedCache(self)
        self._tx_available = asyncio.Event()
        self._prevalidator = prevalidator

    # -- shard routing --

    def _shard_for_key(self, key: bytes) -> _Shard:
        return self._shards[int.from_bytes(key[:8], "big") % len(self._shards)]

    @property
    def _txs(self) -> Dict[bytes, WrappedTx]:
        """Every shard's txs in arrival (seq) order (introspection and
        tests)."""
        return {w.key: w for w in self._fifo_live.values()}

    def _all_wtxs(self) -> List[WrappedTx]:
        return list(self._fifo_live.values())

    # -- sizes --

    def size(self) -> int:
        return self._count

    def size_bytes(self) -> int:
        return self._bytes

    def is_full(self, tx_size: int) -> bool:
        return self._count >= self.cfg.size or self._bytes + tx_size > self.cfg.max_txs_bytes

    # -- lifecycle with consensus --

    async def lock(self) -> None:
        """The barrier consensus holds across Commit+Update: every shard
        lock in ascending order (check_tx_batch's order)."""
        for s in self._shards:
            await s.lock.acquire()

    def unlock(self) -> None:
        for s in reversed(self._shards):
            s.lock.release()

    async def flush_app_conn(self) -> None:
        await self._app.flush()

    def flush(self) -> None:
        """Drop everything (RPC unsafe_flush_mempool)."""
        for s in self._shards:
            s.txs.clear()
            s.cache.reset()
        self._senders.clear()
        self._fifo_live.clear()
        self._fifo_seqs.clear()
        self._prio_counts.clear()
        self._bytes = 0
        self._count = 0

    # -- ingestion --

    async def check_tx(self, tx: bytes, tx_info: Optional[TxInfo] = None) -> abci.ResponseCheckTx:
        """Validate tx through the app and admit it (reference:
        internal/mempool/mempool.go:202-263), under its shard's lock: a
        tx is never checked against the state before a commit and
        inserted after it."""
        if len(tx) > self.cfg.max_tx_bytes:
            raise MempoolError(f"tx too large: {len(tx)} > {self.cfg.max_tx_bytes}")
        key = tx_key(tx)
        shard = self._shard_for_key(key)
        async with shard.lock:
            res = self._precheck(shard, tx, key, tx_info)
            if isinstance(res, MempoolError):
                raise res
            if self._prevalidator is not None:
                verdicts = await asyncio.get_running_loop().run_in_executor(
                    None, self._prevalidator, [tx]
                )
                if not verdicts[0]:
                    return self._prevalidate_reject(tx)
            resp = await self._app.check_tx(abci.RequestCheckTx(tx=tx))
            out = self._admit(shard, tx, key, tx_info, resp)
            if isinstance(out, MempoolError):
                raise out
            return out

    async def check_tx_batch(
        self, txs: Sequence[bytes], tx_info: Optional[TxInfo] = None
    ) -> List[Union[abci.ResponseCheckTx, MempoolError]]:
        """Admit a batch with one ABCI round: an outcome a tx (the
        ResponseCheckTx, or the MempoolError check_tx would raise) in
        input order. The shard locks involved are held in ascending
        order across the app call, as the consensus barrier takes them."""
        if not txs:
            return []
        keys = [tx_key(tx) for tx in txs]
        shard_ids = sorted({int.from_bytes(k[:8], "big") % len(self._shards) for k in keys})
        for sid in shard_ids:
            await self._shards[sid].lock.acquire()
        try:
            out: List[Union[abci.ResponseCheckTx, MempoolError]] = [None] * len(txs)
            pending: List[int] = []  # indices awaiting the app's verdict
            for i, (tx, key) in enumerate(zip(txs, keys)):
                if len(tx) > self.cfg.max_tx_bytes:
                    out[i] = MempoolError(f"tx too large: {len(tx)} > {self.cfg.max_tx_bytes}")
                    continue
                res = self._precheck(self._shard_for_key(key), tx, key, tx_info)
                if isinstance(res, MempoolError):
                    out[i] = res
                else:
                    pending.append(i)
            if pending and self._prevalidator is not None:
                verdicts = await asyncio.get_running_loop().run_in_executor(
                    None, self._prevalidator, [txs[i] for i in pending]
                )
                kept = []
                for i, ok in zip(pending, verdicts):
                    if ok:
                        kept.append(i)
                    else:
                        out[i] = self._prevalidate_reject(txs[i])
                pending = kept
            if pending:
                resps = await self._app.check_tx_batch(
                    [abci.RequestCheckTx(tx=txs[i]) for i in pending]
                )
                for i, resp in zip(pending, resps):
                    out[i] = self._admit(self._shard_for_key(keys[i]), txs[i], keys[i], tx_info, resp)
            return out
        finally:
            for sid in reversed(shard_ids):
                self._shards[sid].lock.release()

    def _precheck(self, shard: _Shard, tx: bytes, key: bytes,
                  tx_info: Optional[TxInfo]) -> Optional[MempoolError]:
        """The checks before the app (seen-cache, pool): the error
        check_tx would raise, or None."""
        tx_info = tx_info or TxInfo()
        if not shard.cache.push(tx):
            # seen before: note the peer that sent it again
            wtx = shard.txs.get(key)
            if wtx is not None and tx_info.sender_id:
                wtx.peers.add(tx_info.sender_id)
            return MempoolError("tx already exists in cache")
        if key in shard.txs:
            # in the pool but evicted from the cache: a second insert
            # would count its bytes twice and reset its gossip seq
            wtx = shard.txs[key]
            if tx_info.sender_id:
                wtx.peers.add(tx_info.sender_id)
            return MempoolError("tx already exists in the mempool")
        return None

    def _prevalidate_reject(self, tx: bytes) -> abci.ResponseCheckTx:
        if not self.cfg.keep_invalid_txs_in_cache:
            self.cache.remove(tx)
        return abci.ResponseCheckTx(code=1, log="rejected by batch prevalidator")

    def _admit(self, shard: _Shard, tx: bytes, key: bytes, tx_info: Optional[TxInfo],
               res: abci.ResponseCheckTx) -> Union[abci.ResponseCheckTx, MempoolError]:
        """After the app: sender dedup and insert, with no await between
        the verdict and the insert."""
        tx_info = tx_info or TxInfo()
        if not res.is_ok:
            if not self.cfg.keep_invalid_txs_in_cache:
                shard.cache.remove(tx)
            return res
        if res.sender and res.sender in self._senders:
            shard.cache.remove(tx)
            return MempoolError(f"rejected tx with sender {res.sender!r}: already present")
        wtx = WrappedTx(
            tx=tx,
            priority=res.priority,
            sender=res.sender,
            gas_wanted=res.gas_wanted,
            height=self._height,
            timestamp=time.monotonic(),
        )
        if tx_info.sender_id:
            wtx.peers.add(tx_info.sender_id)
        if not self._try_insert(shard, wtx):
            shard.cache.remove(tx)
            return TxMempoolFullError(self._count, self._bytes)
        return res

    def _try_insert(self, shard: _Shard, wtx: WrappedTx) -> bool:
        """Insert, evicting strictly lower-priority txs when full
        (reference: internal/mempool/mempool.go:264-312), the victims
        taken across every shard on the global (priority, -seq) order."""
        if self.is_full(wtx.size()):
            if not any(p < wtx.priority for p in self._prio_counts):
                return False
            victims = sorted(
                (w for w in self._all_wtxs() if w.priority < wtx.priority),
                key=lambda w: (w.priority, -w.seq),
            )
            freed = 0
            chosen = []
            need_bytes = self._bytes + wtx.size() - self.cfg.max_txs_bytes
            need_count = self._count + 1 - self.cfg.size
            for v in victims:
                chosen.append(v)
                freed += v.size()
                if freed >= need_bytes and len(chosen) >= need_count:
                    break
            else:
                return False  # not enough lower-priority mass to evict
            for v in chosen:
                self.logger.debug("evicting lower-priority tx %s", v.key.hex()[:16])
                self._remove(v.key, remove_from_cache=True)
        shard.txs[wtx.key] = wtx
        if wtx.sender:
            self._senders[wtx.sender] = wtx.key
        self._fifo_live[wtx.seq] = wtx
        self._fifo_seqs.append(wtx.seq)  # seq rises: the list stays sorted
        self._prio_counts[wtx.priority] = self._prio_counts.get(wtx.priority, 0) + 1
        self._bytes += wtx.size()
        self._count += 1
        self._tx_available.set()
        return True

    def _remove(self, key: bytes, remove_from_cache: bool = False) -> None:
        shard = self._shard_for_key(key)
        wtx = shard.txs.pop(key, None)
        if wtx is None:
            return
        if wtx.sender:
            self._senders.pop(wtx.sender, None)
        self._fifo_live.pop(wtx.seq, None)
        n = self._prio_counts.get(wtx.priority, 0) - 1
        if n > 0:
            self._prio_counts[wtx.priority] = n
        else:
            self._prio_counts.pop(wtx.priority, None)
        if len(self._fifo_seqs) - len(self._fifo_live) > max(64, len(self._fifo_live)):
            self._fifo_seqs = [s for s in self._fifo_seqs if s in self._fifo_live]
        self._bytes -= wtx.size()
        self._count -= 1
        if remove_from_cache:
            shard.cache.remove_by_key(key)

    def remove_tx_by_key(self, key: bytes) -> None:
        self._remove(key, remove_from_cache=True)

    def get_tx(self, key: bytes) -> Optional[bytes]:
        wtx = self._shard_for_key(key).txs.get(key)
        return wtx.tx if wtx else None

    # -- reaping (proposal construction) --

    def reap_max_bytes_max_gas(self, max_bytes: int, max_gas: int) -> List[bytes]:
        """Priority-descending reap under byte and gas budgets (reference:
        internal/mempool/mempool.go:328-366); (-priority, seq) is a total
        order, so no shard layout changes the result."""
        out: List[bytes] = []
        total_bytes = 0
        total_gas = 0
        for wtx in sorted(self._all_wtxs(), key=lambda w: (-w.priority, w.seq)):
            sz = wtx.size()
            if max_bytes > -1 and total_bytes + sz > max_bytes:
                continue
            if max_gas > -1 and total_gas + wtx.gas_wanted > max_gas:
                continue
            total_bytes += sz
            total_gas += wtx.gas_wanted
            out.append(wtx.tx)
        return out

    def reap_max_txs(self, max_txs: int) -> List[bytes]:
        n = self._count if max_txs < 0 else min(max_txs, self._count)
        ordered = sorted(self._all_wtxs(), key=lambda w: (-w.priority, w.seq))
        return [w.tx for w in ordered[:n]]

    # -- after a commit --

    async def update(self, block_height: int, block_txs: Sequence[bytes],
                     deliver_tx_responses: Sequence[abci.ResponseDeliverTx]) -> None:
        """Called by BlockExecutor._commit with the barrier held
        (reference: internal/mempool/mempool.go:380-445)."""
        self._height = block_height
        for tx, res in zip(block_txs, deliver_tx_responses):
            if res.is_ok:
                self.cache.push(tx)  # committed: never admitted again
            elif not self.cfg.keep_invalid_txs_in_cache:
                self.cache.remove(tx)
            self._remove(tx_key(tx))
        self._purge_expired(block_height)
        if self._count and self.cfg.recheck:
            await self._recheck()
        if self._count:
            self._tx_available.set()

    async def _recheck(self) -> None:
        """Check every pool tx again against the state after the commit
        (reference: internal/mempool/mempool.go:471-523), in arrival
        order, through check_tx_batch in tx_batch_size chunks."""
        wtxs = self._all_wtxs()
        chunk = max(1, int(self.cfg.tx_batch_size))
        for lo in range(0, len(wtxs), chunk):
            batch = wtxs[lo : lo + chunk]
            resps = await self._app.check_tx_batch(
                [abci.RequestCheckTx(tx=w.tx, type=abci.CheckTxType.RECHECK) for w in batch]
            )
            for wtx, res in zip(batch, resps):
                if not res.is_ok:
                    self._remove(wtx.key, remove_from_cache=not self.cfg.keep_invalid_txs_in_cache)
                    continue
                if res.priority != wtx.priority:
                    n = self._prio_counts.get(wtx.priority, 0) - 1
                    if n > 0:
                        self._prio_counts[wtx.priority] = n
                    else:
                        self._prio_counts.pop(wtx.priority, None)
                    self._prio_counts[res.priority] = self._prio_counts.get(res.priority, 0) + 1
                wtx.priority = res.priority
                wtx.gas_wanted = res.gas_wanted

    def _purge_expired(self, block_height: int) -> None:
        """TTL eviction (reference: internal/mempool/mempool.go:524-570)."""
        if not self.cfg.ttl_duration and not self.cfg.ttl_num_blocks:
            return
        now = time.monotonic()
        for shard in self._shards:
            for key in list(shard.txs.keys()):
                wtx = shard.txs[key]
                if (self.cfg.ttl_duration and now - wtx.timestamp > self.cfg.ttl_duration) or (
                    self.cfg.ttl_num_blocks and block_height - wtx.height > self.cfg.ttl_num_blocks
                ):
                    self._remove(key, remove_from_cache=True)

    # -- gossip --

    def next_gossip_tx(self, after_seq: int) -> Optional[WrappedTx]:
        """The first tx with seq > after_seq in arrival order, or None
        (a bisect of the FIFO index)."""
        i = bisect_right(self._fifo_seqs, after_seq)
        while i < len(self._fifo_seqs):
            wtx = self._fifo_live.get(self._fifo_seqs[i])
            if wtx is not None:
                return wtx
            i += 1  # a lazily deleted entry
        return None

    def next_gossip_txs(self, after_seq: int, max_txs: int, max_bytes: int) -> List[WrappedTx]:
        """Up to max_txs successors of after_seq within a byte budget:
        one gossip envelope's worth."""
        out: List[WrappedTx] = []
        total = 0
        i = bisect_right(self._fifo_seqs, after_seq)
        while i < len(self._fifo_seqs) and len(out) < max_txs:
            wtx = self._fifo_live.get(self._fifo_seqs[i])
            i += 1
            if wtx is None:
                continue
            total += len(wtx.tx)
            if out and total > max_bytes:
                break
            out.append(wtx)
        return out

    async def wait_for_tx(self, after_seq: int) -> WrappedTx:
        """Block until a tx with seq > after_seq exists (the gossip
        cursor; reference: internal/mempool/reactor.go)."""
        while True:
            wtx = self.next_gossip_tx(after_seq)
            if wtx is not None:
                return wtx
            self._tx_available.clear()
            await self._tx_available.wait()

    def tx_available(self) -> asyncio.Event:
        return self._tx_available
