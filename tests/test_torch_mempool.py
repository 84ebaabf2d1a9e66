"""The port's transaction pool held against the JAX package's.

Both packages' TxMempool run the same seeded action sequences on the
same app (an OracleApp of each package: a tx's bytes choose its verdict,
priority and sender, and some txs fail only on recheck), and after every
action their outcomes (each ResponseCheckTx's code and log, or the
error's type and message) and every order a caller can see are
compared: size and bytes, the reaps by bytes, by gas and by count, the
gossip cursor's walk and its windows, the senders, the seen-cache, and
the app's CheckTx calls (the recheck's sequence). Covered:
tests/test_mempool.py's and tests/test_mempool_sharded.py's cases as
sequences: admission, duplicates, a full pool's priority eviction,
sender dedup, reaps, update with committed and failed txs, recheck, the
TTL purge by blocks and by duration (the monotonic clock pinned in both
modules), batch admission, the prevalidator seam, the gossip cursor, the
consensus barrier, and the seen-cache alone. Tolerance: zero.

The JAX pool takes metrics on a private registry; the port's takes none
(ROADMAP §3), and no outcome differs for it.
"""

import asyncio
from types import SimpleNamespace

import numpy as np
import pytest

from tendermint_tpu.abci import types as jax_abci
from tendermint_tpu.abci.client import LocalClient as JaxLocalClient
from tendermint_tpu.abci.kvstore import KVStoreApplication as JaxKVStore
from tendermint_tpu.config import MempoolConfig as JaxMempoolConfig
from tendermint_tpu.libs.metrics import Registry
from tendermint_tpu.mempool import cache as jax_cache
from tendermint_tpu.mempool import mempool as jax_mempool
from tendermint_tpu.mempool import types as jax_types
from tendermint_tpu.mempool.metrics import MempoolMetrics
from tendermint_tpu_torch.abci import types as port_abci
from tendermint_tpu_torch.abci.client import LocalClient as PortLocalClient
from tendermint_tpu_torch.abci.kvstore import KVStoreApplication as PortKVStore
from tendermint_tpu_torch.config import MempoolConfig as PortMempoolConfig
from tendermint_tpu_torch.mempool import cache as port_cache
from tendermint_tpu_torch.mempool import mempool as port_mempool
from tendermint_tpu_torch.mempool import types as port_types


def run(coro):
    return asyncio.run(coro)


def oracle_app(base, abci):
    """An app of one package whose CheckTx verdict comes from the tx:
    `s<sender>|p<prio>:...` ok with that sender and priority,
    `p<prio>:...` ok, `bad...` code 1, `...@drop...` code 1 on recheck
    only; gas_wanted is the tx's length mod 3 + 1. Records every call."""

    class OracleApp(base):
        def __init__(self):
            super().__init__()
            self.calls = []

        def check_tx(self, req):
            tx = req.tx
            self.calls.append((tx, req.type))
            if tx.startswith(b"bad"):
                return abci.ResponseCheckTx(code=1, log="rejected")
            if req.type == abci.CheckTxType.RECHECK and b"@drop" in tx:
                return abci.ResponseCheckTx(code=1, log="recheck-rejected")
            sender, body = "", tx
            if tx.startswith(b"s") and b"|" in tx:
                s, _, body = tx.partition(b"|")
                sender = s[1:].decode()
            prio = 0
            if body.startswith(b"p") and b":" in body:
                prio = int(body[1 : body.index(b":")])
            return abci.ResponseCheckTx(gas_wanted=len(tx) % 3 + 1, priority=prio, sender=sender)

    return OracleApp()


class Pair:
    """The two packages' pools on their own OracleApp, one config, and
    each module's clock pinned to `self.now`."""

    def __init__(self, prevalidator=None, **cfg):
        self.now = 1000.0
        clock = SimpleNamespace(monotonic=lambda: self.now)
        self.jax_app = oracle_app(JaxKVStore, jax_abci)
        self.port_app = oracle_app(PortKVStore, port_abci)
        self.jax = jax_mempool.TxMempool(
            JaxLocalClient(self.jax_app), JaxMempoolConfig(**cfg),
            metrics=MempoolMetrics(Registry()), prevalidator=prevalidator,
        )
        self.port = port_mempool.TxMempool(
            PortLocalClient(self.port_app), PortMempoolConfig(**cfg), prevalidator=prevalidator,
        )
        self._clock = clock

    def __enter__(self):
        self._saved = (jax_mempool.time, port_mempool.time)
        jax_mempool.time = port_mempool.time = SimpleNamespace(
            monotonic=self._clock.monotonic, perf_counter=self._saved[0].perf_counter
        )
        return self

    def __exit__(self, *exc):
        jax_mempool.time, port_mempool.time = self._saved

    async def both(self, call):
        """call(pool, package) on each pool: the outcomes, compared."""
        got = []
        for pool, abci in ((self.jax, jax_abci), (self.port, port_abci)):
            try:
                got.append(outcome(await call(pool, abci)))
            except Exception as e:  # compared: the JAX package's error is the expected one
                got.append(("raised", type(e).__name__, str(e)))
        assert got[0] == got[1]
        return got[0]


def outcome(res):
    if res is None:
        return None
    if isinstance(res, list):
        return [outcome(r) for r in res]
    if isinstance(res, Exception):
        return ("error", type(res).__name__, str(res))
    return ("code", res.code, res.log, res.priority, res.sender, res.gas_wanted)


def fifo_walk(pool):
    out, cur = [], -1
    while (w := pool.next_gossip_tx(cur)) is not None:
        out.append(w.tx)
        cur = w.seq
    return out


def windows(pool, n, budget):
    out, cur = [], -1
    while win := pool.next_gossip_txs(cur, n, budget):
        out.append([w.tx for w in win])
        cur = win[-1].seq
    return out


def fingerprint(pool, app):
    return {
        "size": pool.size(),
        "bytes": pool.size_bytes(),
        "reap_all": pool.reap_max_bytes_max_gas(-1, -1),
        "reap_bytes": pool.reap_max_bytes_max_gas(40, -1),
        "reap_gas": pool.reap_max_bytes_max_gas(-1, 5),
        "reap_both": pool.reap_max_bytes_max_gas(60, 7),
        "reap_top3": pool.reap_max_txs(3),
        "reap_none": pool.reap_max_txs(0),
        "fifo": fifo_walk(pool),
        "windows": windows(pool, 3, 30),
        "senders": dict(pool._senders),
        "cached": sorted(k for s in pool._shards for k in getattr(s.cache, "_map", {})),
        "cache_len": len(pool.cache),
        "peers": {w.tx: sorted(w.peers) for w in pool._txs.values()},
        "heights": {w.tx: w.height for w in pool._txs.values()},
        "app_calls": list(app.calls),
        "full": pool.is_full(1),
    }


def _tx(rng, i: int) -> bytes:
    prio = int(rng.integers(0, 6))
    r = rng.random()
    if r < 0.08:
        return b"bad%d" % i
    if r < 0.3:
        return b"s%d|p%d:tx%d" % (rng.integers(0, 10), prio, i)
    if r < 0.45:
        return b"p%d:@drop-tx%d" % (prio, i)
    return b"p%d:tx%d-" % (prio, i) + b"x" * int(rng.integers(0, 12))


async def _sequence(pair: Pair, seed: int, steps: int) -> int:
    """A seeded sequence of admissions (single and batched, with
    resubmissions, peers and oversized txs), commits (update with ok and
    failed DeliverTx results), clock steps and flushes, on both pools;
    the fingerprints compared after each step. Returns the admitted
    count."""
    rng = np.random.default_rng(seed)
    issued, height, admitted = [], 0, 0
    for step in range(steps):
        op = rng.random()
        if op < 0.45 or not issued:
            tx = issued[int(rng.integers(0, len(issued)))] if issued and rng.random() < 0.2 else _tx(rng, step)
            if rng.random() < 0.03:
                tx = b"p1:" + b"z" * 300  # over max_tx_bytes
            issued.append(tx)
            sender = int(rng.integers(0, 4))
            got = await pair.both(lambda p, a: p.check_tx(tx, (jax_types if p is pair.jax else port_types).TxInfo(sender_id=sender)))
            admitted += got is not None and got[0] == "code" and got[1] == 0
        elif op < 0.7:
            batch = [issued[int(rng.integers(0, len(issued)))] if rng.random() < 0.25 else _tx(rng, 10_000 + step * 16 + j)
                     for j in range(int(rng.integers(0, 9)))]
            issued += batch
            sender = int(rng.integers(0, 4))
            await pair.both(lambda p, a: p.check_tx_batch(batch, (jax_types if p is pair.jax else port_types).TxInfo(sender_id=sender)))
        elif op < 0.9:
            height += 1
            committed = pair.jax.reap_max_txs(int(rng.integers(0, 6)))
            # a tx the pool never saw may be committed too (another node's)
            if rng.random() < 0.3:
                committed.append(_tx(rng, 20_000 + step))
            codes = [0 if rng.random() < 0.8 else 1 for _ in committed]
            await pair.both(lambda p, a: p.update(height, committed, [a.ResponseDeliverTx(code=c) for c in codes]))
        elif op < 0.98:
            pair.now += float(rng.choice([0.5, 3.0, 11.0]))
        else:
            for p in (pair.jax, pair.port):
                p.flush()
        assert fingerprint(pair.jax, pair.jax_app) == fingerprint(pair.port, pair.port_app), step
    return admitted


CONFIGS = {
    "sharded-full-ttl-blocks": dict(size=12, max_txs_bytes=12 * 40, ttl_num_blocks=3, max_tx_bytes=200),
    "one-shard-ttl-duration": dict(size=16, shards=1, ttl_duration=10.0, max_tx_bytes=200),
    "no-cache-keep-invalid": dict(size=10, cache_size=0, keep_invalid_txs_in_cache=True, max_tx_bytes=200),
    "small-cache-no-recheck": dict(size=20, cache_size=6, recheck=False, tx_batch_size=3, max_tx_bytes=200),
    "byte-bound": dict(size=100, max_txs_bytes=150, max_tx_bytes=200),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("seed", [1, 2])
def test_action_sequences_equal_jax(name, seed):
    """300 seeded actions a case on both pools: every outcome and every
    observable order equal after each one."""

    async def go():
        with Pair(**CONFIGS[name]) as pair:
            admitted = await _sequence(pair, seed * 1000 + len(name), 300)
        assert admitted > 5

    run(go())


def test_prevalidator_seam_equal_jax():
    """The batch prevalidator sees the txs that pass the pre-checks, in
    order; its refusals are code 1 with the JAX log, never reach the app,
    and leave the cache (tests/test_mempool_sharded.py's case)."""
    seen = {}

    def prevalidate(txs):
        seen.setdefault("calls", []).append(list(txs))
        return [b"deny" not in t for t in txs]

    async def go():
        with Pair(prevalidator=prevalidate) as pair:
            batch = [b"p1:ok1", b"p1:deny-a", b"p1:ok1", b"p2:ok2"]
            got = await pair.both(lambda p, a: p.check_tx_batch(batch))
            assert [g[1] if g[0] == "code" else g[1] for g in got] == [0, 1, "MempoolError", 0]
            assert got[1][2] == "rejected by batch prevalidator"
            await pair.both(lambda p, a: p.check_tx(b"p1:ok1"))
            await pair.both(lambda p, a: p.check_tx(b"p3:deny-b"))
            assert fingerprint(pair.jax, pair.jax_app) == fingerprint(pair.port, pair.port_app)
            assert all(b"deny" not in t for t, _ in pair.port_app.calls)

    run(go())
    # each package called it the same way: twice for the batch, twice serially
    calls = seen["calls"]
    assert calls[0] == calls[1] == [b"p1:ok1", b"p1:deny-a", b"p2:ok2"]


def test_full_pool_eviction_and_sender_dedup_equal_jax():
    """A full pool evicts strictly lower priorities (the lowest, newest
    first) across shards, refuses a tx nothing lower can make room for
    with the JAX TxMempoolFullError message, and refuses a second tx of
    a sender in the pool."""

    async def go():
        with Pair(size=4) as pair:
            for tx in (b"p1:a", b"p2:b", b"p1:c", b"s7|p3:d"):
                await pair.both(lambda p, a: p.check_tx(tx))
            got = await pair.both(lambda p, a: p.check_tx(b"p1:e"))
            assert got[0] == "raised" and got[2] == "mempool is full: 4 txs, 19 bytes"
            got = await pair.both(lambda p, a: p.check_tx(b"p5:f"))
            assert got[1] == 0
            assert pair.port.reap_max_txs(-1) == [b"p5:f", b"s7|p3:d", b"p2:b", b"p1:a"]
            got = await pair.both(lambda p, a: p.check_tx(b"s7|p9:g"))
            assert got[2] == "rejected tx with sender '7': already present"
            assert fingerprint(pair.jax, pair.jax_app) == fingerprint(pair.port, pair.port_app)

    run(go())


def test_update_rechecks_in_arrival_order_equal_jax():
    """update removes the committed txs (a failed one leaves the cache),
    then rechecks the rest in arrival order in tx_batch_size chunks; the
    @drop txs leave the pool."""

    async def go():
        with Pair(tx_batch_size=2) as pair:
            txs = [b"p%d:t%d" % (i % 4, i) for i in range(5)] + [b"p9:@drop-1", b"p0:t9"]
            await pair.both(lambda p, a: p.check_tx_batch(txs))
            committed = [txs[1], txs[3]]
            await pair.both(lambda p, a: p.update(1, committed, [a.ResponseDeliverTx(code=0), a.ResponseDeliverTx(code=1)]))
            assert fingerprint(pair.jax, pair.jax_app) == fingerprint(pair.port, pair.port_app)
            rechecked = [t for t, kind in pair.port_app.calls if kind == port_abci.CheckTxType.RECHECK]
            assert rechecked == [txs[0], txs[2], txs[4], b"p9:@drop-1", b"p0:t9"]
            assert b"p9:@drop-1" not in pair.port.reap_max_txs(-1)
            # the committed-ok tx stays cached, the failed one does not
            assert pair.port.cache.has(txs[1]) and not pair.port.cache.has(txs[3])

    run(go())


def test_barrier_excludes_admission_in_both():
    """lock() holds every shard: an admission waits until unlock(), in
    both packages."""

    async def go():
        for pool in (Pair().jax, Pair().port):
            await pool.lock()
            task = asyncio.ensure_future(pool.check_tx(b"p1:waits"))
            for _ in range(5):
                await asyncio.sleep(0)
            assert not task.done() and pool.size() == 0
            pool.unlock()
            res = await asyncio.wait_for(task, 5)
            assert res.is_ok and pool.size() == 1

    run(go())


def test_wait_for_tx_wakes_on_admission_in_both():
    async def go():
        for pool in (Pair().jax, Pair().port):
            waiter = asyncio.ensure_future(pool.wait_for_tx(-1))
            await asyncio.sleep(0)
            assert not waiter.done()
            await pool.check_tx(b"p2:wake")
            wtx = await asyncio.wait_for(waiter, 5)
            assert wtx.tx == b"p2:wake"

    run(go())


@pytest.mark.parametrize("size", [1, 3, 8])
def test_lru_cache_equal_jax(size):
    """The seen-cache alone: seeded pushes, removes and lookups."""
    rng = np.random.default_rng(size)
    jc, pc = jax_cache.LRUTxCache(size), port_cache.LRUTxCache(size)
    for _ in range(400):
        tx = b"t%d" % rng.integers(0, 12)
        op = rng.random()
        if op < 0.6:
            assert jc.push(tx) == pc.push(tx)
        elif op < 0.8:
            jc.remove(tx)
            pc.remove(tx)
        elif op < 0.9:
            jc.remove_by_key(jax_types.tx_key(tx))
            pc.remove_by_key(port_types.tx_key(tx))
        assert jc.has(tx) == pc.has(tx) and len(jc) == len(pc)
        assert list(jc._map) == list(pc._map)
    nj, np_ = jax_cache.NopTxCache(), port_cache.NopTxCache()
    assert (nj.push(b"x"), nj.has(b"x"), len(nj)) == (np_.push(b"x"), np_.has(b"x"), len(np_))


def test_types_equal_jax():
    assert str(jax_types.TxMempoolFullError(3, 99)) == str(port_types.TxMempoolFullError(3, 99))
    assert issubclass(port_types.TxMempoolFullError, port_types.MempoolError)
    assert port_types.tx_key(b"abc") == jax_types.tx_key(b"abc")
    w = port_types.WrappedTx(tx=b"abc", priority=2)
    assert (w.key, w.size(), w.seq > 0) == (jax_types.tx_key(b"abc"), 3, True)
    assert port_types.WrappedTx(tx=b"d").seq > w.seq
