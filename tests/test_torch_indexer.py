"""The port's tx indexer, its KV and SQL sinks, the key migration and the
ResponseDeliverTx codec, against the JAX package's, on the CPU.

The same TxResults (built in both packages from the same fields, the
shapes of tests/test_indexer.py) go into each package's KVSink and
SQLSink (sqlite3 in memory): every query's results, block searches,
`get_tx_by_hash` and `has_block` must be equal, with NUL bytes in values
and after a replay. IndexerService indexes what the port's EventBus
publishes. migrate_db moves a store of legacy keys to the same keys and
values as the JAX migrate_db. Tolerance: zero.
"""

import asyncio
import struct

import numpy as np
import pytest

from tendermint_tpu.abci import codec as jax_codec
from tendermint_tpu.abci import types as jax_abci
from tendermint_tpu.state import indexer as jax_indexer
from tendermint_tpu.state import sink_sql as jax_sink_sql
from tendermint_tpu.store import keymigrate as jax_keymigrate
from tendermint_tpu.store.kv import MemKV as JaxMemKV
from tendermint_tpu_torch.abci import codec
from tendermint_tpu_torch.abci import types as abci
from tendermint_tpu_torch.eventbus import EventBus
from tendermint_tpu_torch.state import indexer
from tendermint_tpu_torch.state import sink_sql
from tendermint_tpu_torch.store import keymigrate
from tendermint_tpu_torch.store.kv import MemKV
from tendermint_tpu_torch.types import events as E
from tendermint_tpu_torch.types.tx import tx_hash

from .test_torch_isolation import jax_device_plane_paused  # noqa: F401 (autouse)

CHAIN = "torch-indexer-chain"


def _results(pkg_abci, pkg_indexer, rows):
    """TxResults of one package from (height, index, tx, key, indexed,
    code) rows."""
    out = []
    for height, index, tx, key, indexed, code in rows:
        out.append(pkg_indexer.TxResult(
            height=height, index=index, tx=tx,
            result=pkg_abci.ResponseDeliverTx(
                code=code, data=b"d" + tx[:3], log="log-%d" % index, gas_wanted=index,
                events=(
                    pkg_abci.Event(type="app", attributes=(
                        pkg_abci.EventAttribute(b"key", key, indexed),
                        pkg_abci.EventAttribute(b"noindex", b"x", False),
                    )),
                    pkg_abci.Event(type="transfer", attributes=(
                        pkg_abci.EventAttribute(b"amount", b"%d" % (10 * index + height), True),
                    )),
                ),
            ),
        ))
    return out


ROWS = [
    (1, 0, b"tx-a", b"apple", True, 0),
    (1, 1, b"tx-b", b"banana", True, 0),
    (2, 0, b"tx-c", b"apple", True, 1),
    (3, 0, b"tx-d", b"apricot", True, 0),
    (3, 1, b"tx-nul", b"a\x00b", True, 0),
    (3, 2, b"tx-plain", b"a", True, 0),
    (4, 0, b"tx-hidden", b"apple", False, 0),
    (5, 3, b"tx-a", b"again", True, 0),  # the same tx bytes at a later height
]

QUERIES = [
    "app.key = 'apple'",
    "app.key = 'a'",
    "app.key CONTAINS 'a'",
    "app.key CONTAINS 'ap'",
    "app.key EXISTS",
    "app.noindex = 'x'",
    "tx.height = 3",
    "tx.height >= 2",
    "tx.height < 3 AND app.key = 'apple'",
    "transfer.amount > 12",
    "transfer.amount <= 20 AND tx.height > 1",
    f"tx.hash = '{tx_hash(b'tx-b').hex().upper()}'",
    "app.key = 'zzz'",
]

BLOCK_EVENTS = [
    (5, [("val_update", b"pubkey", b"aa")]),
    (6, []),
    (7, [("epoch", b"phase", b"end"), ("epoch", b"phase", b"start")]),
]

BLOCK_QUERIES = [
    "val_update.pubkey = 'aa'",
    "block.height > 5",
    "block.height >= 5 AND epoch.phase = 'end'",
    "epoch.phase EXISTS",
    "epoch.phase = 'none'",
]


def _block_events(pkg_abci, evs):
    return [pkg_abci.Event(type=t, attributes=(pkg_abci.EventAttribute(k, v, True),)) for t, k, v in evs]


def _sinks():
    port = {"kv": indexer.KVSink(MemKV()), "sql": sink_sql.SQLSink("sqlite::memory:", CHAIN)}
    jax = {"kv": jax_indexer.KVSink(JaxMemKV()), "sql": jax_sink_sql.SQLSink("sqlite::memory:", CHAIN)}
    return port, jax


def _fill(sinks, pkg_abci, pkg_indexer, replay: bool):
    for s in sinks.values():
        trs = _results(pkg_abci, pkg_indexer, ROWS)
        s.index_tx_events(trs)
        for height, evs in BLOCK_EVENTS:
            s.index_block_events(height, _block_events(pkg_abci, evs))
        if replay:  # a crash-restart replays what it had indexed
            s.index_tx_events(trs[2:5])


def _view(sink):
    """Everything a sink answers, as bytes and ints."""
    return {
        "tx": {q: [t.to_proto() for t in sink.search_tx_events(q)] for q in QUERIES},
        "block": {q: sink.search_block_events(q) for q in BLOCK_QUERIES},
        "by_hash": [
            (r[2], None if (t := sink.get_tx_by_hash(tx_hash(r[2]))) is None else t.to_proto())
            for r in ROWS + [(0, 0, b"absent", b"", True, 0)]
        ],
        "has_block": [sink.has_block(h) for h in range(1, 9)],
    }


@pytest.mark.parametrize("kind", ["kv", "sql"])
@pytest.mark.parametrize("replay", [False, True])
def test_sinks_answer_as_the_jax_sinks(kind, replay):
    port, jax = _sinks()
    _fill(port, abci, indexer, replay)
    _fill(jax, jax_abci, jax_indexer, replay)
    got, want = _view(port[kind]), _view(jax[kind])
    assert got == want
    assert port[kind].type() == jax[kind].type()
    # the NUL byte does not split a value, and nothing unindexed is found
    assert [t.tx for t in port[kind].search_tx_events("app.key = 'a'")] == [b"tx-plain"]
    assert port[kind].search_tx_events("app.noindex = 'x'") == []
    for s in (port["sql"], jax["sql"]):
        s.close()


def test_sql_sink_schema_rows_equal_jax():
    port, jax = _sinks()
    _fill(port, abci, indexer, False)
    _fill(jax, jax_abci, jax_indexer, False)
    sql = ("SELECT b.height, e.type, e.tx_id, a.key, a.composite_key, a.value "
           "FROM attributes a JOIN events e ON e.rowid = a.event_id "
           "JOIN blocks b ON b.rowid = e.block_id ORDER BY a.rowid")
    assert port["sql"]._exec(sql).fetchall() == jax["sql"]._exec(sql).fetchall()
    rows = "SELECT block_id, \"index\", tx_hash, tx_result FROM tx_results ORDER BY rowid"
    assert port["sql"]._exec(rows).fetchall() == jax["sql"]._exec(rows).fetchall()
    with pytest.raises(ValueError) as port_err:
        sink_sql.SQLSink("mysql://x")
    with pytest.raises(ValueError) as jax_err:
        jax_sink_sql.SQLSink("mysql://x")
    assert str(port_err.value) == str(jax_err.value)
    with pytest.raises(ValueError, match="sqlite"):
        sink_sql.SQLSink("postgres://db")


def test_null_sink_is_empty():
    s = indexer.NullSink()
    s.index_tx_events(_results(abci, indexer, ROWS))
    s.index_block_events(1, [])
    assert (s.type(), s.search_tx_events("tx.height = 1"), s.search_block_events("block.height = 1"),
            s.get_tx_by_hash(b"x"), s.has_block(1)) == ("null", [], [], None, False)


def test_deliver_tx_codec_and_tx_result_bytes_equal_jax():
    for pr, jr in zip(_results(abci, indexer, ROWS), _results(jax_abci, jax_indexer, ROWS)):
        raw = codec.enc_resp_deliver_tx(pr.result)
        assert raw == jax_codec._enc_resp_deliver_tx(jr.result)
        assert codec.dec_resp_deliver_tx(raw) == pr.result
        assert pr.to_proto() == jr.to_proto()
        assert indexer.TxResult.from_proto(jr.to_proto()) == pr


def test_indexer_service_end_to_end_on_the_event_bus():
    """NewBlock and Tx events published on the port's bus reach both
    sinks through IndexerService; a sink that raises is logged and does
    not end indexing."""

    class Broken(indexer.NullSink):
        def index_tx_events(self, results):
            raise RuntimeError("sink down")

    async def go():
        bus = EventBus()
        await bus.start()
        kv, sql = indexer.KVSink(MemKV()), sink_sql.SQLSink("sqlite::memory:", CHAIN)
        svc = indexer.IndexerService([kv, sql, Broken()], bus)
        await svc.start()
        header = type("H", (), {"height": 3})()
        bus.publish_new_block(E.EventDataNewBlock(
            block=type("B", (), {"header": header})(), block_id=None,
            result_end_block=abci.ResponseEndBlock(events=tuple(
                _block_events(abci, [("end", b"done", b"yes")])
            )),
        ))
        trs = _results(abci, indexer, ROWS[:4])
        for tr in trs:
            bus.publish_tx(E.EventDataTx(height=tr.height, tx=tr.tx, index=tr.index, result=tr.result),
                           tx_hash=tx_hash(tr.tx))
        for _ in range(200):
            if sql.has_block(3) and all(s.get_tx_by_hash(tx_hash(b"tx-d")) for s in (kv, sql)):
                break
            await asyncio.sleep(0.01)
        await svc.stop()
        await bus.stop()
        return kv, sql, trs

    kv, sql, trs = asyncio.run(asyncio.wait_for(go(), 30.0))
    for s in (kv, sql):
        assert s.search_block_events("end.done = 'yes'") == [3]
        assert [t.to_proto() for t in s.search_tx_events("tx.height >= 1")] == [t.to_proto() for t in trs]
    sql.close()


# -- key migration --------------------------------------------------------


def _legacy_items(seed: int) -> list:
    """A store of legacy keys (migrate.go formats) with seeded values,
    bad ones and modern keys among them."""
    rng = np.random.default_rng(seed)

    def val():
        return rng.bytes(int(rng.integers(1, 40)))

    items = []
    for h in (1, 2, 10, 255, 4096):
        items += [(b"H:%d" % h, val()), (b"C:%d" % h, val()), (b"SC:%d" % h, val()),
                  (b"P:%d:0" % h, val()), (b"P:%d:1" % h, val()),
                  (b"validatorsKey:%d" % h, val()), (b"consensusParamsKey:%d" % h, val()),
                  (b"abciResponsesKey:%d" % h, val())]
        items.append((b"BH:" + rng.bytes(32).hex().encode(), b"%d" % h))
    items += [(b"stateKey", val()), (b"H:notanumber", val()), (b"BH:zz", b"1"),
              (b"\x00" + struct.pack(">q", 7), val()), (b"other", val())]
    return items


@pytest.mark.parametrize("context", ["blockstore", "state", "tx_index"])
def test_migrate_db_equals_jax(context):
    items = _legacy_items(61)
    db, jdb = MemKV(), JaxMemKV()
    for k, v in items:
        db.set(k, v)
        jdb.set(k, v)
    n = keymigrate.migrate_db(db, context)
    assert n == jax_keymigrate.migrate_db(jdb, context)
    assert list(db.iterate(None, None)) == list(jdb.iterate(None, None))
    # resumable and idempotent: a second run moves nothing
    assert keymigrate.migrate_db(db, context) == 0
    assert list(db.iterate(None, None)) == list(jdb.iterate(None, None))
    if context != "tx_index":
        assert n > 0
