"""The port's JSON-RPC server and routes against the JAX package's, on
the CPU, over real HTTP on 127.0.0.1:0.

A seeded kvstore chain (6 validators, ed25519 only or 3 ed25519 + 3
sr25519; HEIGHTS blocks of a few txs) is made and applied by the port
(workloads.serve_chain) and replayed by a JAX BlockExecutor from its
genesis JSON and block bytes. Each package's Environment is built from
parts over its own stores, as tests/test_stateless_bulk.py and
tests/test_servingcache.py build theirs: a TxMempool on a kvstore app of
its own, the node's app behind AppConns, an event bus, an evidence pool,
and a KV and an SQL sink fed the stored results. Both are served by
their own RPCServer, and every call goes to both: the JSON results (or
error codes and messages) must be equal. The JAX side takes its metrics
on private registries and never builds a node through make_node, which
binds a fixed p2p port. Tolerance: zero.
"""

import asyncio
import base64
import json
import re

import numpy as np
import pytest

from tendermint_tpu.abci.client import LocalClient as JaxLocalClient
from tendermint_tpu.abci.kvstore import KVStoreApplication as JaxKVStore
from tendermint_tpu.abci.proxy import AppConns as JaxAppConns
from tendermint_tpu.crypto import sigcache as jax_sigcache
from tendermint_tpu.crypto import sr25519 as _jax_sr  # noqa: F401  (registers the key type)
from tendermint_tpu.crypto.keys import pubkey_from_type_and_bytes as jax_pubkey
from tendermint_tpu.eventbus import EventBus as JaxEventBus
from tendermint_tpu.evidence.metrics import EvidenceMetrics
from tendermint_tpu.evidence.pool import EvidencePool as JaxEvidencePool
from tendermint_tpu.libs.metrics import Registry
from tendermint_tpu.mempool.mempool import TxMempool as JaxTxMempool
from tendermint_tpu.mempool.metrics import MempoolMetrics
from tendermint_tpu.mempool.nop import NopMempool as JaxNopMempool
from tendermint_tpu.rpc import core as jax_core
from tendermint_tpu.rpc.metrics import RPCMetrics
from tendermint_tpu.rpc.server import RPCServer as JaxRPCServer
from tendermint_tpu.state import indexer as jax_indexer
from tendermint_tpu.state import sink_sql as jax_sink_sql
from tendermint_tpu.state.execution import BlockExecutor as JaxBlockExecutor
from tendermint_tpu.state.metrics import StateMetrics
from tendermint_tpu.state.store import StateStore as JaxStateStore
from tendermint_tpu.state.types import state_from_genesis as jax_state_from_genesis
from tendermint_tpu.store.block_store import BlockStore as JaxBlockStore
from tendermint_tpu.store.kv import MemKV as JaxMemKV
from tendermint_tpu.types.block import Block as JaxBlock
from tendermint_tpu.types.block_id import BlockID as JaxBlockID
from tendermint_tpu.types.commit import Commit as JaxCommit
from tendermint_tpu.types.genesis import GenesisDoc as JaxGenesisDoc
from tendermint_tpu.types.light import LightBlock as JaxLightBlock
from tendermint_tpu.types.light import LightBlocksResponse as JaxLightBlocksResponse
from tendermint_tpu_torch import workloads
from tendermint_tpu_torch.abci.client import LocalClient
from tendermint_tpu_torch.abci.kvstore import KVStoreApplication
from tendermint_tpu_torch.abci.proxy import AppConns
from tendermint_tpu_torch.crypto.merkle import Proof
from tendermint_tpu_torch.eventbus import EventBus
from tendermint_tpu_torch.evidence.pool import EvidencePool
from tendermint_tpu_torch.rpc import core
from tendermint_tpu_torch.rpc.client import HTTPClient, RPCClientError, WSClient
from tendermint_tpu_torch.rpc.server import RPCServer
from tendermint_tpu_torch.rpc.servingcache import ServingCache
from tendermint_tpu_torch.state.indexer import KVSink, TxResult
from tendermint_tpu_torch.state.sink_sql import SQLSink
from tendermint_tpu_torch.store.kv import MemKV
from tendermint_tpu_torch.types.evidence import evidence_to_proto
from tendermint_tpu_torch.types.genesis import GenesisDoc
from tendermint_tpu_torch.types.light import LightBlock, LightBlocksResponse, SignedHeader
from tendermint_tpu_torch.types.tx import tx_hash, txs_hash

from .test_torch_isolation import jax_device_plane_paused  # noqa: F401 (autouse)

CHAIN = "torch-rpc-chain"
SEED = 43
HEIGHTS = 8
N_VALS = 6
TIMEOUT_S = 60.0


# -- the chain, in both packages ---------------------------------------


def _replay_jax(genesis: str, blocks) -> tuple:
    """A JAX node at the genesis applying the port's blocks from their
    bytes: (state store, block store, app)."""
    state = jax_state_from_genesis(JaxGenesisDoc.from_json(genesis))
    state_store, block_store = JaxStateStore(JaxMemKV()), JaxBlockStore(JaxMemKV())
    state_store.save(state)
    app = JaxKVStore()
    executor = JaxBlockExecutor(
        state_store, JaxLocalClient(app), JaxNopMempool(), block_store=block_store,
        metrics=StateMetrics(Registry()),
    )
    with jax_sigcache.disabled():
        for cb in blocks:
            block = JaxBlock.from_proto(cb.block.to_proto())
            _, parts = state.make_block(
                block.header.height, block.txs, block.last_commit, [], block.header.proposer_address
            )
            block_store.save_block(block, parts, JaxCommit.from_proto(cb.seen_commit.to_proto()))
            state = asyncio.run(
                executor.apply_block(state, JaxBlockID.from_proto(cb.block_id.to_proto()), block)
            )
    return state_store, block_store, app


def build_pair_chain(n_sr: int, seed: int = SEED, heights: int = HEIGHTS, n_txs: int = 3):
    """(genesis, privs, port chain and node, JAX stores and app) of one
    seeded kvstore chain; height 2 carries a malformed validator update
    (a DeliverTx with code 1)."""
    privs = workloads.seeded_keys(N_VALS, seed + n_sr, n_sr)
    genesis = workloads.kv_genesis(CHAIN, privs)
    txs = [workloads.kv_txs(seed, h, n_txs, (34, 80)) for h in range(1, heights + 1)]
    txs[1] = txs[1] + [b"val:zz!1"]
    chain, node, _states = workloads.serve_chain(genesis, privs, txs, seed)
    return {"genesis": genesis, "privs": privs, "chain": chain, "node": node,
            "jax": _replay_jax(genesis, chain)}


def _tx_results(block_store, state_store, h: int) -> list:
    block = block_store.load_block(h)
    res = state_store.load_abci_responses(h)
    return [(h, i, tx, r) for i, (tx, r) in enumerate(zip(block.txs, res.deliver_tx_objs))]


def _fill(sinks, block_store, state_store, tx_result, upto: int) -> None:
    """Index heights 1..upto's stored results and block events."""
    for h in range(1, upto + 1):
        res = state_store.load_abci_responses(h)
        events = list(res.begin_block_obj.events) + list(res.end_block_obj.events)
        for s in sinks:
            s.index_block_events(h, events)
            s.index_tx_events([tx_result(*r) for r in _tx_results(block_store, state_store, h)])


class Pair:
    """The two Environments over one chain, their servers once started."""

    def __init__(self, served):
        node = served["node"]
        jstate_store, jblock_store, japp = served["jax"]
        privs = served["privs"]
        pk = privs[0].pub_key()
        self.port_pool = workloads.kv_mempool(KVStoreApplication())
        self.jax_pool = JaxTxMempool(
            JaxLocalClient(JaxKVStore()), metrics=MempoolMetrics(Registry())
        )
        self.port_bus, self.jax_bus = EventBus(), JaxEventBus()
        self.port_sinks = [KVSink(MemKV()), SQLSink("sqlite::memory:", CHAIN)]
        self.jax_sinks = [
            jax_indexer.KVSink(JaxMemKV()), jax_sink_sql.SQLSink("sqlite::memory:", CHAIN)
        ]
        _fill(self.port_sinks, node.block_store, node.state_store, TxResult, HEIGHTS)
        _fill(self.jax_sinks, jblock_store, jstate_store, jax_indexer.TxResult, HEIGHTS)
        self.port_proxy = AppConns(lambda: LocalClient(node.app))
        self.jax_proxy = JaxAppConns(lambda: JaxLocalClient(japp))
        self.port_evpool = EvidencePool(MemKV(), node.state_store, node.block_store)
        self.jax_evpool = JaxEvidencePool(
            JaxMemKV(), jstate_store, jblock_store, metrics=EvidenceMetrics(Registry())
        )
        self.port = core.Environment(
            chain_id=CHAIN, block_store=node.block_store, state_store=node.state_store,
            mempool=self.port_pool, event_bus=self.port_bus, proxy=self.port_proxy,
            genesis=GenesisDoc.from_json(served["genesis"]), evidence_pool=self.port_evpool,
            event_sinks=self.port_sinks, privval_pub_key=pk,
        )
        self.jax = jax_core.Environment(
            chain_id=CHAIN, block_store=jblock_store, state_store=jstate_store,
            mempool=self.jax_pool, event_bus=self.jax_bus, proxy=self.jax_proxy,
            genesis=JaxGenesisDoc.from_json(served["genesis"]), evidence_pool=self.jax_evpool,
            event_sinks=self.jax_sinks, privval_pub_key=jax_pubkey(pk.type(), pk.bytes()),
            metrics=RPCMetrics(Registry()),
        )

    async def start(self, max_body_bytes: int = 1_000_000):
        for svc in (self.port_bus, self.jax_bus, self.port_proxy, self.jax_proxy):
            await svc.start()
        self.port_srv = RPCServer(self.port, "tcp://127.0.0.1:0", max_body_bytes)
        self.jax_srv = JaxRPCServer(self.jax, "tcp://127.0.0.1:0", max_body_bytes)
        await self.port_srv.start()
        await self.jax_srv.start()
        self.port_addr = f"127.0.0.1:{self.port_srv.bound_port}"
        self.jax_addr = f"127.0.0.1:{self.jax_srv.bound_port}"
        self.clients = (HTTPClient(self.port_addr), HTTPClient(self.jax_addr))

    async def stop(self):
        for c in self.clients:
            await c.close()
        await self.jax_srv.stop()
        await self.port_srv.stop()
        for svc in (self.port_proxy, self.jax_proxy, self.port_bus, self.jax_bus):
            await svc.stop()

    async def both(self, method: str, **params):
        """Each server's answer to one call: ("ok", result) or ("err",
        code, message)."""
        out = []
        for c in self.clients:
            try:
                out.append(("ok", await c.call(method, **params)))
            except RPCClientError as e:
                out.append(("err", e.code, str(e)))
        return out


def run_pair(served, body, **kw):
    """Start a Pair over `served`, run body(pair), stop it; the whole
    loop under a deadline, so a hang fails in seconds."""

    async def main():
        pair = Pair(served)
        await pair.start(**kw)
        try:
            return await body(pair)
        finally:
            await pair.stop()

    return asyncio.run(asyncio.wait_for(main(), TIMEOUT_S))


@pytest.fixture(scope="module", params=["ed25519", "mixed"])
def served(request):
    return build_pair_chain(0 if request.param == "ed25519" else N_VALS // 2)


@pytest.fixture(scope="module")
def served_ed():
    return build_pair_chain(0)


# -- the routes ---------------------------------------------------------


def test_route_table_is_the_jax_one_but_the_recorder_and_profiler():
    env = core.Environment(chain_id=CHAIN, block_store=None, state_store=None)
    jenv = jax_core.Environment(
        chain_id=CHAIN, block_store=None, state_store=None, metrics=RPCMetrics(Registry())
    )
    assert sorted(env.routes()) == sorted(set(jenv.routes()) - {"consensus_timeline", "profile"})
    assert list(env.routes()) == [r for r in jenv.routes() if r not in ("consensus_timeline", "profile")]


def _cases(served) -> list:
    """(method, params) of every read route, with good and bad params."""
    chain = served["chain"]
    h3 = chain[2].block
    tx = h3.txs[1]
    return [
        ("health", {}),
        ("status", {}),
        ("net_info", {}),
        ("genesis", {}),
        ("genesis_chunked", {}),
        ("genesis_chunked", {"chunk": 3}),
        ("blockchain", {}),
        ("blockchain", {"min_height": 2, "max_height": 6}),
        ("header", {"height": 3}),
        ("header", {}),
        ("header", {"height": 99}),
        ("header", {"height": "x"}),
        ("header_by_hash", {"hash": h3.hash().hex()}),
        ("header_by_hash", {"hash": "00" * 32}),
        ("header_by_hash", {"hash": "zz"}),
        ("block", {"height": 3}),
        ("block_by_hash", {"hash": h3.hash().hex()}),
        ("block_by_hash", {"hash": "11" * 32}),
        ("block_results", {"height": 2}),
        ("block_results", {"height": 3}),
        ("commit", {"height": 3}),
        ("commit", {"height": HEIGHTS}),
        ("validators", {"height": 3}),
        ("validators", {"height": 3, "page": 2, "per_page": 4}),
        ("validators", {"height": 3, "page": 9}),
        ("consensus_params", {"height": 3}),
        ("consensus_state", {}),
        ("dump_consensus_state", {}),
        ("abci_info", {}),
        ("abci_query", {"data": tx.split(b"=")[0].hex()}),
        ("abci_query", {"data": "zz"}),
        ("check_tx", {"tx": base64.b64encode(b"k1=v1").decode()}),
        ("check_tx", {"tx": "!!"}),
        ("tx", {"hash": tx_hash(tx).hex()}),
        ("tx", {"hash": "22" * 32}),
        ("tx_search", {"query": "tx.height = 3"}),
        ("tx_search", {"query": "tx.height >= 2", "page": 2, "per_page": 4, "order_by": "desc"}),
        ("tx_search", {"query": f"tx.hash = '{tx_hash(tx).hex().upper()}'"}),
        ("tx_search", {}),
        ("block_search", {"query": "block.height > 5"}),
        ("block_search", {"query": "block.height <= 4", "order_by": "desc"}),
        ("light_block", {"height": 3}),
        ("light_block", {"height": HEIGHTS}),
        ("light_blocks", {"min_height": 2, "max_height": 7}),
        ("light_blocks", {"min_height": 3, "max_blocks": 2}),
        ("tx_proofs", {"height": 3, "indices": [0, 2]}),
        ("tx_proofs", {"height": 3, "indices": [7]}),
        ("tx_proofs", {"height": 3, "indices": "x"}),
        ("num_unconfirmed_txs", {}),
        ("unconfirmed_txs", {}),
        ("broadcast_evidence", {}),
        ("broadcast_evidence", {"evidence": "zz"}),
        ("subscribe", {"query": "tm.event = 'Tx'"}),
        ("no_such_route", {}),
    ]


def test_every_route_answers_as_the_jax_one(served):
    async def body(pair):
        got = []
        for method, params in _cases(served):
            got.append((method, params, await pair.both(method, **params)))
        return got

    for method, params, (port, jax) in run_pair(served, body):
        assert port == jax, (method, params)


async def raw_http(addr, req: bytes) -> bytes:
    """The server's whole answer to one raw HTTP request."""
    host, port = addr.split(":")
    r, w = await asyncio.open_connection(host, int(port))
    w.write(req)
    await w.drain()
    data = await r.read()
    w.close()
    return data


def post_request(body: bytes) -> bytes:
    return (b"POST / HTTP/1.1\r\nHost: x\r\nConnection: close\r\n"
            b"Content-Length: %d\r\n\r\n" % len(body)) + body


# JSON-RPC requests whose params are a string, a number and true
MALFORMED_PARAMS = tuple(
    b'{"jsonrpc":"2.0","id":1,"method":"block","params":%s}' % x for x in (b'"x"', b"7", b"true")
)


def test_uri_form_post_batch_and_protocol_errors(served_ed):
    """GET /method?k=v (JSON values, bare strings), the route listing at
    /, a POST batch, a parse error, positional params, an unknown method
    and a body over the limit: the same bytes from both servers."""

    raw, post = raw_http, post_request

    def get(target: str) -> bytes:
        return f"GET {target} HTTP/1.1\r\nHost: x\r\nConnection: close\r\n\r\n".encode()

    requests = [
        get("/"),
        get("/header?height=3"),
        get("/validators?height=3&per_page=2"),
        get("/tx_search?query=tx.height%3D4"),
        get("/block_by_hash?hash=" + "ab" * 32),
        get("/nope"),
        post(b'{"jsonrpc": "2.0", "id": 7, "method": "header", "params": {"height": 2}}'),
        post(b'[{"jsonrpc": "2.0", "id": 1, "method": "health"},'
             b' {"jsonrpc": "2.0", "id": 2, "method": "commit", "params": {"height": 1}}]'),
        post(b"{not json"),
        post(b'{"jsonrpc": "2.0", "id": 3, "method": "header", "params": [3]}'),
        post(b'{"jsonrpc": "2.0", "id": 4, "method": "missing"}'),
        post(b'{"jsonrpc": "2.0", "id": 5}'),
        post(b'{"jsonrpc": "2.0", "id": 6, "method": "health", "params": {"pad": "'
             + b"x" * 300 + b'"}}'),
        b"PUT / HTTP/1.1\r\nHost: x\r\nContent-Length: 0\r\n\r\n",
    ]

    async def body(pair):
        out = []
        for req in requests:
            out.append([await raw(a, req) for a in (pair.port_addr, pair.jax_addr)])
        return out

    answers = run_pair(served_ed, body, max_body_bytes=256)
    # the route listing: the JAX one but the recorder's and profiler's
    listing = [json.loads(a.split(b"\r\n\r\n", 1)[1])["result"] for a in answers[0]]
    assert listing[0] == sorted(set(listing[1]) - {"consensus_timeline", "profile"})
    for req, (port, jax) in list(zip(requests, answers))[1:]:
        assert port == jax, req[:60]
    codes = [json.loads(a[0].split(b"\r\n\r\n", 1)[1] or b"null") if a[0].startswith(b"HTTP/1.1 200")
             else a[0].split(b"\r\n")[0] for a in answers]
    assert codes[5]["error"]["code"] == -32601
    assert codes[8]["error"]["code"] == -32700
    assert codes[9]["error"]["code"] == -32602
    assert codes[10]["error"]["code"] == -32601
    assert codes[11]["error"]["code"] == -32600
    assert codes[12] == b"HTTP/1.1 413 Too Large"
    assert codes[13] == b"HTTP/1.1 405 Method Not Allowed"


def test_params_that_are_not_an_object_are_answered_as_jax_and_not_kept(served_ed):
    """A request whose params are "x", 7 or true: each gets the JAX
    server's answer (INTERNAL_ERROR with the route's AttributeError, as
    tendermint_tpu/rpc/jsonrpc.py `_dispatch` gives it), the port's server
    keeps none of them as its failure(), and answers the next call."""

    async def body(pair):
        answers = []
        for req in MALFORMED_PARAMS:
            answers.append([await raw_http(a, post_request(req)) for a in (pair.port_addr, pair.jax_addr)])
        return answers, pair.port_srv.failure(), await pair.both("header", height=2)

    answers, failure, after = run_pair(served_ed, body)
    for port, jax in answers:
        assert port == jax
        err = json.loads(port.split(b"\r\n\r\n", 1)[1])["error"]
        assert err["code"] == -32603 and err["message"].startswith("AttributeError(")
    assert failure is None
    assert after[0] == after[1] and after[0][0] == "ok"


def test_websocket_subscribe_notifications_equal_the_jax_text(served_ed):
    """A websocket client subscribes to Tx events on each server; the
    same EventDataTx published on each bus reaches it as the same text
    the JAX `_notification_text` makes; unsubscribe and its errors
    answer alike."""
    node = served_ed["node"]
    jstate_store, jblock_store, _ = served_ed["jax"]
    query = "tm.event = 'Tx'"

    async def body(pair):
        from tendermint_tpu.types import events as JE
        from tendermint_tpu_torch.types import events as PE

        answers = []
        texts = []
        for addr, bus, events, stores in (
            (pair.port_addr, pair.port_bus, PE, (node.block_store, node.state_store)),
            (pair.jax_addr, pair.jax_bus, JE, (jblock_store, jstate_store)),
        ):
            ws = WSClient(addr)
            await ws.connect()
            got = [await ws.call("subscribe", query=query)]
            try:
                await ws.call("subscribe", query=query)
            except RPCClientError as e:
                got.append((e.code, str(e)))
            for h, i, tx, res in _tx_results(*stores, 3)[:2]:
                bus.publish_tx(events.EventDataTx(height=h, index=i, tx=tx, result=res), tx_hash=tx_hash(tx))
            texts.append([await ws.next_event() for _ in range(2)])
            got.append(await ws.call("unsubscribe", query=query))
            try:
                await ws.call("unsubscribe", query=query)
            except RPCClientError as e:
                got.append((e.code, str(e)))
            got.append(await ws.call("unsubscribe_all"))
            got.append(await ws.call("header", height=2))
            await ws.close()
            answers.append(got)
        return answers, texts

    (port, jax), (ptexts, jtexts) = run_pair(served_ed, body)
    assert port == jax
    assert ptexts == jtexts and len(ptexts) == 2
    # the frame text itself: the JAX _notification_text of the message
    from tendermint_tpu.pubsub import Message as JaxMessage
    from tendermint_tpu.types import events as JE
    from tendermint_tpu_torch.pubsub import Message
    from tendermint_tpu_torch.types import events as PE

    h, i, tx, res = _tx_results(node.block_store, node.state_store, 3)[0]
    jh, ji, jtx, jres = _tx_results(jblock_store, jstate_store, 3)[0]
    tags = {"tm.event": ["Tx"], "tx.hash": [tx_hash(tx).hex().upper()], "tx.height": ["3"]}
    pm = Message(data=PE.EventDataTx(height=h, index=i, tx=tx, result=res), events=tags)
    jm = JaxMessage(data=JE.EventDataTx(height=jh, index=ji, tx=jtx, result=jres), events=tags)
    assert core.Environment._notification_text(pm, query, 5) == \
        jax_core.Environment._notification_text(jm, query, 5)


# -- light_blocks, tx_proofs and the serving cache -----------------------


class _BS:
    """A block store over LightBlocks (tests/test_stateless_bulk.py)."""

    def __init__(self, blocks, gap_at=None):
        self.blocks, self.gap_at = blocks, gap_at

    def height(self):
        return max(self.blocks)

    def base(self):
        return min(self.blocks)

    def load_block_meta(self, h):
        if h == self.gap_at or h not in self.blocks:
            return None
        return type("M", (), {"header": self.blocks[h].signed_header.header})()

    def load_block_commit(self, h):
        lb = self.blocks.get(h)
        return lb.signed_header.commit if lb else None

    def load_seen_commit(self):
        return None


class _SS:
    def __init__(self, blocks):
        self.blocks = blocks

    def load_validators(self, h):
        lb = self.blocks.get(h)
        return lb.validator_set if lb else None


def _light_envs(n: int, gap_at=None):
    blocks = workloads.build_light_chain(CHAIN, n, 4, SEED)
    jblocks = {h: JaxLightBlock.from_proto(b.to_proto()) for h, b in blocks.items()}
    env = core.Environment(chain_id=CHAIN, block_store=_BS(blocks, gap_at), state_store=_SS(blocks))
    jenv = jax_core.Environment(
        chain_id=CHAIN, block_store=_BS(jblocks, gap_at), state_store=_SS(jblocks),
        metrics=RPCMetrics(Registry()),
    )
    return blocks, env, jenv


def _req(params):
    return core.RPCRequest(method="x", params=params, req_id=1)


def _jreq(params):
    from tendermint_tpu.rpc.jsonrpc import RPCRequest

    return RPCRequest(method="x", params=params, req_id=1)


def test_light_blocks_clamp_and_gap_equal_jax():
    cap = core.LIGHT_BLOCKS_PAGE_CAP
    assert cap == jax_core.LIGHT_BLOCKS_PAGE_CAP
    blocks, env, jenv = _light_envs(cap + 10)
    for params in ({"min_height": 3}, {"min_height": 1, "max_blocks": 3},
                   {"min_height": 1, "max_blocks": 10_000}, {"min_height": 10**9},
                   {"max_height": -5}, {"min_height": 4, "max_height": 9}):
        got = asyncio.run(env.light_blocks(_req(params)))
        assert got == asyncio.run(jenv.light_blocks(_jreq(params))), params
    page = LightBlocksResponse.from_proto(
        bytes.fromhex(asyncio.run(env.light_blocks(_req({"min_height": 3})))["light_blocks"])
    )
    assert [b.height for b in page.light_blocks] == list(range(3, 3 + cap))
    _blocks, env, jenv = _light_envs(10, gap_at=5)
    got = asyncio.run(env.light_blocks(_req({"min_height": 2, "max_height": 9})))
    assert got == asyncio.run(jenv.light_blocks(_jreq({"min_height": 2, "max_height": 9})))
    assert got["count"] == 3


def test_tx_proofs_and_param_checks_equal_jax(served_ed):
    """Proofs of the held tree verify against the header's data_hash and
    equal the JAX route's; bad indices, out-of-range, negative and past
    int64 indices, and the clamp answer alike."""
    node = served_ed["node"]
    jstate_store, jblock_store, _ = served_ed["jax"]
    env = core.Environment(chain_id=CHAIN, block_store=node.block_store, state_store=node.state_store)
    jenv = jax_core.Environment(chain_id=CHAIN, block_store=jblock_store, state_store=jstate_store,
                                metrics=RPCMetrics(Registry()))

    def outcome(e, req, params):
        try:
            return "ok", asyncio.run(e.tx_proofs(req(params)))
        except Exception as err:
            return type(err).__name__, getattr(err, "code", None), getattr(err, "message", str(err))

    block = node.block_store.load_block(2)
    for params in ({"height": 2, "indices": list(range(len(block.txs)))},
                   {"height": 2, "indices": [0] * (core.TX_PROOFS_CAP + 50)},
                   {"height": 2, "indices": None}, {"height": 2, "indices": [1, "x"]},
                   {"height": 2, "indices": [True]}, {"height": 2, "indices": [99]},
                   {"height": 2, "indices": [-1]}, {"height": 2, "indices": [2**70]}):
        assert outcome(env, _req, params) == outcome(jenv, _jreq, params), params
    res = asyncio.run(env.tx_proofs(_req({"height": 2, "indices": [0, 3]})))
    assert res["root"] == block.header.data_hash.hex() == txs_hash(block.txs).hex()
    for hexp, i in zip(res["proofs"], [0, 3]):
        Proof.from_proto_bytes(bytes.fromhex(hexp)).verify(block.header.data_hash, tx_hash(block.txs[i]))
    assert env.serving_cache.tx_tree(2) is env.serving_cache.tx_tree(2)


def test_serving_cache_blob_equals_the_page_codec_cold_and_warm(served_ed):
    """The light_blocks page, cold and warm, is byte-equal to
    LightBlocksResponse.to_proto of the light blocks the stores hold, and
    to the JAX page; the tip (seen commit) is never cached."""
    node = served_ed["node"]
    jstate_store, jblock_store, _ = served_ed["jax"]
    env = core.Environment(chain_id=CHAIN, block_store=node.block_store, state_store=node.state_store)
    jenv = jax_core.Environment(chain_id=CHAIN, block_store=jblock_store, state_store=jstate_store,
                                metrics=RPCMetrics(Registry()))
    want = LightBlocksResponse(
        light_blocks=[env.serving_cache.light_block_at(h) for h in range(1, HEIGHTS + 1)],
        last_height=HEIGHTS,
    ).to_proto().hex()
    params = {"min_height": 1, "max_height": HEIGHTS}
    for _ in ("cold", "warm"):
        got = asyncio.run(env.light_blocks(_req(params)))
        assert got["light_blocks"] == want
        assert got == asyncio.run(jenv.light_blocks(_jreq(params)))
    assert sorted(env.serving_cache._blobs) == list(range(1, HEIGHTS))
    page = JaxLightBlocksResponse.from_proto(bytes.fromhex(want))
    assert [b.height for b in page.light_blocks] == list(range(1, HEIGHTS + 1))


def test_no_loaded_object_can_drift_from_a_cached_blob(served_ed):
    """Why the port's cache needs no mutation epochs: after a fill,
    every Commit, Header and ValidatorSet the stores hand out is a fresh
    decode. Mutating all of them in place, as the JAX epochs guard
    against, changes neither a cached blob nor the next fresh load."""
    node = served_ed["node"]
    cache = ServingCache(node.block_store, node.state_store)
    before = {h: cache.encoded_light_block(h) for h in range(1, HEIGHTS)}
    assert sorted(cache._blobs) == list(range(1, HEIGHTS))
    for h in range(1, HEIGHTS):
        lb = cache.light_block_at(h)
        commit = node.block_store.load_block_commit(h)
        vals = node.state_store.load_validators(h)
        for c in (lb.signed_header.commit, commit):
            s = c.signatures[0]
            c.signatures[0] = type(s).for_block(bytes(64), s.validator_address, s.timestamp_ns)
            c.round += 1
        for v in (lb.validator_set, vals):
            v.validators[0].voting_power += 5
        lb.signed_header.header.app_hash = b"\x01" * 32
        assert lb.to_proto() != before[h]
    for h in range(1, HEIGHTS):
        assert cache.encoded_light_block(h) is before[h]
        fresh = LightBlock(
            signed_header=SignedHeader(
                header=node.block_store.load_block_meta(h).header,
                commit=node.block_store.load_block_commit(h),
            ),
            validator_set=node.state_store.load_validators(h),
        )
        assert fresh.to_proto() == before[h]


# -- the mempool routes ---------------------------------------------------


def test_broadcast_tx_outcomes_equal_jax(served_ed):
    """broadcast_tx_sync through the admission batcher: a burst of
    concurrent unique txs (one batch), then duplicates, malformed
    validator txs and bad params one at a time; then async admission,
    the pool's listing, remove_tx and flush. Every answer equals the JAX
    server's, and each pool holds the same txs in the same order."""
    rng = np.random.default_rng(SEED)
    burst = workloads.kv_txs(SEED, 100, 24, (34, 90))
    later = [burst[3], burst[7], b"val:zz!1", b"val:" + b"ab" * 32 + b"!x", b"k=v"]

    def b64(tx):
        return base64.b64encode(tx).decode()

    async def body(pair):
        clients = [(HTTPClient(pair.port_addr), HTTPClient(pair.jax_addr)) for _ in range(6)]
        out = []

        async def send(c, tx):
            try:
                return "ok", await c.call("broadcast_tx_sync", tx=b64(tx))
            except RPCClientError as e:
                return "err", e.code, str(e)

        order = rng.permutation(len(burst)).tolist()
        for side in (0, 1):
            got = await asyncio.gather(*(send(clients[k % 6][side], burst[i]) for k, i in enumerate(order)))
            out.append(sorted(map(json.dumps, got)))
        for tx in later:
            out.append(await pair.both("broadcast_tx_sync", tx=b64(tx)))
        out.append(await pair.both("broadcast_tx_sync", tx="**"))
        out.append(await pair.both("broadcast_tx_sync"))
        out.append(await pair.both("broadcast_tx_async", tx=b64(b"async=1")))
        while not pair.port_pool.size() == pair.jax_pool.size() == len(burst) + 2:
            await asyncio.sleep(0.01)  # the async admissions (run_pair's deadline bounds it)
        out.append(await pair.both("num_unconfirmed_txs"))
        out.append(await pair.both("unconfirmed_txs", limit=100))
        out.append(await pair.both("remove_tx", tx_key=tx_hash(burst[0]).hex()))
        out.append(await pair.both("num_unconfirmed_txs"))
        out.append(await pair.both("unsafe_flush_mempool"))
        out.append(await pair.both("num_unconfirmed_txs"))
        for pc, jc in clients:
            await pc.close()
            await jc.close()
        return out

    out = run_pair(served_ed, body)
    assert out[0] == out[1]
    assert all(json.loads(s)[0] == "ok" for s in out[0])
    for port, jax in out[2:]:
        assert port == jax
    assert out[2][0][0] == "err" and "tx already exists in cache" in out[2][0][2]
    assert out[4][0][1]["code"] != 0  # the malformed validator tx


def test_broadcast_evidence_answers_equal_jax(served_ed):
    """A light-client attack on the chain (a conflicting header at
    height 5 signed by every validator, the common height 4): both pools
    accept it with the same hash, a second report answers the same, and
    evidence whose conflicting commit carries too little power is
    rejected with the same "evidence rejected: …" text."""
    from tendermint_tpu_torch.types.evidence import LightClientAttackEvidence

    ev_ok, ev_bad = _attack_evidence(served_ed)

    async def body(pair):
        out = []
        for ev in (ev_ok, ev_ok, ev_bad):
            out.append(await pair.both("broadcast_evidence", evidence=evidence_to_proto(ev).hex()))
        out.append([[e.hash() for e in pair.port_evpool.pending_evidence(10**6)[0]],
                    [e.hash() for e in pair.jax_evpool.pending_evidence(10**6)[0]]])
        return out

    out = run_pair(served_ed, body)
    for port, jax in out[:3]:
        assert port == jax
    assert out[0][0] == ("ok", {"hash": ev_ok.hash().hex()})
    assert out[2][0][0] == "err" and out[2][0][2].startswith("evidence rejected: invalid evidence: ")
    assert out[3] == [[ev_ok.hash()], [ev_ok.hash()]]
    assert isinstance(ev_ok, LightClientAttackEvidence)


def _attack_evidence(served, at: int = 5):
    """(accepted, rejected) LightClientAttackEvidence against the served
    chain: the header at `at` with another app hash, signed by every
    validator (or by one alone), common height at - 1."""
    from tendermint_tpu_torch.types.block_id import BlockID, PartSetHeader
    from tendermint_tpu_torch.types.evidence import LightClientAttackEvidence

    node, privs = served["node"], served["privs"]
    vals = node.state_store.load_validators(at)
    out = []
    for signers, app_hash in ((privs, b"\x5a" * 32), (privs[:1], b"\x5b" * 32)):
        header = node.block_store.load_block_meta(at).header
        header.app_hash = app_hash
        bid = BlockID(hash=header.hash(), part_set_header=PartSetHeader(total=1, hash=b"\x33" * 32))
        commit = workloads.sign_commit(CHAIN, vals, bid, at, header.time_ns, signers, SEED)
        out.append(LightClientAttackEvidence(
            conflicting_block=LightBlock(
                signed_header=SignedHeader(header=header, commit=commit), validator_set=vals
            ),
            common_height=at - 1,
            total_voting_power=vals.total_voting_power(),
            timestamp_ns=header.time_ns,
        ))
    return out


# -- broadcast_tx_commit on a one-validator step machine -----------------


class _JaxValidator:
    """A JAX-package one-validator node whose proposals reap a TxMempool:
    FilePV in home, WAL, evidence pool, event bus, MemKV stores, private
    metrics registries (tests/test_torch_consensus_state.py JaxNode, with
    the mempool)."""

    def __init__(self, genesis_json: str, seed32: bytes, home: str):
        import os

        from tendermint_tpu.config import ConsensusConfig as JaxConsensusConfig
        from tendermint_tpu.consensus.metrics import ConsensusMetrics
        from tendermint_tpu.consensus.state import ConsensusState as JaxConsensusState
        from tendermint_tpu.consensus.timeline import TimelineRecorder
        from tendermint_tpu.consensus.wal import WAL as JaxWAL
        from tendermint_tpu.crypto.ed25519 import PrivKeyEd25519 as JaxPrivKey
        from tendermint_tpu.privval.file import FilePV as JaxFilePV

        for d in ("config", "data"):
            os.makedirs(os.path.join(home, d), exist_ok=True)
        state = jax_state_from_genesis(JaxGenesisDoc.from_json(genesis_json))
        self.state_store, self.block_store = JaxStateStore(JaxMemKV()), JaxBlockStore(JaxMemKV())
        self.state_store.save(state)
        evpool = JaxEvidencePool(JaxMemKV(), self.state_store, self.block_store,
                                 metrics=EvidenceMetrics(Registry()))
        self.event_bus = JaxEventBus()
        app = JaxKVStore()
        self.mempool = JaxTxMempool(JaxLocalClient(app), metrics=MempoolMetrics(Registry()))
        executor = JaxBlockExecutor(
            self.state_store, JaxLocalClient(app), self.mempool, evpool, self.block_store,
            self.event_bus, metrics=StateMetrics(Registry()),
        )
        privval = JaxFilePV.from_priv_key(
            JaxPrivKey.from_seed(seed32),
            os.path.join(home, "config", "priv_validator_key.json"),
            os.path.join(home, "data", "priv_validator_state.json"),
        )
        privval.save()
        metrics = ConsensusMetrics(Registry())
        with workloads.pinned_clock(lambda: 0):
            self.cs = JaxConsensusState(
                JaxConsensusConfig(skip_timeout_commit=True), state, executor, self.block_store,
                privval=privval, event_bus=self.event_bus,
                wal=JaxWAL(os.path.join(home, "data", "cs.wal", "wal")), evidence_pool=evpool,
                metrics=metrics, timeline=TimelineRecorder(enabled=False, metrics=metrics),
            )


def test_broadcast_tx_commit_on_a_one_validator_step_machine(tmp_path):
    """One validator whose proposals reap the pool the route admits to
    (workloads.consensus_node, its clock pinned to its height): the
    route's answer (CheckTx, hash, height, DeliverTx) and the round state
    routes before the start equal the JAX route's on the JAX step
    machine of the same genesis; a rejected tx answers at once, alike."""
    from tendermint_tpu_torch.config import ConsensusConfig, MempoolConfig
    from tendermint_tpu_torch.crypto.ed25519 import PrivKeyEd25519

    seed32 = bytes(range(32))
    priv = PrivKeyEd25519.from_seed(seed32)
    genesis = workloads.kv_genesis(CHAIN, [priv])
    tx = b"commit-key=commit-value"

    async def drive(node, env, srv):
        with workloads.pinned_clock(lambda: node.cs.rs.height):
            await node.event_bus.start()
            await srv.start()
            c = HTTPClient(f"127.0.0.1:{srv.bound_port}")
            out = [await c.call("consensus_state"), await c.call("dump_consensus_state")]
            try:
                await c.call("broadcast_tx_commit", tx="!!")
            except RPCClientError as e:
                out.append((e.code, str(e)))
            task = asyncio.ensure_future(c.call("broadcast_tx_commit", tx=base64.b64encode(tx).decode()))
            while node.mempool.size() < 1:
                await asyncio.sleep(0.005)
            await node.cs.start()
            out.append(await task)
            c2 = HTTPClient(f"127.0.0.1:{srv.bound_port}")
            out.append(await c2.call("broadcast_tx_commit", tx=base64.b64encode(b"val:zz!1").decode()))
            await node.cs.stop()
            await c.close()
            await c2.close()
            await srv.stop()
            await node.event_bus.stop()
        return out

    node = workloads.consensus_node(genesis, priv, str(tmp_path / "port"),
                                    cfg=ConsensusConfig(skip_timeout_commit=True),
                                    mempool_cfg=MempoolConfig())
    env = core.Environment(chain_id=CHAIN, block_store=node.block_store, state_store=node.state_store,
                           mempool=node.mempool, event_bus=node.event_bus, consensus=node.cs)
    got = asyncio.run(asyncio.wait_for(drive(node, env, RPCServer(env, "tcp://127.0.0.1:0")), TIMEOUT_S))
    node.close()
    with jax_sigcache.disabled():
        jnode = _JaxValidator(genesis, seed32, str(tmp_path / "jax"))
        jenv = jax_core.Environment(chain_id=CHAIN, block_store=jnode.block_store,
                                    state_store=jnode.state_store, mempool=jnode.mempool,
                                    event_bus=jnode.event_bus, consensus=jnode.cs,
                                    metrics=RPCMetrics(Registry()))
        want = asyncio.run(asyncio.wait_for(
            drive(jnode, jenv, JaxRPCServer(jenv, "tcp://127.0.0.1:0")), TIMEOUT_S))
    # dump_consensus_state prints each VoteSet with str(), which in both
    # packages is the default object repr: a module path and an address
    got[1], want[1] = (
        json.loads(re.sub(r"<[\w.]+\.VoteSet object at 0x[0-9a-f]+>", "<VoteSet>", json.dumps(x)))
        for x in (got[1], want[1])
    )
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, (i, json.dumps(g, sort_keys=True), json.dumps(w, sort_keys=True))
    assert len(got) == len(want) == 5
    assert got[3]["height"] == 1 and got[3]["deliver_tx"]["code"] == 0
    assert got[3]["hash"] == tx_hash(tx).hex()
    assert got[4]["check_tx"]["code"] != 0 and got[4]["height"] == 0
