"""RPC method implementations against a node Environment.

Counterpart: tendermint_tpu/rpc/core.py:1-1263, but for two routes
(reference: internal/rpc/core/{routes.go:30-73, env.go, blocks.go,
mempool.go, status.go, tx.go, consensus.go, abci.go, events.go,
evidence.go, net.go, health.go}). The Environment holds the node
internals the reference's does; every public method is one JSON-RPC
route. `consensus_timeline` and `profile` (:588-674) read the flight
recorder and the profiler, which the port does not have yet (ROADMAP item 11b): the
route table omits them, and a call answers METHOD_NOT_FOUND.

JSON conventions, the JAX package's: bytes are lowercase hex strings;
transaction payloads are base64; heights and other int64s are JSON
numbers.

ERRORS. `broadcast_evidence` answers "evidence rejected: <message>"
only for the evidence pool's check errors (CHECK_ERRORS), with the JAX
package's message; the JAX route turns any exception of
`add_evidence` into that answer. Any other error, a failed kernel
launch of the conflicting commit's check among them, raises to the
dispatcher, which answers INTERNAL_ERROR and keeps it (rpc/jsonrpc.py,
RPCServer.failure()). A DeviceFault stays contained inside the
verifier. The Environment's RPCMetrics struct (DEFAULT_REGISTRY's
unless given; :208-241) reaches the serving cache and the JSON-RPC
server, and counts the bulk light_blocks and tx_proofs requests
(:1063-1112). The trace spans wait for ROADMAP item 11b.
"""

from __future__ import annotations

import asyncio
import base64
import dataclasses
import json
import logging
from typing import Any, Dict, List, Optional, Tuple

from ..crypto.keys import PubKey
from ..encoding.proto import ProtoWriter
from ..eventbus import EventBus
from ..evidence.pool import EvidenceError
from ..mempool import Mempool, MempoolError, TxInfo
from ..pubsub import ERR_TERMINATED, SubscriptionError
from ..state.indexer import EventSink
from ..types import events as tme
from ..types.genesis import GenesisDoc
from ..types.tx import tx_hash
from ..types.validator import ValidatorSet
from .jsonrpc import (
    INTERNAL_ERROR,
    INVALID_PARAMS,
    RPCError,
    RPCRequest,
)
from .metrics import RPCMetrics
from .servingcache import DEFAULT_CAPACITY, ServingCache

__all__ = [
    "CHECK_ERRORS",
    "Environment",
    "GENESIS_CHUNK_SIZE",
    "LIGHT_BLOCKS_PAGE_CAP",
    "TX_PROOFS_CAP",
]

GENESIS_CHUNK_SIZE = 16 * 1024 * 1024  # reference: env.go:51

# hard server-side page bound for the bulk light_blocks route (the
# reference's BlockchainInfo page size; a 150-validator LightBlock is
# ~15 KB of proto, so a full page stays well under typical client
# frame limits). Clients page past it (light/provider.py light_blocks).
LIGHT_BLOCKS_PAGE_CAP = 20

# hard server-side bound on merkle proofs per tx_proofs request: a
# proof is ~32·log2(N) bytes, and the held tree serves K proofs in
# K·log2(N) gathers, so 100 keeps the worst request under ~1 ms
TX_PROOFS_CAP = 100

# what the evidence pool's check of reported evidence raises for bad
# evidence: EvidenceError (the pool wraps verify_evidence's ValueError)
# and the commit checks' errors (light/verifier.py CHECK_ERRORS)
CHECK_ERRORS = (EvidenceError, ValueError, OverflowError)


def encode(obj: Any) -> Any:
    """Generic domain-object -> JSON-encodable structure."""
    if isinstance(obj, PubKey):
        return {"type": obj.type(), "value": obj.bytes().hex()}
    if isinstance(obj, ValidatorSet):
        return {
            "validators": [encode(v) for v in obj.validators],
            "proposer": (
                encode(obj.get_proposer()) if obj.size() else None
            ),
            "total_voting_power": obj.total_voting_power(),
        }
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        # underscore fields are internal caches (Commit._hash,
        # Commit._sign_templates, Header._hash ...) — never part of the
        # wire shape, and not necessarily JSON-encodable
        return {
            f.name: encode(getattr(obj, f.name))
            for f in dataclasses.fields(obj)
            if not f.name.startswith("_")
        }
    if isinstance(obj, bytes):
        return obj.hex()
    if isinstance(obj, (list, tuple)):
        return [encode(x) for x in obj]
    if isinstance(obj, dict):
        return {str(k): encode(v) for k, v in obj.items()}
    return obj


def _b64(data: bytes) -> str:
    return base64.b64encode(data).decode()


def _decode_tx_param(params: Dict[str, Any]) -> bytes:
    tx = params.get("tx")
    if not isinstance(tx, str):
        raise RPCError(INVALID_PARAMS, "missing tx param (base64 string)")
    try:
        return base64.b64decode(tx, validate=True)
    except Exception:
        raise RPCError(INVALID_PARAMS, "tx is not valid base64")


def _decode_hash_param(params: Dict[str, Any], key: str = "hash") -> bytes:
    h = params.get(key)
    if not isinstance(h, str):
        raise RPCError(INVALID_PARAMS, f"missing {key} param (hex string)")
    try:
        return bytes.fromhex(h)
    except ValueError:
        raise RPCError(INVALID_PARAMS, f"{key} is not valid hex")


class _AdmissionBatcher:
    """Coalesces concurrent broadcast_tx admissions into pipelined
    mempool.check_tx_batch calls.

    Under high-rate ingest, thousands of broadcast_tx requests are in
    flight at once and each serial check_tx pays its own shard-lock
    acquire, ABCI client lock, and event-loop hops. The batcher queues
    (tx, future) pairs and a single drain task admits them in
    tx_batch_size chunks — requests arriving while one batch's app call
    is in flight simply form the next batch, so the coalescing window
    is the natural pipeline depth, not a timer. Per-tx outcomes are
    identical to serial check_tx (dup/full errors come back as the
    exceptions check_tx would have raised)."""

    def __init__(self, mempool, max_batch: int = 64) -> None:
        self._mp = mempool
        self._max = max(1, max_batch)
        # drained every loop tick by _drain; its producers are requests,
        # already bounded by the connections' inflight caps
        self._queue: List[Tuple[bytes, asyncio.Future]] = []
        self._task: Optional[asyncio.Task] = None

    async def check_tx(self, tx: bytes):
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._queue.append((tx, fut))
        if self._task is None or self._task.done():
            self._task = asyncio.ensure_future(self._drain())
        return await fut

    async def _drain(self) -> None:
        # yield once so every admission scheduled this tick lands in
        # the first batch instead of a batch of one
        await asyncio.sleep(0)
        while self._queue:
            batch = self._queue[: self._max]
            del self._queue[: len(batch)]
            try:
                outs = await self._mp.check_tx_batch(
                    [tx for tx, _ in batch], TxInfo()
                )
            except Exception as e:
                for _, fut in batch:
                    if not fut.done():
                        fut.set_exception(e)
                continue
            for (_, fut), out in zip(batch, outs):
                if fut.done():
                    continue
                if isinstance(out, Exception):
                    fut.set_exception(out)
                else:
                    fut.set_result(out)


class Environment:
    """Node internals the RPC methods read (reference: env.go:58-100)."""

    def __init__(
        self,
        *,
        chain_id: str,
        block_store,
        state_store,
        mempool: Optional[Mempool] = None,
        event_bus: Optional[EventBus] = None,
        consensus=None,  # ConsensusState
        consensus_reactor=None,
        peer_manager=None,
        proxy=None,  # AppConns
        genesis: Optional[GenesisDoc] = None,
        evidence_pool=None,
        event_sinks: Optional[List[EventSink]] = None,
        node_info=None,
        privval_pub_key: Optional[PubKey] = None,
        cfg=None,
        metrics: Optional[RPCMetrics] = None,
    ) -> None:
        self.chain_id = chain_id
        self.block_store = block_store
        self.state_store = state_store
        self.mempool: Optional[Mempool] = mempool
        self.event_bus = event_bus
        self.consensus = consensus
        self.consensus_reactor = consensus_reactor
        self.peer_manager = peer_manager
        self.proxy = proxy
        self.genesis = genesis
        self.evidence_pool: Optional["EvidencePool"] = evidence_pool
        self.event_sinks = event_sinks or []
        self.node_info = node_info
        self.privval_pub_key = privval_pub_key
        self.cfg = cfg
        self.metrics = metrics if metrics is not None else RPCMetrics()
        # per-block serving cache (encoded LightBlock blobs and held
        # tx-proof trees); capacity 0 disables it (rpc/servingcache.py)
        self.serving_cache = ServingCache(
            block_store,
            state_store,
            capacity=(
                cfg.rpc.serving_cache_blocks
                if cfg is not None
                else DEFAULT_CAPACITY
            ),
            metrics=self.metrics,
        )
        self.logger = logging.getLogger(__name__)
        # ws client_id -> set of query strings (for unsubscribe_all)
        self._ws_subs: Dict[str, set] = {}
        self._genesis_chunks: Optional[List[bytes]] = None
        self._commit_waiters = 0  # uniquifies broadcast_tx_commit subs
        self._admission: Optional[_AdmissionBatcher] = None

    # -- route table (reference: routes.go:30-73) --

    def routes(self) -> Dict[str, Any]:
        r = {
            "health": self.health,
            "status": self.status,
            "net_info": self.net_info,
            "genesis": self.genesis_route,
            "genesis_chunked": self.genesis_chunked,
            "blockchain": self.blockchain,
            "header": self.header,
            "header_by_hash": self.header_by_hash,
            "block": self.block,
            "block_by_hash": self.block_by_hash,
            "block_results": self.block_results,
            "commit": self.commit,
            "validators": self.validators,
            "consensus_state": self.consensus_state,
            "dump_consensus_state": self.dump_consensus_state,
            "consensus_params": self.consensus_params,
            "unconfirmed_txs": self.unconfirmed_txs,
            "num_unconfirmed_txs": self.num_unconfirmed_txs,
            "broadcast_tx_sync": self.broadcast_tx_sync,
            "broadcast_tx_async": self.broadcast_tx_async,
            "broadcast_tx_commit": self.broadcast_tx_commit,
            "check_tx": self.check_tx,
            "remove_tx": self.remove_tx,
            "unsafe_flush_mempool": self.unsafe_flush_mempool,
            "abci_query": self.abci_query,
            "abci_info": self.abci_info,
            "broadcast_evidence": self.broadcast_evidence,
            "tx": self.tx,
            "tx_search": self.tx_search,
            "block_search": self.block_search,
            "light_block": self.light_block,
            "light_blocks": self.light_blocks,
            "tx_proofs": self.tx_proofs,
            "subscribe": self.subscribe,
            "unsubscribe": self.unsubscribe,
            "unsubscribe_all": self.unsubscribe_all,
        }
        return r

    # -- info routes --

    async def health(self, req: RPCRequest):
        return {}

    async def status(self, req: RPCRequest):
        """reference: internal/rpc/core/status.go:24."""
        latest_height = self.block_store.height()
        latest_meta = (
            self.block_store.load_block_meta(latest_height)
            if latest_height
            else None
        )
        sync_info = {
            "latest_block_hash": (
                latest_meta.block_id.hash.hex() if latest_meta else ""
            ),
            "latest_app_hash": (
                latest_meta.header.app_hash.hex() if latest_meta else ""
            ),
            "latest_block_height": latest_height,
            "latest_block_time": (
                latest_meta.header.time_ns if latest_meta else 0
            ),
            "earliest_block_height": self.block_store.base(),
            "catching_up": (
                self.consensus_reactor.wait_sync
                if self.consensus_reactor is not None
                else False
            ),
        }
        validator_info = {}
        if self.privval_pub_key is not None:
            addr = self.privval_pub_key.address()
            power = 0
            state = self.state_store.load()
            if state is not None:
                _, val = state.validators.get_by_address(addr)
                if val is not None:
                    power = val.voting_power
            validator_info = {
                "address": addr.hex(),
                "pub_key": self.privval_pub_key.bytes().hex(),
                "voting_power": power,
            }
        return {
            "node_info": encode(self.node_info) if self.node_info else {},
            "sync_info": sync_info,
            "validator_info": validator_info,
        }

    async def net_info(self, req: RPCRequest):
        """reference: internal/rpc/core/net.go:16."""
        peers = []
        if self.peer_manager is not None:
            for pid, addr in self.peer_manager.connected_peers():
                peers.append({"node_id": pid, "url": addr})
        return {
            "listening": True,
            "n_peers": len(peers),
            "peers": peers,
        }

    async def genesis_route(self, req: RPCRequest):
        if self.genesis is None:
            raise RPCError(INTERNAL_ERROR, "genesis not available")
        return {"genesis": json.loads(self.genesis.to_json())}

    async def genesis_chunked(self, req: RPCRequest):
        """reference: env.go InitGenesisChunks + net.go GenesisChunked."""
        if self.genesis is None:
            raise RPCError(INTERNAL_ERROR, "genesis not available")
        if self._genesis_chunks is None:
            data = self.genesis.to_json().encode()
            self._genesis_chunks = [
                data[i : i + GENESIS_CHUNK_SIZE]
                for i in range(0, len(data), GENESIS_CHUNK_SIZE)
            ] or [b""]
        chunks = self._genesis_chunks
        chunk = int(req.params.get("chunk", 0))
        if not 0 <= chunk < len(chunks):
            raise RPCError(
                INVALID_PARAMS,
                f"chunk {chunk} out of range (total {len(chunks)})",
            )
        return {
            "chunk": chunk,
            "total": len(chunks),
            "data": _b64(chunks[chunk]),
        }

    # -- block routes (reference: internal/rpc/core/blocks.go) --

    def _height_param(
        self, params: Dict[str, Any], default_latest: bool = True
    ) -> int:
        h = params.get("height")
        if h is None:
            if not default_latest:
                raise RPCError(INVALID_PARAMS, "missing height param")
            return self.block_store.height()
        height = int(h)
        base = self.block_store.base()
        top = self.block_store.height()
        if height < base or height > top:
            raise RPCError(
                INVALID_PARAMS,
                f"height {height} not available (base {base}, height {top})",
            )
        return height

    async def blockchain(self, req: RPCRequest):
        """Block metas in [min_height, max_height], newest first
        (reference: blocks.go:26 BlockchainInfo, 20-block page)."""
        top = self.block_store.height()
        base = self.block_store.base()
        max_h = min(int(req.params.get("max_height", top) or top), top)
        min_h = max(int(req.params.get("min_height", base) or base), base)
        min_h = max(min_h, max_h - 19)
        metas = []
        # descending page, count explicitly capped at 20: both bounds
        # are client-chosen ints, so the loop bound must be a clamp
        # expression, not a subtraction of two attacker values
        for off in range(min(max_h - min_h + 1, 20)):
            m = self.block_store.load_block_meta(max_h - off)
            if m is not None:
                metas.append(encode(m))
        return {
            "last_height": top,
            "block_metas": metas,
        }

    async def header(self, req: RPCRequest):
        height = self._height_param(req.params)
        meta = self.block_store.load_block_meta(height)
        if meta is None:
            raise RPCError(INVALID_PARAMS, f"no header at height {height}")
        return {"header": encode(meta.header)}

    async def header_by_hash(self, req: RPCRequest):
        h = _decode_hash_param(req.params)
        meta = self.block_store.load_block_meta_by_hash(h)
        if meta is None:
            return {"header": None}
        return {"header": encode(meta.header)}

    async def block(self, req: RPCRequest):
        height = self._height_param(req.params)
        block = self.block_store.load_block(height)
        meta = self.block_store.load_block_meta(height)
        if block is None or meta is None:
            raise RPCError(INVALID_PARAMS, f"no block at height {height}")
        return {
            "block_id": encode(meta.block_id),
            "block": encode(block),
        }

    async def block_by_hash(self, req: RPCRequest):
        h = _decode_hash_param(req.params)
        block = self.block_store.load_block_by_hash(h)
        if block is None:
            return {"block_id": None, "block": None}
        meta = self.block_store.load_block_meta(block.header.height)
        return {
            "block_id": encode(meta.block_id) if meta else None,
            "block": encode(block),
        }

    async def block_results(self, req: RPCRequest):
        """reference: blocks.go:148 BlockResults."""
        height = self._height_param(req.params)
        resp = self.state_store.load_abci_responses(height)
        if resp is None:
            raise RPCError(
                INVALID_PARAMS, f"no results for height {height}"
            )
        val_updates = resp.end_block_obj.validator_updates if (
            resp.end_block_obj is not None
        ) else []
        return {
            "height": height,
            "txs_results": [encode(r) for r in resp.deliver_tx_objs],
            "begin_block_events": (
                [encode(e) for e in resp.begin_block_obj.events]
                if resp.begin_block_obj is not None
                else []
            ),
            "end_block_events": (
                [encode(e) for e in resp.end_block_obj.events]
                if resp.end_block_obj is not None
                else []
            ),
            "validator_updates": [encode(v) for v in val_updates],
            "consensus_param_updates": (
                encode(resp.end_block_obj.consensus_param_updates)
                if resp.end_block_obj is not None
                else None
            ),
        }

    async def commit(self, req: RPCRequest):
        height = self._height_param(req.params)
        meta = self.block_store.load_block_meta(height)
        if meta is None:
            raise RPCError(INVALID_PARAMS, f"no block at height {height}")
        commit = self.block_store.load_block_commit(height)
        canonical = commit is not None
        if commit is None and height == self.block_store.height():
            commit = self.block_store.load_seen_commit()
        return {
            "signed_header": {
                "header": encode(meta.header),
                "commit": encode(commit) if commit else None,
            },
            "canonical": canonical,
        }

    async def validators(self, req: RPCRequest):
        """reference: consensus.go:21 Validators (paginated)."""
        height = self._height_param(req.params)
        vals = self.state_store.load_validators(height)
        if vals is None:
            raise RPCError(
                INVALID_PARAMS, f"no validator set at height {height}"
            )
        page = int(req.params.get("page", 1))
        per_page = min(int(req.params.get("per_page", 30)), 100)
        total = vals.size()
        start = (page - 1) * per_page
        if start < 0 or (start >= total and total > 0):
            raise RPCError(INVALID_PARAMS, f"page {page} out of range")
        sel = vals.validators[start : start + per_page]
        return {
            "block_height": height,
            "validators": [encode(v) for v in sel],
            "count": len(sel),
            "total": total,
        }

    async def consensus_params(self, req: RPCRequest):
        height = self._height_param(req.params)
        params = self.state_store.load_params(height)
        if params is None:
            state = self.state_store.load()
            params = state.consensus_params if state else None
        return {
            "block_height": height,
            "consensus_params": encode(params) if params else None,
        }

    async def consensus_state(self, req: RPCRequest):
        """Round-state summary (reference: consensus.go:66)."""
        if self.consensus is None:
            raise RPCError(INTERNAL_ERROR, "consensus not available")
        rs = self.consensus.get_round_state()
        return {
            "round_state": {
                "height": rs.height,
                "round": rs.round,
                "step": int(rs.step),
                "start_time": rs.start_time_ns,
                "proposal_block_hash": (
                    rs.proposal_block.hash().hex()
                    if rs.proposal_block is not None
                    else ""
                ),
                "locked_block_hash": (
                    rs.locked_block.hash().hex()
                    if rs.locked_block is not None
                    else ""
                ),
                "valid_block_hash": (
                    rs.valid_block.hash().hex()
                    if rs.valid_block is not None
                    else ""
                ),
            }
        }

    async def dump_consensus_state(self, req: RPCRequest):
        """Full round state incl. vote sets (reference: consensus.go:36)."""
        if self.consensus is None:
            raise RPCError(INTERNAL_ERROR, "consensus not available")
        rs = self.consensus.get_round_state()
        votes = []
        if rs.votes is not None:
            for r in range(rs.round + 1):
                prevotes = rs.votes.prevotes(r)
                precommits = rs.votes.precommits(r)
                votes.append(
                    {
                        "round": r,
                        "prevotes": (
                            str(prevotes) if prevotes is not None else ""
                        ),
                        "precommits": (
                            str(precommits)
                            if precommits is not None
                            else ""
                        ),
                    }
                )
        return {
            "round_state": {
                "height": rs.height,
                "round": rs.round,
                "step": int(rs.step),
                "validators": encode(rs.validators),
                "proposal": encode(rs.proposal),
                "locked_round": rs.locked_round,
                "valid_round": rs.valid_round,
                "votes": votes,
                "commit_round": rs.commit_round,
            }
        }

    # -- mempool routes (reference: internal/rpc/core/mempool.go) --

    def _require_mempool(self) -> Mempool:
        if self.mempool is None:
            raise RPCError(INTERNAL_ERROR, "mempool not available")
        return self.mempool

    def _admit_tx(self, tx: bytes):
        """Awaitable CheckTx admission through the coalescing batcher
        when the mempool supports batch admission; serial otherwise
        (custom Mempool implementations keep working)."""
        mp = self._require_mempool()
        if not hasattr(mp, "check_tx_batch"):
            # a tx is opaque app bytes: CheckTx is its validation
            return mp.check_tx(tx, TxInfo())
        if self._admission is None or self._admission._mp is not mp:
            self._admission = _AdmissionBatcher(
                mp,
                max_batch=getattr(
                    getattr(mp, "cfg", None), "tx_batch_size", 64
                ),
            )
        return self._admission.check_tx(tx)

    async def broadcast_tx_async(self, req: RPCRequest):
        """Fire-and-forget (reference: mempool.go:22)."""
        self._require_mempool()
        tx = _decode_tx_param(req.params)

        async def _check():
            try:
                await self._admit_tx(tx)
            except MempoolError as e:
                self.logger.info("async tx rejected err=%s", e)

        asyncio.ensure_future(_check())
        return {"hash": tx_hash(tx).hex()}

    async def broadcast_tx_sync(self, req: RPCRequest):
        """Wait for CheckTx result (reference: mempool.go:38)."""
        tx = _decode_tx_param(req.params)
        try:
            res = await self._admit_tx(tx)
        except MempoolError as e:
            raise RPCError(INTERNAL_ERROR, f"tx rejected: {e}")
        return {
            "code": res.code,
            "data": _b64(res.data),
            "log": res.log,
            "codespace": res.codespace,
            "hash": tx_hash(tx).hex(),
        }

    async def check_tx(self, req: RPCRequest):
        """CheckTx against the query connection without adding to the
        pool (reference: mempool.go:135)."""
        if self.proxy is None:
            raise RPCError(INTERNAL_ERROR, "proxy app not available")
        from ..abci import types as abci

        tx = _decode_tx_param(req.params)
        res = await self.proxy.query.check_tx(abci.RequestCheckTx(tx=tx))
        return encode(res)

    async def remove_tx(self, req: RPCRequest):
        """reference: mempool.go:149 (by tx key = sha256 of tx)."""
        mp = self._require_mempool()
        key = _decode_hash_param(req.params, "tx_key")
        mp.remove_tx_by_key(key)
        return {}

    async def broadcast_tx_commit(self, req: RPCRequest):
        """Subscribe to the tx event, CheckTx, then wait for delivery in
        a block (reference: mempool.go:58-129)."""
        self._require_mempool()
        if self.event_bus is None:
            raise RPCError(INTERNAL_ERROR, "event bus not available")
        tx = _decode_tx_param(req.params)
        txh = tx_hash(tx)
        query = (
            f"{tme.EVENT_TYPE_KEY}='{tme.EventValue.TX}'"
            f" AND {tme.TX_HASH_KEY}='{txh.hex().upper()}'"
        )
        # unique per request: concurrent submissions of the SAME tx must
        # not collide on the (client_id, query) subscription key
        self._commit_waiters += 1
        client_id = (
            f"broadcast_tx_commit-{txh.hex()[:16]}-{self._commit_waiters}"
        )
        try:
            sub = self.event_bus.subscribe(client_id, query, limit=1)
        except SubscriptionError as e:
            raise RPCError(INTERNAL_ERROR, str(e))
        try:
            try:
                check = await self._admit_tx(tx)
            except MempoolError as e:
                raise RPCError(INTERNAL_ERROR, f"tx rejected: {e}")
            result: Dict[str, Any] = {
                "check_tx": encode(check),
                "hash": txh.hex(),
                "height": 0,
                "deliver_tx": None,
            }
            if check.code != 0:
                return result
            timeout = (
                self.cfg.rpc.timeout_broadcast_tx_commit
                if self.cfg is not None
                else 10.0
            )
            try:
                msg = await asyncio.wait_for(sub.next(), timeout)
            except asyncio.TimeoutError:
                raise RPCError(
                    INTERNAL_ERROR,
                    "timed out waiting for tx to be included in a block",
                )
            ev: tme.EventDataTx = msg.data
            result["height"] = ev.height
            result["deliver_tx"] = encode(ev.result)
            return result
        finally:
            self.event_bus.unsubscribe_all(client_id)

    async def unconfirmed_txs(self, req: RPCRequest):
        """reference: mempool.go:160."""
        mp = self._require_mempool()
        limit = int(req.params.get("limit", 30))
        txs = mp.reap_max_txs(limit)
        return {
            "n_txs": len(txs),
            "total": mp.size(),
            "total_bytes": mp.size_bytes(),
            "txs": [_b64(tx) for tx in txs],
        }

    async def num_unconfirmed_txs(self, req: RPCRequest):
        mp = self._require_mempool()
        return {
            "n_txs": mp.size(),
            "total": mp.size(),
            "total_bytes": mp.size_bytes(),
        }

    async def unsafe_flush_mempool(self, req: RPCRequest):
        mp = self._require_mempool()
        mp.flush()
        return {}

    # -- ABCI passthrough (reference: internal/rpc/core/abci.go) --

    async def abci_query(self, req: RPCRequest):
        if self.proxy is None:
            raise RPCError(INTERNAL_ERROR, "proxy app not available")
        from ..abci import types as abci

        data = req.params.get("data", "")
        if not isinstance(data, str):
            raise RPCError(INVALID_PARAMS, "data must be a hex string")
        try:
            data_b = bytes.fromhex(data)
        except ValueError:
            raise RPCError(INVALID_PARAMS, "data is not valid hex")
        res = await self.proxy.query.query(
            abci.RequestQuery(
                data=data_b,
                path=req.params.get("path", ""),
                height=int(req.params.get("height", 0)),
                prove=bool(req.params.get("prove", False)),
            )
        )
        return {"response": encode(res)}

    async def abci_info(self, req: RPCRequest):
        if self.proxy is None:
            raise RPCError(INTERNAL_ERROR, "proxy app not available")
        from ..abci import types as abci

        res = await self.proxy.query.info(abci.RequestInfo())
        return {"response": encode(res)}

    # -- evidence (reference: internal/rpc/core/evidence.go) --

    async def broadcast_evidence(self, req: RPCRequest):
        if self.evidence_pool is None:
            raise RPCError(INTERNAL_ERROR, "evidence pool not available")
        from ..types.evidence import evidence_from_proto

        raw = req.params.get("evidence")
        if not isinstance(raw, str):
            raise RPCError(
                INVALID_PARAMS, "missing evidence param (hex proto)"
            )
        try:
            ev = evidence_from_proto(bytes.fromhex(raw))
            # basic shape checks before the pool is touched; decoding
            # and validate_basic make no device call, so the JAX
            # package's catch stays
            ev.validate_basic()
        except Exception as e:
            raise RPCError(INVALID_PARAMS, f"invalid evidence: {e}")
        try:
            self.evidence_pool.add_evidence(ev)
        except CHECK_ERRORS as e:
            # only a verdict on the evidence; anything else (a failed
            # launch) raises to the dispatcher (module docstring)
            raise RPCError(INTERNAL_ERROR, f"evidence rejected: {e}")
        return {"hash": ev.hash().hex()}

    # -- tx / block search (reference: internal/rpc/core/tx.go,
    #    blocks.go:244 BlockSearch) --

    def _search_sink(self) -> EventSink:
        """First search-capable sink. The reference only serves search
        from its kv sink (the psql sink defers to raw SQL,
        indexer/sink/psql/psql.go:238-256); our SQL sink answers the
        read surface too, so any sink except Null qualifies."""
        for s in self.event_sinks:
            if s.type() in ("kv", "psql"):
                return s
        raise RPCError(
            INTERNAL_ERROR,
            "tx indexing is disabled (no search-capable sink)",
        )

    async def tx(self, req: RPCRequest):
        sink = self._search_sink()
        h = _decode_hash_param(req.params)
        res = sink.get_tx_by_hash(h)
        if res is None:
            raise RPCError(INVALID_PARAMS, f"tx {h.hex()} not found")
        return {
            "hash": h.hex(),
            "height": res.height,
            "index": res.index,
            "tx_result": encode(res.result),
            "tx": _b64(res.tx),
        }

    async def tx_search(self, req: RPCRequest):
        sink = self._search_sink()
        query = req.params.get("query")
        if not isinstance(query, str):
            raise RPCError(INVALID_PARAMS, "missing query param")
        results = sink.search_tx_events(query)
        if bool(req.params.get("order_by") == "desc"):
            results = list(reversed(results))
        page = int(req.params.get("page", 1))
        per_page = min(int(req.params.get("per_page", 30)), 100)
        start = (page - 1) * per_page
        sel = results[start : start + per_page]
        return {
            "txs": [
                {
                    "hash": tx_hash(r.tx).hex(),
                    "height": r.height,
                    "index": r.index,
                    "tx_result": encode(r.result),
                    "tx": _b64(r.tx),
                }
                for r in sel
            ],
            "total_count": len(results),
        }

    async def block_search(self, req: RPCRequest):
        sink = self._search_sink()
        query = req.params.get("query")
        if not isinstance(query, str):
            raise RPCError(INVALID_PARAMS, "missing query param")
        heights = sink.search_block_events(query)
        if req.params.get("order_by") == "desc":
            heights = list(reversed(heights))
        page = int(req.params.get("page", 1))
        per_page = min(int(req.params.get("per_page", 30)), 100)
        start = (page - 1) * per_page
        sel = heights[start : start + per_page]
        blocks = []
        for h in sel:
            meta = self.block_store.load_block_meta(h)
            block = self.block_store.load_block(h)
            if meta is not None and block is not None:
                blocks.append(
                    {
                        "block_id": encode(meta.block_id),
                        "block": encode(block),
                    }
                )
        return {"blocks": blocks, "total_count": len(heights)}

    async def light_block(self, req: RPCRequest):
        """SignedHeader + ValidatorSet as proto hex — the light
        client's HTTP provider surface (reference: light/provider/http
        assembles the same from /commit + /validators; one proto blob
        round-trips exactly). Served from the per-block blob cache:
        the encode is paid once per block, not per request."""
        height = self._height_param(req.params)
        blob = self.serving_cache.encoded_light_block(height)
        if blob is None:
            raise RPCError(
                INVALID_PARAMS, f"no light block at height {height}"
            )
        return {"height": height, "light_block": blob.hex()}

    async def light_blocks(self, req: RPCRequest):
        """Bulk stateless serving: consecutive LightBlocks for
        [min_height, max_height] ascending, as one proto-hex
        LightBlocksResponse page. The page is hard-clamped at
        LIGHT_BLOCKS_PAGE_CAP server-side (an optional `max_blocks`
        param may shrink it, never grow it); a height whose parts are
        missing ends the page — a bulk reply never has gaps, so
        bisecting clients can trust consecutive heights. `last_height`
        carries the store tip so a clamped client knows whether to ask
        for the next page (framework route; the reference serves this
        shape one height at a time via /commit + /validators)."""
        top = self.block_store.height()
        base = self.block_store.base()
        max_h = min(int(req.params.get("max_height", top) or top), top)
        min_h = max(int(req.params.get("min_height", base) or base), base)
        cap = LIGHT_BLOCKS_PAGE_CAP
        max_blocks = int(req.params.get("max_blocks", 0) or 0)
        if 0 < max_blocks < cap:
            cap = max_blocks
        # ascending page, count explicitly capped: both bounds are
        # client-chosen ints, so the loop bound is a clamp, not a
        # subtraction of two client values. The page wraps per-block
        # cached `LightBlock.to_proto()` blobs, byte-equal to
        # LightBlocksResponse.to_proto
        w = ProtoWriter()
        count = 0
        for off in range(min(max_h - min_h + 1, cap)):
            blob = self.serving_cache.encoded_light_block(min_h + off)
            if blob is None:
                break
            w.message(1, blob)
            count += 1
        w.int(2, top)
        self.metrics.light_blocks_requests.inc()
        self.metrics.light_blocks_batch_size.observe(count)
        return {
            "count": count,
            "last_height": top,
            "light_blocks": w.finish().hex(),
        }

    async def tx_proofs(self, req: RPCRequest):
        """Merkle inclusion proofs for transactions of one block,
        served from the held per-block MerkleMultiTree: aunt
        gathering per request, the tree built once per block.
        Params: height (as everywhere), `indices` = list of tx indexes
        (server-clamped at TX_PROOFS_CAP; shrink-only like the
        light_blocks page). Proofs verify against `header.data_hash`
        (root == types/tx.txs_hash), so a stateless client needs only
        a verified header to check them (framework route; the
        reference serves per-tx proofs via /tx?prove=true)."""
        height = self._height_param(req.params)
        raw = req.params.get("indices")
        if not isinstance(raw, list):
            raise RPCError(
                INVALID_PARAMS, "indices must be a list of ints"
            )
        # clamp BEFORE validating: even the type scan must not cost
        # more than the serving bound (excess indices are dropped —
        # shrink-only, like the light_blocks page)
        raw = raw[:TX_PROOFS_CAP]
        if not all(
            isinstance(i, int) and not isinstance(i, bool) for i in raw
        ):
            raise RPCError(
                INVALID_PARAMS, "indices must be a list of ints"
            )
        tree = self.serving_cache.tx_tree(height)
        if tree is None:
            raise RPCError(INVALID_PARAMS, f"no block at height {height}")
        try:
            # OverflowError too: an index past int64 fails inside
            # numpy's asarray, and it is client input, not a server
            # fault
            proofs = tree.proofs(raw)
        except (ValueError, OverflowError) as e:
            raise RPCError(INVALID_PARAMS, str(e))
        self.metrics.tx_proofs_requests.inc()
        return {
            "height": height,
            "total": tree.total,
            "root": tree.root.hex(),
            "proofs": [p.to_proto_bytes().hex() for p in proofs],
        }

    # -- subscriptions (websocket only; reference: events.go) --

    _MAX_SUBS_PER_CLIENT = 5

    async def subscribe(self, req: RPCRequest):
        if req.ws is None:
            raise RPCError(
                INVALID_PARAMS, "subscribe requires a websocket connection"
            )
        if self.event_bus is None:
            raise RPCError(INTERNAL_ERROR, "event bus not available")
        query = req.params.get("query")
        if not isinstance(query, str):
            raise RPCError(INVALID_PARAMS, "missing query param")
        ws = req.ws
        # register cleanup BEFORE anything can fail: a client whose only
        # subscribe attempts error out must still be swept on disconnect
        if ws.on_close is None:
            ws.on_close = self._ws_disconnected
        limit = (
            self.cfg.rpc.max_subscriptions_per_client
            if self.cfg is not None
            else self._MAX_SUBS_PER_CLIENT
        )
        subs = self._ws_subs.setdefault(ws.client_id, set())
        if len(subs) >= limit:
            raise RPCError(
                INTERNAL_ERROR, "too many subscriptions for this client"
            )
        if query in subs:
            raise RPCError(INVALID_PARAMS, "already subscribed to query")
        try:
            sub = self.event_bus.subscribe(ws.client_id, query, limit=100)
        except SubscriptionError as e:
            raise RPCError(INTERNAL_ERROR, str(e))
        except ValueError as e:
            raise RPCError(INVALID_PARAMS, f"invalid query: {e}")
        subs.add(query)
        asyncio.ensure_future(self._pump_events(ws, sub, query, req.req_id))
        return {}

    @staticmethod
    def _notification_text(msg, query: str, req_id) -> str:
        """One JSON-RPC notification frame as text.

        The expensive part, encode() of the event payload (a full
        block for NewBlock) and its json.dumps, is computed once per
        published Message and kept on it, so the subscribers sharing a
        Message each pay only a req_id and query splice.
        """
        body = getattr(msg, "_rpc_body", None)
        if body is None:
            body = json.dumps(
                {
                    "data": {
                        "type": type(msg.data).__name__,
                        "value": encode(msg.data),
                    },
                    "events": encode(msg.events),
                }
            )[1:-1]  # strip the braces: '"data": ..., "events": ...'
            # cache on the (frozen) Message: a cache write, not a
            # semantic mutation — every reader derives the same bytes
            object.__setattr__(msg, "_rpc_body", body)
        return '{"jsonrpc": "2.0", "id": %s, "result": {"query": %s, %s}}' % (
            json.dumps(req_id),
            json.dumps(query),
            body,
        )

    async def _pump_events(self, ws, sub, query: str, req_id) -> None:
        """Forward matching events as JSON-RPC notifications until the
        subscription dies or the socket closes (reference:
        events.go:50-85)."""
        try:
            while not ws.closed.is_set():
                msg = await sub.next()
                await ws.send_text(
                    self._notification_text(msg, query, req_id)
                )
        except SubscriptionError as e:
            # a subscriber dropped for lagging (queue overflow) is told
            # WHY its feed died — a fleet client (and the load harness)
            # must distinguish "no events matched" from "you were shed"
            # (clean unsubscribes stay silent: the client asked)
            if str(e) == ERR_TERMINATED and not ws.closed.is_set():
                await ws.send_json(
                    {
                        "jsonrpc": "2.0",
                        "id": req_id,
                        "error": RPCError(
                            INTERNAL_ERROR,
                            ERR_TERMINATED,
                            data=query,
                        ).to_obj(),
                    }
                )
            self._ws_subs.get(ws.client_id, set()).discard(query)
        except asyncio.CancelledError:
            pass

    async def unsubscribe(self, req: RPCRequest):
        if req.ws is None or self.event_bus is None:
            raise RPCError(
                INVALID_PARAMS, "unsubscribe requires a websocket connection"
            )
        query = req.params.get("query")
        if not isinstance(query, str):
            raise RPCError(INVALID_PARAMS, "missing query param")
        try:
            self.event_bus.unsubscribe(req.ws.client_id, query)
        except SubscriptionError:
            raise RPCError(INVALID_PARAMS, "subscription not found")
        self._ws_subs.get(req.ws.client_id, set()).discard(query)
        return {}

    async def unsubscribe_all(self, req: RPCRequest):
        if req.ws is None or self.event_bus is None:
            raise RPCError(
                INVALID_PARAMS,
                "unsubscribe_all requires a websocket connection",
            )
        try:
            self.event_bus.unsubscribe_all(req.ws.client_id)
        except SubscriptionError:
            pass  # idempotent: no subscriptions is fine
        self._ws_subs.pop(req.ws.client_id, None)
        return {}

    def _ws_disconnected(self, ws) -> None:
        if self.event_bus is not None:
            try:
                self.event_bus.unsubscribe_all(ws.client_id)
            except SubscriptionError:
                pass  # client already unsubscribed everything
        self._ws_subs.pop(ws.client_id, None)
