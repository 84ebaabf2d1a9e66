"""The port's pubsub, query language and event bus held against the JAX
package's.

A seeded corpus of queries (every operator, conjunctions, numbers,
strings, missing tags) over a seeded corpus of tag maps gives the same
match matrix in both packages, and the same QuerySyntaxError messages
for malformed queries. The pubsub server's fan-out, unsubscribe, overflow
termination and duplicate refusal give the same deliveries and errors.
Block execution with an event bus (state/execution.py _fire_events) and
the step machine's events publish the same events with the same tags:
a kvstore chain applied by both packages' BlockExecutor, and a height
of the consensus harness driven through both packages' ConsensusState,
each subscriber seeing the same (event, tags) sequence. Tolerance: zero.
"""

import asyncio

import numpy as np
import pytest

from tendermint_tpu.abci.client import LocalClient as JaxLocalClient
from tendermint_tpu.abci.kvstore import KVStoreApplication as JaxKVStore
from tendermint_tpu.crypto import sigcache as jax_sigcache
from tendermint_tpu.eventbus import EventBus as JaxEventBus
from tendermint_tpu.libs.metrics import Registry
from tendermint_tpu.mempool.nop import NopMempool as JaxNopMempool
from tendermint_tpu.pubsub import Server as JaxServer
from tendermint_tpu.pubsub import SubscriptionError as JaxSubscriptionError
from tendermint_tpu.pubsub.query import compile_query as jax_compile_query
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
from tendermint_tpu_torch import workloads
from tendermint_tpu_torch.eventbus import EventBus
from tendermint_tpu_torch.pubsub import Server, SubscriptionError
from tendermint_tpu_torch.pubsub.query import compile_query, query_for_event
from tendermint_tpu_torch.types import events as E

from .test_torch_isolation import jax_device_plane_paused  # noqa: F401 (autouse)

CHAIN_ID = "torch-bus-chain"
SEED = 61
TAGS = ("tm.event", "tx.height", "tx.hash", "app.key", "app.creator", "block.height")


def run(coro):
    return asyncio.run(coro)


def _outcome(fn):
    try:
        return "ok", fn()
    except Exception as e:  # the outcome compared IS the exception
        return type(e).__name__, str(e)


def _corpus(seed: int):
    """(queries, tag maps) from the seed."""
    rng = np.random.default_rng(seed)
    words = ["Tx", "NewBlock", "kvstore", "k1", "particle", "12", "-3", "4.5", "abc", ""]
    maps = []
    for _ in range(40):
        tags = {}
        for tag in TAGS:
            if rng.integers(3):
                tags[tag] = [str(rng.choice(words)) for _ in range(int(rng.integers(1, 3)))]
        maps.append(tags)
    queries = []
    for _ in range(60):
        conds = []
        for _ in range(int(rng.integers(1, 4))):
            tag = str(rng.choice(TAGS))
            op = str(rng.choice(["=", "<", "<=", ">", ">=", "CONTAINS", "EXISTS", "=s"]))
            if op == "EXISTS":
                conds.append(f"{tag} EXISTS")
            elif op in ("CONTAINS", "=s"):
                conds.append(f"{tag} {'CONTAINS' if op == 'CONTAINS' else '='} '{rng.choice(words)}'")
            else:
                conds.append(f"{tag} {op} {rng.choice(['5', '12', '-3', '4.5', '0'])}")
        queries.append(" AND ".join(conds))
    return queries, maps


@pytest.mark.parametrize("seed", range(3))
def test_query_matches_equal_jax_on_a_seeded_corpus(seed):
    queries, maps = _corpus(SEED + seed)
    hits = 0
    for src in queries:
        q, jq = compile_query(src), jax_compile_query(src)
        assert str(q) == str(jq) == src
        row = [q.matches(t) for t in maps]
        assert row == [jq.matches(t) for t in maps], src
        hits += sum(row)
    assert 0 < hits < len(queries) * len(maps)


@pytest.mark.parametrize(
    "bad",
    ["", "tm.event", "tm.event =", "= 'Tx'", "tm.event = 'Tx' AND", "tm.event < 'Tx'",
     "tm.event CONTAINS 5", "a.b = 1 OR c.d = 2", "tm.event = 'Tx' tx.height = 5", "x ~ 1"],
)
def test_query_syntax_errors_equal_jax(bad):
    got, want = _outcome(lambda: compile_query(bad)), _outcome(lambda: jax_compile_query(bad))
    assert got == want and got[0] == "QuerySyntaxError"


def _server_script(server_cls, error_cls):
    """Subscriptions, publishes, an overflow, unsubscribes: what each
    subscriber receives and what raises."""

    async def go():
        s = server_cls()
        await s.start()
        log = []
        a = s.subscribe("a", "tm.event = 'Tx'", limit=3)
        b = s.subscribe("b", "tm.event = 'Tx' AND tx.height > 2")
        c = s.subscribe("c", "app.key EXISTS", limit=1)
        log.append(_outcome(lambda: s.subscribe("a", "tm.event = 'Tx'")))
        for h in range(1, 5):
            log.append(s.publish({"h": h}, {"tm.event": ["Tx"], "tx.height": [str(h)], "app.key": ["k"]}))
        log.append((s.num_clients(), s.num_subscriptions(), s.max_queue_depth()))
        for sub in (a, b, c):
            got = []
            while True:
                try:
                    got.append(sub._queue.get_nowait())
                except asyncio.QueueEmpty:
                    break
            log.append([m.data["h"] if hasattr(m, "data") else None for m in got])
        log.append(_outcome(lambda: s.unsubscribe("c", "app.key EXISTS")))
        s.unsubscribe("b", "tm.event = 'Tx' AND tx.height > 2")
        log.append(_outcome(lambda: s.unsubscribe_all("b")))
        # a overflowed at its fourth message: already dropped
        log.append(_outcome(lambda: s.unsubscribe_all("a")))
        log.append((s.num_clients(), s.num_subscriptions()))
        try:
            await a.next()
        except error_cls as e:
            log.append(("terminated", str(e)))
        await s.stop()
        return log

    return run(go())


def test_pubsub_server_equal_jax():
    got = _server_script(Server, SubscriptionError)
    assert got == _server_script(JaxServer, JaxSubscriptionError)
    assert got[-1] == ("terminated", "subscription terminated: queue overflow")


# -- events of block execution and of the step machine --

QUERIES = (
    query_for_event(E.EventValue.NEW_BLOCK),
    query_for_event(E.EventValue.NEW_BLOCK_HEADER),
    query_for_event(E.EventValue.TX),
    "tm.event = 'Tx' AND tx.height = 2",
    query_for_event(E.EventValue.NEW_ROUND_STEP),
    query_for_event(E.EventValue.NEW_ROUND),
    query_for_event(E.EventValue.COMPLETE_PROPOSAL),
    query_for_event(E.EventValue.VOTE),
    query_for_event(E.EventValue.POLKA),
    query_for_event(E.EventValue.LOCK),
    query_for_event(E.EventValue.VALID_BLOCK),
)


def _drain(subs) -> list:
    """Each subscription's messages: their tags, and the height of the
    data where it has one."""
    out = []
    for sub in subs:
        got = []
        while not sub._queue.empty():
            m = sub._queue.get_nowait()
            height = getattr(m.data, "height", None)
            if height is None and hasattr(m.data, "header"):
                height = m.data.header.height
            if height is None and hasattr(m.data, "vote"):
                height = (m.data.vote.height, m.data.vote.type, m.data.vote.validator_index)
            got.append((sorted(m.events.items()), height))
        out.append(got)
    return out


def test_block_execution_events_equal_jax():
    """A 4-validator kvstore chain applied with an event bus in both
    packages: NewBlock, NewBlockHeader and every Tx (with tx.hash and
    tx.height) reach the same subscribers with the same tags."""
    privs = workloads.seeded_keys(4, SEED)
    genesis = workloads.kv_genesis(CHAIN_ID, privs)
    txs = [workloads.kv_txs(SEED, h, 4, (40, 70)) for h in (1, 2, 3)]
    chain = workloads.build_block_chain(genesis, privs, txs, SEED)
    out = {}
    for pkg in ("port", "jax"):
        async def go():
            if pkg == "port":
                bus = EventBus()
                node = workloads.block_exec_node(genesis)
                node.executor.event_bus = bus
                executor, state, save = node.executor, node.state, node.block_store.save_block
                blocks = [(cb.block, cb.parts, cb.seen_commit, cb.block_id) for cb in chain]
            else:
                bus = JaxEventBus()
                state = jax_state_from_genesis(JaxGenesisDoc.from_json(genesis))
                ss, bs = JaxStateStore(JaxMemKV()), JaxBlockStore(JaxMemKV())
                ss.save(state)
                executor = JaxBlockExecutor(ss, JaxLocalClient(JaxKVStore()), JaxNopMempool(),
                                            block_store=bs, event_bus=bus,
                                            metrics=StateMetrics(Registry()))
                save = bs.save_block
                blocks = []
                for cb in chain:
                    b = JaxBlock.from_proto(cb.block.to_proto())
                    blocks.append((b, b.make_part_set(), JaxCommit.from_proto(cb.seen_commit.to_proto()),
                                   JaxBlockID.from_proto(cb.block_id.to_proto())))
            await bus.start()
            subs = [bus.subscribe(f"c{i}", q, limit=1000) for i, q in enumerate(QUERIES)]
            with jax_sigcache.disabled():
                for block, parts, seen, bid in blocks:
                    save(block, parts, seen)
                    state = await executor.apply_block(state, bid, block)
            got = _drain(subs)
            await bus.stop()
            return got

        out[pkg] = run(go())
    assert out["port"] == out["jax"]
    assert [len(x) for x in out["port"][:4]] == [3, 3, sum(map(len, txs)), len(txs[1])]


def test_step_machine_events_equal_jax(tmp_path):
    """Two heights of the consensus harness through both packages'
    step machines, each with an event bus: the same round steps, new
    rounds, complete proposals, votes, polkas, locks and blocks, with
    the same tags, in the same order."""
    import tests.test_torch_consensus_state as CS

    genesis, privs, node_priv, chain = CS._chain(4, 0, 2)
    out = {}
    for node in CS.both_nodes(genesis, node_priv, tmp_path, "bus"):
        step = CS.Step(node)

        async def go():
            await node.event_bus.start()
            subs = [node.event_bus.subscribe(f"c{i}", q, limit=1000) for i, q in enumerate(QUERIES)]
            with workloads.pinned_clock(lambda: node.cs.rs.height):
                await step.start()
                for ch in chain:
                    await CS.feed(step, ch)
                await step.stop()
            got = _drain(subs)
            await node.event_bus.stop()
            return got

        with jax_sigcache.disabled():
            out[node.msgs is CS.port_msgs] = run(go())
        node.close()
    assert out[True] == out[False]
    steps, votes = out[True][4], out[True][7]
    # propose, prevote, precommit, commit at heights 1 and 2; propose at 3
    assert len(steps) == 9 and len(votes) == 16
