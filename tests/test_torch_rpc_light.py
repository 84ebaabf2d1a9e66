"""The port's light client over HTTP, and the evidence route, against the
JAX package's, on the CPU.

HTTPProvider pages past the server's clamp and refuses hostile pages as
the JAX provider does (tests/test_stateless_bulk.py:429-476, on scripted
pages). A seeded kvstore chain past two pages (workloads.serve_chain,
replayed by a JAX BlockExecutor; tests/test_torch_rpc.py) is served by
each package's RPCServer on 127.0.0.1:0, and each package's sequential
light client syncs it over its own HTTPProvider: the stored headers must
be equal, on the native CPU planes and, for one hop, through the port's
device verifier on the CPU (the kernels' plain versions, bucket 8). A
lying witness serves a conflicting header signed by every validator:
both clients raise DivergenceError with the same evidence, but for the
total power the port's client fills in (the reference's detector sets
it; the JAX client leaves it 0), and the port's HTTPProvider reports it
in the Evidence envelope the route decodes; both primaries answer that
report alike and hold it as pending. The catches: a check error under
`broadcast_evidence` answers "evidence rejected: …" with the JAX text,
while a failed launch (a patched RuntimeError) or an injected `rpc.route`
fault answers INTERNAL_ERROR and is kept by the server. Group affinity
is pinned in both packages. Tolerance: zero.
"""

import asyncio

import pytest

from tendermint_tpu.crypto import batch as jax_batch
from tendermint_tpu.light import Client as JaxClient
from tendermint_tpu.light import LightStore as JaxStore
from tendermint_tpu.light import TrustOptions as JaxTrust
from tendermint_tpu.light.errors import LightBlockNotFoundError as JaxNotFound
from tendermint_tpu.light.provider import HTTPProvider as JaxHTTPProvider
from tendermint_tpu.rpc import core as jax_core
from tendermint_tpu.rpc.metrics import RPCMetrics
from tendermint_tpu.rpc.server import RPCServer as JaxRPCServer
from tendermint_tpu.libs.metrics import Registry
from tendermint_tpu.store.kv import MemKV as JaxMemKV
from tendermint_tpu.types.block_meta import BlockMeta as JaxBlockMeta
from tendermint_tpu.types.commit import Commit as JaxCommit
from tendermint_tpu.types.evidence import evidence_to_proto as jax_evidence_to_proto
from tendermint_tpu.types.light import LightBlock as JaxLightBlock
from tendermint_tpu.types.light import LightBlocksResponse as JaxLightBlocksResponse
from tendermint_tpu_torch import workloads
from tendermint_tpu_torch.crypto import batch as port_batch
from tendermint_tpu_torch.crypto import breaker as B
from tendermint_tpu_torch.crypto import faults
from tendermint_tpu_torch.crypto import gpu_verifier as G
from tendermint_tpu_torch.evidence.pool import EvidencePool
from tendermint_tpu_torch.light.client import SEQUENTIAL_BATCH_HOPS
from tendermint_tpu_torch.light.errors import LightBlockNotFoundError
from tendermint_tpu_torch.light.provider import HTTPProvider
from tendermint_tpu_torch.rpc import core
from tendermint_tpu_torch.rpc.client import HTTPClient, RPCClientError
from tendermint_tpu_torch.store.kv import MemKV
from tendermint_tpu_torch.types.evidence import evidence_to_proto
from tendermint_tpu_torch.types.light import LightBlocksResponse

from .test_torch_isolation import jax_device_plane_paused  # noqa: F401 (autouse)
from .test_torch_rpc import CHAIN, TIMEOUT_S, Pair, _attack_evidence, build_pair_chain

HEIGHTS = 2 * core.LIGHT_BLOCKS_PAGE_CAP + 5  # the sync pages past the clamp
CONFLICT_AT = HEIGHTS - 1


@pytest.fixture(scope="module")
def served():
    return build_pair_chain(0, seed=47, heights=HEIGHTS, n_txs=1)


@pytest.fixture
def pinned():
    saved = (jax_batch.group_affinity_state(), port_batch.group_affinity_state())

    def pin(n):
        jax_batch.set_group_affinity(n)
        port_batch.set_group_affinity(n)

    try:
        yield pin
    finally:
        jax_batch.restore_group_affinity(saved[0])
        port_batch.restore_group_affinity(saved[1])


# -- HTTPProvider on scripted pages ---------------------------------------


class _StubRPC:
    """Stands in for an HTTPProvider's client: serves scripted pages."""

    def __init__(self, pages):
        self.pages = list(pages)
        self.calls = []

    async def call(self, method, **params):
        assert method == "light_blocks"
        self.calls.append(params)
        resp = self.pages.pop(0)
        return {"count": len(resp.light_blocks), "last_height": resp.last_height,
                "light_blocks": resp.to_proto().hex()}


def _providers(blocks, pages):
    """A port and a JAX HTTPProvider each on the same scripted pages
    ([heights], last_height)."""
    jblocks = {h: JaxLightBlock.from_proto(b.to_proto()) for h, b in blocks.items()}
    p = HTTPProvider.__new__(HTTPProvider)
    j = JaxHTTPProvider.__new__(JaxHTTPProvider)
    p.addr = j.addr = "stub:0"
    p._client = _StubRPC(LightBlocksResponse([blocks[h] for h in hs], top) for hs, top in pages)
    j._client = _StubRPC(JaxLightBlocksResponse([jblocks[h] for h in hs], top) for hs, top in pages)
    return p, j


async def _fetch(provider, first, last):
    try:
        return "ok", [b.height for b in await provider.light_blocks(first, last)]
    except (LightBlockNotFoundError, JaxNotFound) as e:
        return "LightBlockNotFoundError", str(e)


@pytest.mark.parametrize("pages, first, last", [
    ([([2, 3, 4], 7), ([5, 6], 7)], 2, 6),  # past the clamp
    ([([4], 6)], 2, 4),  # out of order
    ([([], 6)], 2, 4),  # empty
    ([([2, 3, 4], 6)], 2, 3),  # over-full: the surplus ignored
])
def test_http_provider_pages_as_the_jax_one(pages, first, last):
    blocks = workloads.build_light_chain(CHAIN, 8, 4, 5)
    p, j = _providers(blocks, pages)
    got, want = asyncio.run(_fetch(p, first, last)), asyncio.run(_fetch(j, first, last))
    assert got == want
    assert p._client.calls == j._client.calls


# -- light syncs over HTTP --------------------------------------------------


def _stores(served):
    node = served["node"]
    jstate_store, jblock_store, _ = served["jax"]
    return (node.block_store, node.state_store), (jblock_store, jstate_store)


def _envs(served, lying: bool):
    """(port envs, JAX envs): the primary (with an evidence pool) and an
    honest witness, or a lying witness serving a conflicting header at
    CONFLICT_AT."""
    (bs, ss), (jbs, jss) = _stores(served)
    pool = EvidencePool(MemKV(), ss, bs)
    from tendermint_tpu.evidence.metrics import EvidenceMetrics
    from tendermint_tpu.evidence.pool import EvidencePool as JaxEvidencePool

    jpool = JaxEvidencePool(JaxMemKV(), jss, jbs, metrics=EvidenceMetrics(Registry()))
    port = [core.Environment(chain_id=CHAIN, block_store=bs, state_store=ss, evidence_pool=pool)]
    jax = [jax_core.Environment(chain_id=CHAIN, block_store=jbs, state_store=jss,
                                evidence_pool=jpool, metrics=RPCMetrics(Registry()))]
    wbs, jwbs = bs, jbs
    if lying:
        meta, commit = workloads.conflicting_light_block(bs, ss, CONFLICT_AT, served["privs"], 47)
        wbs = workloads.ServingStore(bs, metas={CONFLICT_AT: meta}, commits={CONFLICT_AT: commit})
        jwbs = workloads.ServingStore(
            jbs, metas={CONFLICT_AT: JaxBlockMeta.from_proto(meta.to_proto())},
            commits={CONFLICT_AT: JaxCommit.from_proto(commit.to_proto())},
        )
    port.append(core.Environment(chain_id=CHAIN, block_store=wbs, state_store=ss))
    jax.append(jax_core.Environment(chain_id=CHAIN, block_store=jwbs, state_store=jss,
                                    metrics=RPCMetrics(Registry())))
    return port, jax, pool, jpool


def _now(served):
    return served["chain"][-1].block.header.time_ns + 10**9


async def _sync(envs, make_client, server_cls, height, now, trust_lb):
    servers = [server_cls(e, "tcp://127.0.0.1:0") for e in envs]
    for s in servers:
        await s.start()
    addrs = [f"127.0.0.1:{s.bound_port}" for s in servers]
    client = make_client(addrs, trust_lb)
    evidence = []
    try:
        lb = await client.verify_light_block_at_height(height, now)
        outcome = ("ok", lb.height, lb.signed_header.hash())
    except Exception as e:  # the outcome compared IS the exception
        outcome = (type(e).__name__, str(e))
        evidence = list(getattr(e, "evidence", []))
    for p in [client.primary, *client.witnesses]:
        await p.close()
    for s in servers:
        await s.stop()
    return outcome, sorted(client.store._heights()), client, evidence


def _port_client(addrs, trust_lb):
    return workloads.http_light_client(addrs[0], addrs[1:], CHAIN, trust_lb)


def _jax_client(addrs, trust_lb):
    return JaxClient(
        CHAIN, JaxTrust(period_ns=10**18, height=trust_lb.height, hash=trust_lb.signed_header.hash()),
        JaxHTTPProvider(addrs[0], timeout=60.0), [JaxHTTPProvider(a, timeout=60.0) for a in addrs[1:]],
        JaxStore(JaxMemKV()), sequential=True,
    )


def _run_both(served, lying: bool, trust_h: int = 1, height: int = None):
    port_envs, jax_envs, pool, jpool = _envs(served, lying)
    (bs, ss), _ = _stores(served)
    trust_lb = workloads.stored_light_blocks(bs, ss, [trust_h])[trust_h]
    height = height or bs.height()
    now = _now(served)
    got = asyncio.run(asyncio.wait_for(
        _sync(port_envs, _port_client, workloads_rpc_server(), height, now, trust_lb), TIMEOUT_S))
    want = asyncio.run(asyncio.wait_for(
        _sync(jax_envs, _jax_client, JaxRPCServer, height, now, trust_lb), TIMEOUT_S))
    return got, want, pool, jpool


def workloads_rpc_server():
    from tendermint_tpu_torch.rpc.server import RPCServer

    return RPCServer


@pytest.mark.parametrize("affinity", [SEQUENTIAL_BATCH_HOPS, 1])
def test_http_light_sync_stores_the_jax_headers(served, pinned, affinity):
    """Merged windows (affinity 32, the bulk route paged at 20) and the
    hop-at-a-time loop (affinity 1, one light_block call a height)."""
    pinned(affinity)
    (p_out, p_heights, p, _), (j_out, j_heights, j, _), _, _ = _run_both(served, lying=False)
    assert p_out == j_out and p_out[:2] == ("ok", HEIGHTS)
    assert p_heights == j_heights == list(range(1, HEIGHTS + 1))
    for h in p_heights:
        assert p.store.light_block(h).to_proto() == j.store.light_block(h).to_proto()


def test_http_light_sync_through_the_device_verifier_on_the_cpu(served, pinned):
    """The last hop with the port's device verifier on the plain
    versions: one window of the light plan's 5 ed25519 signatures
    (bucket 8), no fault, and the JAX client's store."""
    faults.reset()
    B.reset_all()
    G.install(device="cpu", min_batch=2, gather_deadline_s=30.0)
    try:
        pinned(SEQUENTIAL_BATCH_HOPS)
        before = G.stats()
        (p_out, p_heights, _p, _), (j_out, j_heights, _j, _), _, _ = _run_both(
            served, lying=False, trust_h=HEIGHTS - 1)
        after = G.stats()
    finally:
        G.uninstall()
        faults.reset()
        B.reset_all()
    assert p_out == j_out and p_heights == j_heights == [HEIGHTS - 1, HEIGHTS]
    assert after["batches_ed25519"] - before["batches_ed25519"] == 1
    assert after["sigs_ed25519"] - before["sigs_ed25519"] == 5
    assert after["faults"] == before["faults"]
    assert after["rerouted_sigs"] == before["rerouted_sigs"]


def test_lying_witness_divergence_evidence_and_primary_answer(served, pinned):
    """A client trusting CONFLICT_AT - 1 verifies CONFLICT_AT; the lying
    witness serves a conflicting header signed by every validator: both
    raise DivergenceError with the same evidence but for the total power;
    the port's report reaches its primary, whose pool holds it, while the
    JAX provider's report (the bare message) leaves its pool empty. Both
    primaries answer the port's report bytes alike."""
    pinned(SEQUENTIAL_BATCH_HOPS)
    got, want, pool, jpool = _run_both(served, lying=True, trust_h=CONFLICT_AT - 1, height=CONFLICT_AT)
    (p_out, p_heights, _p, pevs), (j_out, j_heights, _j, jevs) = got, want
    assert p_out == j_out and p_out[0] == "DivergenceError"
    assert p_heights == j_heights == [CONFLICT_AT - 1]  # the conflict is not stored
    assert len(pevs) == len(jevs) == 1
    (pev,), (jev,) = pevs, jevs
    (bs, ss), _ = _stores(served)
    power = ss.load_validators(CONFLICT_AT - 1).total_voting_power()
    assert (jev.total_voting_power, pev.total_voting_power) == (0, power)
    jev.total_voting_power = power
    assert evidence_to_proto(pev) == jax_evidence_to_proto(jev)
    assert pev.hash() == jev.hash()
    assert [e.hash() for e in pool.pending_evidence(10**6)[0]] == [pev.hash()]
    assert jpool.pending_evidence(10**6)[0] == []

    async def report(server_cls, env):
        srv = server_cls(env, "tcp://127.0.0.1:0")
        await srv.start()
        c = HTTPClient(f"127.0.0.1:{srv.bound_port}")
        try:
            return await c.call("broadcast_evidence", evidence=evidence_to_proto(pev).hex())
        finally:
            await c.close()
            await srv.stop()

    port_envs, jax_envs, pool, jpool = _envs(served, lying=False)
    answers = [asyncio.run(asyncio.wait_for(report(cls, envs[0]), TIMEOUT_S))
               for cls, envs in ((workloads_rpc_server(), port_envs), (JaxRPCServer, jax_envs))]
    assert answers[0] == answers[1] == {"hash": pev.hash().hex()}
    assert [e.hash() for e in jpool.pending_evidence(10**6)[0]] == [pev.hash()]


# -- the catches ------------------------------------------------------------


@pytest.fixture(scope="module")
def served_ed():
    return build_pair_chain(0)


def test_a_failed_launch_under_a_route_is_kept_by_the_server(served_ed, monkeypatch):
    """A RuntimeError under broadcast_evidence (the conflicting commit's
    check, patched to fail as a launch does) is answered INTERNAL_ERROR,
    never "evidence rejected"; RPCServer.failure() returns it and stop()
    raises it. A check error stays an answer and is not kept."""
    from tendermint_tpu_torch.evidence import verify as ev_verify

    ev_ok, ev_bad = _attack_evidence(served_ed)
    boom = RuntimeError("ed25519_verify_tile launch failed: unspecified launch failure")

    def failing(*_a, **_k):
        raise boom

    async def main():
        pair = Pair(served_ed)
        await pair.start()
        try:
            rejected = await pair.both("broadcast_evidence", evidence=evidence_to_proto(ev_bad).hex())
            kept_after_check = pair.port_srv.failure()
            monkeypatch.setattr(ev_verify, "verify_commit_light_trusting", failing)
            answer = await pair.clients[0].call("header", height=2)
            try:
                await pair.clients[0].call("broadcast_evidence", evidence=evidence_to_proto(ev_ok).hex())
            except RPCClientError as e:
                failed = (e.code, str(e))
            return rejected, kept_after_check, answer, failed, pair.port_srv.failure()
        finally:
            for c in pair.clients:
                await c.close()
            await pair.jax_srv.stop()
            with pytest.raises(RuntimeError, match="launch failed"):
                await pair.port_srv.stop()
            for svc in (pair.port_proxy, pair.jax_proxy, pair.port_bus, pair.jax_bus):
                await svc.stop()

    rejected, kept, answer, failed, failure = asyncio.run(asyncio.wait_for(main(), TIMEOUT_S))
    assert rejected[0] == rejected[1] and rejected[0][2].startswith("evidence rejected: ")
    assert kept is None and answer["header"]["height"] == 2
    assert failed[0] == -32603 and "evidence rejected" not in failed[1]
    assert "launch failed" in failed[1]
    assert failure is boom


def test_an_injected_route_fault_answers_internal_error_and_is_kept(served_ed):
    """The `rpc.route` fault point raises inside the dispatch: the client
    gets INTERNAL_ERROR, as from the JAX server's own seam, and the port's
    server keeps the fault."""
    from tendermint_tpu.crypto import faults as jax_faults

    async def main():
        pair = Pair(served_ed)
        await pair.start()
        try:
            with faults.inject("rpc.route", "raise", key="header"), \
                    jax_faults.inject("rpc.route", "raise", key="header"):
                got = await pair.both("header", height=2)
            after = await pair.both("header", height=2)
            return got, after, pair.port_srv.failure()
        finally:
            for c in pair.clients:
                await c.close()
            await pair.jax_srv.stop()
            with pytest.raises(faults.DeviceFault):
                await pair.port_srv.stop()
            for svc in (pair.port_proxy, pair.jax_proxy, pair.port_bus, pair.jax_bus):
                await svc.stop()

    got, after, failure = asyncio.run(asyncio.wait_for(main(), TIMEOUT_S))
    assert [g[:2] for g in got] == [("err", -32603)] * 2
    assert "injected device fault at rpc.route" in got[0][2]
    assert after[0] == after[1] and after[0][0] == "ok"
    assert isinstance(failure, faults.DeviceFault)
