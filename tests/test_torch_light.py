"""The port's light client against the JAX package's, on the CPU.

Chains are built by the JAX package (tests/test_light.py build_chain,
ed25519 keys, at most 6 validators and 2 * 32 + 5 heights) and carried
across as LightBlock wire bytes (interop.light_block_from_proto). Both
clients verify the same heights from the same trust root at the same
`now`; the outcome (the verified height and hash, or the error's type
and message), the heights left in the store and, for divergence, the
evidence's bytes must be identical. The group affinity, whose default
depends on the environment, is pinned in both packages for every sync
and restored after. Unless a case installs the port's device verifier
(on device="cpu": the kernels' plain versions), both run their native
CPU planes. Tolerance: zero.
"""

import asyncio

import pytest

from tendermint_tpu.crypto import batch as jax_batch
from tendermint_tpu.crypto.ed25519 import PrivKeyEd25519 as JaxPriv
from tendermint_tpu.light import Client as JaxClient
from tendermint_tpu.light import LightStore as JaxStore
from tendermint_tpu.light import TrustOptions as JaxTrust
from tendermint_tpu.store.kv import MemKV as JaxMemKV
from tendermint_tpu.types import validation as jax_validation
from tendermint_tpu.types.commit import CommitSig as JaxCommitSig
from tendermint_tpu.types.light import LightBlock as JaxLightBlock
from tendermint_tpu.types.validator import Validator as JaxValidator
from tendermint_tpu.types.validator import ValidatorSet as JaxValidatorSet
from tendermint_tpu_torch import interop
from tendermint_tpu_torch.crypto import batch as port_batch
from tendermint_tpu_torch.crypto import breaker as B
from tendermint_tpu_torch.crypto import faults
from tendermint_tpu_torch.crypto import gpu_verifier as G
from tendermint_tpu_torch.crypto.ed25519 import PubKeyEd25519
from tendermint_tpu_torch.light import Client, LightStore, TrustOptions
from tendermint_tpu_torch.light.client import SEQUENTIAL_BATCH_HOPS
from tendermint_tpu_torch.ops.ed25519_kernel import Ed25519Verifier
from tendermint_tpu_torch.store.kv import MemKV
from tendermint_tpu_torch.types import validation as port_validation
from tendermint_tpu_torch.types.validator import Validator, ValidatorSet
from tendermint_tpu_torch.workloads import ChainProvider

from .test_light import CHAIN, HOUR_NS, DictProvider, build_chain
from .test_torch_validation import CHAIN_ID, HEIGHT, N_VALS, _carry, _jax_commit

BASE_NS = 1_700_000_000 * 1_000_000_000
PERIOD_NS = 200 * HOUR_NS
MULTI = 2 * SEQUENTIAL_BATCH_HOPS + 5  # three windows of the merged sync
BAD_H = SEQUENTIAL_BATCH_HOPS + 3  # in the second window


def _now(blocks):
    return BASE_NS + (max(blocks) + 5) * 1_000_000_000


def _chain(n, **kw):
    kw.setdefault("base_time_ns", BASE_NS)
    return build_chain(n, **kw)


def _port_blocks(blocks):
    out = {h: interop.light_block_from_proto(b.to_proto()) for h, b in blocks.items()}
    for h, b in blocks.items():
        assert out[h].to_proto() == b.to_proto()
        assert out[h].signed_header.hash() == b.signed_header.hash()
    return out


def _flip(blocks, h):
    """Blocks with one signature of height h's commit flipped (a copy of
    that height's commit, the rest shared)."""
    out = dict(blocks)
    bad = JaxLightBlock.from_proto(blocks[h].to_proto())
    sigs = list(bad.signed_header.commit.signatures)
    s0 = sigs[1]
    sigs[1] = JaxCommitSig.for_block(
        s0.signature[:-1] + bytes([s0.signature[-1] ^ 1]),
        s0.validator_address,
        s0.timestamp_ns,
    )
    bad.signed_header.commit.signatures = sigs
    out[h] = bad
    return out


@pytest.fixture
def pinned():
    """Pin both packages' group affinity (to the value the test passes),
    restoring each afterwards."""
    saved = (jax_batch.group_affinity_state(), port_batch.group_affinity_state())

    def pin(n):
        jax_batch.set_group_affinity(n)
        port_batch.set_group_affinity(n)

    try:
        yield pin
    finally:
        jax_batch.restore_group_affinity(saved[0])
        port_batch.restore_group_affinity(saved[1])


@pytest.fixture
def device_cpu():
    """The port's device verifier on the plain versions, min_batch 2 so
    the few-validator commits reach it; the affinity fixture pins over
    what install sets."""
    faults.reset()
    B.reset_all()
    G.install(device="cpu", min_batch=2, gather_deadline_s=30.0)
    try:
        yield
    finally:
        G.uninstall()
        faults.reset()
        B.reset_all()


def _heights(store):
    return sorted(store._heights())


async def _outcome(client, height, now):
    try:
        lb = await client.verify_light_block_at_height(height, now)
    except Exception as e:  # the outcome compared IS the exception
        return type(e).__name__, str(e)
    return "ok", lb.height, lb.signed_header.hash()


def _clients(blocks, *, sequential, trust_height=1, period_ns=PERIOD_NS,
             trust_hash=None, jax_witnesses=(), port_witnesses=()):
    pblocks = _port_blocks(blocks)
    root = blocks[trust_height].signed_header.hash() if trust_hash is None else trust_hash
    j = JaxClient(
        CHAIN,
        JaxTrust(period_ns=period_ns, height=trust_height, hash=root),
        DictProvider(blocks, "primary"),
        list(jax_witnesses),
        JaxStore(JaxMemKV()),
        sequential=sequential,
    )
    p = Client(
        CHAIN,
        TrustOptions(period_ns=period_ns, height=trust_height, hash=root),
        ChainProvider(pblocks, "primary"),
        list(port_witnesses),
        LightStore(MemKV()),
        sequential=sequential,
    )
    return j, p


def _both(blocks, height, now=None, **kw):
    """Each client's (outcome, stored heights); asserted equal."""
    now = _now(blocks) if now is None else now
    j, p = _clients(blocks, **kw)
    got = []
    for c in (j, p):
        got.append((asyncio.run(_outcome(c, height, now)), _heights(c.store)))
    assert got[1] == got[0]
    return got[0], (j, p)


# -- sequential sync --------------------------------------------------


@pytest.mark.parametrize("affinity", [SEQUENTIAL_BATCH_HOPS, 1])
def test_sequential_sync_matches(pinned, affinity):
    """Several merged windows (affinity 32), and the hop-at-a-time loop
    (affinity 1): every height verified and stored, as the JAX client
    does."""
    pinned(affinity)
    blocks = _chain(MULTI)
    (outcome, stored), _ = _both(blocks, MULTI, sequential=True)
    assert outcome[:2] == ("ok", MULTI)
    assert stored == list(range(1, MULTI + 1))


def test_merged_windows_go_through_the_device_verifier(pinned, device_cpu):
    """With the device verifier installed, the 68 hops of the sync are
    three device windows (32, 32 and 4 commits, 3 signatures each), not
    one a hop; the store as the JAX client leaves it."""
    pinned(SEQUENTIAL_BATCH_HOPS)
    blocks = _chain(MULTI)
    before = G.stats()
    (outcome, stored), _ = _both(blocks, MULTI, sequential=True)
    after = G.stats()
    assert outcome[:2] == ("ok", MULTI) and len(stored) == MULTI
    assert after["batches_ed25519"] - before["batches_ed25519"] == 3
    assert after["sigs_ed25519"] - before["sigs_ed25519"] == (MULTI - 1) * 3
    assert after["faults"] == before["faults"]
    assert after["rerouted_sigs"] == before["rerouted_sigs"]


@pytest.mark.parametrize("affinity", [SEQUENTIAL_BATCH_HOPS, 1])
def test_flipped_signature_mid_window(pinned, affinity):
    """A bad signature in the second window: the merged window fails,
    its hops are verified again one at a time, and the error names that
    height's signature; every height below it is stored, none above."""
    pinned(affinity)
    blocks = _flip(_chain(SEQUENTIAL_BATCH_HOPS + 8), BAD_H)
    (outcome, stored), _ = _both(blocks, SEQUENTIAL_BATCH_HOPS + 8, sequential=True)
    assert outcome[0] == "InvalidHeaderError"
    assert outcome[1].startswith("wrong signature (#1): ")
    assert stored == list(range(1, BAD_H))


# -- skipping, backwards, trust root ----------------------------------


def _churn(h):
    base = [1, 2, 3, 4]
    for i in range((h - 1) // 3):
        base[i % 4] = 11 + i
    return base


def test_skipping_bisects_through_churn():
    blocks = _chain(16, seeds_at=_churn)
    (outcome, stored), _ = _both(blocks, 16, sequential=False)
    assert outcome[:2] == ("ok", 16) and len(stored) > 2


def test_skipping_single_hop_and_backwards():
    blocks = _chain(10)
    (outcome, stored), _ = _both(blocks, 10, sequential=False)
    assert outcome[:2] == ("ok", 10) and stored == [1, 10]
    (outcome, stored), _ = _both(blocks, 3, sequential=False, trust_height=8)
    assert outcome[:2] == ("ok", 3) and stored == [3, 4, 5, 6, 7, 8]


def test_wrong_trust_hash_and_expired_root():
    blocks = _chain(3)
    (outcome, stored), _ = _both(blocks, 3, sequential=True, trust_hash=b"\x13" * 32)
    assert outcome[0] == "LightClientError" and stored == []
    now = BASE_NS + 400 * HOUR_NS
    (outcome, stored), _ = _both(blocks, 3, now=now, sequential=True, period_ns=HOUR_NS)
    assert outcome == ("LightClientError", "trust-root header is already expired")


def test_divergence_and_failover():
    """A witness with a verifiable fork: DivergenceError, and the same
    evidence bytes reported; a witness of another chain is dropped; a
    primary that cannot serve is replaced by a witness."""
    blocks = _chain(8)
    fork = _chain(8, app_hash=b"\x66" * 32)
    jw, pw = DictProvider(fork, "fork"), ChainProvider(_port_blocks(fork), "fork")
    (outcome, _stored), _ = _both(
        blocks, 8, sequential=False, jax_witnesses=[jw], port_witnesses=[pw]
    )
    assert outcome[0] == "DivergenceError"
    assert [e.to_proto() for e in pw.reported] == [e.to_proto() for e in jw.reported]
    assert [e.hash() for e in pw.reported] == [e.hash() for e in jw.reported]

    garbage = _chain(8, chain_id="other-chain")
    jg, pg = DictProvider(garbage, "garbage"), ChainProvider(_port_blocks(garbage), "garbage")
    jh, ph = DictProvider(blocks, "honest"), ChainProvider(_port_blocks(blocks), "honest")
    (outcome, _stored), (j, p) = _both(
        blocks, 8, sequential=False, jax_witnesses=[jg, jh], port_witnesses=[pg, ph]
    )
    assert outcome[:2] == ("ok", 8)
    assert [w.id() for w in p.witnesses] == [w.id() for w in j.witnesses] == ["honest"]

    pblocks = _port_blocks(blocks)
    j = JaxClient(
        CHAIN, JaxTrust(period_ns=PERIOD_NS, height=1, hash=blocks[1].signed_header.hash()),
        DictProvider({1: blocks[1]}, "flaky"), [DictProvider(blocks, "witness")],
        JaxStore(JaxMemKV()),
    )
    p = Client(
        CHAIN, TrustOptions(period_ns=PERIOD_NS, height=1, hash=blocks[1].signed_header.hash()),
        ChainProvider({1: pblocks[1]}, "flaky"), [ChainProvider(pblocks, "witness")],
        LightStore(MemKV()),
    )
    now = _now(blocks)
    assert asyncio.run(_outcome(p, 8, now)) == asyncio.run(_outcome(j, 8, now))
    assert p.primary.id() == j.primary.id() == "witness"


# -- the merged commit verification -------------------------------------


def _triples(triples):
    return [(pk.bytes(), sb, sig) for pk, sb, sig in triples]


@pytest.mark.parametrize("signers", [set(range(N_VALS)), {0, 1, 3, 5}, {0, 1, 2}])
def test_collect_commit_light_matches(signers):
    """The same triples, in the same order, or the same error."""
    vals, bid, commit = _jax_commit(signers)
    pvals, pbid, pcommit = _carry(vals, bid, commit)
    try:
        want = _triples(jax_validation.collect_commit_light(CHAIN_ID, vals, bid, HEIGHT, commit))
    except Exception as e:
        want = (type(e).__name__, str(e))
    try:
        got = _triples(
            port_validation.collect_commit_light(CHAIN_ID, pvals, pbid, HEIGHT, pcommit)
        )
    except Exception as e:
        got = (type(e).__name__, str(e))
    assert got == want


def test_verify_commit_light_bulk_outcomes():
    """Good, bad and short commits in rows: the same outcome and
    message."""
    good = _jax_commit(set(range(N_VALS)))
    bad = _jax_commit(set(range(N_VALS)), bad=2)
    short = _jax_commit({0, 1, 2})
    absent = _jax_commit({0, 2, 3, 4, 5})
    cases = {
        "good": [good, absent],
        "bad": [good, bad, absent],
        "short": [good, short],
        "bad_then_short": [bad, short],
    }
    seen = {}
    for name, rows in cases.items():
        jrows = [(v, b, HEIGHT, c) for v, b, c in rows]
        prows = [(v, b, HEIGHT, c) for v, b, c in (_carry(*r) for r in rows)]
        outcomes = []
        for fn, rs in (
            (jax_validation.verify_commit_light_bulk, jrows),
            (port_validation.verify_commit_light_bulk, prows),
        ):
            try:
                fn(CHAIN_ID, rs)
                outcomes.append(("ok", ""))
            except Exception as e:
                outcomes.append((type(e).__name__, str(e)))
        assert outcomes[1] == outcomes[0], name
        seen[name] = outcomes[0]
    assert seen["good"] == ("ok", "")
    assert seen["bad"] == ("InvalidCommitError", "wrong signature in merged batch")
    assert seen["short"][0] == seen["bad_then_short"][0] == "NotEnoughVotingPowerError"


def test_port_built_validator_set_matches():
    """The port's constructor gives the JAX constructor's priorities and
    proposer, so the wire forms are equal; the hash memo is dropped when
    the membership changes."""
    privs = [JaxPriv.from_seed(bytes([60 + i]) * 32) for i in range(5)]
    powers = [7, 3, 7, 1, 12]
    jvals = JaxValidatorSet(
        [JaxValidator(pub_key=p.pub_key(), voting_power=w) for p, w in zip(privs, powers)]
    )
    pvals = ValidatorSet(
        [
            Validator(pub_key=PubKeyEd25519(p.pub_key().bytes()), voting_power=w)
            for p, w in zip(privs, powers)
        ]
    )
    assert pvals.to_proto() == jvals.to_proto()
    assert pvals.get_proposer().address == jvals.get_proposer().address
    pvals.validate_basic()
    h = pvals.hash()
    assert h == jvals.hash() and pvals.hash() is h
    pvals.validators.pop()
    pvals._reindex()
    assert pvals.hash() != h


# -- the group affinity -------------------------------------------------


def test_affinity_defaults_install_and_override():
    saved = port_batch.group_affinity_state()
    try:
        port_batch.restore_group_affinity((None, port_batch.native_cpu_affinity, False))
        assert port_batch.group_affinity() == 32  # the native plane loads
        G.install(device="cpu", min_batch=2)
        try:
            assert port_batch.group_affinity() == G.DEVICE_GROUP_AFFINITY["cpu"] == 1
        finally:
            G.uninstall()
        assert port_batch.group_affinity_state()[1] is port_batch.native_cpu_affinity
        assert port_batch.group_affinity() == 32
        port_batch.set_group_affinity(7)
        G.install(device="cpu", min_batch=2)
        try:
            assert port_batch.group_affinity() == 7
        finally:
            G.uninstall()
        assert port_batch.group_affinity() == 7
        assert G.DEVICE_GROUP_AFFINITY["cuda"] == 32
    finally:
        port_batch.restore_group_affinity(saved)


# -- no fallback hides the device ---------------------------------------


def _launch_error(*_a, **_k):
    raise RuntimeError("tm_ed25519_verify_tile: launch failed: an illegal memory access")


@pytest.mark.parametrize("affinity", [SEQUENTIAL_BATCH_HOPS, 1])
def test_launch_error_reaches_the_caller(pinned, device_cpu, monkeypatch, affinity):
    """A failed launch out of a dispatch is neither a bad header nor a
    reason to re-run the window hop by hop: the caller gets it as it
    was raised, nothing past the trust root is stored, and no fault is
    counted."""
    pinned(affinity)
    monkeypatch.setattr(Ed25519Verifier, "dispatch", _launch_error)
    blocks = _chain(10)
    before = G.stats()
    p = _clients(blocks, sequential=True)[1]
    with pytest.raises(RuntimeError, match="illegal memory access") as ei:
        asyncio.run(p.verify_light_block_at_height(10, _now(blocks)))
    assert type(ei.value) is RuntimeError
    assert _heights(p.store) == [1]
    assert G.stats()["faults"] == before["faults"]


def test_launch_error_in_the_per_hop_rerun_reaches_the_caller(pinned, device_cpu, monkeypatch):
    """The per-hop re-run after a failed window does not catch it
    either: the window fails on a bad signature, and the first re-run
    dispatch fails to launch."""
    pinned(SEQUENTIAL_BATCH_HOPS)
    blocks = _flip(_chain(10), 6)
    calls = []
    real = Ed25519Verifier.dispatch

    def first_then_fail(self, *args):
        calls.append(1)
        if len(calls) == 1:
            return real(self, *args)
        _launch_error()

    monkeypatch.setattr(Ed25519Verifier, "dispatch", first_then_fail)
    p = _clients(blocks, sequential=True)[1]
    with pytest.raises(RuntimeError, match="illegal memory access"):
        asyncio.run(p.verify_light_block_at_height(10, _now(blocks)))
    assert len(calls) == 2 and _heights(p.store) == [1]


def test_device_fault_is_contained_without_a_verdict(pinned, device_cpu):
    """A DeviceFault at dispatch is contained in gpu_verifier: the
    window is answered by the C plane, counted as a fault, and the sync
    ends as the JAX client's does."""
    pinned(SEQUENTIAL_BATCH_HOPS)
    blocks = _chain(10)
    before = G.stats()
    with faults.inject("gpu.dispatch", mode="raise", times=1):
        (outcome, stored), _ = _both(blocks, 10, sequential=True)
    assert outcome[:2] == ("ok", 10) and stored == list(range(1, 11))
    after = G.stats()
    assert after["faults"] == before["faults"] + 1
    assert after["rerouted_sigs"] - before["rerouted_sigs"] == 9 * 3
