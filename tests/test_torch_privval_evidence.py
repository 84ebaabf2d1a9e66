"""The port's FilePV, evidence verification and evidence pool held
against the JAX package's.

FilePV: a seeded key's key and state files are byte-equal; a seeded
sequence of votes and proposals (new heights, rounds and steps, the same
request again, one differing only in its timestamp, a conflicting one,
height, round and step regressions, nil votes) gives the same
signatures, timestamps or refusals and messages, and the same state
file after every request; loading (a missing state file, a mismatched
address, load_or_generate, load_empty_state) and the `privval.save`
io_error fault (the signature withheld, the state file untouched)
behave the same. Evidence: on a 4-validator kvstore chain made by the
port (workloads.build_block_chain) and applied by both packages,
duplicate-vote and light-client-attack evidence, valid and broken in
each way the verifiers check, gets the same outcome and message from
verify_evidence and from the pool's add_evidence and check_evidence; a
conflict reported by consensus becomes the same pending evidence at the
next update, and evidence committed in a block is marked committed, the
pool's database byte-equal throughout. Tolerance: zero.
"""

import asyncio
import json
import os
import pathlib

import numpy as np
import pytest

from tendermint_tpu.abci.client import LocalClient as JaxLocalClient
from tendermint_tpu.abci.kvstore import KVStoreApplication as JaxKVStore
from tendermint_tpu.crypto import faults as jax_faults
from tendermint_tpu.crypto import sigcache as jax_sigcache
from tendermint_tpu.crypto.ed25519 import PrivKeyEd25519 as JaxPrivKey
from tendermint_tpu.evidence.metrics import EvidenceMetrics
from tendermint_tpu.evidence.pool import EvidencePool as JaxEvidencePool
from tendermint_tpu.evidence.verify import verify_evidence as jax_verify_evidence
from tendermint_tpu.libs.metrics import Registry
from tendermint_tpu.mempool.nop import NopMempool as JaxNopMempool
from tendermint_tpu.privval.file import FilePV as JaxFilePV
from tendermint_tpu.privval.types import MockPV as JaxMockPV
from tendermint_tpu.state.execution import BlockExecutor as JaxBlockExecutor
from tendermint_tpu.state.metrics import StateMetrics
from tendermint_tpu.state.store import StateStore as JaxStateStore
from tendermint_tpu.state.types import state_from_genesis as jax_state_from_genesis
from tendermint_tpu.store.block_store import BlockStore as JaxBlockStore
from tendermint_tpu.store.kv import MemKV as JaxMemKV
from tendermint_tpu.types.block import Block as JaxBlock
from tendermint_tpu.types.block_id import BlockID as JaxBlockID
from tendermint_tpu.types.commit import Commit as JaxCommit
from tendermint_tpu.types.evidence import evidence_from_proto as jax_evidence_from_proto
from tendermint_tpu.types.genesis import GenesisDoc as JaxGenesisDoc
from tendermint_tpu.types.proposal import Proposal as JaxProposal
from tendermint_tpu.types.vote import Vote as JaxVote
from tendermint_tpu_torch import workloads
from tendermint_tpu_torch.crypto import faults, sigcache
from tendermint_tpu_torch.evidence.pool import EvidencePool
from tendermint_tpu_torch.evidence.verify import verify_evidence
from tendermint_tpu_torch.privval.file import FilePV
from tendermint_tpu_torch.privval.types import MockPV
from tendermint_tpu_torch.store.kv import MemKV
from tendermint_tpu_torch.types.block_id import BlockID, PartSetHeader
from tendermint_tpu_torch.types.canonical import PRECOMMIT_TYPE, PREVOTE_TYPE
from tendermint_tpu_torch.types.evidence import (
    DuplicateVoteEvidence,
    LightClientAttackEvidence,
    evidence_to_proto,
)
from tendermint_tpu_torch.types.light import LightBlock, SignedHeader
from tendermint_tpu_torch.types.proposal import Proposal
from tendermint_tpu_torch.types.vote import Vote

from .test_torch_isolation import jax_device_plane_paused  # noqa: F401 (autouse)

CHAIN_ID = "torch-pv-chain"
SEED = 53


@pytest.fixture(autouse=True)
def _isolated():
    sigcache.reset()
    with jax_sigcache.disabled():
        yield
    sigcache.reset()


def run(coro):
    return asyncio.run(coro)


def _outcome(fn):
    try:
        fn()
    except Exception as e:  # the outcome compared IS the exception
        return type(e).__name__, str(e)
    return "ok", ""


# -- FilePV --


def _pvs(tmp_path, seed: int = SEED):
    """(port FilePV, JAX FilePV) of one seeded ed25519 key, saved."""
    key = workloads.seeded_keys(1, seed)[0]
    out = []
    for pkg in ("port", "jax"):
        home = tmp_path / pkg
        (home / "config").mkdir(parents=True, exist_ok=True)
        (home / "data").mkdir(parents=True, exist_ok=True)
        paths = (str(home / "config" / "priv_validator_key.json"),
                 str(home / "data" / "priv_validator_state.json"))
        cls, priv = (FilePV, key) if pkg == "port" else (JaxFilePV, JaxPrivKey.from_seed(key.bytes()[:32]))
        pv = cls.from_priv_key(priv, *paths)
        pv.save()
        out.append(pv)
    return out


def _files(pv) -> tuple:
    return (pathlib.Path(pv.key.file_path).read_bytes(), pathlib.Path(pv.last_sign_state.file_path).read_bytes())


def _requests(seed: int) -> list:
    """A seeded sequence of (kind, height, round, vote type, block tag,
    timestamp) signing requests that walks through every branch of the
    last-sign-state check."""
    rng = np.random.default_rng(seed)
    h = 2
    reqs = [("proposal", h, 0, 0, 1, 1_700_000_000_000_000_000)]
    for _ in range(12):
        ts = 1_700_000_000_000_000_000 + int(rng.integers(0, 1 << 30))
        step = int(rng.integers(0, 9))
        tag = int(rng.integers(0, 3))
        if step < 3:  # a new height
            h += 1
            reqs.append(("proposal", h, 0, 0, tag, ts))
            reqs.append(("vote", h, 0, PREVOTE_TYPE, tag, ts))
        elif step == 3:
            reqs.append(("vote", h, 0, PRECOMMIT_TYPE, tag, ts))
        elif step == 4:
            reqs.append(reqs[-1])  # the same request again
        elif step == 5:
            reqs.append(reqs[-1][:5] + (reqs[-1][5] + 7,))  # another timestamp only
        elif step == 6:
            reqs.append(reqs[-1][:4] + ((reqs[-1][4] + 1) % 3,) + reqs[-1][5:])  # conflicting
        elif step == 7:
            reqs.append(("vote", h - 1, 0, PREVOTE_TYPE, tag, ts))  # a height regression
        else:
            reqs.append(("vote", h, 1, PRECOMMIT_TYPE, tag, ts))
            reqs.append(("vote", h, 0, PREVOTE_TYPE, tag, ts))  # a round regression
    reqs.append(("vote", h, 1, PREVOTE_TYPE, 0, 5))  # a step regression
    reqs.append(("vote", h + 1, 0, PREVOTE_TYPE, 0, 0))  # no timestamp: now
    return reqs


def _sign(pv, req, jax: bool):
    kind, h, r, vtype, tag, ts = req
    bid = BlockID(bytes([tag + 1]) * 32, PartSetHeader(1, bytes([tag + 9]) * 32)) if tag else BlockID()
    if kind == "vote":
        obj = Vote(type=vtype, height=h, round=r, block_id=bid, timestamp_ns=ts,
                   validator_address=b"\x01" * 20, validator_index=0)
    else:
        obj = Proposal(height=h, round=r, pol_round=-1, block_id=bid, timestamp_ns=ts)
    if jax:
        obj = (JaxVote if kind == "vote" else JaxProposal).from_proto(obj.to_proto())
    fn = pv.sign_vote if kind == "vote" else pv.sign_proposal
    got = _outcome(lambda: run(fn(CHAIN_ID, obj)))
    return got, obj.to_proto()


@pytest.mark.parametrize("seed", range(4))
def test_filepv_signs_and_refuses_as_jax(tmp_path, monkeypatch, seed):
    import time

    monkeypatch.setattr(time, "time_ns", lambda: 1_800_000_000_000_000_000)
    port, jax = _pvs(tmp_path)
    assert _files(port) == _files(jax)
    kinds = set()
    for req in _requests(SEED + seed):
        got = _sign(port, req, False)
        assert got == _sign(jax, req, True), req
        assert _files(port) == _files(jax), req
        kinds.add(got[0][0] if got[0][0] == "ok" else got[0][1].split(".")[0][:20])
    assert "ok" in kinds and len(kinds) >= 3


def test_filepv_files_and_loading_as_jax(tmp_path):
    port, jax = _pvs(tmp_path)
    key = json.loads(pathlib.Path(port.key.file_path).read_text())
    assert set(key) == {"address", "pub_key", "priv_key"}
    assert oct(os.stat(port.key.file_path).st_mode & 0o777) == "0o600"
    for cls, pv in ((FilePV, port), (JaxFilePV, jax)):
        back = cls.load(pv.key.file_path, pv.last_sign_state.file_path)
        assert back.key.address == pv.key.address
        assert cls.load_or_generate(pv.key.file_path, pv.last_sign_state.file_path).key.address == pv.key.address
        assert cls.load_empty_state(pv.key.file_path, "/nonexistent/state.json").last_sign_state.height == 0
    outs = []
    for cls, pv in ((FilePV, port), (JaxFilePV, jax)):
        missing = _outcome(lambda: cls.load(pv.key.file_path, pv.last_sign_state.file_path + ".gone"))
        raw = json.loads(pathlib.Path(pv.key.file_path).read_text())
        raw["address"] = "00" * 20
        bad = pv.key.file_path + ".bad"
        pathlib.Path(bad).write_text(json.dumps(raw))
        mismatch = _outcome(lambda: cls.load(bad, pv.last_sign_state.file_path))
        outs.append((missing[0], mismatch))
    assert outs[0] == outs[1] and outs[0][1][1] == "privval key file address/pubkey mismatch"
    assert _outcome(lambda: FilePV.generate("/x", "/y", "sr25519")) == (
        "ValueError", "key type: sr25519 is not supported")


def test_privval_save_fault_withholds_the_signature_as_jax(tmp_path):
    """The `privval.save` io_error rule: the checkpoint's write fails,
    the vote is not signed, the state file is as it was."""
    port, jax = _pvs(tmp_path)
    before = _files(port)
    req = ("vote", 3, 0, PREVOTE_TYPE, 1, 1_700_000_000_000_000_000)
    with faults.inject("privval.save", "io_error", times=1), jax_faults.inject(
        "privval.save", "io_error", times=1
    ):
        got, vote = _sign(port, req, False)
        want, jvote = _sign(jax, req, True)
    assert got == want and got[0] == "OSError" and "injected I/O fault at privval.save" in got[1]
    assert vote == jvote and Vote.from_proto(vote).signature == b""
    assert _files(port) == before == _files(jax)
    # and the next try signs
    assert _sign(port, req, False) == _sign(jax, req, True)


def test_mockpv_signs_as_jax():
    key = workloads.seeded_keys(1, SEED + 3)[0]
    port, jax = MockPV(key), JaxMockPV(JaxPrivKey.from_seed(key.bytes()[:32]))
    for pv, is_jax in ((port, False), (jax, True)):
        pv.break_vote_sigs = True
    req = ("vote", 4, 1, PRECOMMIT_TYPE, 2, 99)
    assert _sign(port, req, False) == _sign(jax, req, True)
    req = ("proposal", 4, 1, 0, 2, 99)
    assert _sign(port, req, False) == _sign(jax, req, True)


# -- evidence --


class _Nodes:
    """A 4-validator chain of 3 heights made by the port, applied by
    both packages: each package's state and block stores and a fresh
    evidence pool on its own database."""

    def __init__(self, privs, genesis, chain):
        self.privs, self.chain = privs, chain
        node = workloads.block_exec_node(genesis)
        state = node.state
        for cb in chain:
            node.block_store.save_block(cb.block, cb.parts, cb.seen_commit)
            state = run(node.executor.apply_block(state, cb.block_id, cb.block))
        self.port = node
        jstate = jax_state_from_genesis(JaxGenesisDoc.from_json(genesis))
        self.jss, self.jbs = JaxStateStore(JaxMemKV()), JaxBlockStore(JaxMemKV())
        self.jss.save(jstate)
        jexec = JaxBlockExecutor(self.jss, JaxLocalClient(JaxKVStore()), JaxNopMempool(),
                                 block_store=self.jbs, metrics=StateMetrics(Registry()))
        for cb in chain:
            block = JaxBlock.from_proto(cb.block.to_proto())
            self.jbs.save_block(block, block.make_part_set(), JaxCommit.from_proto(cb.seen_commit.to_proto()))
            jstate = run(jexec.apply_block(jstate, JaxBlockID.from_proto(cb.block_id.to_proto()), block))

    def pools(self):
        port = EvidencePool(MemKV(), self.port.state_store, self.port.block_store)
        jax = JaxEvidencePool(JaxMemKV(), self.jss, self.jbs, metrics=EvidenceMetrics(Registry()))
        return port, jax


@pytest.fixture(scope="module")
def nodes():
    privs = workloads.seeded_keys(4, SEED)
    genesis = workloads.kv_genesis(CHAIN_ID, privs)
    txs = [workloads.kv_txs(SEED, h, 3, (40, 60)) for h in (1, 2, 3)]
    chain = workloads.build_block_chain(genesis, privs, txs, SEED)
    return _Nodes(privs, genesis, chain)


def _double_sign(nodes, h: int, i: int, **over):
    """Validator i's two conflicting precommits at height h, as
    DuplicateVoteEvidence with the block time and set of h; `over`
    breaks a field."""
    vals = nodes.port.state_store.load_validators(h)
    addr = vals.validators[i].address
    priv = next(p for p in nodes.privs if p.pub_key().address() == addr)
    votes = []
    for tag in (b"\xaa", b"\xbb"):
        v = Vote(type=PRECOMMIT_TYPE, height=h, round=0, block_id=BlockID(tag * 32, PartSetHeader(1, tag * 32)),
                 timestamp_ns=5, validator_address=addr, validator_index=i)
        v.signature = priv.sign(v.sign_bytes(CHAIN_ID))
        votes.append(v)
    time_ns = nodes.port.block_store.load_block_meta(h).header.time_ns
    ev = DuplicateVoteEvidence.from_votes(votes[0], votes[1], time_ns, vals)
    for k, v in over.items():
        if k == "vote_b_round":
            ev.vote_b.round = v
        elif k == "same_block":
            ev.vote_b.block_id = ev.vote_a.block_id
        elif k == "bad_sig":
            ev.vote_b.signature = bytes([ev.vote_b.signature[0] ^ 1]) + ev.vote_b.signature[1:]
        elif k == "other_address":
            ev.vote_b.validator_address = b"\x09" * 20
        elif k == "height":
            ev.vote_a.height = ev.vote_b.height = v
        else:
            setattr(ev, k, v)
    return ev


def _attack(nodes, **over):
    """A light-client attack: block 2's header with another app hash,
    signed by every validator (common height 1)."""
    cb = nodes.chain[1]
    header = type(cb.block.header).from_proto(cb.block.header.to_proto())
    header.app_hash = b"\x44" * 32
    vals = nodes.port.state_store.load_validators(1)
    bid = BlockID(header.hash(), cb.block_id.part_set_header)
    commit = workloads.sign_commit(CHAIN_ID, vals, bid, 2, header.time_ns, nodes.privs, SEED)
    if over.pop("same_header", False):
        header = cb.block.header
    if over.pop("bad_sig", False):
        s = commit.signatures[0]
        s.signature = bytes([s.signature[0] ^ 1]) + s.signature[1:]
    ev = LightClientAttackEvidence(
        conflicting_block=LightBlock(SignedHeader(header, commit), vals),
        common_height=1, total_voting_power=vals.total_voting_power(), timestamp_ns=7,
    )
    for k, v in over.items():
        setattr(ev, k, v)
    return ev


EVIDENCE_CASES = {
    "duplicate_vote": lambda n: _double_sign(n, 2, 1),
    "duplicate_vote_other_round": lambda n: _double_sign(n, 2, 1, vote_b_round=1),
    "duplicate_vote_same_block": lambda n: _double_sign(n, 2, 1, same_block=True),
    "duplicate_vote_bad_signature": lambda n: _double_sign(n, 2, 2, bad_sig=True),
    "duplicate_vote_other_validator": lambda n: _double_sign(n, 2, 0, other_address=True),
    "duplicate_vote_wrong_power": lambda n: _double_sign(n, 2, 3, validator_power=11),
    "duplicate_vote_wrong_total": lambda n: _double_sign(n, 2, 3, total_voting_power=41),
    "duplicate_vote_wrong_time": lambda n: _double_sign(n, 1, 3, timestamp_ns=3),
    "duplicate_vote_unknown_height": lambda n: _double_sign(n, 3, 1, height=9),
    "light_client_attack": lambda n: _attack(n),
    "light_client_attack_bad_signature": lambda n: _attack(n, bad_sig=True),
    # the trusted header is the one at the common height
    "light_client_attack_same_header": lambda n: _attack(n, same_header=True, common_height=2),
    "light_client_attack_wrong_total": lambda n: _attack(n, total_voting_power=3),
}


def _pool_db(pool) -> list:
    return list(pool.db.iterate())


@pytest.mark.parametrize("case", sorted(EVIDENCE_CASES))
def test_evidence_verify_and_pool_intake_as_jax(nodes, case):
    ev = EVIDENCE_CASES[case](nodes)
    jev = jax_evidence_from_proto(evidence_to_proto(ev))
    port_state, jax_state = nodes.port.state_store.load(), nodes.jss.load()
    got = _outcome(lambda: verify_evidence(ev, port_state, nodes.port.state_store, nodes.port.block_store))
    want = _outcome(lambda: jax_verify_evidence(jev, jax_state, nodes.jss, nodes.jbs))
    assert got == want
    assert (got[0] == "ok") == (case in ("duplicate_vote", "light_client_attack"))
    pool, jpool = nodes.pools()
    assert _outcome(lambda: pool.add_evidence(ev)) == _outcome(lambda: jpool.add_evidence(jev))
    assert _outcome(lambda: pool.check_evidence([ev])) == _outcome(lambda: jpool.check_evidence([jev]))
    assert _outcome(lambda: pool.check_evidence([ev, ev])) == _outcome(lambda: jpool.check_evidence([jev, jev]))
    assert pool.size() == jpool.size() and _pool_db(pool) == _pool_db(jpool)
    assert [e.bytes() for e in pool.pending_evidence(1 << 20)[0]] == [
        e.bytes() for e in jpool.pending_evidence(1 << 20)[0]
    ]


def test_reported_conflict_becomes_evidence_then_committed_as_jax(nodes):
    """report_conflicting_votes buffers a pair; the next update forms the
    same DuplicateVoteEvidence (pending, stored); an update with it in
    the block marks it committed and drops it from pending; check of a
    committed item is refused, in both."""
    ev = _double_sign(nodes, 2, 1)
    jev = jax_evidence_from_proto(evidence_to_proto(ev))
    pool, jpool = nodes.pools()
    pool.report_conflicting_votes(ev.vote_a, ev.vote_b)
    jpool.report_conflicting_votes(jev.vote_a, jev.vote_b)
    assert pool.size() == jpool.size() == 0
    state, jstate = nodes.port.state_store.load(), nodes.jss.load()
    pool.update(state, [])
    jpool.update(jstate, [])
    assert pool.size() == jpool.size() == 1 and _pool_db(pool) == _pool_db(jpool)
    assert pool.pending_evidence(1 << 20)[0][0].bytes() == ev.bytes()
    pool.update(state, [ev])
    jpool.update(jstate, [jev])
    assert pool.size() == jpool.size() == 0 and pool.is_committed(ev) and jpool.is_committed(jev)
    assert _pool_db(pool) == _pool_db(jpool)
    assert _outcome(lambda: pool.check_evidence([ev])) == _outcome(lambda: jpool.check_evidence([jev]))
    assert _outcome(lambda: pool.check_evidence([ev]))[1] == "evidence was already committed"
    # another pair pending; a pool restarted on the same database
    # reloads it
    other = _double_sign(nodes, 2, 2)
    pool.report_conflicting_votes(other.vote_a, other.vote_b)
    jother = jax_evidence_from_proto(evidence_to_proto(other))
    jpool.report_conflicting_votes(jother.vote_a, jother.vote_b)
    pool.update(state, [])
    jpool.update(jstate, [])
    again = EvidencePool(pool.db, nodes.port.state_store, nodes.port.block_store)
    jagain = JaxEvidencePool(jpool.db, nodes.jss, nodes.jbs, metrics=EvidenceMetrics(Registry()))
    assert again.size() == jagain.size() == 1
    assert again.pending_evidence(1 << 20)[0][0].bytes() == jagain.pending_evidence(1 << 20)[0][0].bytes()
