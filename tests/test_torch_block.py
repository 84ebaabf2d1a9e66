"""The block types and stores of the port, held against the JAX package.

ConsensusParams, GenesisDoc, Part and PartSet, Block and BlockMeta,
DuplicateVoteEvidence and the Evidence oneof, State, ValidatorSet change
sets, the ABCI responses a height stores, SqliteKV and BlockStore: the
same seeded inputs go through tendermint_tpu and tendermint_tpu_torch,
and the wire bytes, hashes, exception types and messages must be equal.
Tolerance: zero (everything here is exact bytes). State crosses between
the packages as bytes only (tendermint_tpu_torch/interop.py). Nothing
here reaches a device program; stores live in pytest's tmp_path.
"""

import asyncio

import numpy as np
import pytest

from tendermint_tpu.abci import codec as jax_codec
from tendermint_tpu.abci import types as jax_abci
from tendermint_tpu.crypto import sr25519 as _jax_sr  # noqa: F401  (registers the key type)
from tendermint_tpu.crypto.ed25519 import PubKeyEd25519 as JaxEdPub
from tendermint_tpu.crypto.sr25519 import PubKeySr25519 as JaxSrPub
from tendermint_tpu.state.store import ABCIResponses as JaxABCIResponses
from tendermint_tpu.state.types import State as JaxState
from tendermint_tpu.state.types import median_time as jax_median_time
from tendermint_tpu.state.types import state_from_genesis as jax_state_from_genesis
from tendermint_tpu.store.block_store import BlockStore as JaxBlockStore
from tendermint_tpu.store.kv import Batch as JaxBatch
from tendermint_tpu.store.kv import SqliteKV as JaxSqliteKV
from tendermint_tpu.types.block import Block as JaxBlock
from tendermint_tpu.types.block import max_data_bytes as jax_max_data_bytes
from tendermint_tpu.types.block_meta import BlockMeta as JaxBlockMeta
from tendermint_tpu.types.commit import Commit as JaxCommit
from tendermint_tpu.types.evidence import DuplicateVoteEvidence as JaxDVE
from tendermint_tpu.types.evidence import evidence_from_proto as jax_evidence_from_proto
from tendermint_tpu.types.evidence import evidence_to_proto as jax_to
from tendermint_tpu.types.genesis import GenesisDoc as JaxGenesisDoc
from tendermint_tpu.types.params import ConsensusParams as JaxParams
from tendermint_tpu.types.part_set import Part as JaxPart
from tendermint_tpu.types.part_set import PartSet as JaxPartSet
from tendermint_tpu.types.validator import Validator as JaxValidator
from tendermint_tpu.types.validator import ValidatorSet as JaxValidatorSet
from tendermint_tpu.types.vote import Vote as JaxVote
from tendermint_tpu_torch import interop, workloads
from tendermint_tpu_torch.abci import codec as port_codec
from tendermint_tpu_torch.abci import types as port_abci
from tendermint_tpu_torch.state.store import ABCIResponses
from tendermint_tpu_torch.state.types import median_time, state_from_genesis
from tendermint_tpu_torch.store.block_store import BlockStore
from tendermint_tpu_torch.store.kv import Batch, MemKV, SqliteKV, open_db
from tendermint_tpu_torch.types.block import max_data_bytes
from tendermint_tpu_torch.types.block_id import BlockID, PartSetHeader
from tendermint_tpu_torch.types.block_meta import BlockMeta
from tendermint_tpu_torch.types.commit import Commit
from tendermint_tpu_torch.types.evidence import (
    DuplicateVoteEvidence,
    evidence_from_proto,
    evidence_to_proto,
)
from tendermint_tpu_torch.types.params import ConsensusParams
from tendermint_tpu_torch.types.part_set import Part, PartSet
from tendermint_tpu_torch.types.validator import Validator, ValidatorSet
from tendermint_tpu_torch.types.vote import Vote

from .test_torch_isolation import jax_device_plane_paused  # noqa: F401 (autouse)

CHAIN_ID = "torch-block-chain"
SEED = 13


def _outcome(fn):
    try:
        out = fn()
    except Exception as e:  # the outcome compared IS the exception
        return type(e).__name__, str(e)
    return "ok", out


@pytest.fixture(scope="module")
def chain():
    """A 4 ed25519 + 2 sr25519 kvstore chain of 4 heights, made and
    applied by the port (workloads.build_block_chain)."""
    privs = workloads.seeded_keys(6, SEED, 2)
    genesis = workloads.kv_genesis(CHAIN_ID, privs)
    rng = np.random.default_rng(SEED)
    txs = [workloads.kv_txs(SEED, h, int(rng.integers(0, 9)), (34, 90)) for h in range(1, 5)]
    return genesis, privs, workloads.build_block_chain(genesis, privs, txs, SEED)


# -- params, genesis, state --


def _params_pair(rng):
    types = [["ed25519"], ["ed25519", "sr25519"], ["sr25519", "ed25519", "secp256k1"]][
        int(rng.integers(0, 3))
    ]
    vals = dict(
        max_bytes=int(rng.integers(1, 1 << 26)),
        max_gas=int(rng.integers(-1, 1 << 40)),
        age=int(rng.integers(1, 1 << 20)),
        dur=int(rng.integers(1, 1 << 50)),
        ev=int(rng.integers(0, 1 << 20)),
        app=int(rng.integers(0, 9)),
    )
    out = []
    for cls in (JaxParams, ConsensusParams):
        p = cls()
        p.block.max_bytes, p.block.max_gas = vals["max_bytes"], vals["max_gas"]
        p.evidence.max_age_num_blocks = vals["age"]
        p.evidence.max_age_duration_ns = vals["dur"]
        p.evidence.max_bytes = vals["ev"]
        p.validator.pub_key_types = list(types)
        p.version.app_version = vals["app"]
        out.append(p)
    return out


@pytest.mark.parametrize("seed", range(6))
def test_params_bytes_hash_and_validation_equal_jax(seed):
    rng = np.random.default_rng([SEED, seed])
    jp, pp = _params_pair(rng)
    assert pp.to_proto() == jp.to_proto()
    assert pp.hash() == jp.hash()
    assert ConsensusParams.from_proto(jp.to_proto()).to_proto() == jp.to_proto()
    assert _outcome(pp.validate) == _outcome(jp.validate)
    assert pp.update(pp).to_proto() == jp.update(jp).to_proto()
    # each limit broken alone gives the JAX package's message
    for attr, sub, value in (
        ("block", "max_bytes", 0),
        ("block", "max_bytes", 104857601),
        ("block", "max_gas", -2),
        ("evidence", "max_age_num_blocks", 0),
        ("evidence", "max_age_duration_ns", 0),
        ("evidence", "max_bytes", -1),
        ("validator", "pub_key_types", []),
    ):
        jb, pb = _params_pair(np.random.default_rng([SEED, seed]))
        setattr(getattr(jb, attr), sub, value)
        setattr(getattr(pb, attr), sub, value)
        assert _outcome(pb.validate) == _outcome(jb.validate)


def test_genesis_json_validator_set_and_state_equal_jax(chain):
    genesis, _privs, _blocks = chain
    jg = JaxGenesisDoc.from_json(genesis)
    pg = interop.genesis_from_json(jg.to_json())
    assert pg.to_json() == jg.to_json() == genesis
    assert pg.validator_set().to_proto() == jg.validator_set().to_proto()
    assert pg.validator_set().hash() == jg.validator_set().hash()
    ps, js = state_from_genesis(pg), jax_state_from_genesis(jg)
    assert ps.to_proto() == js.to_proto()
    assert interop.state_from_proto(js.to_proto()).to_proto() == js.to_proto()
    assert ps.copy().to_proto() == js.copy().to_proto()
    # the checks of validate_and_complete, each with the JAX message
    for edit in (
        lambda g: setattr(g, "chain_id", ""),
        lambda g: setattr(g, "chain_id", "x" * 51),
        lambda g: setattr(g, "initial_height", -1),
        lambda g: setattr(g.validators[0], "power", 0),
        lambda g: setattr(g.validators[1], "address", b"\x01" * 20),
        lambda g: setattr(g.consensus_params.block, "max_bytes", 0),
    ):
        a, b = JaxGenesisDoc.from_json(genesis), interop.genesis_from_json(genesis)
        edit(a)
        edit(b)
        assert _outcome(b.validate_and_complete) == _outcome(a.validate_and_complete)


def test_state_copy_median_time_and_store_form_equal_jax(chain):
    genesis, _privs, blocks = chain
    commit = blocks[1].block.last_commit
    jcommit = JaxCommit.from_proto(commit.to_proto())
    vals = state_from_genesis(interop.genesis_from_json(genesis)).validators
    jvals = JaxValidatorSet.from_proto(vals.to_proto())
    assert median_time(commit, vals) == jax_median_time(jcommit, jvals)
    assert _outcome(lambda: median_time(Commit(height=2), vals)) == _outcome(
        lambda: jax_median_time(JaxCommit(height=2), jvals)
    )
    # a state after two heights, through the store form both ways
    node = workloads.block_exec_node(genesis)
    state = node.state
    for cb in blocks[:2]:
        state = asyncio.run(node.executor.apply_block(state, cb.block_id, cb.block))
    js = JaxState.from_proto(state.to_proto())
    assert js.to_proto() == state.to_proto()
    assert js.copy().to_proto() == state.copy().to_proto()


# -- parts, blocks, metas, evidence --


@pytest.mark.parametrize("size,part_size", [(0, 64), (1, 64), (64, 64), (65, 64), (1000, 37), (5000, 512)])
def test_part_set_bytes_proofs_and_assembly_equal_jax(size, part_size):
    data = np.random.default_rng([SEED, size]).bytes(size)
    jps = JaxPartSet.from_data(data, part_size)
    pps = PartSet.from_data(data, part_size)
    assert (pps.total, pps.hash, pps.byte_size) == (jps.total, jps.hash, jps.byte_size)
    assert [pps.parts[i].to_proto() for i in range(pps.total)] == [
        jps.parts[i].to_proto() for i in range(jps.total)
    ]
    # a receiver filling the set part by part from the header
    recv = PartSet.from_header(pps.header())
    for i in reversed(range(pps.total)):
        part = Part.from_proto(jps.parts[i].to_proto())
        assert recv.add_part(part) is True
        assert recv.add_part(part) is False
    assert recv.is_complete() and recv.assemble() == data
    assert recv.parts_bit_array.count() == pps.total
    # a part with a foreign proof, and one past the end
    if pps.total > 1:
        jrecv, precv = JaxPartSet.from_header(jps.header()), PartSet.from_header(pps.header())
        jbad = JaxPart(index=0, bytes=jps.parts[1].bytes, proof=jps.parts[0].proof)
        pbad = Part(index=0, bytes=pps.parts[1].bytes, proof=pps.parts[0].proof)
        assert _outcome(lambda: precv.add_part(pbad)) == _outcome(lambda: jrecv.add_part(jbad))
    jp = JaxPart(index=pps.total, bytes=b"", proof=jps.parts[0].proof)
    pp = Part(index=pps.total, bytes=b"", proof=pps.parts[0].proof)
    assert _outcome(lambda: PartSet.from_header(pps.header()).add_part(pp)) == _outcome(
        lambda: JaxPartSet.from_header(jps.header()).add_part(jp)
    )


def _dve_pair(privs, vals, rng):
    """The same two conflicting precommits in both packages."""
    i = int(rng.integers(0, len(vals)))
    val = vals.validators[i]
    priv = next(p for p in privs if p.pub_key().address() == val.address)
    votes = []
    for tag in (b"a", b"b"):
        v = Vote(
            type=2, height=3, round=1,
            block_id=BlockID(hash=tag * 32, part_set_header=PartSetHeader(1, tag * 32)),
            timestamp_ns=workloads.BASE_TIME_NS + int(rng.integers(0, 10**9)),
            validator_address=val.address, validator_index=i,
        )
        v.signature = priv.sign(v.sign_bytes(CHAIN_ID)) if priv.type() == "ed25519" else (
            priv.sign(v.sign_bytes(CHAIN_ID), rng=rng.bytes)
        )
        votes.append(v)
    jvals = JaxValidatorSet.from_proto(vals.to_proto())
    jvotes = [JaxVote.from_proto(v.to_proto()) for v in votes]
    return (
        DuplicateVoteEvidence.from_votes(votes[1], votes[0], 77, vals),
        JaxDVE.from_votes(jvotes[1], jvotes[0], 77, jvals),
    )


def test_duplicate_vote_evidence_and_oneof_equal_jax(chain):
    genesis, privs, _blocks = chain
    vals = interop.genesis_from_json(genesis).validator_set()
    pe, je = _dve_pair(privs, vals, np.random.default_rng(SEED))
    assert pe.to_proto() == je.to_proto()
    assert pe.hash() == je.hash()
    assert (pe.height(), pe.validator_power, pe.total_voting_power) == (
        je.height(), je.validator_power, je.total_voting_power
    )
    assert _outcome(pe.validate_basic) == _outcome(je.validate_basic)
    assert evidence_to_proto(pe) == jax_to(je)
    assert evidence_from_proto(jax_to(je)).to_proto() == je.to_proto()
    assert _outcome(lambda: evidence_from_proto(b"")) == _outcome(lambda: jax_evidence_from_proto(b""))
    # the votes swapped, and one vote twice: validate_basic refuses both
    for edit in (
        lambda e: (setattr(e, "vote_a", e.vote_b)),
        lambda e: (setattr(e, "vote_b", e.vote_a)),
    ):
        a, b = JaxDVE.from_proto(je.to_proto()), DuplicateVoteEvidence.from_proto(je.to_proto())
        edit(a)
        edit(b)
        assert _outcome(b.validate_basic) == _outcome(a.validate_basic)
    assert _outcome(lambda: DuplicateVoteEvidence.from_votes(None, None, 0, vals)) == _outcome(
        lambda: JaxDVE.from_votes(None, None, 0, JaxValidatorSet.from_proto(vals.to_proto()))
    )


def test_blocks_metas_and_tampering_equal_jax(chain):
    genesis, privs, blocks = chain
    vals = interop.genesis_from_json(genesis).validator_set()
    pe, _je = _dve_pair(privs, vals, np.random.default_rng(SEED + 1))
    for cb in blocks:
        raw = cb.block.to_proto()
        jb = JaxBlock.from_proto(raw)
        pb = interop.block_from_proto(raw)
        assert jb.to_proto() == pb.to_proto() == raw
        assert pb.hash() == jb.hash() == cb.block_id.hash
        assert pb.block_id().to_proto() == jb.block_id().to_proto() == cb.block_id.to_proto()
        assert pb.make_part_set(1024).header() == cb.block.make_part_set(1024).header()
        assert [p.to_proto() for p in pb.make_part_set(1024).parts] == [
            p.to_proto() for p in jb.make_part_set(1024).parts
        ]
        assert _outcome(pb.validate_basic) == _outcome(jb.validate_basic) == ("ok", None)
        assert BlockMeta.from_block(pb, pb.size()).to_proto() == JaxBlockMeta.from_block(jb, jb.size()).to_proto()
        # evidence in the block, through the oneof
        pb.evidence, pb.header.evidence_hash = [pe], b""
        pb.fill_header()
        jb2 = JaxBlock.from_proto(pb.to_proto())
        assert jb2.to_proto() == pb.to_proto() and jb2.hash() == pb.hash()
    # each header or body field out of step with the rest
    raw = blocks[2].block.to_proto()
    for edit in (
        lambda b: b.txs.append(b"extra=1"),
        lambda b: b.last_commit.signatures.pop(),
        lambda b: setattr(b.header, "evidence_hash", b"\x05" * 32),
        lambda b: setattr(b.header, "height", 0),
        lambda b: setattr(b.header, "chain_id", "c" * 51),
        lambda b: setattr(b.header, "proposer_address", b"\x01" * 19),
        lambda b: setattr(b.header, "data_hash", b"\x01" * 31),
        lambda b: setattr(b, "last_commit", None),
        lambda b: setattr(b.last_commit, "round", -1),
    ):
        a, b = JaxBlock.from_proto(raw), interop.block_from_proto(raw)
        edit(a)
        edit(b)
        assert _outcome(b.validate_basic) == _outcome(a.validate_basic)
    for n_vals in (1, 150, 10_000):
        for mb in (1000, 1 << 20, 22020096):
            assert _outcome(lambda: max_data_bytes(mb, 17, n_vals)) == _outcome(
                lambda: jax_max_data_bytes(mb, 17, n_vals)
            )


# -- validator change sets --


def _change_pair(rng, vals_proto, n_changes, privs):
    """The same seeded change set in both packages: new keys, new powers
    of members, removals (power 0)."""
    jvals = JaxValidatorSet.from_proto(vals_proto)
    members = [v for v in jvals.validators]
    port_changes, jax_changes = [], []
    for k in range(n_changes):
        r = float(rng.random())
        if r < 0.4 or not members:
            priv = privs[k % len(privs)]
            pub, power = priv.pub_key(), int(rng.integers(1, 30))
        else:
            m = members[int(rng.integers(0, len(members)))]
            pub = m.pub_key
            power = 0 if r < 0.7 else int(rng.integers(1, 30))
        raw = pub.bytes()
        jpub = JaxSrPub(raw) if pub.type() == "sr25519" else JaxEdPub(raw)
        port_pub = interop.validator_set_from_proto(
            JaxValidatorSet([JaxValidator(pub_key=jpub, voting_power=1)]).to_proto()
        ).validators[0].pub_key
        jax_changes.append(JaxValidator(pub_key=jpub, voting_power=power))
        port_changes.append(Validator(pub_key=port_pub, voting_power=power))
    return jvals, interop.validator_set_from_proto(vals_proto), jax_changes, port_changes


@pytest.mark.parametrize("seed", range(8))
def test_validator_change_sets_equal_jax(chain, seed):
    genesis, _privs, _blocks = chain
    rng = np.random.default_rng([SEED, 50, seed])
    vals_proto = interop.genesis_from_json(genesis).validator_set().to_proto()
    new = workloads.seeded_keys(4, SEED + 100 + seed, 2)
    jvals, pvals, jc, pc = _change_pair(rng, vals_proto, int(rng.integers(0, 5)), new)
    if seed == 6:  # a duplicate entry
        jc, pc = jc + jc[:1], pc + pc[:1]
    if seed == 7:  # every member removed
        jc = [JaxValidator(pub_key=v.pub_key, voting_power=0) for v in jvals.validators]
        pc = [Validator(pub_key=v.pub_key, voting_power=0) for v in pvals.validators]
    want = _outcome(lambda: jvals.update_with_change_set(jc))
    assert _outcome(lambda: pvals.update_with_change_set(pc)) == want
    assert pvals.to_proto() == jvals.to_proto()
    assert pvals.hash() == jvals.hash()
    c = pvals.copy_increment_proposer_priority(3)
    assert c.to_proto() == jvals.copy_increment_proposer_priority(3).to_proto()
    assert c.hash() == pvals.hash()


# -- ABCI responses --


def _responses(rng, mod, params_cls):
    def attr():
        return mod.EventAttribute(rng.bytes(int(rng.integers(0, 6))), rng.bytes(4), bool(rng.integers(0, 2)))

    def event():
        return mod.Event(type=["app", "transfer", ""][int(rng.integers(0, 3))],
                         attributes=tuple(attr() for _ in range(int(rng.integers(0, 3)))))

    txs = [
        mod.ResponseDeliverTx(
            code=int(rng.integers(0, 3)), data=rng.bytes(int(rng.integers(0, 5))),
            log="log" * int(rng.integers(0, 2)), gas_wanted=int(rng.integers(0, 9)),
            gas_used=int(rng.integers(0, 9)), events=tuple(event() for _ in range(int(rng.integers(0, 3)))),
            codespace="cs" * int(rng.integers(0, 2)),
        )
        for _ in range(int(rng.integers(0, 6)))
    ]
    params = params_cls() if rng.random() < 0.5 else None
    ups = tuple(
        mod.ValidatorUpdate(mod.PubKey(["ed25519", "sr25519"][int(rng.integers(0, 2))], rng.bytes(32)),
                            int(rng.integers(0, 20)))
        for _ in range(int(rng.integers(0, 3)))
    )
    end = mod.ResponseEndBlock(validator_updates=ups, consensus_param_updates=params,
                               events=tuple(event() for _ in range(int(rng.integers(0, 2)))))
    begin = mod.ResponseBeginBlock(events=tuple(event() for _ in range(int(rng.integers(0, 3)))))
    return txs, end, begin


@pytest.mark.parametrize("seed", range(5))
def test_abci_responses_bytes_equal_jax(seed):
    jt, je, jb = _responses(np.random.default_rng([SEED, 60, seed]), jax_abci, JaxParams)
    pt, pe, pb = _responses(np.random.default_rng([SEED, 60, seed]), port_abci, ConsensusParams)
    assert [port_codec.enc_resp_deliver_tx(r) for r in pt] == [jax_codec._enc_resp_deliver_tx(r) for r in jt]
    assert port_codec.enc_resp_end_block(pe) == jax_codec._enc_resp_end_block(je)
    assert port_codec.enc_resp_begin_block(pb) == jax_codec._enc_resp_begin_block(jb)
    jr = JaxABCIResponses(
        deliver_txs=[jax_codec._enc_resp_deliver_tx(r) for r in jt],
        end_block=jax_codec._enc_resp_end_block(je),
        begin_block=jax_codec._enc_resp_begin_block(jb),
    )
    pr = interop.abci_responses_from_proto(jr.to_proto())
    assert pr.to_proto() == jr.to_proto()
    assert [port_codec.enc_resp_deliver_tx(r) for r in pr.deliver_tx_objs] == jr.deliver_txs
    assert port_codec.enc_resp_end_block(pr.end_block_obj) == jr.end_block
    assert port_codec.enc_resp_begin_block(pr.begin_block_obj) == jr.begin_block
    again = ABCIResponses(pr.deliver_txs, pr.end_block, pr.begin_block)
    assert again.to_proto() == jr.to_proto()


# -- SqliteKV and BlockStore --


def test_sqlite_kv_matches_memkv_and_jax(tmp_path):
    rng = np.random.default_rng([SEED, 70])
    port_db = SqliteKV(str(tmp_path / "port.sqlite"))
    jax_db = JaxSqliteKV(str(tmp_path / "jax.sqlite"))
    mem = MemKV()
    try:
        keys = [rng.bytes(int(rng.integers(1, 4))) for _ in range(40)]
        for step in range(120):
            k = keys[int(rng.integers(0, len(keys)))]
            r = float(rng.random())
            for db in (port_db, jax_db, mem):
                if r < 0.6:
                    db.set(k, bytes([step % 256]))
                elif r < 0.8:
                    db.delete(k)
            if r >= 0.8:
                b, jb = Batch(), JaxBatch()
                for kk in keys[:5]:
                    b.set(kk, b"batch")
                    jb.set(kk, b"batch")
                b.delete(k)
                jb.delete(k)
                port_db.write_batch(b)
                mem.write_batch(b)
                jax_db.write_batch(jb)
        lo, hi = sorted(rng.bytes(2) for _ in range(2))
        for db in (port_db, mem):
            assert list(db.iterate()) == list(jax_db.iterate())
            assert list(db.iterate(lo, hi, reverse=True)) == list(jax_db.iterate(lo, hi, reverse=True))
            assert db.first_key(lo, hi) == jax_db.first_key(lo, hi)
            assert db.last_key(lo, hi) == jax_db.last_key(lo, hi)
            assert [db.get(k) for k in keys] == [jax_db.get(k) for k in keys]
            assert [db.has(k) for k in keys] == [jax_db.has(k) for k in keys]
    finally:
        port_db.close()
        jax_db.close()
    reopened = open_db("port", "sqlite", str(tmp_path))
    try:
        assert list(reopened.iterate()) == list(mem.iterate())
    finally:
        reopened.close()
    assert isinstance(open_db("x", "memdb", str(tmp_path)), MemKV)
    with pytest.raises(ValueError, match="unknown db backend"):
        open_db("x", "rocksdb", str(tmp_path))


def test_block_store_round_trip_and_pruning_equal_jax(chain, tmp_path):
    _genesis, _privs, blocks = chain
    port_db = SqliteKV(str(tmp_path / "port-blocks.sqlite"))
    jax_db = JaxSqliteKV(str(tmp_path / "jax-blocks.sqlite"))
    try:
        ps, js = BlockStore(port_db), JaxBlockStore(jax_db)
        for cb in blocks:
            jblock = JaxBlock.from_proto(cb.block.to_proto())
            jparts = jblock.make_part_set()
            jseen = JaxCommit.from_proto(cb.seen_commit.to_proto())
            ps.save_block(cb.block, cb.parts, cb.seen_commit)
            js.save_block(jblock, jparts, jseen)
        assert list(port_db.iterate()) == list(jax_db.iterate())
        assert (ps.base(), ps.height(), ps.size()) == (js.base(), js.height(), js.size())
        for cb in blocks:
            h = cb.block.header.height
            assert ps.load_block(h).to_proto() == js.load_block(h).to_proto() == cb.block.to_proto()
            assert ps.load_block_meta(h).to_proto() == js.load_block_meta(h).to_proto()
            assert ps.load_block_by_hash(cb.block_id.hash).to_proto() == cb.block.to_proto()
            assert ps.load_block_part(h, 0).to_proto() == js.load_block_part(h, 0).to_proto()
            c, jc = ps.load_block_commit(h - 1), js.load_block_commit(h - 1)
            assert (c and c.to_proto()) == (jc and jc.to_proto())
        assert ps.load_seen_commit().to_proto() == js.load_seen_commit().to_proto()
        # a height out of order is refused with the JAX message
        bad = blocks[1]
        assert _outcome(lambda: ps.save_block(bad.block, bad.parts, bad.seen_commit)) == _outcome(
            lambda: js.save_block(JaxBlock.from_proto(bad.block.to_proto()),
                                  JaxBlock.from_proto(bad.block.to_proto()).make_part_set(),
                                  JaxCommit.from_proto(bad.seen_commit.to_proto()))
        )
        for retain in (0, 2, 2, 1, 3, 9):
            assert _outcome(lambda: ps.prune_blocks(retain)) == _outcome(lambda: js.prune_blocks(retain))
            assert list(port_db.iterate()) == list(jax_db.iterate())
        assert (ps.base(), ps.height()) == (js.base(), js.height()) == (3, 4)
        assert ps.load_block(2) is None and ps.load_block_meta(2) is None
        assert ps.load_block(3).to_proto() == blocks[2].block.to_proto()
    finally:
        port_db.close()
        jax_db.close()
