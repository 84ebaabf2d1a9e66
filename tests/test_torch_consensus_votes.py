"""The consensus vote path of the port, held against the JAX package:
BitArray and its wire form, the verified-signature cache, VoteSet and
HeightVoteSet, the vote messages, and the vote-burst pre-verify of the
receive loop.

Inputs come from numpy seeds: keys and votes from the port's seeded
workloads (tendermint_tpu_torch.workloads), carried to the JAX package
as wire bytes. The JAX side runs on its CPU verifiers; its pre-verify,
`ConsensusState._preverify_votes_impl`, is called on a stand-in `self`
holding only what it reads (rs, state.chain_id, logger). The port runs on
its native CPU plane, or with its device verifier installed on the CPU
(the kernels' plain versions) where a case says so. Tolerance: zero
(equal bytes, equal returns, the same exception type and message, the
same cached keys).
"""

import asyncio
import random
from types import SimpleNamespace

import numpy as np
import pytest

from tendermint_tpu.consensus import msgs as jax_msgs
from tendermint_tpu.consensus.state import ConsensusState as JaxConsensusState
from tendermint_tpu.consensus.types import HeightVoteSet as JaxHeightVoteSet
from tendermint_tpu.consensus.types import RoundState as JaxRoundState
from tendermint_tpu.crypto import sigcache as jax_sigcache
from tendermint_tpu.libs import rng as jax_rng
from tendermint_tpu.libs.bits import BitArray as JaxBitArray
from tendermint_tpu.libs.log import get_logger
from tendermint_tpu.types.block_id import BlockID as JaxBlockID
from tendermint_tpu.types.commit import Commit as JaxCommit
from tendermint_tpu.types.validator import ValidatorSet as JaxValidatorSet
from tendermint_tpu.types.vote import Vote as JaxVote
from tendermint_tpu.types.vote_set import VoteSet as JaxVoteSet
from tendermint_tpu.types.vote_set import commit_to_vote_set as jax_commit_to_vote_set
from tendermint_tpu_torch import interop, workloads
from tendermint_tpu_torch.consensus import msgs as port_msgs
from tendermint_tpu_torch.consensus.state import ConsensusState
from tendermint_tpu_torch.consensus.types import HeightVoteSet, RoundState, RoundStep
from tendermint_tpu_torch.crypto import batch as port_batch
from tendermint_tpu_torch.crypto import breaker, faults, gpu_verifier
from tendermint_tpu_torch.crypto import sigcache
from tendermint_tpu_torch.libs.bits import MAX_BIT_ARRAY_SIZE, BitArray
from tendermint_tpu_torch.ops.ed25519_kernel import Ed25519Verifier
from tendermint_tpu_torch.types.block_id import BlockID, PartSetHeader
from tendermint_tpu_torch.types.canonical import PRECOMMIT_TYPE, PREVOTE_TYPE
from tendermint_tpu_torch.types.validation import verify_commit
from tendermint_tpu_torch.types.vote import Vote
from tendermint_tpu_torch.types.vote_set import VoteSet, commit_to_vote_set

CHAIN_ID = "torch-votes-chain"
HEIGHT = 17


@pytest.fixture(autouse=True)
def _clean():
    """Both caches empty at their default capacity, no fault armed, no
    device verifier installed, before and after each test."""

    def reset():
        for mod in (sigcache, jax_sigcache):
            mod.reset()
            mod.set_capacity(mod.DEFAULT_CAPACITY)
        faults.reset()
        breaker.reset_all()

    reset()
    yield
    gpu_verifier.uninstall()
    reset()


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except Exception as e:  # the exception's type and text are the outcome
        return ("err", type(e).__name__, str(e))


def _jax_vote(vote):
    return JaxVote.from_proto(vote.to_proto())


def _jax_bid(bid):
    return JaxBlockID.from_proto(bid.to_proto())


def _jax_vals(vals):
    return JaxValidatorSet.from_proto(vals.to_proto())


def _bits(ba):
    return None if ba is None else (ba.size, ba.to_words())


def _sign(traffic, vote):
    """Sign `vote` with its validator's key (by index into the set)."""
    priv = traffic.privs[vote.validator_index]
    msg = vote.sign_bytes(CHAIN_ID)
    if priv.type() == "sr25519":
        vote.signature = priv.sign(msg, rng=np.random.default_rng(len(msg)).bytes)
    else:
        vote.signature = priv.sign(msg)
    return vote


def _other_block(tag: bytes) -> BlockID:
    return BlockID(bytes([tag[0]]) * 32, PartSetHeader(1, bytes([tag[0] ^ 0x5A]) * 32))


# -- BitArray and its wire form --------------------------------------------


@pytest.mark.parametrize("size", [0, 1, 7, 63, 64, 65, 130, 200])
def test_bit_array_ops_equal_jax(size):
    rng = np.random.default_rng(size)
    bits_a = rng.integers(0, 2, size).astype(bool)
    bits_b = rng.integers(0, 2, max(size - 5, 0)).astype(bool)

    def build(cls, bits):
        ba = cls(len(bits))
        for i, b in enumerate(bits):
            ba.set(i, bool(b))
        return ba

    pa, pb = build(BitArray, bits_a), build(BitArray, bits_b)
    ja, jb = build(JaxBitArray, bits_a), build(JaxBitArray, bits_b)
    for name in ("or_", "and_", "sub"):
        assert _bits(getattr(pa, name)(pb)) == _bits(getattr(ja, name)(jb)), name
        assert _bits(getattr(pb, name)(pa)) == _bits(getattr(jb, name)(ja)), name
    assert _bits(pa.not_()) == _bits(ja.not_())
    for p, j in ((pa, ja), (pb, jb)):
        assert (p.is_empty(), p.is_full(), p.count()) == (j.is_empty(), j.is_full(), j.count())
        assert list(p.indices()) == list(j.indices())
        assert [p.get(i) for i in range(-1, p.size + 1)] == [j.get(i) for i in range(-1, j.size + 1)]
        assert p.copy() == p and repr(p) == repr(j)
        back = BitArray.from_words(p.size, p.to_words())
        assert back == p and back is not p
    upd_p, upd_j = pa.copy(), ja.copy()
    upd_p.update(pb)
    upd_j.update(jb)
    assert _bits(upd_p) == _bits(upd_j)
    assert (pa == pb) == (ja == jb) and pa != _bits(pa)
    # the same seed picks the same index
    for seed in range(5):
        jax_rng.reseed(seed)
        try:
            want = ja.pick_random()
        finally:
            jax_rng.reseed(None)
        assert pa.pick_random(random.Random(seed)) == want
    # the wire form, both ways
    for p, j in ((pa, ja), (pb, jb)):
        wire = port_msgs.encode_bit_array(p)
        assert wire == jax_msgs.encode_bit_array(j)
        assert port_msgs.decode_bit_array(wire) == p
        assert _bits(jax_msgs.decode_bit_array(wire)) == _bits(p)
    assert port_msgs.encode_bit_array(None) is None
    assert port_msgs.decode_bit_array(None) is None


@pytest.mark.parametrize(
    "size, words",
    [
        (MAX_BIT_ARRAY_SIZE + 1, []),
        (64, [1, 2]),
        (65, [1 << 64]),
        (-1, []),
    ],
)
def test_bit_array_from_words_refuses_as_jax(size, words):
    assert _outcome(BitArray.from_words, size, words) == _outcome(
        JaxBitArray.from_words, size, words
    )
    assert _outcome(BitArray.from_words, size, words)[0] == "err"


# -- the verified-signature cache (tests/test_sigcache.py's triple cases) --


def test_sigcache_exact_triple_keying_and_boundaries():
    pk, sb, sig = b"\x01" * 32, b"sign-bytes", b"\x02" * 64
    sigcache.add(pk, sb, sig)
    assert sigcache.seen(pk, sb, sig)
    assert not sigcache.seen(b"\x03" + pk[1:], sb, sig)
    assert not sigcache.seen(pk, sb + b"x", sig)
    assert not sigcache.seen(pk, sb, sig[:-1] + b"\x00")
    sigcache.add(b"\x01" * 32, b"ab", b"\x02" * 64)
    assert not sigcache.seen(b"\x01" * 32, b"a", b"b" + b"\x02" * 63)


def test_sigcache_rotation_bound_and_evictions_equal_jax():
    """The same inserts give the same resident count and evictions in
    both packages, and never more than two generations."""
    counts = []
    for mod, evictions in (
        (sigcache, lambda: sigcache.stats()["evictions"]),
        (jax_sigcache, lambda: jax_sigcache.stats()["evictions"]),
    ):
        mod.set_capacity(100)
        base = evictions()
        trace = []
        for i in range(1000):
            mod.add(b"\x01" * 32, b"msg-%d" % i, b"\x02" * 64)
            assert mod.entries() <= 200
            trace.append((mod.entries(), evictions() - base))
        for start in range(0, 1000, 250):
            mod.add_keys_bulk(
                (b"\x01" * 32, b"bulk-%d" % i, b"\x02" * 64)
                for i in range(start, start + 250)
            )
            assert mod.entries() <= 200
            trace.append((mod.entries(), evictions() - base))
        counts.append(trace)
    assert counts[0] == counts[1]
    assert counts[0][-1][1] > 0


def test_sigcache_promotion_and_bulk_probe():
    sigcache.set_capacity(10)
    hot = (b"\x07" * 32, b"hot-triple", b"\x08" * 64)
    sigcache.add(*hot)
    for i in range(200):
        sigcache.add(b"\x01" * 32, b"churn-%d" % i, b"\x02" * 64)
        assert sigcache.seen(*hot)  # each consult promotes it again
    sigcache.set_capacity(sigcache.DEFAULT_CAPACITY)
    sigcache.reset()
    keys = [(b"\x01" * 32, b"msg-%d" % i, b"\x02" * 64) for i in range(6)]
    sigcache.add_keys_bulk(keys[:3])
    assert sigcache.seen_keys_bulk(keys) == set(keys[:3])
    assert sigcache.seen_keys_bulk([]) == set()
    sigcache.set_capacity(4)
    sigcache.reset()
    sigcache.add_keys_bulk([hot])
    for i in range(20):
        sigcache.add_keys_bulk([(b"\x01" * 32, b"churn-%d" % i, b"\x02" * 64)])
        assert sigcache.seen_keys_bulk([hot]) == {hot}


def test_sigcache_disabled_scope_and_counts():
    before = sigcache.stats()
    with sigcache.disabled():
        assert not sigcache.enabled()
        sigcache.add(b"\x01" * 32, b"m", b"\x02" * 64)
        assert not sigcache.seen(b"\x01" * 32, b"m", b"\x02" * 64)
    assert sigcache.enabled() and sigcache.entries() == 0
    sigcache.add(b"\x01" * 32, b"m", b"\x02" * 64)
    assert sigcache.seen(b"\x01" * 32, b"m", b"\x02" * 64)
    assert not sigcache.seen(b"\x01" * 32, b"n", b"\x02" * 64)
    after = sigcache.stats()
    assert (after["hits"] - before["hits"], after["misses"] - before["misses"]) == (1, 1)
    assert after["entries"] == 1 and after["capacity"] == sigcache.DEFAULT_CAPACITY


def test_drain_and_cache_skips_a_faulted_batch():
    class Stub:
        def __init__(self, faulted, bits):
            self.faulted, self.bits = faulted, bits

        def verify(self):
            return all(self.bits), self.bits

    keys = [("a",), ("b",), None, ("c",)]
    assert port_batch.drain_and_cache(Stub(True, [True] * 4), keys) == (True, [True] * 4)
    assert sigcache.entries() == 0
    port_batch.drain_and_cache(Stub(False, [True, False, True, True]), keys)
    assert sigcache.seen_keys_bulk([("a",), ("b",), ("c",)]) == {("a",), ("c",)}


# -- VoteSet and HeightVoteSet on seeded sequences ---------------------------

KINDS = (
    *["valid"] * 8, "duplicate", "bad_index", "bad_address",
    "negative_index", "empty_address", "forged", "short_sig", "conflict",
    "wrong_height", "catchup", "maj23", "set_round",
)


def _sequence(seed: int, n: int, steps: int):
    """(traffic, actions): the seeded validators of one height and a
    list of actions on a HeightVoteSet, each ("vote", vote, peer),
    ("maj23", round, type, peer, block id) or ("set_round", round)."""
    rng = np.random.default_rng(seed)
    t = workloads.build_vote_traffic(CHAIN_ID, HEIGHT, n, seed, n // 2)
    blocks = [t.block_id, _other_block(b"\x0b"), BlockID()]
    sent = []
    actions = []

    def fresh(i, vote_type, round_, block):
        v = Vote(
            type=vote_type,
            height=HEIGHT,
            round=round_,
            block_id=block,
            timestamp_ns=workloads.BASE_TIME_NS + int(rng.integers(0, 10**9)),
            validator_address=t.vals.validators[i].address,
            validator_index=i,
        )
        return _sign(t, v)

    for _ in range(steps):
        kind = KINDS[int(rng.integers(len(KINDS)))]
        peer = f"peer-{int(rng.integers(3))}"
        i = int(rng.integers(n))
        vote_type = (PREVOTE_TYPE, PRECOMMIT_TYPE)[int(rng.integers(2))]
        round_ = int(rng.choice(2, p=[0.8, 0.2]))
        block = blocks[int(rng.choice(3, p=[0.8, 0.1, 0.1]))]
        if kind in ("duplicate", "conflict") and not sent:
            kind = "valid"
        if kind == "valid":
            v = fresh(i, vote_type, round_, block)
            sent.append(v)
        elif kind == "duplicate":
            v = sent[int(rng.integers(len(sent)))].copy()
        elif kind == "conflict":
            prev = sent[int(rng.integers(len(sent)))]
            other = blocks[(blocks.index(prev.block_id) + 1) % 3]
            v = fresh(prev.validator_index, prev.type, prev.round, other)
        elif kind == "catchup":
            v = fresh(i, vote_type, int(rng.integers(2, 7)), block)
        elif kind == "maj23":
            actions.append(("maj23", int(rng.integers(3)), vote_type, peer, block))
            continue
        elif kind == "set_round":
            actions.append(("set_round", int(rng.integers(0, 4))))
            continue
        else:
            v = fresh(i, vote_type, round_, block)
            if kind == "bad_index":
                v.validator_index = n + int(rng.integers(1, 5))
            elif kind == "bad_address":
                v.validator_address = t.vals.validators[(i + 1) % n].address
            elif kind == "negative_index":
                v.validator_index = -1
            elif kind == "empty_address":
                v.validator_address = b""
            elif kind == "forged":
                sig = bytearray(v.signature)
                sig[int(rng.integers(64))] ^= 1 << int(rng.integers(8))
                v.signature = bytes(sig)
            elif kind == "short_sig":
                v.signature = v.signature[:63]
            elif kind == "wrong_height":
                v.height = HEIGHT + 1
                _sign(t, v)
        actions.append(("vote", v, peer))
    return t, actions


def _apply(hvs, action, to_jax: bool):
    kind = action[0]
    if kind == "vote":
        vote = _jax_vote(action[1]) if to_jax else action[1]
        return _outcome(hvs.add_vote, vote, action[2])
    if kind == "maj23":
        _k, round_, vote_type, peer, block = action
        return _outcome(
            hvs.set_peer_maj23, round_, vote_type, peer, _jax_bid(block) if to_jax else block
        )
    return _outcome(hvs.set_round, action[1])


def _vote_set_state(vs, blocks, to_jax: bool):
    bid, ok = vs.two_thirds_majority()
    by_block = [
        _bits(vs.bit_array_by_block_id(_jax_bid(b) if to_jax else b)) for b in blocks
    ]
    commit = _outcome(vs.make_commit)
    if commit[0] == "ok":
        commit = ("ok", commit[1].to_proto())
    return (
        _bits(vs.bit_array()),
        vs.sum,
        bid.to_proto(),
        ok,
        vs.has_two_thirds_any(),
        vs.has_all(),
        vs.is_commit(),
        by_block,
        sorted(vs.peer_maj23s),
        [None if v is None else v.to_proto() for v in vs.votes],
        commit,
    )


@pytest.mark.parametrize("seed", range(8))
def test_vote_sequences_equal_jax(seed):
    n = 5 + seed % 3
    t, actions = _sequence(seed, n, 70)
    port = HeightVoteSet(CHAIN_ID, HEIGHT, t.vals)
    jax_ = JaxHeightVoteSet(CHAIN_ID, HEIGHT, _jax_vals(t.vals))
    for action in actions:
        got, want = _apply(port, action, False), _apply(jax_, action, True)
        assert got == want, action
    assert sorted(port._round_vote_sets) == sorted(jax_._round_vote_sets)
    assert port.round == jax_.round
    assert port._peer_catchup_rounds == jax_._peer_catchup_rounds
    pol, pol_bid = port.pol_info()
    jpol, jpol_bid = jax_.pol_info()
    assert (pol, pol_bid and pol_bid.to_proto()) == (jpol, jpol_bid and jpol_bid.to_proto())
    blocks = [t.block_id, _other_block(b"\x0b"), BlockID()]
    for r in sorted(port._round_vote_sets):
        for vote_type in (PREVOTE_TYPE, PRECOMMIT_TYPE):
            p, j = port._get(r, vote_type), jax_._get(r, vote_type)
            assert _vote_set_state(p, blocks, False) == _vote_set_state(j, blocks, True)


def test_commit_round_trips_through_vote_sets_as_jax():
    """A +2/3 precommit set's commit, its bytes equal to the JAX
    package's, rebuilt into a VoteSet by both packages."""
    t = workloads.build_vote_traffic(CHAIN_ID, HEIGHT, 6, 99, 3)
    precommits = [v for v in t.votes if v.type == PRECOMMIT_TYPE]
    port = VoteSet(CHAIN_ID, HEIGHT, 0, PRECOMMIT_TYPE, t.vals)
    for v in precommits[:5]:
        assert port.add_vote(v)
    commit = port.make_commit()
    wire = commit.to_proto()
    jvs = jax_commit_to_vote_set(CHAIN_ID, JaxCommit.from_proto(wire), _jax_vals(t.vals))
    assert jvs.make_commit().to_proto() == wire
    back = commit_to_vote_set(CHAIN_ID, interop.commit_from_proto(wire), t.vals)
    assert _bits(back.bit_array()) == _bits(jvs.bit_array())
    assert back.make_commit().to_proto() == wire
    verify_commit(CHAIN_ID, t.vals, t.block_id, HEIGHT, commit)
    with pytest.raises(ValueError, match="cannot MakeCommit unless VoteSet type is precommit"):
        VoteSet(CHAIN_ID, HEIGHT, 0, PREVOTE_TYPE, t.vals).make_commit()


# -- the vote messages -----------------------------------------------------


def _messages():
    t = workloads.build_vote_traffic(CHAIN_ID, HEIGHT, 3, 5, 1)
    ba = BitArray(130)
    for i in (0, 64, 129):
        ba.set(i)
    bid = t.block_id
    return [
        port_msgs.VoteMessage(t.votes[0]),
        port_msgs.VoteMessage(t.votes[-1]),
        port_msgs.HasVoteMessage(height=HEIGHT, round=2, type=PRECOMMIT_TYPE, index=9),
        port_msgs.VoteSetMaj23Message(height=HEIGHT, round=1, type=PREVOTE_TYPE, block_id=bid),
        port_msgs.VoteSetBitsMessage(
            height=HEIGHT, round=0, type=PRECOMMIT_TYPE, block_id=bid, votes=ba
        ),
        port_msgs.VoteSetBitsMessage(height=HEIGHT, round=0, type=PREVOTE_TYPE),
    ]


@pytest.mark.parametrize("index", range(6))
def test_message_wire_bytes_equal_jax_both_ways(index):
    msg = _messages()[index]
    wire = port_msgs.encode_msg(msg)
    jmsg = jax_msgs.decode_msg(wire)
    assert type(jmsg).__name__ == type(msg).__name__
    assert jax_msgs.encode_msg(jmsg) == wire
    back = interop.msg_from_proto(jax_msgs.encode_msg(jmsg))
    assert back == msg and port_msgs.encode_msg(back) == wire
    info = port_msgs.MsgInfo(msg=msg, peer_id="peer-7")
    jinfo = jax_msgs.MsgInfo.from_proto(info.to_proto())
    assert jinfo.peer_id == "peer-7" and jinfo.to_proto() == info.to_proto()
    assert port_msgs.MsgInfo.from_proto(jinfo.to_proto()) == info
    assert _outcome(msg.validate_basic) == _outcome(jmsg.validate_basic)
    if isinstance(msg, port_msgs.VoteMessage):
        assert interop.vote_from_proto(jmsg.vote.to_proto()) == msg.vote


def test_unported_message_arms_are_refused_by_name():
    from tendermint_tpu.consensus.msgs import NewRoundStepMessage, ProposalPOLMessage

    for jmsg, name in (
        (NewRoundStepMessage(height=3, round=1, step=2), "NewRoundStepMessage"),
        (ProposalPOLMessage(height=3, proposal_pol_round=1), "ProposalPOLMessage"),
    ):
        with pytest.raises(ValueError, match=f"{name}.*not ported"):
            port_msgs.decode_msg(jax_msgs.encode_msg(jmsg))
    with pytest.raises(ValueError, match="empty or unknown"):
        port_msgs.decode_msg(b"")
    with pytest.raises(TypeError, match="unknown consensus message"):
        port_msgs.encode_msg(object())


@pytest.mark.parametrize(
    "msg, err",
    [
        (port_msgs.HasVoteMessage(height=-1), "negative Height"),
        (port_msgs.HasVoteMessage(round=-1), "negative Round"),
        (port_msgs.HasVoteMessage(type=3), "invalid Type"),
        (port_msgs.HasVoteMessage(type=1, index=-2), "negative Index"),
        (port_msgs.VoteSetMaj23Message(type=7), "invalid Type"),
        (port_msgs.VoteSetBitsMessage(height=-4, type=2), "negative Height"),
    ],
)
def test_message_validate_basic_equal_jax(msg, err):
    jmsg = jax_msgs.decode_msg(port_msgs.encode_msg(msg))
    got = _outcome(msg.validate_basic)
    assert got == _outcome(jmsg.validate_basic) and got[2] == err


# -- the pre-verify --------------------------------------------------------


def _burst(n=24, seed=3):
    """One burst at HEIGHT of a mixed set: every prevote, and each bad
    case: a forged signature per key type (ahead of its validator's real
    vote), a vote of a foreign height, a bad index, a 63-byte signature,
    a duplicate, an equivocation (a second prevote for another block)
    and a message that is not a vote."""
    t = workloads.build_vote_traffic(CHAIN_ID, HEIGHT, n, seed, n // 2)
    prevotes = [v for v in t.votes if v.type == PREVOTE_TYPE]
    ed = next(v for v in prevotes if t.privs[v.validator_index].type() == "ed25519")
    sr = next(v for v in prevotes if t.privs[v.validator_index].type() == "sr25519")
    bad = []
    for v in (ed, sr):
        forged = v.copy()
        forged.signature = v.signature[:5] + bytes([v.signature[5] ^ 4]) + v.signature[6:]
        bad.append(forged)
    foreign = prevotes[2].copy()
    foreign.height = HEIGHT + 3
    bad.append(_sign(t, foreign))
    bad_index = prevotes[3].copy()
    bad_index.validator_index = n + 4
    bad.append(bad_index)
    short = prevotes[4].copy()
    short.signature = short.signature[:63]
    bad.append(short)
    equivocation = prevotes[5].copy()
    equivocation.block_id = _other_block(b"\x0e")
    tail = [prevotes[6].copy(), _sign(t, equivocation)]
    votes = bad + prevotes + tail
    extra = port_msgs.HasVoteMessage(height=HEIGHT, round=0, type=PREVOTE_TYPE, index=1)
    batch = [port_msgs.MsgInfo(port_msgs.VoteMessage(v), "peer") for v in votes]
    batch.insert(3, port_msgs.MsgInfo(extra, "peer"))
    valid = {
        (t.vals.validators[v.validator_index].pub_key.bytes(), v.sign_bytes(CHAIN_ID), v.signature)
        for v in prevotes + [tail[1]]
    }
    return t, batch, valid


def _jax_preverify(t, batch):
    me = SimpleNamespace(
        rs=JaxRoundState(height=HEIGHT, validators=_jax_vals(t.vals)),
        state=SimpleNamespace(chain_id=CHAIN_ID),
        logger=get_logger("test_torch_consensus_votes"),
    )
    jbatch = [jax_msgs.MsgInfo.from_proto(mi.to_proto()) for mi in batch]
    JaxConsensusState._preverify_votes_impl(me, jbatch)
    return set(jax_sigcache._gen0) | set(jax_sigcache._gen1)


def _port_cached():
    return set(sigcache._gen0) | set(sigcache._gen1)


@pytest.mark.parametrize("route", ["cpu_plane", "device_plain"])
def test_preverify_caches_the_same_keys_as_jax(route):
    t, batch, valid = _burst()
    if route == "device_plain":
        gpu_verifier.install(device="cpu", min_batch=2, gather_deadline_s=None)
    before = gpu_verifier.stats()
    cs = workloads.vote_state(CHAIN_ID, t.vals, HEIGHT)
    cs._preverify_votes(batch)
    want = _jax_preverify(t, batch)
    assert _port_cached() == want == valid
    windows = gpu_verifier.stats()["batches"] - before["batches"]
    assert windows == (2 if route == "device_plain" else 0)
    # a second burst of the same votes: all hits, no batch
    cs._preverify_votes(batch)
    assert _jax_preverify(t, batch) == _port_cached() == valid
    assert gpu_verifier.stats()["batches"] - before["batches"] == windows
    assert gpu_verifier.stats()["faults"] == before["faults"]


def test_preverify_is_off_with_the_cache():
    t, batch, _valid = _burst()
    cs = workloads.vote_state(CHAIN_ID, t.vals, HEIGHT)
    with sigcache.disabled():
        cs._preverify_votes(batch)
    assert sigcache.entries() == 0


def _wait_probes():
    for route in gpu_verifier.ROUTES:
        t = breaker.breaker_for(route)._probe_thread
        if t is not None:
            t.join(10.0)
            assert not t.is_alive()


def test_a_faulted_preverify_caches_nothing_and_outcomes_hold():
    """A DeviceFault in the pre-verify's batch is contained (the CPU
    answers, the batch is marked faulted) and caches nothing; each vote
    then takes the per-vote path with its JAX outcome."""
    t, batch, valid = _burst()
    gpu_verifier.install(device="cpu", min_batch=2, gather_deadline_s=None)
    _wait_probes()
    before = gpu_verifier.stats()
    cs = workloads.vote_state(CHAIN_ID, t.vals, HEIGHT)
    with faults.inject("gpu.dispatch", "raise"):
        cs._preverify_votes(batch)
    after = gpu_verifier.stats()
    assert after["faults"] - before["faults"] == 2
    assert sigcache.entries() == 0
    outcomes = _ingest_outcomes(cs, [mi.msg for mi in batch])
    assert outcomes == _jax_outcomes(t, [mi.msg for mi in batch])
    # the breakers opened: the ingest's pre-verify ran on the CPU plane
    assert _port_cached() == valid
    _wait_probes()


def test_a_launch_error_reaches_the_caller(monkeypatch):
    """An error outside the fault policy is not caught by the
    pre-verify (the JAX package's `except Exception: continue`): it ends
    the receive loop, and ingest raises it."""
    t, _batch, _valid = _burst()
    gpu_verifier.install(device="cpu", min_batch=2, gather_deadline_s=None)
    _wait_probes()

    def boom(self, *args):
        raise RuntimeError("launch failed: an illegal memory access")

    monkeypatch.setattr(Ed25519Verifier, "dispatch", boom)
    cs = workloads.vote_state(CHAIN_ID, t.vals, HEIGHT)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        workloads.ingest(cs, t.wires, 256)
    assert cs.rs.votes.prevotes(0).sum == 0


# -- the receive loop ------------------------------------------------------


def _record(cs):
    """Wrap cs._add_vote to record each vote's outcome, in order."""
    seen = []
    inner = cs._add_vote

    async def add_vote(vote, peer_id):
        try:
            got = await inner(vote, peer_id)
        except Exception as e:
            seen.append(("err", type(e).__name__, str(e)))
            raise
        seen.append(("ok", got))
        return got

    cs._add_vote = add_vote
    return seen


def _ingest_outcomes(cs, msgs, burst=256):
    seen = _record(cs)
    workloads.ingest(cs, [port_msgs.encode_msg(m) for m in msgs], burst)
    return seen


def _jax_outcomes(t, msgs, hvs=None, last_commit=None, step=RoundStep.NEW_HEIGHT):
    """The JAX package's _add_vote_impl outcome of each vote, in order,
    on its HeightVoteSet: the votes of the height, a late precommit of
    the height before into `last_commit`, anything else False."""
    hvs = hvs or JaxHeightVoteSet(CHAIN_ID, HEIGHT, _jax_vals(t.vals))
    out = []
    for m in msgs:
        if not isinstance(m, port_msgs.VoteMessage):
            continue
        v = _jax_vote(m.vote)
        if v.height + 1 == HEIGHT and v.type == PRECOMMIT_TYPE:
            if step != RoundStep.NEW_HEIGHT or last_commit is None:
                out.append(("ok", False))
            else:
                out.append(_outcome(last_commit.add_vote, v))
        elif v.height != HEIGHT:
            out.append(("ok", False))
        else:
            out.append(_outcome(hvs.add_vote, v, "peer"))
    return out


def test_ingest_of_64_validators_ends_as_jax(monkeypatch):
    """64 mixed validators' prevotes and precommits with every bad case,
    through the port's ConsensusState with its device verifier on the
    plain versions (two windows: one a key type), and the same votes one
    by one into the JAX package's HeightVoteSet: the same outcomes, the
    same sets, and the same commit, which verifies."""
    t = workloads.build_vote_traffic(CHAIN_ID, HEIGHT, 64, 11, 32)
    _, bad_batch, _valid = _burst(24, 3)  # votes of another set: every one fails
    msgs = [port_msgs.decode_msg(w) for w in t.wires]
    msgs[40:40] = [mi.msg for mi in bad_batch[:8]]
    gpu_verifier.install(device="cpu", min_batch=32, gather_deadline_s=None)
    _wait_probes()
    before = gpu_verifier.stats()
    cs = workloads.vote_state(CHAIN_ID, t.vals, HEIGHT)
    got = _ingest_outcomes(cs, msgs)
    after = gpu_verifier.stats()
    assert (after["batches_ed25519"] - before["batches_ed25519"],
            after["batches_sr25519"] - before["batches_sr25519"]) == (1, 1)
    assert after["faults"] == before["faults"]
    jhvs = JaxHeightVoteSet(CHAIN_ID, HEIGHT, _jax_vals(t.vals))
    assert got == _jax_outcomes(t, msgs, jhvs)
    assert sum(o == ("ok", True) for o in got) == 128
    blocks = [t.block_id, BlockID()]
    for vote_type in (PREVOTE_TYPE, PRECOMMIT_TYPE):
        p, j = cs.rs.votes._get(0, vote_type), jhvs._get(0, vote_type)
        assert _vote_set_state(p, blocks, False) == _vote_set_state(j, blocks, True)
    commit = cs.rs.votes.precommits(0).make_commit()
    assert commit.to_proto() == jhvs.precommits(0).make_commit().to_proto()
    verify_commit(CHAIN_ID, t.vals, t.block_id, HEIGHT, commit)


def test_late_precommit_goes_to_last_commit_as_jax():
    """A precommit of the height before lands in rs.last_commit at the
    NEW_HEIGHT step and is refused at another; votes of other heights
    are refused."""
    prev = workloads.build_vote_traffic(CHAIN_ID, HEIGHT - 1, 6, 21, 3)
    precommits = [v for v in prev.votes if v.type == PRECOMMIT_TYPE]
    prevotes = [v for v in prev.votes if v.type == PREVOTE_TYPE]
    msgs = [port_msgs.VoteMessage(v) for v in precommits[:5] + prevotes[:2]]
    for step in (RoundStep.NEW_HEIGHT, RoundStep.PREVOTE):
        last = VoteSet(CHAIN_ID, HEIGHT - 1, 0, PRECOMMIT_TYPE, prev.vals)
        jlast = JaxVoteSet(CHAIN_ID, HEIGHT - 1, 0, PRECOMMIT_TYPE, _jax_vals(prev.vals))
        rs = RoundState(height=HEIGHT, validators=prev.vals, step=step, last_commit=last)
        cs = ConsensusState(CHAIN_ID, rs)
        got = _ingest_outcomes(cs, msgs)
        assert got == _jax_outcomes(prev, msgs, last_commit=jlast, step=step)
        assert _bits(last.bit_array()) == _bits(jlast.bit_array())
        assert got[0] == ("ok", step == RoundStep.NEW_HEIGHT)


def test_own_messages_go_before_the_drained_peer_messages():
    t = workloads.build_vote_traffic(CHAIN_ID, HEIGHT, 4, 31)
    cs = workloads.vote_state(CHAIN_ID, t.vals, HEIGHT)
    order = []
    inner = cs._handle_msg

    async def handle(mi):
        order.append((mi.peer_id, mi.msg.vote.validator_index, mi.msg.vote.type))
        if len(order) == 1:  # our own vote arrives while the burst is handled
            cs._send_internal(port_msgs.VoteMessage(t.votes[7]))
        await inner(mi)

    cs._handle_msg = handle

    async def run():
        cs.start()
        try:
            for v in t.votes[:4]:
                cs.send_peer_msg(port_msgs.VoteMessage(v), "peer")
            await cs.wait_idle()
        finally:
            await cs.stop()

    asyncio.run(run())
    want = [("peer", t.votes[0].validator_index, PREVOTE_TYPE),
            ("", t.votes[7].validator_index, PRECOMMIT_TYPE)]
    want += [("peer", v.validator_index, PREVOTE_TYPE) for v in t.votes[1:4]]
    assert order == want
