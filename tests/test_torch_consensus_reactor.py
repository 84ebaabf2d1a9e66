"""The port's consensus reactor, PeerState, gossip RNG, test network and
evidence reactor, held against the JAX package's.

- the gossip RNG: the same seed gives the same draws (choice, randbelow,
  shuffle, derive, subseed);
- PeerState: seeded sequences of 320 actions (NewRoundStep,
  NewValidBlock, HasVote, VoteSetBits, ProposalPOL, a proposal, a part,
  the bit allocations and the stall resets) at 4 and 150 validators
  leave equal `prs` fields and bit arrays after every action, the clock
  pinned; pick_vote_to_send (the port finds the index as the k-th set
  bit, the JAX package in a list of every candidate) and
  _send_commit_vote pick the same index for the same RNG state;
- the reactor's handlers and vote gossip, run on the same envelopes
  against each package's round state at 10 validators, send the same
  envelopes (wire bytes) and queue the same messages for the step
  machine, and raise the same errors;
- a four-validator localnet of each package (p2ptest.TestNetwork, the
  consensus, mempool and evidence reactors, MockPV, MemKV) commits
  heights 1-3 with equal txs and app hashes. The clock is not pinned
  here (the routers and timeouts run on the loop's time): block time,
  the LastCommit's signatures and timestamps and so the block hashes
  differ between the packages, and are compared within each;
- the port's localnet heals a 2|2 partition through the live-vote stall
  reset;
- the evidence reactor: a RuntimeError of a launch under
  pool.add_evidence reaches the reactor's stop(), a DeviceFault is
  contained by the device plane's fault policy and the evidence is
  admitted.

JAX routers and pools run on private metrics registries; no socket is
opened. Tolerance: zero.
"""

import asyncio
import random
import time
import types

import numpy as np
import pytest

from tendermint_tpu.abci import KVStoreApplication as JaxKVStore
from tendermint_tpu.abci import LocalClient as JaxLocalClient
from tendermint_tpu.config import ConsensusConfig as JaxConsensusConfig
from tendermint_tpu.config import MempoolConfig as JaxMempoolConfig
from tendermint_tpu.consensus import msgs as jax_msgs
from tendermint_tpu.consensus import peer_state as jax_ps
from tendermint_tpu.consensus import reactor as jax_reactor
from tendermint_tpu.consensus import types as jax_cstypes
from tendermint_tpu.consensus.metrics import ConsensusMetrics
from tendermint_tpu.consensus.state import ConsensusState as JaxConsensusState
from tendermint_tpu.consensus.timeline import TimelineRecorder
from tendermint_tpu.crypto import sigcache as jax_sigcache
from tendermint_tpu.crypto.ed25519 import PrivKeyEd25519 as JaxPrivKey
from tendermint_tpu.eventbus import EventBus as JaxEventBus
from tendermint_tpu.evidence import reactor as jax_ev_reactor
from tendermint_tpu.evidence.metrics import EvidenceMetrics
from tendermint_tpu.evidence.pool import EvidencePool as JaxEvidencePool
from tendermint_tpu.libs import bits as jax_bits
from tendermint_tpu.libs import rng as jax_rng
from tendermint_tpu.libs.metrics import Registry
from tendermint_tpu.mempool import reactor as jax_mp_reactor
from tendermint_tpu.mempool.mempool import TxMempool as JaxTxMempool
from tendermint_tpu.mempool.metrics import MempoolMetrics
from tendermint_tpu.p2p import channel as jax_channel
from tendermint_tpu.p2p import p2ptest as jax_p2ptest
from tendermint_tpu.privval.types import MockPV as JaxMockPV
from tendermint_tpu.state.execution import BlockExecutor as JaxBlockExecutor
from tendermint_tpu.state.metrics import StateMetrics
from tendermint_tpu.state.store import StateStore as JaxStateStore
from tendermint_tpu.state.types import state_from_genesis as jax_state_from_genesis
from tendermint_tpu.store.block_store import BlockStore as JaxBlockStore
from tendermint_tpu.store.kv import MemKV as JaxMemKV
from tendermint_tpu.types.block_id import BlockID as JaxBlockID
from tendermint_tpu.types.genesis import GenesisDoc as JaxGenesisDoc
from tendermint_tpu.types.validator import Validator as JaxValidator
from tendermint_tpu.types.validator import ValidatorSet as JaxValidatorSet
from tendermint_tpu.types.vote import Vote as JaxVote
from tendermint_tpu_torch import workloads
from tendermint_tpu_torch.abci.client import LocalClient
from tendermint_tpu_torch.abci.kvstore import KVStoreApplication
from tendermint_tpu_torch.config import ConsensusConfig, MempoolConfig
from tendermint_tpu_torch.consensus import msgs as port_msgs
from tendermint_tpu_torch.consensus import peer_state as port_ps
from tendermint_tpu_torch.consensus import reactor as port_reactor
from tendermint_tpu_torch.consensus import types as port_cstypes
from tendermint_tpu_torch.consensus.state import ConsensusState
from tendermint_tpu_torch.crypto import faults, gpu_verifier, sigcache
from tendermint_tpu_torch.eventbus import EventBus
from tendermint_tpu_torch.evidence import reactor as port_ev_reactor
from tendermint_tpu_torch.evidence.pool import EvidencePool
from tendermint_tpu_torch.libs import bits as port_bits
from tendermint_tpu_torch.libs import rng as port_rng
from tendermint_tpu_torch.mempool import reactor as port_mp_reactor
from tendermint_tpu_torch.mempool.mempool import TxMempool
from tendermint_tpu_torch.ops.ed25519_kernel import Ed25519Verifier
from tendermint_tpu_torch.p2p import channel as port_channel
from tendermint_tpu_torch.p2p import p2ptest as port_p2ptest
from tendermint_tpu_torch.p2p.types import Envelope
from tendermint_tpu_torch.privval.types import MockPV
from tendermint_tpu_torch.state.execution import BlockExecutor
from tendermint_tpu_torch.state.store import StateStore
from tendermint_tpu_torch.state.types import state_from_genesis
from tendermint_tpu_torch.store.block_store import BlockStore
from tendermint_tpu_torch.store.kv import MemKV
from tendermint_tpu_torch.types.block_id import BlockID, PartSetHeader
from tendermint_tpu_torch.types.canonical import PRECOMMIT_TYPE, PREVOTE_TYPE
from tendermint_tpu_torch.types.genesis import GenesisDoc
from tendermint_tpu_torch.types.validator import Validator, ValidatorSet
from tendermint_tpu_torch.types.vote import Vote

from .test_torch_isolation import jax_device_plane_paused  # noqa: F401 (autouse)

CHAIN_ID = "torch-reactor-chain"
SEED = 61
PINNED_NS = 1_760_000_000 * 1_000_000_000


@pytest.fixture(autouse=True)
def _isolated():
    sigcache.reset()
    with jax_sigcache.disabled():
        yield
    sigcache.reset()
    port_rng.reseed(None)
    jax_rng.reseed(None)


def run(coro):
    return asyncio.run(coro)


def _outcome(fn):
    try:
        return "ok", fn()
    except Exception as e:  # the outcome compared IS the exception
        return type(e).__name__, str(e)


# -- the gossip RNG --


@pytest.mark.parametrize("seed", [0, 7, 123456])
def test_rng_draws_equal_jax(seed):
    port_rng.reseed(seed)
    jax_rng.reseed(seed)
    seq = list(range(37))
    for n in (1, 2, 3, 10, 1000, 10_000):
        assert port_rng.randbelow(n) == jax_rng.randbelow(n)
        assert port_rng.choice(seq[: max(1, n % 37)]) == jax_rng.choice(seq[: max(1, n % 37)])
    a, b = list(seq), list(seq)
    port_rng.shuffle(a)
    jax_rng.shuffle(b)
    assert a == b
    # choice(seq) and seq[randbelow(len(seq))] are the same draw
    port_rng.reseed(seed)
    jax_rng.reseed(seed)
    assert [seq[port_rng.randbelow(len(seq))] for _ in range(50)] == [jax_rng.choice(seq) for _ in range(50)]
    assert port_rng.subseed(seed, "gossip") == jax_rng.subseed(seed, "gossip")
    assert port_rng.derive(seed, "x").random() == jax_rng.derive(seed, "x").random()


# -- PeerState --


def _bits(pkg, size: int, rnd: random.Random):
    ba = (port_bits if pkg == "port" else jax_bits).BitArray(size)
    for i in range(size):
        if rnd.random() < 0.4:
            ba.set(i, True)
    return ba


def _prs_tuple(prs) -> tuple:
    out = []
    for f in ("height", "round", "step", "start_time_ns", "proposal", "proposal_pol_round",
              "last_commit_round", "catchup_commit_round"):
        out.append(getattr(prs, f))
    h = prs.proposal_block_parts_header
    out.append((h.total, h.hash))
    for f in ("proposal_block_parts", "proposal_pol", "prevotes", "precommits", "last_commit",
              "catchup_commit"):
        ba = getattr(prs, f)
        out.append(None if ba is None else (ba.size, [ba.get(i) for i in range(ba.size)]))
    return tuple(out)


def _actions(n: int, seed: int, count: int = 320) -> list:
    """A seeded action list, each (kind, args), drawn so that heights,
    rounds and types collide often."""
    rnd = random.Random(seed)
    out = []
    for _ in range(count):
        h, r = rnd.randint(1, 4), rnd.randint(-1, 2)
        kind = rnd.choice(["nrs", "nrs", "nvb", "has_vote", "has_vote", "vsb", "pol", "proposal",
                           "part", "ensure", "catchup", "reset_live", "reset_catchup"])
        out.append((kind, h, max(r, 0), rnd.randint(1, 8), rnd.choice([PREVOTE_TYPE, PRECOMMIT_TYPE]),
                    rnd.randrange(n + 1), rnd.randint(0, 3), rnd.randint(1, 6), rnd.random() < 0.5,
                    rnd.randint(0, 1 << 30)))
    return out


def _apply(pkg: str, ps, action, n: int):
    kind, h, r, step, vtype, idx, secs, total, flag, sub = action
    msgs = port_msgs if pkg == "port" else jax_msgs
    rnd = random.Random(sub)
    psh_cls = PartSetHeader if pkg == "port" else type(jax_msgs.NewValidBlockMessage().block_part_set_header)
    bid_cls = BlockID if pkg == "port" else JaxBlockID
    if kind == "nrs":
        ps.apply_new_round_step(msgs.NewRoundStepMessage(
            height=h, round=r, step=step, seconds_since_start_time=secs, last_commit_round=r - 1))
    elif kind == "nvb":
        ps.apply_new_valid_block(msgs.NewValidBlockMessage(
            height=h, round=r, block_part_set_header=psh_cls(total=total, hash=bytes([total]) * 32),
            block_parts=_bits(pkg, total, rnd), is_commit=flag))
    elif kind == "has_vote":
        ps.apply_has_vote(msgs.HasVoteMessage(height=h, round=r, type=vtype, index=idx))
    elif kind == "vsb":
        bid = bid_cls(hash=b"\x11" * 32, part_set_header=psh_cls(total=1, hash=b"\x22" * 32))
        ours = _bits(pkg, n, random.Random(sub + 1)) if flag else None
        ps.apply_vote_set_bits(msgs.VoteSetBitsMessage(
            height=h, round=r, type=vtype, block_id=bid, votes=_bits(pkg, n, rnd)), ours)
    elif kind == "pol":
        ps.apply_proposal_pol(msgs.ProposalPOLMessage(
            height=h, proposal_pol_round=r - 1, proposal_pol=_bits(pkg, n, rnd)))
    elif kind == "proposal":
        proposal = types.SimpleNamespace(
            height=h, round=r, pol_round=r - 1 if flag else -1,
            block_id=bid_cls(hash=b"\x33" * 32, part_set_header=psh_cls(total=total, hash=b"\x44" * 32)))
        ps.set_has_proposal(proposal)
    elif kind == "part":
        ps.set_has_proposal_block_part(h, r, idx % 7)
    elif kind == "ensure":
        ps.ensure_vote_bits(n)
    elif kind == "catchup":
        ps.ensure_catchup_commit_round(h, r, n)
    elif kind == "reset_live":
        ps.reset_live_votes()
    else:
        ps.reset_catchup_precommits(h, r, n)


class _Votes:
    """A VoteSet as pick_vote_to_send reads it: its bits, and an index
    as the vote."""

    def __init__(self, pkg, n, h, r, vtype, rnd):
        self.height, self.round, self.signed_msg_type, self._n = h, r, vtype, n
        self._bits = _bits(pkg, n, rnd)

    def size(self):
        return self._n

    def bit_array(self):
        return self._bits.copy()

    def get_by_index(self, i):
        return i


@pytest.mark.parametrize("n", [4, 150])
@pytest.mark.parametrize("seed", [1, 2])
def test_peer_state_sequences_and_picks_equal_jax(monkeypatch, n, seed):
    monkeypatch.setattr(time, "time_ns", lambda: PINNED_NS)
    port, jax = port_ps.PeerState("peer"), jax_ps.PeerState("peer")
    picks = 0
    for k, action in enumerate(_actions(n, seed * 1000 + n)):
        _apply("port", port, action, n)
        _apply("jax", jax, action, n)
        assert _prs_tuple(port.prs) == _prs_tuple(jax.prs), (k, action)
        # a pick after every action, for the same RNG state
        _, h, r, _, vtype, *_ = action
        pv = _Votes("port", n, h, r, vtype, random.Random(k))
        jv = _Votes("jax", n, h, r, vtype, random.Random(k))
        port_rng.reseed(k)
        jax_rng.reseed(k)
        got, want = port.pick_vote_to_send(pv), jax.pick_vote_to_send(jv)
        assert got == want, (k, action)
        assert port_rng.gossip().getstate() == jax_rng.gossip().getstate()
        picks += got is not None
        assert _prs_tuple(port.prs) == _prs_tuple(jax.prs)
    assert picks > 5


class _Sig:
    def __init__(self, absent):
        self._absent = absent

    def is_absent(self):
        return self._absent


class _Commit:
    def __init__(self, n, h, r, rnd):
        self.height, self.round = h, r
        self.signatures = [_Sig(rnd.random() < 0.2) for _ in range(n)]

    def get_vote(self, i):
        return types.SimpleNamespace(height=self.height, round=self.round, type=PRECOMMIT_TYPE,
                                     validator_index=i)


@pytest.mark.parametrize("n", [4, 150, 10_000])
def test_send_commit_vote_picks_equal_jax(n):
    """A peer two heights behind gets precommits of a stored commit: the
    same index a pick, for the same RNG state, until every signature
    present was sent (then both send nothing)."""
    rnd = random.Random(n)
    commit = _Commit(n, 3, 0, rnd)
    sent = {"port": [], "jax": []}
    reactors = {}
    for pkg, mod, pmod in (("port", port_reactor, port_ps), ("jax", jax_reactor, jax_ps)):
        r = mod.ConsensusReactor.__new__(mod.ConsensusReactor)
        r._send_vote = lambda ps, v, pkg=pkg: sent[pkg].append(v.validator_index) or True
        ps = pmod.PeerState("peer")
        ps.prs.height = 3
        ps.ensure_vote_bits(n)
        ps.ensure_catchup_commit_round(3, 0, n)
        # a few already marked, and a peer bit array shorter than the commit
        for i in range(0, n, 7):
            ps.prs.catchup_commit.set(i, True)
        reactors[pkg] = (r, ps)
    rounds = 400 if n < 10_000 else 60
    for k in range(rounds):
        port_rng.reseed(k)
        jax_rng.reseed(k)
        got = reactors["port"][0]._send_commit_vote(reactors["port"][1], commit)
        want = reactors["jax"][0]._send_commit_vote(reactors["jax"][1], commit)
        assert got == want
        for pkg in ("port", "jax"):
            if sent[pkg]:
                r, ps = reactors[pkg]
                ps.set_has_vote(3, 0, PRECOMMIT_TYPE, sent[pkg][-1])
        assert sent["port"] == sent["jax"]
    assert len(set(sent["port"])) == len(sent["port"]) > 0


def test_bit_array_nth_set_is_the_listed_index():
    rnd = random.Random(5)
    for size in (1, 7, 64, 65, 1000, 10_000):
        ba = _bits("port", size, rnd)
        listed = list(ba.indices())
        assert [ba.nth_set(k) for k in range(len(listed))] == listed
        with pytest.raises(IndexError):
            ba.nth_set(len(listed))


# -- the reactor's handlers and vote gossip --


N_HANDLER_VALS = 10


def _privs():
    return workloads.seeded_keys(N_HANDLER_VALS, SEED)


def _round_state(pkg: str, privs, height: int):
    """Each package's round state at `height`, round 1, its prevotes
    and precommits of rounds 0 and 1 partly filled (seeded), and the
    previous height's precommits as its LastCommit."""
    jax_privs = [JaxPrivKey.from_seed(p.bytes()[:32]) for p in privs]
    if pkg == "port":
        vals = ValidatorSet([Validator(pub_key=p.pub_key(), voting_power=10) for p in privs])
        hvs_cls, vote_cls, mod, keys = port_cstypes.HeightVoteSet, Vote, port_cstypes, privs
    else:
        vals = JaxValidatorSet([JaxValidator(pub_key=p.pub_key(), voting_power=10) for p in jax_privs])
        hvs_cls, vote_cls, mod, keys = jax_cstypes.HeightVoteSet, JaxVote, jax_cstypes, jax_privs
    rs = mod.RoundState()
    rs.height, rs.round, rs.step, rs.validators = height, 1, mod.RoundStep.PREVOTE, vals
    rs.start_time_ns = PINNED_NS
    rs.votes = hvs_cls(CHAIN_ID, height, vals)
    rs.votes.set_round(2)
    last = hvs_cls(CHAIN_ID, height - 1, vals)
    rnd = np.random.default_rng([SEED, height])
    bid_cls = BlockID if pkg == "port" else JaxBlockID
    psh_cls = PartSetHeader if pkg == "port" else type(JaxBlockID().part_set_header)
    block = bid_cls(hash=b"\x55" * 32, part_set_header=psh_cls(total=2, hash=b"\x66" * 32))
    for hvs, h, rounds in ((rs.votes, height, (0, 1)), (last, height - 1, (0,))):
        for r in rounds:
            for vtype in (PREVOTE_TYPE, PRECOMMIT_TYPE):
                for i, v in enumerate(vals.validators):
                    if hvs is rs.votes and rnd.random() < 0.35:
                        continue
                    vote = vote_cls(type=vtype, height=h, round=r, block_id=block,
                                    timestamp_ns=PINNED_NS + i, validator_address=v.address,
                                    validator_index=i)
                    vote.signature = keys[[k.pub_key().address() for k in keys].index(v.address)].sign(
                        vote.sign_bytes(CHAIN_ID))
                    hvs.add_vote(vote, "")
    rs.last_commit = last.precommits(0)
    return rs, block


def _handler_reactor(pkg: str, privs, height: int):
    mod = port_reactor if pkg == "port" else jax_reactor
    ch_mod = port_channel if pkg == "port" else jax_channel
    cfg = (ConsensusConfig if pkg == "port" else JaxConsensusConfig)()
    rs, block = _round_state(pkg, privs, height)
    queued = []
    cs = types.SimpleNamespace(rs=rs, cfg=cfg, send_peer_msg=lambda m, p: queued.append((p, m)) or True)
    channels = {cid: ch_mod.Channel(d) for cid, d in mod.consensus_channel_descriptors().items()}
    r = mod.ConsensusReactor(cs, channels, asyncio.Queue(), None, cfg=cfg)
    return r, queued, block


def _drain(reactor, encode) -> list:
    out = []
    for ch in (reactor.state_ch, reactor.data_ch, reactor.vote_ch, reactor.vote_bits_ch):
        while not ch.out_queue.empty():
            env = ch.out_queue.get_nowait()
            out.append((ch.id, env.to, env.broadcast, encode(env.message)))
    return out


def _envelopes(pkg: str, privs, height: int, block) -> list:
    """The seeded inbound envelope sequence of two peers, as (channel,
    peer, message) of pkg's classes, built from wire bytes."""
    msgs = port_msgs if pkg == "port" else jax_msgs
    rnd = random.Random(SEED)
    other = port_msgs.VoteSetMaj23Message(
        height=height, round=0, type=PREVOTE_TYPE,
        block_id=BlockID(hash=b"\x77" * 32, part_set_header=PartSetHeader(total=1, hash=b"\x88" * 32)))
    wires = []
    for peer in ("peer-a", "peer-b"):
        wires.append((0x20, peer, port_msgs.NewRoundStepMessage(
            height=height, round=rnd.choice([0, 1]), step=rnd.choice([3, 4, 6]),
            seconds_since_start_time=1, last_commit_round=0)))
    for k in range(60):
        peer = rnd.choice(["peer-a", "peer-b", "stranger"])
        kind = rnd.choice(["has_vote", "has_vote", "maj23", "bits", "vote", "nrs", "wrong"])
        r, vtype = rnd.choice([0, 1]), rnd.choice([PREVOTE_TYPE, PRECOMMIT_TYPE])
        if kind == "has_vote":
            wires.append((0x20, peer, port_msgs.HasVoteMessage(
                height=height, round=r, type=vtype, index=rnd.randrange(N_HANDLER_VALS))))
        elif kind == "maj23":
            bid = block if rnd.random() < 0.7 else other.block_id
            wires.append((0x20, peer, port_msgs.VoteSetMaj23Message(
                height=height, round=r, type=vtype,
                block_id=BlockID.from_proto(bid.to_proto()))))
        elif kind == "bits":
            ba = port_bits.BitArray(N_HANDLER_VALS)
            for i in range(N_HANDLER_VALS):
                ba.set(i, rnd.random() < 0.5)
            wires.append((0x23, peer, port_msgs.VoteSetBitsMessage(
                height=height, round=r, type=vtype,
                block_id=BlockID.from_proto(block.to_proto()), votes=ba)))
        elif kind == "vote":
            i = rnd.randrange(N_HANDLER_VALS)
            v = Vote(type=vtype, height=height, round=r, block_id=BlockID.from_proto(block.to_proto()),
                     timestamp_ns=PINNED_NS + 9, validator_address=privs[i].pub_key().address(),
                     validator_index=i)
            v.signature = privs[i].sign(v.sign_bytes(CHAIN_ID))
            wires.append((0x22, peer, port_msgs.VoteMessage(vote=v)))
        elif kind == "nrs":
            wires.append((0x20, peer, port_msgs.NewRoundStepMessage(
                height=height + rnd.choice([-1, 0, 0, 1]), round=rnd.choice([0, 1]),
                step=rnd.choice([1, 3, 4, 6, 8]), seconds_since_start_time=2, last_commit_round=0)))
        else:  # a vote on the state channel: refused
            wires.append((0x20, peer, port_msgs.HasVoteMessage(
                height=height, round=r, type=vtype, index=rnd.randrange(N_HANDLER_VALS))))
            wires.append((0x22, peer, port_msgs.HasVoteMessage(
                height=height, round=r, type=vtype, index=0)))
    return [(cid, peer, msgs.decode_msg(port_msgs.encode_msg(m))) for cid, peer, m in wires]


def test_reactor_handlers_and_vote_gossip_send_equal_envelopes(monkeypatch):
    monkeypatch.setattr(time, "time_ns", lambda: PINNED_NS)
    privs = _privs()
    height = 3
    runs = {}
    for pkg, env_cls in (("port", Envelope), ("jax", jax_reactor.Envelope)):
        reactor, queued, block = _handler_reactor(pkg, privs, height)
        ps_mod = port_ps if pkg == "port" else jax_ps
        for peer in ("peer-a", "peer-b"):
            reactor.peers[peer] = ps_mod.PeerState(peer)
        handlers = {0x20: reactor._handle_state_msg, 0x21: reactor._handle_data_msg,
                    0x22: reactor._handle_vote_msg, 0x23: reactor._handle_vote_bits_msg}
        encode = (port_msgs if pkg == "port" else jax_msgs).encode_msg
        log = []
        for k, (cid, peer, m) in enumerate(_envelopes(pkg, privs, height, block)):
            got = _outcome(lambda: run(handlers[cid](env_cls(message=m, from_peer=peer))))
            log.append((k, got[0], got[1] if got[0] != "ok" else None))
            log.append(_drain(reactor, encode))
            # a gossip turn for each peer after every message
            for peer in ("peer-a", "peer-b"):
                (port_rng if pkg == "port" else jax_rng).reseed(k * 10 + len(peer))
                sent = reactor._gossip_votes_same_height(reactor.peers[peer])
                log.append((peer, sent, _drain(reactor, encode)))
        log.append([(p, encode(m)) for p, m in queued])
        log.append([_prs_tuple(reactor.peers[p].prs) for p in ("peer-a", "peer-b")])
        runs[pkg] = log
    assert runs["port"] == runs["jax"]
    flat = str(runs["port"])
    assert "ValueError" in flat  # the refused messages were among them
    sent_votes = sum(1 for e in runs["port"] if isinstance(e, tuple) and len(e) == 3 and e[1])
    assert sent_votes > 10


# -- four-validator localnets --


def _fast(cls):
    return cls(
        timeout_propose=2.0, timeout_propose_delta=0.5, timeout_prevote=1.0,
        timeout_prevote_delta=0.5, timeout_precommit=1.0, timeout_precommit_delta=0.5,
        timeout_commit=0.2, skip_timeout_commit=False, peer_gossip_sleep_duration=0.01,
        peer_query_maj23_sleep_duration=0.5,
    )


def _genesis(n: int) -> str:
    privs = [p for p in workloads.seeded_keys(n, SEED + 1)]
    return workloads.kv_genesis(CHAIN_ID, privs), privs


class _PortNode:
    def __init__(self, p2p, priv, genesis_json):
        self.p2p = p2p
        self.app = KVStoreApplication()
        client = LocalClient(self.app)
        self.state_store = StateStore(MemKV())
        state = state_from_genesis(GenesisDoc.from_json(genesis_json))
        self.state_store.save(state)
        self.block_store = BlockStore(MemKV())
        self.mempool = TxMempool(client, MempoolConfig())
        self.bus = EventBus()
        self.evpool = EvidencePool(MemKV(), self.state_store, self.block_store)
        executor = BlockExecutor(self.state_store, client, self.mempool, self.evpool, self.block_store, self.bus)
        self.cs = ConsensusState(_fast(ConsensusConfig), state, executor, self.block_store,
                                 privval=MockPV(priv), event_bus=self.bus, evidence_pool=self.evpool)
        chans = {cid: p2p.open_channel(d) for cid, d in port_reactor.consensus_channel_descriptors().items()}
        self.cs_reactor = port_reactor.ConsensusReactor(self.cs, chans, p2p.peer_manager.subscribe(), self.bus)
        self.mp_reactor = port_mp_reactor.MempoolReactor(
            self.mempool, p2p.open_channel(port_mp_reactor.mempool_channel_descriptor()),
            p2p.peer_manager.subscribe())
        self.ev_reactor = port_ev_reactor.EvidenceReactor(
            self.evpool, p2p.open_channel(port_ev_reactor.evidence_channel_descriptor()),
            p2p.peer_manager.subscribe())

    async def start(self):
        await self.bus.start()
        await self.cs_reactor.start()
        await self.mp_reactor.start()
        await self.ev_reactor.start()

    async def stop(self):
        await self.ev_reactor.stop()
        await self.mp_reactor.stop()
        await self.cs_reactor.stop()
        await self.bus.stop()


class _JaxNode:
    def __init__(self, p2p, priv, genesis_json):
        self.p2p = p2p
        self.app = JaxKVStore()
        client = JaxLocalClient(self.app)
        self.state_store = JaxStateStore(JaxMemKV())
        state = jax_state_from_genesis(JaxGenesisDoc.from_json(genesis_json))
        self.state_store.save(state)
        self.block_store = JaxBlockStore(JaxMemKV())
        self.mempool = JaxTxMempool(client, JaxMempoolConfig(), metrics=MempoolMetrics(Registry()))
        self.bus = JaxEventBus()
        self.evpool = JaxEvidencePool(JaxMemKV(), self.state_store, self.block_store,
                                      metrics=EvidenceMetrics(Registry()))
        executor = JaxBlockExecutor(self.state_store, client, self.mempool, evidence_pool=self.evpool,
                                    block_store=self.block_store, event_bus=self.bus,
                                    metrics=StateMetrics(Registry()))
        self.cs = JaxConsensusState(_fast(JaxConsensusConfig), state, executor, self.block_store,
                                    privval=JaxMockPV(priv), event_bus=self.bus, evidence_pool=self.evpool,
                                    metrics=ConsensusMetrics(Registry()),
                                    timeline=TimelineRecorder(enabled=False))
        chans = {cid: p2p.open_channel(d) for cid, d in jax_reactor.consensus_channel_descriptors().items()}
        self.cs_reactor = jax_reactor.ConsensusReactor(self.cs, chans, p2p.peer_manager.subscribe(), self.bus)
        self.mp_reactor = jax_mp_reactor.MempoolReactor(
            self.mempool, p2p.open_channel(jax_mp_reactor.mempool_channel_descriptor()),
            p2p.peer_manager.subscribe())
        self.ev_reactor = jax_ev_reactor.EvidenceReactor(
            self.evpool, p2p.open_channel(jax_ev_reactor.evidence_channel_descriptor()),
            p2p.peer_manager.subscribe())

    start = _PortNode.start
    stop = _PortNode.stop


def _txs():
    return workloads.kv_txs(SEED, 1, 12, (20, 40))


async def _localnet(pkg: str, heights: int = 3, partition: bool = False, byz=None) -> list:
    genesis, privs = _genesis(4)
    if pkg == "port":
        net = port_p2ptest.TestNetwork(4, chain_id=CHAIN_ID)
        nodes = [_PortNode(net.nodes[i], privs[i], genesis) for i in range(4)]
    else:
        net = jax_p2ptest.TestNetwork(4, chain_id=CHAIN_ID)
        nodes = [_JaxNode(net.nodes[i], JaxPrivKey.from_seed(privs[i].bytes()[:32]), genesis)
                 for i in range(4)]
    for node in nodes:
        for tx in _txs():
            await node.mempool.check_tx(tx)
    if byz is not None:
        byz(nodes)
    for node in nodes:
        await node.start()
    await net.start()
    try:
        if partition:
            await asyncio.gather(*(n.cs.wait_for_height(3, timeout=30.0) for n in nodes))
            faults.set_partition("node0,node1|node2,node3")
            await asyncio.sleep(3.0)
            heal_at = max(n.cs.rs.height for n in nodes)
            faults.set_partition("")
            await asyncio.gather(*(n.cs.wait_for_height(heal_at + 1, timeout=30.0) for n in nodes))
        else:
            # block h + 1 carries the app hash after h
            await asyncio.gather(*(n.cs.wait_for_height(heights + 2, timeout=30.0) for n in nodes))
    finally:
        faults.set_partition("")
        for node in nodes:
            await node.stop()
        await net.stop()
    return nodes


def _committed(nodes, heights: int) -> list:
    """Per height: the block hashes the nodes hold (one if they agree),
    its txs and the app hash after it."""
    out = []
    for h in range(1, heights + 1):
        blocks = [n.block_store.load_block(h) for n in nodes]
        nxt = [n.block_store.load_block(h + 1) for n in nodes]
        out.append({
            "hashes": {b.hash() for b in blocks},
            "txs": {tuple(bytes(t) for t in b.txs) for b in blocks},
            "app_hash": {b.header.app_hash for b in nxt if b is not None},
        })
    return out


def test_four_validator_localnets_commit_equal_txs_and_app_hashes():
    port = _committed(run(_localnet("port")), 3)
    jax = _committed(run(_localnet("jax")), 3)
    for h, (p, j) in enumerate(zip(port, jax), start=1):
        assert len(p["hashes"]) == 1 and len(j["hashes"]) == 1, f"nodes disagree at {h}"
        assert p["txs"] == j["txs"] and len(p["txs"]) == 1
        assert p["app_hash"] == j["app_hash"] and len(p["app_hash"]) == 1
    # every tx committed, once
    assert sorted(t for d in port for t in next(iter(d["txs"]))) == sorted(_txs())


def test_port_localnet_heals_a_partition_through_the_live_stall_reset(monkeypatch):
    resets = []
    inner = port_ps.PeerState.reset_live_votes

    def counted(self):
        resets.append(self.peer_id)
        inner(self)

    monkeypatch.setattr(port_ps.PeerState, "reset_live_votes", counted)
    nodes = run(_localnet("port", partition=True))
    common = min(n.block_store.height() for n in nodes)
    assert common >= 3
    for h in range(1, common + 1):
        assert len({n.block_store.load_block(h).hash() for n in nodes}) == 1
    assert resets


# -- the evidence reactor's errors --


def _attack_node():
    """A 4-validator chain of 3 heights on the port and a light-client
    attack against it (its conflicting commit: four signatures, one
    device window at min_batch 2)."""
    privs = workloads.seeded_keys(4, SEED + 2)
    genesis = workloads.kv_genesis(CHAIN_ID, privs)
    txs = [workloads.kv_txs(SEED, h, 3, (40, 60)) for h in (1, 2, 3)]
    chain = workloads.build_block_chain(genesis, privs, txs, SEED)
    node = workloads.block_exec_node(genesis)
    state = node.state
    for cb in chain:
        node.block_store.save_block(cb.block, cb.parts, cb.seen_commit)
        state = run(node.executor.apply_block(state, cb.block_id, cb.block))
    cb = chain[1]
    header = type(cb.block.header).from_proto(cb.block.header.to_proto())
    header.app_hash = b"\x44" * 32
    vals = node.state_store.load_validators(1)
    bid = BlockID(header.hash(), cb.block_id.part_set_header)
    commit = workloads.sign_commit(CHAIN_ID, vals, bid, 2, header.time_ns, privs, SEED)
    from tendermint_tpu_torch.types.evidence import LightClientAttackEvidence
    from tendermint_tpu_torch.types.light import LightBlock, SignedHeader

    ev = LightClientAttackEvidence(
        conflicting_block=LightBlock(SignedHeader(header, commit), vals),
        common_height=1, total_voting_power=vals.total_voting_power(), timestamp_ns=7,
    )
    return node, ev


async def _deliver_evidence(node, ev):
    """An evidence reactor over a fresh pool of node's stores; one
    EvidenceListMessage from a peer. Returns (the pool, the reactor)
    once the message was taken, the reactor still running."""
    pool = EvidencePool(MemKV(), node.state_store, node.block_store)
    ch = port_channel.Channel(port_ev_reactor.evidence_channel_descriptor())
    reactor = port_ev_reactor.EvidenceReactor(pool, ch, asyncio.Queue())
    await reactor.start()
    ch.deliver(Envelope(message=port_ev_reactor.EvidenceListMessage(evidence=(ev,)), from_peer="peer"))
    for _ in range(200):
        await asyncio.sleep(0.005)
        if ch.in_queue.empty() and (pool.size() or reactor.failure() is not None):
            break
    return pool, reactor


def test_evidence_reactor_raises_a_failed_launch_to_its_caller(monkeypatch):
    node, ev = _attack_node()
    gpu_verifier.install(device="cpu", min_batch=2, gather_deadline_s=None)

    def failed_launch(self, *args):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(Ed25519Verifier, "dispatch", failed_launch)

    async def go():
        pool, reactor = await _deliver_evidence(node, ev)
        assert isinstance(reactor.failure(), RuntimeError)
        with pytest.raises(RuntimeError, match="illegal memory access"):
            await reactor.stop()
        return pool

    try:
        pool = run(go())
    finally:
        gpu_verifier.uninstall()
        node.close()
    assert pool.size() == 0


def test_evidence_reactor_admits_through_a_contained_device_fault():
    node, ev = _attack_node()
    gpu_verifier.install(device="cpu", min_batch=2, gather_deadline_s=None)

    async def go():
        with faults.inject("gpu.dispatch", "raise", times=1) as rule:
            pool, reactor = await _deliver_evidence(node, ev)
            assert reactor.failure() is None
            await reactor.stop()
        return pool, rule

    try:
        before = gpu_verifier.stats()
        pool, rule = run(go())
        after = gpu_verifier.stats()
    finally:
        gpu_verifier.uninstall()
        node.close()
    assert rule.fired == 1
    assert after["faults"] == before["faults"] + 1
    assert pool.size() == 1 and pool.pending_evidence(1 << 20)[0][0].hash() == ev.hash()
