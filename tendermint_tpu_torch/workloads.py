"""Seeded inputs for the port's bench and its on-card checks: validator
sets and Commits, chains of LightBlocks, and blocks of transactions,
all built with the port's own types from a seed.

- build_commit: a Commit of n equal-power validators, every one signing,
  some of them sr25519;
- build_light_chain: LightBlocks 1..n of one chain with a static set of
  equal-power validators, every one signing every height: the shape of
  BASELINE.md config 4 (the JAX package's bench.py:1161
  `_build_light_chain`), ed25519 only or mixed;
- ChainProvider: a light Provider serving such a chain; light_client, a
  fresh sequential client of it, and light_sync, which times the client
  verifying its top height;
- block_txs: a block of transactions of seeded lengths and bytes;
- build_vote_traffic: the prevotes and precommits of one height and
  round for one block, every validator voting once of each type, as
  VoteMessage wire bytes in a seeded order (the consensus vote path's
  traffic); vote_state, a fresh consensus.state.ConsensusState at that
  height, and ingest, which feeds it wire bytes in bursts;
- kv_txs: a block of kvstore transactions (`key=value`) of seeded
  lengths; kv_genesis, the genesis JSON of a set of validators;
  build_block_chain, a chain of blocks made by State.make_block and
  applied by a BlockExecutor on the kvstore app, each LastCommit signed
  by every validator whose key it is given; block_exec_node, a
  fresh node to apply it (the state from the genesis, the kvstore app,
  state and block stores on MemKV or on SqliteKV in a directory);
- build_consensus_chain: the heights of a chain as one node's step
  machine meets them (the proposer's signed proposal and parts, every
  other validator's prevote and precommit as wire bytes, the node's own
  votes and proposals predicted, its clock pinned by pinned_clock);
  consensus_node, a node with FilePV, WAL, evidence pool and event bus
  on SqliteKV (and, if asked, a TxMempool its proposals reap);
  drive_heights, which feeds it the chain height by height;
- the mempool harness: kv_mempool, a TxMempool on its own connection to
  a kvstore app; node_key, a node's p2p identity from the seed;
  gossip_node, a router on a memory or TCP transport with the mempool
  reactor on channel 0x30; admit, which feeds a pool txs through
  check_tx_batch in batches; wait_for_pool, which waits until a pool
  holds a count of txs; drive_mempool_heights, which gossips a stream
  of txs from a full node's pool to a consensus_node's over a
  MemoryNetwork, then feeds the node a chain in which it proposes a
  height from its pool.

Keys, timestamps and signing witnesses come from the seed, so a seed
gives the same bytes on every host. Signing is native: ed25519's and
sr25519's fixed-base multiplies run in the C plane (tendermint_tpu_torch/
native); the bench's sign_keygen cell times one signature of each key
type, and its light_sync cell the build of a chain.
"""

from __future__ import annotations

import asyncio
import contextlib
import hashlib
import os
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from .crypto.ed25519 import PrivKeyEd25519
from .crypto.sr25519 import PrivKeySr25519, sign_batch
from .config import ConsensusConfig, MempoolConfig, P2PConfig
from .consensus.msgs import (
    BlockPartMessage,
    EndHeightMessage,
    ProposalMessage,
    VoteMessage,
    decode_msg,
    encode_msg,
)
from .consensus.state import PEER_DRAIN, ConsensusState
from .consensus.types import RoundStep
from .consensus.wal import WAL
from .eventbus import EventBus
from .evidence.pool import EvidencePool
from .privval.file import FilePV
from .abci.client import LocalClient
from .abci.kvstore import KVStoreApplication
from .crypto import batch
from .light.client import Client, TrustOptions
from .light.errors import LightBlockNotFoundError
from .light.provider import Provider
from .light.store import LightStore
from .mempool.mempool import TxMempool
from .mempool.nop import NopMempool
from .mempool.reactor import MempoolReactor, mempool_channel_descriptor
from .p2p.peermanager import PeerManager, peer_manager_options
from .p2p.router import Router, router_options
from .p2p.transport import MemoryNetwork, MemoryTransport, Transport
from .p2p.types import NodeInfo, node_id_from_pubkey
from .state.execution import BlockExecutor
from .state.store import StateStore
from .state.types import State, state_from_genesis
from .store.block_store import BlockStore
from .store.kv import MemKV, SqliteKV
from .types.block import Block
from .types.block_id import BlockID, PartSetHeader
from .types.canonical import PRECOMMIT_TYPE, PREVOTE_TYPE
from .types.commit import Commit, CommitSig
from .types.evidence import DuplicateVoteEvidence
from .types.genesis import GenesisDoc, GenesisValidator
from .types.header import Consensus, Header
from .types.params import ConsensusParams
from .types.part_set import PartSet
from .types.proposal import Proposal
from .types.light import LightBlock, SignedHeader
from .types.validator import Validator, ValidatorSet
from .types.vote import Vote

__all__ = [
    "BASE_TIME_NS",
    "CLOCK_BASE_NS",
    "CLOCK_STEP_NS",
    "ChainBlock",
    "ChainProvider",
    "ConsensusHeight",
    "ConsensusNode",
    "ExecNode",
    "GossipNode",
    "HeightRun",
    "MempoolRun",
    "VoteTraffic",
    "block_exec_node",
    "block_txs",
    "build_block_chain",
    "build_commit",
    "build_consensus_chain",
    "build_light_chain",
    "admit",
    "build_vote_traffic",
    "clock_at",
    "consensus_node",
    "drive_heights",
    "drive_mempool_heights",
    "end_height_records",
    "first_proposer_height",
    "gossip_node",
    "ingest",
    "kv_genesis",
    "kv_mempool",
    "kv_txs",
    "light_client",
    "light_sync",
    "node_key",
    "pinned_clock",
    "seeded_keys",
    "sign_commit",
    "vote_state",
    "wait_for_pool",
]

# the time of height 0 of a built chain, and of a built commit's votes
BASE_TIME_NS = 1_760_000_000 * 1_000_000_000

# ed25519 keys by seed: a mixed set reuses the ed25519-only set's keys
_ED_KEYS: dict = {}


def seeded_keys(n: int, seed: int, n_sr: int = 0) -> list:
    """n private keys from the seed, n_sr of them sr25519 (which ones
    fixed by index from the seed), the rest ed25519."""
    is_sr = np.zeros(n, dtype=bool)
    is_sr[np.random.default_rng([seed, 3]).permutation(n)[:n_sr]] = True
    privs = []
    for i in range(n):
        key_seed = hashlib.sha256(b"chip-smoke-%d-%d" % (seed, i)).digest()
        if is_sr[i]:
            privs.append(PrivKeySr25519(key_seed))
            continue
        if key_seed not in _ED_KEYS:
            _ED_KEYS[key_seed] = PrivKeyEd25519.from_seed(key_seed)
        privs.append(_ED_KEYS[key_seed])
    return privs


def _sign_all(privs, msgs, witness, lap=None) -> list:
    """privs[i] signs msgs[i]: ed25519 one at a time, then sr25519
    together (every R first, then the challenges), witnesses from
    `witness`; lap(name), if given, after each key type."""
    sigs = [None] * len(privs)
    sr_idx = []
    for i, (priv, msg) in enumerate(zip(privs, msgs)):
        if priv.type() == "sr25519":
            sr_idx.append(i)
        else:
            sigs[i] = priv.sign(msg)
    if lap:
        lap("ed25519_sign_s")
    if sr_idx:
        sr_sigs = sign_batch(
            [privs[i] for i in sr_idx],
            [msgs[i] for i in sr_idx],
            rng=witness.bytes,
        )
        for i, sig in zip(sr_idx, sr_sigs):
            sigs[i] = sig
    if lap:
        lap("sr25519_sign_s")
    return sigs


def build_commit(
    n: int,
    seed: int,
    chain_id: str,
    height: int,
    n_sr: int = 0,
    timings: Optional[dict] = None,
):
    """(ValidatorSet, BlockID, Commit) of n equal-power validators that
    all signed, n_sr of them sr25519 (seeded_keys). Vote timestamps
    spread over one second, as a real commit's do, so the sign-bytes come
    in several varint lengths. `timings`, a dict, receives the seconds of
    keygen and of the signing of each key type."""
    clock = [time.perf_counter()]
    seconds = {} if timings is None else timings

    def lap(name):
        now = time.perf_counter()
        seconds[name] = now - clock[0]
        clock[0] = now

    privs = seeded_keys(n, seed, n_sr)
    lap("keygen_s")
    by_addr = {p.pub_key().address(): p for p in privs}
    vals = ValidatorSet(
        [Validator(pub_key=p.pub_key(), voting_power=10) for p in privs]
    )
    block_id = BlockID(
        hashlib.sha256(b"block-%d" % seed).digest(),
        PartSetHeader(1, hashlib.sha256(b"parts-%d" % seed).digest()),
    )
    rng = np.random.default_rng(seed)
    votes = []
    for i, val in enumerate(vals.validators):
        ts = BASE_TIME_NS + int(rng.integers(0, 1_000_000_000))
        vote = Vote(
            type=PRECOMMIT_TYPE,
            height=height,
            round=0,
            block_id=block_id,
            timestamp_ns=ts,
            validator_address=val.address,
            validator_index=i,
        )
        votes.append((by_addr[val.address], vote.sign_bytes(chain_id), ts))
    sigs = _sign_all(
        [p for p, _sb, _ts in votes],
        [sb for _p, sb, _ts in votes],
        np.random.default_rng([seed, 25519]),
        lap,
    )
    commit = Commit(
        height=height,
        round=0,
        block_id=block_id,
        signatures=[
            CommitSig.for_block(sig, val.address, ts)
            for sig, val, (_p, _sb, ts) in zip(sigs, vals.validators, votes)
        ],
    )
    return vals, block_id, commit


def build_light_chain(
    chain_id: str, n_heights: int, n_vals: int, seed: int, n_sr: int = 0
) -> Dict[int, LightBlock]:
    """LightBlocks 1..n_heights of one chain: a static set of n_vals
    equal-power validators (n_sr of them sr25519), every one signing
    every height at its header's time; height h at BASE_TIME_NS + h
    seconds, each header naming the previous block."""
    privs = seeded_keys(n_vals, seed, n_sr)
    vals = ValidatorSet(
        [Validator(pub_key=p.pub_key(), voting_power=10) for p in privs]
    )
    by_addr = {p.pub_key().address(): p for p in privs}
    signers = [by_addr[v.address] for v in vals.validators]
    vals_hash = vals.hash()
    proposer = vals.get_proposer().address
    witness = np.random.default_rng([seed, 4])
    blocks: Dict[int, LightBlock] = {}
    prev_bid = BlockID()
    for h in range(1, n_heights + 1):
        header = Header(
            version=Consensus(block=11),
            chain_id=chain_id,
            height=h,
            time_ns=BASE_TIME_NS + h * 1_000_000_000,
            last_block_id=prev_bid,
            validators_hash=vals_hash,
            next_validators_hash=vals_hash,
            app_hash=b"\x07" * 32,
            proposer_address=proposer,
        )
        bid = BlockID(
            hash=header.hash(),
            part_set_header=PartSetHeader(total=1, hash=b"\x22" * 32),
        )
        # every validator signs the same bytes: the validator's address
        # and index are not in a vote's sign-bytes
        sign_bytes = Vote(
            type=PRECOMMIT_TYPE,
            height=h,
            round=0,
            block_id=bid,
            timestamp_ns=header.time_ns,
        ).sign_bytes(chain_id)
        sigs = _sign_all(signers, [sign_bytes] * n_vals, witness)
        commit = Commit(
            height=h,
            round=0,
            block_id=bid,
            signatures=[
                CommitSig.for_block(sig, v.address, header.time_ns)
                for sig, v in zip(sigs, vals.validators)
            ],
        )
        blocks[h] = LightBlock(
            signed_header=SignedHeader(header=header, commit=commit),
            validator_set=vals,
        )
        prev_bid = bid
    return blocks


class ChainProvider(Provider):
    """Serves the LightBlocks of a dict by height (0: the highest)."""

    def __init__(self, blocks: Dict[int, LightBlock], id_: str = "chain"):
        self.blocks = blocks
        self._id = id_
        self.reported: list = []

    def id(self) -> str:
        return self._id

    async def light_block(self, height: int) -> LightBlock:
        if height == 0:
            height = max(self.blocks)
        if height not in self.blocks:
            raise LightBlockNotFoundError(f"no light block at {height}")
        return self.blocks[height]

    async def report_evidence(self, ev) -> None:
        self.reported.append(ev)


def light_client(blocks, chain_id: str, pruning_size: int = 1000) -> Client:
    """A fresh sequential light client of the chain `blocks`, trusting
    its height 1, with a trusting period longer than any chain here."""
    return Client(
        chain_id,
        TrustOptions(period_ns=10**18, height=1, hash=blocks[1].signed_header.hash()),
        ChainProvider(blocks),
        [],
        LightStore(MemKV()),
        sequential=True,
        pruning_size=pruning_size,
    )


def light_sync(client: Client, affinity: int) -> float:
    """Seconds of `client` (a light_client) verifying the top height of
    its chain, one second after that header's time, with the group
    affinity pinned to `affinity` (and restored after). Raises unless it
    ends at that height's header."""
    blocks = client.primary.blocks
    top = max(blocks)
    now = blocks[top].signed_header.header.time_ns + 1_000_000_000
    saved = batch.group_affinity_state()
    batch.set_group_affinity(affinity)
    try:
        t0 = time.perf_counter()
        lb = asyncio.run(client.verify_light_block_at_height(top, now))
        seconds = time.perf_counter() - t0
    finally:
        batch.restore_group_affinity(saved)
    if lb.height != top or lb.signed_header.hash() != blocks[top].signed_header.hash():
        raise AssertionError(f"light sync ended at {lb.height}, not {top}")
    return seconds


def block_txs(seed: int, n: int, lengths: tuple) -> list:
    """n transactions, lengths in [lengths[0], lengths[1]] and bytes from
    the seed."""
    rng = np.random.default_rng([seed, 5])
    lens = rng.integers(lengths[0], lengths[1] + 1, n)
    blob = rng.bytes(int(lens.sum()))
    ends = np.cumsum(lens).tolist()
    return [blob[e - k : e] for e, k in zip(ends, lens.tolist())]


@dataclass
class VoteTraffic:
    """One height's votes (build_vote_traffic): the set, the block voted
    for, each validator's private key by index, and the votes with their
    VoteMessage wire bytes, prevotes then precommits, each type in a
    seeded order."""

    vals: ValidatorSet
    block_id: BlockID
    privs: List
    votes: List[Vote]
    wires: List[bytes]


def build_vote_traffic(
    chain_id: str, height: int, n: int, seed: int, n_sr: int = 0, round_: int = 0
) -> VoteTraffic:
    """Every one of n equal-power validators (n_sr of them sr25519,
    seeded_keys) prevotes and precommits for one block at (height,
    round_); each vote's timestamp is drawn from the seed within one
    second, so the sign-bytes come in several lengths."""
    privs = seeded_keys(n, seed, n_sr)
    vals = ValidatorSet(
        [Validator(pub_key=p.pub_key(), voting_power=10) for p in privs]
    )
    by_addr = {p.pub_key().address(): p for p in privs}
    signers = [by_addr[v.address] for v in vals.validators]
    block_id = BlockID(
        hashlib.sha256(b"vote-block-%d-%d" % (seed, height)).digest(),
        PartSetHeader(1, hashlib.sha256(b"vote-parts-%d" % seed).digest()),
    )
    rng = np.random.default_rng([seed, 6, height])
    votes = []
    for vote_type in (PREVOTE_TYPE, PRECOMMIT_TYPE):
        for i in rng.permutation(n).tolist():
            votes.append(
                Vote(
                    type=vote_type,
                    height=height,
                    round=round_,
                    block_id=block_id,
                    timestamp_ns=BASE_TIME_NS + int(rng.integers(0, 1_000_000_000)),
                    validator_address=vals.validators[i].address,
                    validator_index=i,
                )
            )
    sigs = _sign_all(
        [signers[v.validator_index] for v in votes],
        [v.sign_bytes(chain_id) for v in votes],
        np.random.default_rng([seed, 7, height]),
    )
    for vote, sig in zip(votes, sigs):
        vote.signature = sig
    return VoteTraffic(
        vals=vals,
        block_id=block_id,
        privs=signers,
        votes=votes,
        wires=[encode_msg(VoteMessage(v)) for v in votes],
    )


def vote_state(chain_id: str, vals: ValidatorSet, height: int) -> ConsensusState:
    """A fresh ConsensusState at `height`, round 0, with its
    HeightVoteSet: the state of a chain whose first height is `height`
    and whose set is vals, on MemKV stores and the kvstore app, with no
    signer (an observer: it votes nothing) and the default timeouts."""
    state = State(
        chain_id=chain_id,
        initial_height=height,
        last_block_time_ns=BASE_TIME_NS,
        validators=vals,
        next_validators=vals.copy_increment_proposer_priority(1),
        last_height_validators_changed=height,
        last_height_consensus_params_changed=height,
    )
    state_store, block_store = StateStore(MemKV()), BlockStore(MemKV())
    state_store.save(state)
    executor = BlockExecutor(
        state_store, LocalClient(KVStoreApplication()), NopMempool(), block_store=block_store
    )
    return ConsensusState(ConsensusConfig(), state, executor, block_store)


def ingest(cs: ConsensusState, wires: List[bytes], burst: int, peer_id: str = "peer") -> None:
    """Run cs's receive loop over the wire bytes of consensus messages
    from one peer, `burst` at a time: each burst is decoded and queued
    whole, then handled before the next is queued (the loop drains up to
    consensus.state.PEER_DRAIN a turn, so a burst of that size is one
    pre-verify). Raises what the loop raises, and when a message was
    dropped by a full queue."""

    async def run():
        await cs.start()
        try:
            for i in range(0, len(wires), burst):
                for w in wires[i : i + burst]:
                    if not cs.send_peer_msg(decode_msg(w), peer_id):
                        raise RuntimeError("the peer queue dropped a message")
                await cs.wait_idle()
        finally:
            await cs.stop()

    asyncio.run(run())


def kv_txs(seed: int, height: int, n: int, lengths: tuple) -> list:
    """n kvstore transactions `key=value` of lengths in [lengths[0],
    lengths[1]] (at least 34): a key of 32 hex digits, then '=' and a
    value of hex digits, all from the seed and the height. Keys are
    128 random bits, so a block's transactions add as many entries."""
    rng = np.random.default_rng([seed, 8, height])
    lens = rng.integers(lengths[0], lengths[1] + 1, n).tolist()
    digits = rng.bytes((sum(lens) + 1) // 2).hex().encode()
    out, at = [], 0
    for k in lens:
        out.append(digits[at : at + 32] + b"=" + digits[at + 33 : at + k])
        at += k
    return out


def kv_genesis(chain_id: str, privs: Sequence, power: int = 10) -> str:
    """The genesis JSON of equal-power validators holding `privs` at
    BASE_TIME_NS, accepting the key types among them."""
    types = sorted({p.type() for p in privs})
    params = ConsensusParams()
    params.validator.pub_key_types = types
    doc = GenesisDoc(
        chain_id=chain_id,
        genesis_time_ns=BASE_TIME_NS,
        consensus_params=params,
        validators=[GenesisValidator(pub_key=p.pub_key(), power=power) for p in privs],
    )
    return doc.to_json()


def sign_commit(chain_id: str, vals: ValidatorSet, block_id: BlockID, height: int,
                time_ns: int, privs: Sequence, seed: int) -> Commit:
    """The Commit of block_id at height, round 0: every validator of vals
    whose key is in privs signs a precommit (timestamps after time_ns,
    within one second, from the seed); the others are absent."""
    by_addr = {p.pub_key().address(): p for p in privs}
    rng = np.random.default_rng([seed, 9, height])
    stamps = (time_ns + 1 + rng.integers(0, 1_000_000_000, len(vals))).tolist()
    signers, msgs, at = [], [], []
    for i, (v, ts) in enumerate(zip(vals.validators, stamps)):
        priv = by_addr.get(v.address)
        if priv is None:
            continue
        vote = Vote(type=PRECOMMIT_TYPE, height=height, round=0,
                    block_id=block_id, timestamp_ns=ts)
        signers.append(priv)
        msgs.append(vote.sign_bytes(chain_id))
        at.append(i)
    sigs = _sign_all(signers, msgs, np.random.default_rng([seed, 10, height]))
    commit_sigs = [CommitSig.absent() for _ in vals.validators]
    for i, sig in zip(at, sigs):
        commit_sigs[i] = CommitSig.for_block(sig, vals.validators[i].address, stamps[i])
    return Commit(height=height, round=0, block_id=block_id, signatures=commit_sigs)


@dataclass
class ChainBlock:
    """One height of a built chain: the block, its id and parts, and the
    commit a node saw for it (the next block's LastCommit)."""

    block: Block
    block_id: BlockID
    parts: PartSet
    seen_commit: Commit


@dataclass
class ExecNode:
    """What applies blocks on one node: the state from the genesis, the
    kvstore app behind a local client, and the state and block stores."""

    state: State
    app: KVStoreApplication
    executor: BlockExecutor
    state_store: StateStore
    block_store: BlockStore
    dbs: tuple

    def close(self) -> None:
        for db in self.dbs:
            db.close()


def block_exec_node(genesis_json: str, db_dir: Optional[str] = None) -> ExecNode:
    """A fresh node at the genesis: the stores on MemKV, or on SqliteKV
    files `state.sqlite` and `blockstore.sqlite` in db_dir (made if
    missing; ExecNode.close closes them)."""
    if db_dir is None:
        state_db, block_db = MemKV(), MemKV()
    else:
        os.makedirs(db_dir, exist_ok=True)
        state_db = SqliteKV(os.path.join(db_dir, "state.sqlite"))
        block_db = SqliteKV(os.path.join(db_dir, "blockstore.sqlite"))
    state = state_from_genesis(GenesisDoc.from_json(genesis_json))
    state_store, block_store = StateStore(state_db), BlockStore(block_db)
    state_store.save(state)
    app = KVStoreApplication()
    executor = BlockExecutor(
        state_store, LocalClient(app), NopMempool(), block_store=block_store
    )
    return ExecNode(state, app, executor, state_store, block_store, (state_db, block_db))


def build_block_chain(genesis_json: str, privs: Sequence, txs: Sequence[list],
                      seed: int) -> List[ChainBlock]:
    """Blocks 1..len(txs) of the genesis's chain, block h holding txs[h-1]:
    each made by State.make_block from the state after the height before
    (its proposer the set's, its LastCommit that height's commit, signed
    by sign_commit), then applied on a node of block_exec_node so that the
    next block carries its app and results hashes."""
    node = block_exec_node(genesis_json)
    chain_id = node.state.chain_id
    state = node.state
    last_commit = Commit(height=0)
    out = []
    for h, block_txs_ in enumerate(txs, start=state.initial_height):
        proposer = state.validators.get_proposer().address
        block, parts = state.make_block(h, list(block_txs_), last_commit, [], proposer)
        block_id = BlockID(hash=block.hash(), part_set_header=parts.header())
        seen = sign_commit(chain_id, state.validators, block_id, h,
                           block.header.time_ns, privs, seed)
        node.block_store.save_block(block, parts, seen)
        state = asyncio.run(node.executor.apply_block(state, block_id, block))
        out.append(ChainBlock(block, block_id, parts, seen))
        last_commit = seen
    return out


# -- the step machine's harness --

# the pinned clock of a driven node: time.time_ns() reads CLOCK_BASE_NS
# plus CLOCK_STEP_NS a height, the height the node is at when it reads
# it; an hour after BASE_TIME_NS, so after every block time of a chain
# built here, and a millisecond a height, well inside timeout_commit
CLOCK_BASE_NS = BASE_TIME_NS + 3600 * 1_000_000_000
CLOCK_STEP_NS = 1_000_000


def clock_at(height: int) -> int:
    return CLOCK_BASE_NS + CLOCK_STEP_NS * height


@contextlib.contextmanager
def pinned_clock(height_of):
    """For the block, time.time_ns() returns clock_at(height_of()): every
    read of the clock within one height gives the same value, whatever
    the host's speed, so two runs of a node write the same bytes."""
    real = time.time_ns
    time.time_ns = lambda: clock_at(height_of())
    try:
        yield
    finally:
        time.time_ns = real


@dataclass
class ConsensusNode:
    """One validator node: the step machine with its WAL, FilePV,
    evidence pool and event bus, over the kvstore app and state, block
    and evidence stores on SqliteKV files in `home`, and the mempool its
    proposals reap (NopMempool, or a TxMempool)."""

    cs: ConsensusState
    executor: BlockExecutor
    state_store: StateStore
    block_store: BlockStore
    evpool: EvidencePool
    event_bus: EventBus
    privval: FilePV
    app: KVStoreApplication
    home: str
    dbs: tuple
    mempool: object = None

    def end_heights(self) -> List[bytes]:
        return end_height_records(self.cs.wal.path)

    def close(self) -> None:
        for db in self.dbs:
            db.close()


def end_height_records(wal_path: str) -> List[bytes]:
    """The framed bytes (crc, length, TimedWALMessage) of every EndHeight
    record of a WAL group, in order."""
    from .consensus import wal as wal_mod

    out = []
    for path in wal_mod.wal_group_files(wal_path):
        with open(path, "rb") as f:
            while (payload := wal_mod._read_record(f)) is not None:
                if isinstance(wal_mod._decode_record(payload)[1], EndHeightMessage):
                    out.append(wal_mod._frame(payload))
    return out


def consensus_node(genesis_json: str, priv, home: str, cfg: Optional[ConsensusConfig] = None,
                   mempool_cfg: Optional[MempoolConfig] = None) -> ConsensusNode:
    """A fresh node at the genesis whose validator signs with priv
    through a FilePV in home/config and home/data, its WAL in
    home/data/cs.wal; cfg defaults to the JAX package's timeouts with
    skip_timeout_commit (every precommit arrives). Its proposals reap a
    NopMempool, or, given mempool_cfg, a TxMempool on its own connection
    to the node's app (kv_mempool)."""
    for d in ("config", "data"):
        os.makedirs(os.path.join(home, d), exist_ok=True)
    data = os.path.join(home, "data")
    state_db = SqliteKV(os.path.join(data, "state.sqlite"))
    block_db = SqliteKV(os.path.join(data, "blockstore.sqlite"))
    evidence_db = SqliteKV(os.path.join(data, "evidence.sqlite"))
    state = state_from_genesis(GenesisDoc.from_json(genesis_json))
    state_store, block_store = StateStore(state_db), BlockStore(block_db)
    state_store.save(state)
    evpool = EvidencePool(evidence_db, state_store, block_store)
    event_bus = EventBus()
    app = KVStoreApplication()
    mempool = NopMempool() if mempool_cfg is None else kv_mempool(app, mempool_cfg)
    executor = BlockExecutor(
        state_store, LocalClient(app), mempool, evpool, block_store, event_bus
    )
    privval = FilePV.from_priv_key(
        priv,
        os.path.join(home, "config", "priv_validator_key.json"),
        os.path.join(data, "priv_validator_state.json"),
    )
    privval.save()
    with pinned_clock(lambda: 0):  # the constructor reads the clock at height 0
        cs = ConsensusState(
            cfg or ConsensusConfig(skip_timeout_commit=True),
            state,
            executor,
            block_store,
            privval=privval,
            event_bus=event_bus,
            wal=WAL(os.path.join(data, "cs.wal", "wal")),
            evidence_pool=evpool,
        )
    return ConsensusNode(
        cs, executor, state_store, block_store, evpool, event_bus, privval, app, home,
        (state_db, block_db, evidence_db), mempool,
    )


@dataclass
class ConsensusHeight:
    """One height of a consensus chain as its node meets it: the block
    and its id, the proposal and the parts as wire bytes (none when the
    node proposes), then the other validators' prevotes and precommits
    as VoteMessage wire bytes in a seeded order, and the commit of every
    validator (the next block's LastCommit). `equivocator` is the index
    of a validator whose second precommit, for another block, follows
    its real one (-1: none)."""

    height: int
    block: Block
    block_id: BlockID
    node_proposes: bool
    proposal: Optional[bytes]
    parts: List[bytes]
    prevotes: List[bytes]
    precommits: List[bytes]
    commit: Commit
    equivocator: int = -1


def _node_vote(priv, chain_id: str, vote_type: int, height: int, block_id: BlockID,
               index: int, last_block_time_ns: int) -> Vote:
    """The vote the node's own validator signs at `height` (its pinned
    clock and consensus.state's vote time: never before the last block's
    time plus 1 ms; ed25519 signatures are deterministic)."""
    vote = Vote(
        type=vote_type,
        height=height,
        round=0,
        block_id=block_id,
        timestamp_ns=max(clock_at(height), last_block_time_ns + 1_000_000),
        validator_address=priv.pub_key().address(),
        validator_index=index,
    )
    vote.signature = priv.sign(vote.sign_bytes(chain_id))
    return vote


def build_consensus_chain(genesis_json: str, privs: Sequence, node_priv, txs: Sequence[list],
                          seed: int, equivocate_at: int = 0,
                          node_reaps: bool = False) -> List[ConsensusHeight]:
    """Heights 1..len(txs) of the genesis's chain as one node, whose
    validator holds node_priv (ed25519), meets them in round 0: block h
    holds txs[h-1] and is made by State.make_block from the state after
    h - 1, its LastCommit the commit of every validator at h - 1 (the
    node's own precommit as the node signs it, the others from the
    seed); the proposer's signed proposal and the parts, then every
    other validator's prevote and precommit. Where the node proposes,
    the block is the one it makes (no transactions: its mempool is
    empty; the evidence its pool holds) and no proposal or part is sent;
    with node_reaps, its mempool holds txs[h-1] in arrival order by then
    (kvstore's priority is 0), and the block holds them.
    At height equivocate_at one validator also precommits another block
    right after its real precommit. Each block is applied on a
    harness node so the next carries its app and results hashes."""
    node = block_exec_node(genesis_json)
    chain_id = node.state.chain_id
    state = node.state
    by_addr = {p.pub_key().address(): p for p in privs}
    node_addr = node_priv.pub_key().address()
    last_commit = Commit(height=0, round=0, block_id=BlockID(), signatures=[])
    out, pending = [], []
    for h, block_txs_ in enumerate(txs, start=state.initial_height):
        vals = state.validators.validators
        node_index, _ = state.validators.get_by_address(node_addr)
        proposer = state.validators.get_proposer()
        node_proposes = proposer.address == node_addr
        if node_proposes:
            # the node reaps its mempool and its pool's evidence
            reaped = list(block_txs_) if node_reaps else []
            block, parts = state.make_block(h, reaped, last_commit, pending, proposer.address)
            pending = []
        else:
            block, parts = state.make_block(h, list(block_txs_), last_commit, [], proposer.address)
        block_id = BlockID(hash=block.hash(), part_set_header=parts.header())
        rng = np.random.default_rng([seed, 13, h])
        proposal_wire, part_wires = None, []
        if not node_proposes:
            proposal = Proposal(height=h, round=0, pol_round=-1, block_id=block_id,
                                timestamp_ns=block.header.time_ns)
            proposal.signature = _sign_all(
                [by_addr[proposer.address]], [proposal.sign_bytes(chain_id)], rng
            )[0]
            proposal_wire = encode_msg(ProposalMessage(proposal))
            part_wires = [
                encode_msg(BlockPartMessage(height=h, round=0, part=parts.get_part(i)))
                for i in range(parts.total)
            ]
        others = [i for i in rng.permutation(len(vals)).tolist() if i != node_index]
        votes = {}
        for vote_type in (PREVOTE_TYPE, PRECOMMIT_TYPE):
            votes[vote_type] = [
                Vote(
                    type=vote_type,
                    height=h,
                    round=0,
                    block_id=block_id,
                    timestamp_ns=block.header.time_ns + 1 + int(rng.integers(0, 1_000_000_000)),
                    validator_address=vals[i].address,
                    validator_index=i,
                )
                for i in others
            ]
        signed = votes[PREVOTE_TYPE] + votes[PRECOMMIT_TYPE]
        equivocator = -1
        if h == equivocate_at:
            real = votes[PRECOMMIT_TYPE][0]
            equivocator = real.validator_index
            other = real.copy()
            other.block_id = BlockID(
                hashlib.sha256(b"equivocation-%d-%d" % (seed, h)).digest(),
                PartSetHeader(1, hashlib.sha256(b"equivocation-parts-%d" % seed).digest()),
            )
            votes[PRECOMMIT_TYPE].insert(1, other)
            signed.append(other)
        sigs = _sign_all(
            [by_addr[v.validator_address] for v in signed],
            [v.sign_bytes(chain_id) for v in signed],
            np.random.default_rng([seed, 14, h]),
        )
        for v, sig in zip(signed, sigs):
            v.signature = sig
        own = _node_vote(node_priv, chain_id, PRECOMMIT_TYPE, h, block_id, node_index,
                         state.last_block_time_ns)
        by_index = {v.validator_index: v for v in votes[PRECOMMIT_TYPE] if v.block_id == block_id}
        by_index[node_index] = own
        commit = Commit(
            height=h,
            round=0,
            block_id=block_id,
            signatures=[
                CommitSig.for_block(by_index[i].signature, vals[i].address, by_index[i].timestamp_ns)
                for i in range(len(vals))
            ],
        )
        if equivocator >= 0:
            # the pool's evidence of it once the height is applied
            pending.append(
                DuplicateVoteEvidence.from_votes(
                    votes[PRECOMMIT_TYPE][0], votes[PRECOMMIT_TYPE][1],
                    block.header.time_ns, state.validators,
                )
            )
        node.block_store.save_block(block, parts, commit)
        state = asyncio.run(node.executor.apply_block(state, block_id, block))
        out.append(
            ConsensusHeight(
                height=h,
                block=block,
                block_id=block_id,
                node_proposes=node_proposes,
                proposal=proposal_wire,
                parts=part_wires,
                prevotes=[encode_msg(VoteMessage(v)) for v in votes[PREVOTE_TYPE]],
                precommits=[encode_msg(VoteMessage(v)) for v in votes[PRECOMMIT_TYPE]],
                commit=commit,
                equivocator=equivocator,
            )
        )
        last_commit = commit
    node.close()
    return out


@dataclass
class HeightRun:
    """What drive_heights saw of one height (host clock, seconds from
    the height's first message): when the proposal's messages, the
    prevotes and the precommits had been handled, when EndHeight was
    written, when the node stood at the next height, and the round it
    committed in; the timeouts the loop handled, each (step, acted on)."""

    height: int
    round: int = -1
    proposal_s: float = 0.0
    prevotes_s: float = 0.0
    precommits_s: float = 0.0
    end_height_s: float = 0.0
    next_height_s: float = 0.0
    timeouts: List[tuple] = None


async def drive_heights(node: ConsensusNode, chain: List[ConsensusHeight], burst: int = PEER_DRAIN,
                        before=None, after=None, extra=None) -> List[HeightRun]:
    """Start node's step machine, feed it the chain's heights and stop
    it: at each height, once the node stands in round 0 (height 1 waits
    for its start timeout), the messages of extra.get(h, []) (wire bytes
    sent first, such as a forged proposal), the proposal and its parts,
    then the prevotes and then the precommits in bursts of `burst`, each
    burst queued whole and handled before the next. before(h) and
    after(h), if given, run at a height's first message and once the
    node stands at the next height. Raises what the loop raises, when a
    queue dropped a message, and when a height did not end."""
    cs = node.cs
    runs: List[HeightRun] = []
    marks: Dict[str, float] = {}
    write_end = cs.wal.write_end_height
    handle_timeout = cs._handle_timeout
    finalize_commit = cs._finalize_commit

    def end_height(height: int) -> None:
        write_end(height)
        marks["end_height"] = time.perf_counter()

    async def finalize(height: int) -> None:
        await finalize_commit(height)
        marks["finalized"] = time.perf_counter()

    async def timeout(ti):
        rs = cs.rs
        acted = not (
            ti.height != rs.height or ti.round < rs.round
            or (ti.round == rs.round and ti.step < rs.step)
        )
        timeouts.append((ti.height, ti.round, ti.step, acted))
        await handle_timeout(ti)

    timeouts: List[tuple] = []
    cs._handle_timeout = timeout
    cs._finalize_commit = finalize
    await node.event_bus.start()
    with pinned_clock(lambda: cs.rs.height):
        await cs.start()
        cs.wal.write_end_height = end_height
        try:
            mark = 0  # the first height's timeouts include the start's
            for ch in chain:
                deadline = time.monotonic() + 30
                while not (cs.rs.height == ch.height and cs.rs.step >= RoundStep.NEW_ROUND):
                    if time.monotonic() > deadline:
                        raise RuntimeError(f"the node did not enter height {ch.height}")
                    await asyncio.sleep(0.001)
                run = HeightRun(height=ch.height, timeouts=[])
                if before is not None:
                    before(ch.height)
                t0 = time.perf_counter()
                head = list((extra or {}).get(ch.height, ()))
                if ch.proposal is not None:
                    head += [ch.proposal] + ch.parts
                await _send(cs, head, len(head) or 1)
                run.proposal_s = time.perf_counter() - t0
                await _send(cs, ch.prevotes, burst)
                run.prevotes_s = time.perf_counter() - t0
                await _send(cs, ch.precommits, burst)
                run.precommits_s = time.perf_counter() - t0
                if cs.rs.height != ch.height + 1:
                    raise RuntimeError(f"height {ch.height} did not end (at {cs.rs.height})")
                run.end_height_s = marks.pop("end_height") - t0
                run.next_height_s = marks.pop("finalized") - t0
                seen = node.block_store.load_seen_commit()
                run.round = seen.round if seen is not None and seen.height == ch.height else -1
                run.timeouts, mark = timeouts[mark:], len(timeouts)
                if after is not None:
                    after(ch.height)
                runs.append(run)
        finally:
            cs.wal.write_end_height = write_end
            cs._handle_timeout = handle_timeout
            cs._finalize_commit = finalize_commit
            await cs.stop()
            await node.event_bus.stop()
    return runs


async def _send(cs: ConsensusState, wires: List[bytes], burst: int) -> None:
    for i in range(0, len(wires), burst):
        for w in wires[i : i + burst]:
            if not cs.send_peer_msg(decode_msg(w), "peer"):
                raise RuntimeError("the peer queue dropped a message")
        await cs.wait_idle()


# -- the mempool harness --


def first_proposer_height(privs: Sequence, key_type: str = "ed25519", start: int = 2) -> int:
    """The first height from `start` on whose round-0 proposer holds a
    key of key_type, in a static set of equal-power validators holding
    privs (height h's proposer is the genesis set's after h - 1
    increments)."""
    by_addr = {p.pub_key().address(): p for p in privs}
    vals = ValidatorSet([Validator(pub_key=p.pub_key(), voting_power=10) for p in privs])
    h = 1
    while h < start or by_addr[vals.get_proposer().address].type() != key_type:
        vals = vals.copy_increment_proposer_priority(1)
        h += 1
    return h


def kv_mempool(app: KVStoreApplication, cfg: Optional[MempoolConfig] = None) -> TxMempool:
    """A TxMempool on a connection of its own to app (a node's mempool
    connection, tendermint_tpu_torch/abci/proxy.py)."""
    return TxMempool(LocalClient(app), cfg or MempoolConfig())


def node_key(seed: int, i: int) -> PrivKeyEd25519:
    """Node i's p2p identity (its node ID is the key's address), from
    the seed."""
    return PrivKeyEd25519.from_seed(hashlib.sha256(b"node-key-%d-%d" % (seed, i)).digest())


@dataclass
class GossipNode:
    """A node's p2p half: its router on a transport, the peer manager
    and the mempool reactor on channel 0x30 over `mempool`."""

    node_id: str
    mempool: TxMempool
    router: Router
    reactor: MempoolReactor
    peer_manager: PeerManager

    async def start(self) -> None:
        await self.router.start()
        await self.reactor.start()

    async def stop(self) -> None:
        await self.reactor.stop()
        await self.router.stop()


def gossip_node(mempool: TxMempool, key, transport: Transport, chain_id: str,
                listen_addr: str = "", moniker: str = "") -> GossipNode:
    """A router with the node key `key` on `transport` (listening on
    listen_addr when given), its peer manager and router options from
    the JAX P2PConfig defaults as node start wires them, and the mempool
    reactor over mempool (its channel sized by the pool's max_tx_bytes,
    broadcasting if the pool's config says so). Add peers with
    node.peer_manager.add("<id>@host:port")."""
    cfg = P2PConfig()
    node_id = node_id_from_pubkey(key.pub_key())
    info = NodeInfo(node_id=node_id, listen_addr=listen_addr, network=chain_id,
                    version="tendermint_tpu_torch", moniker=moniker)
    manager = PeerManager(node_id, peer_manager_options(cfg))
    router = Router(info, key, manager, transport, listen_addr=listen_addr,
                    options=router_options(cfg))
    channel = router.open_channel(mempool_channel_descriptor(mempool.cfg.max_tx_bytes))
    reactor = MempoolReactor(mempool, channel, manager.subscribe(), broadcast=mempool.cfg.broadcast)
    return GossipNode(node_id, mempool, router, reactor, manager)


async def admit(pool: TxMempool, txs: Sequence[bytes], batch: int) -> tuple:
    """Feed txs to pool through check_tx_batch, `batch` at a time,
    yielding to the loop between batches (so gossip runs beside the
    admission). Returns (outcomes in order, seconds inside the calls)."""
    out, spent = [], 0.0
    for i in range(0, len(txs), batch):
        t0 = time.perf_counter()
        out += await pool.check_tx_batch(list(txs[i : i + batch]))
        spent += time.perf_counter() - t0
        await asyncio.sleep(0)
    return out, spent


async def wait_for_pool(pool: TxMempool, n: int, timeout_s: float) -> float:
    """Wait until pool holds at least n txs; the host clock then.
    Raises if it does not within timeout_s."""
    deadline = time.monotonic() + timeout_s
    while pool.size() < n:
        if time.monotonic() > deadline:
            raise RuntimeError(f"the pool holds {pool.size()} txs, not {n}, after {timeout_s} s")
        await asyncio.sleep(0.001)
    return time.perf_counter()


@dataclass
class MempoolRun:
    """What drive_mempool_heights saw (host clock): the full node's
    admission outcomes of the stream and of the late txs, the seconds
    inside its check_tx_batch calls, the seconds from its first admission
    to the last tx in the node's pool, the node's heights, its own
    height from _enter_propose to EndHeight (and the clock at its
    _enter_propose), and the node's pool at the end in arrival order."""

    outcomes: list
    admit_s: float
    gossip_s: float
    late_outcomes: list
    runs: List[HeightRun]
    own_height_s: float
    enter_propose_at: float
    pool_end: List[bytes]


async def drive_mempool_heights(node: ConsensusNode, pool_b: TxMempool, chain: List[ConsensusHeight],
                                stream: Sequence[bytes], late: Sequence[bytes], seed: int,
                                before=None, after=None, timeout_s: float = 120.0) -> MempoolRun:
    """Node A (node, its pool node.mempool a TxMempool) and a full node B
    (pool_b) gossip on one MemoryNetwork, each with a router and the
    mempool reactor (node keys node_key(seed, 0) and (seed, 1), A
    dialing B). B admits `stream` through check_tx_batch in batches of
    its tx_batch_size; once A's pool holds as many txs as the block of
    the height A proposes, A meets the chain (drive_heights, where
    before and after are passed on); at the first message of A's own
    height B admits `late`, and the run ends once A's pool holds as
    many. Raises what drive_heights raises, and when a pool does not
    fill within timeout_s."""
    own = next(ch for ch in chain if ch.node_proposes)
    pool_a, batch = node.mempool, pool_b.cfg.tx_batch_size
    net = MemoryNetwork()
    a = gossip_node(pool_a, node_key(seed, 0), MemoryTransport(net, "node-a.mem:1"),
                    node.cs.state.chain_id, listen_addr="node-a.mem:1", moniker="node-a")
    b = gossip_node(pool_b, node_key(seed, 1), MemoryTransport(net, "node-b.mem:2"),
                    node.cs.state.chain_id, listen_addr="node-b.mem:2", moniker="node-b")
    a.peer_manager.add(f"{b.node_id}@node-b.mem:2")
    marks: Dict[str, float] = {}
    late_admission = []
    enter_propose = node.cs._enter_propose
    write_end = node.cs.wal.write_end_height

    async def entering_propose(height: int, round_: int) -> None:
        if height == own.height:
            marks.setdefault("enter_propose", time.perf_counter())
        await enter_propose(height, round_)

    def end_height(height: int) -> None:
        write_end(height)
        if height == own.height:
            marks.setdefault("end_height", time.perf_counter())

    def first_message(h: int) -> None:
        if h == own.height:
            late_admission.append(asyncio.get_running_loop().create_task(admit(pool_b, late, batch)))
        if before is not None:
            before(h)

    node.cs._enter_propose = entering_propose
    node.cs.wal.write_end_height = end_height
    await b.start()
    await a.start()
    try:
        deadline = time.monotonic() + timeout_s
        while not (a.peer_manager.peers() and b.peer_manager.peers()):
            if time.monotonic() > deadline:
                raise RuntimeError("the nodes did not connect")
            await asyncio.sleep(0.001)
        t0 = time.perf_counter()
        outcomes, admit_s = await admit(pool_b, stream, batch)
        gossip_s = await wait_for_pool(pool_a, len(own.block.txs), timeout_s) - t0
        runs = await drive_heights(node, chain, before=first_message, after=after)
        late_outcomes, _ = await late_admission[0]
        await wait_for_pool(pool_a, len(late), timeout_s)
        await asyncio.sleep(0.05)  # a second copy would have landed by now
        return MempoolRun(outcomes, admit_s, gossip_s, late_outcomes, runs,
                          marks["end_height"] - marks["enter_propose"], marks["enter_propose"],
                          pool_a.reap_max_txs(-1))
    finally:
        for t in late_admission:
            t.cancel()
        await a.stop()
        await b.stop()
        node.cs._enter_propose = enter_propose
        node.cs.wal.write_end_height = write_end
