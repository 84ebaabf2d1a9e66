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
  state and block stores on MemKV or on SqliteKV in a directory).

Keys, timestamps and signing witnesses come from the seed, so a seed
gives the same bytes on every host. Signing is native: ed25519's and
sr25519's fixed-base multiplies run in the C plane (tendermint_tpu_torch/
native); the bench's sign_keygen cell times one signature of each key
type, and its light_sync cell the build of a chain.
"""

from __future__ import annotations

import asyncio
import hashlib
import os
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from .crypto.ed25519 import PrivKeyEd25519
from .crypto.sr25519 import PrivKeySr25519, sign_batch
from .consensus.msgs import VoteMessage, decode_msg, encode_msg
from .consensus.state import ConsensusState
from .consensus.types import RoundState
from .abci.client import LocalClient
from .abci.kvstore import KVStoreApplication
from .crypto import batch
from .light.client import Client, TrustOptions
from .light.errors import LightBlockNotFoundError
from .light.provider import Provider
from .light.store import LightStore
from .mempool.nop import NopMempool
from .state.execution import BlockExecutor
from .state.store import StateStore
from .state.types import State, state_from_genesis
from .store.block_store import BlockStore
from .store.kv import MemKV, SqliteKV
from .types.block import Block
from .types.block_id import BlockID, PartSetHeader
from .types.canonical import PRECOMMIT_TYPE, PREVOTE_TYPE
from .types.commit import Commit, CommitSig
from .types.genesis import GenesisDoc, GenesisValidator
from .types.header import Consensus, Header
from .types.params import ConsensusParams
from .types.part_set import PartSet
from .types.light import LightBlock, SignedHeader
from .types.validator import Validator, ValidatorSet
from .types.vote import Vote

__all__ = [
    "BASE_TIME_NS",
    "ChainBlock",
    "ChainProvider",
    "ExecNode",
    "VoteTraffic",
    "block_exec_node",
    "block_txs",
    "build_block_chain",
    "build_commit",
    "build_light_chain",
    "build_vote_traffic",
    "ingest",
    "kv_genesis",
    "kv_txs",
    "light_client",
    "light_sync",
    "seeded_keys",
    "sign_commit",
    "vote_state",
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
    """A fresh ConsensusState at `height`, round 0, with its HeightVoteSet."""
    return ConsensusState(chain_id, RoundState(height=height, validators=vals))


def ingest(cs: ConsensusState, wires: List[bytes], burst: int, peer_id: str = "peer") -> None:
    """Run cs's receive loop over the wire bytes of consensus messages
    from one peer, `burst` at a time: each burst is decoded and queued
    whole, then handled before the next is queued (the loop drains up to
    consensus.state.PEER_DRAIN a turn, so a burst of that size is one
    pre-verify). Raises what the loop raises, and when a message was
    dropped by a full queue."""

    async def run():
        cs.start()
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
