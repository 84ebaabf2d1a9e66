"""Seeded inputs for the port's bench and its on-card checks: validator
sets and Commits, chains of LightBlocks, and blocks of transactions,
all built with the port's own types from a seed.

- build_commit: a Commit of n equal-power validators, every one signing,
  some of them sr25519;
- build_three_class_commit: a Commit of n equal-power validators in the
  JAX bench's three-class rotation (bench.py:147-178), ed25519, sr25519
  and secp256k1 by index mod 3, the secp256k1 keys and signatures made on
  a process pool when asked;
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
  height from its pool;
- the consensus gossip harness: gossip_keys, three real validators'
  keys of a set (one proposing a given height); seeded_witness, an
  sr25519 key signing the same bytes for a seed and a message;
  validator_node, a consensus_node on a router with the consensus,
  mempool and evidence reactors; HarnessPeer, a peer with the consensus
  channels and no step machine; drive_gossip_heights, three validator
  nodes and the harness peer committing heights through the nodes'
  gossip while the harness signs for every other validator, and
  run_gossip_network, the same on a fresh network;
- the catch-up harness: serve_chain, a built chain with the node that
  applied it (its app snapshotting); ServingStore and ServingClient, a
  serving peer's view of that node's block store (some blocks or
  commits replaced, a forged one among them) and app connection;
  forged_commit, a commit with one signature flipped, and forged_block,
  a block carrying one; serving_node and
  fresh_node, peers with the block sync and state sync reactors (the
  fresh one with a consensus reactor waiting for block sync); and
  run_catchup, a fresh node block-syncing, or state-syncing, backfilling
  and block-syncing, from serving peers on one MemoryNetwork;
- the RPC harness: rpc_serving, RPCServers for Environments on
  127.0.0.1:0; stored_light_blocks, a node's light blocks as its stores
  hold them; conflicting_light_block, a header of the chain with another
  app hash and the commit of the set signing it (a lying witness serves
  it through a ServingStore); http_light_client and http_light_sync, a
  sequential light client of RPC servers through HTTPProviders;
  rpc_light_sync, a node's chain synced from height 1 over HTTP from it
  and honest witnesses, its light_blocks pages timed; and
  publish_stored_height, a stored height's events on an event bus as
  BlockExecutor publishes them (the indexer's feed);
- the metrics harness: scrape, a node's /metrics and /healthz over HTTP
  (the scrape's ms and bytes beside them), and parse_exposition, a
  Prometheus text document as {series: value}, refusing a line it cannot
  parse and a series it meets twice; run_node_start and cli_localnet
  scrape the nodes they start when those serve Prometheus.

Keys, timestamps and signing witnesses come from the seed, so a seed
gives the same bytes on every host. Signing is native: ed25519's and
sr25519's fixed-base multiplies run in the C plane (tendermint_tpu_torch/
native); the bench's sign_keygen cell times one signature of each key
type, and its light_sync cell the build of a chain.
"""

from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import hashlib
import json
import os
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from .abci import types as abci_types
from .blocksync import BlocksyncReactor, blocksync_channel_descriptor
from .crypto.ed25519 import PrivKeyEd25519
from .crypto.secp256k1 import PrivKeySecp256k1, PubKeySecp256k1
from .crypto.sr25519 import PrivKeySr25519, sign_batch
from .config import ConsensusConfig, MempoolConfig, P2PConfig, StateSyncConfig
from .consensus.msgs import (
    BlockPartMessage,
    EndHeightMessage,
    HasVoteMessage,
    ProposalMessage,
    VoteMessage,
    decode_msg,
    encode_msg,
)
from .consensus.reactor import (
    DATA_CHANNEL,
    VOTE_CHANNEL,
    ConsensusReactor,
    consensus_channel_descriptors,
)
from .consensus.state import PEER_DRAIN, ConsensusState
from .consensus.types import RoundStep
from .consensus.wal import WAL
from .eventbus import EventBus
from .evidence.pool import EvidencePool
from .evidence.reactor import EvidenceReactor, evidence_channel_descriptor
from .libs.service import Service
from .privval.file import FilePV
from .abci.client import LocalClient
from .abci.kvstore import KVStoreApplication
from .crypto import batch
from .light.client import Client, TrustOptions
from .light.errors import LightBlockNotFoundError
from .light.provider import HTTPProvider, Provider
from .light.store import LightStore
from .mempool.mempool import TxMempool
from .mempool.nop import NopMempool
from .mempool.reactor import MempoolReactor, mempool_channel_descriptor
from .p2p.peermanager import PeerManager, peer_manager_options
from .p2p.router import Router, router_options
from .p2p.transport import MemoryNetwork, MemoryTransport, Transport
from .p2p.types import Envelope, NodeInfo, node_id_from_pubkey
from .state.execution import BlockExecutor
from .state.store import StateStore
from .state.types import State, state_from_genesis
from .statesync import StatesyncReactor, statesync_channel_descriptors
from .store.block_store import BlockStore
from .store.kv import MemKV, SqliteKV
from .types.block import Block
from .types.block_id import BlockID, PartSetHeader
from .types.block_meta import BlockMeta
from .types.canonical import PRECOMMIT_TYPE, PREVOTE_TYPE, vote_sign_bytes
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
    "GossipHeight",
    "GossipNode",
    "GossipRun",
    "HarnessPeer",
    "HeightRun",
    "MempoolRun",
    "VoteTraffic",
    "conflicting_light_block",
    "http_light_client",
    "http_light_sync",
    "publish_stored_height",
    "NodeStartRun",
    "catchup_peers",
    "cli_localnet",
    "init_home",
    "rpc_light_sync",
    "rpc_serving",
    "run_node_start",
    "GPU_SCRAPE_SERIES",
    "Scrape",
    "check_cli_scrape",
    "check_node_scrape",
    "gpu_series",
    "parse_exposition",
    "scrape",
    "stage_crash",
    "stored_light_blocks",
    "block_exec_node",
    "block_txs",
    "build_block_chain",
    "build_commit",
    "build_consensus_chain",
    "build_light_chain",
    "build_three_class_commit",
    "admit",
    "build_vote_traffic",
    "clock_at",
    "consensus_node",
    "drive_gossip_heights",
    "drive_heights",
    "drive_mempool_heights",
    "end_height_records",
    "first_proposer_height",
    "gossip_keys",
    "gossip_node",
    "gossip_node_keys",
    "ingest",
    "kv_genesis",
    "kv_mempool",
    "kv_txs",
    "light_client",
    "light_sync",
    "node_key",
    "pinned_clock",
    "run_gossip_network",
    "seeded_keys",
    "seeded_witness",
    "sign_commit",
    "THREE_CLASSES",
    "three_class_key",
    "validator_node",
    "vote_state",
    "wait_for_pool",
    "ValidatorNode",
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


THREE_CLASSES = ("ed25519", "sr25519", "secp256k1")


def three_class_key(i: int):
    """Validator i's private key in the JAX bench's rotation
    (bench.py:164-178): THREE_CLASSES[i % 3], from the seed
    i.to_bytes(4, "big") + b"\\x33" * 28."""
    seed = int(i).to_bytes(4, "big") + b"\x33" * 28
    kind = THREE_CLASSES[i % 3]
    if kind == "sr25519":
        return PrivKeySr25519.from_seed(seed)
    if kind == "secp256k1":
        return PrivKeySecp256k1(seed)
    return PrivKeyEd25519.from_seed(seed)


def _secp_keys_and_sigs(job: list) -> list:
    """(public key bytes, signature) of each (validator index, message)
    of a job: a pool worker's share of a three-class Commit's secp256k1
    third (about 3 ms a key and 3.6 ms a signature, pure Python)."""
    out = []
    for i, msg in job:
        priv = three_class_key(i)
        out.append((priv.pub_key().bytes(), priv.sign(msg)))
    return out


def build_three_class_commit(n: int, chain_id: str, height: int, seed: int, workers: int = 1):
    """(ValidatorSet, BlockID, Commit) of n equal-power validators, all
    signing, validator i keyed by three_class_key(i). Vote timestamps
    spread over one second from the seed; the sr25519 witnesses come from
    the seed too, and ed25519 and secp256k1 signatures are deterministic,
    so a seed gives the same bytes on every host. With workers > 1 the
    secp256k1 keys and signatures are made on a process pool of that
    many workers (spawned, so a parent holding a CUDA context is safe)."""
    rng = np.random.default_rng([seed, 3])
    block_id = BlockID(
        hashlib.sha256(b"three-class-block-%d" % seed).digest(),
        PartSetHeader(1, hashlib.sha256(b"three-class-parts-%d" % seed).digest()),
    )
    stamps = [BASE_TIME_NS + int(t) for t in rng.integers(0, 1_000_000_000, size=n)]
    msgs = [vote_sign_bytes(chain_id, PRECOMMIT_TYPE, height, 0, block_id, ts) for ts in stamps]
    pubs: list = [None] * n
    sigs: list = [None] * n
    secp = [(i, msgs[i]) for i in range(n) if THREE_CLASSES[i % 3] == "secp256k1"]
    if workers > 1 and secp:
        import concurrent.futures
        import multiprocessing

        jobs = [secp[k::workers] for k in range(workers)]
        with concurrent.futures.ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn")
        ) as pool:
            for job, done in zip(jobs, pool.map(_secp_keys_and_sigs, jobs)):
                for (i, _msg), (pub, sig) in zip(job, done):
                    pubs[i], sigs[i] = PubKeySecp256k1(pub), sig
    else:
        for (i, _msg), (pub, sig) in zip(secp, _secp_keys_and_sigs(secp)):
            pubs[i], sigs[i] = PubKeySecp256k1(pub), sig
    sr_idx = [i for i in range(n) if THREE_CLASSES[i % 3] == "sr25519"]
    sr_privs = [three_class_key(i) for i in sr_idx]
    witness = np.random.default_rng([seed, 25519])
    for i, priv, sig in zip(
        sr_idx, sr_privs, sign_batch(sr_privs, [msgs[i] for i in sr_idx], rng=witness.bytes)
    ):
        pubs[i], sigs[i] = priv.pub_key(), sig
    for i in range(0, n, 3):
        priv = three_class_key(i)
        pubs[i], sigs[i] = priv.pub_key(), priv.sign(msgs[i])
    vals = ValidatorSet([Validator(pub_key=pk, voting_power=10) for pk in pubs])
    by_addr = {pk.address(): i for i, pk in enumerate(pubs)}
    commit_sigs = []
    for val in vals.validators:
        i = by_addr[val.address]
        commit_sigs.append(CommitSig.for_block(sigs[i], val.address, stamps[i]))
    return vals, block_id, Commit(height=height, round=0, block_id=block_id, signatures=commit_sigs)


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


def block_exec_node(genesis_json: str, db_dir: Optional[str] = None,
                    snapshot_interval: int = 0, init_chain: bool = False) -> ExecNode:
    """A fresh node at the genesis: the stores on MemKV, or on SqliteKV
    files `state.sqlite` and `blockstore.sqlite` in db_dir (made if
    missing; ExecNode.close closes them); its kvstore app takes a
    state-sync snapshot every snapshot_interval heights (0: never). With
    init_chain, the app has taken the genesis's InitChain and the state
    its answer, as a started node's handshake does at genesis
    (consensus/replay.py); the kvstore app then folds the genesis
    validators into its hash, so only such a chain can be synced by a
    node started from a home."""
    if db_dir is None:
        state_db, block_db = MemKV(), MemKV()
    else:
        os.makedirs(db_dir, exist_ok=True)
        state_db = SqliteKV(os.path.join(db_dir, "state.sqlite"))
        block_db = SqliteKV(os.path.join(db_dir, "blockstore.sqlite"))
    state = state_from_genesis(GenesisDoc.from_json(genesis_json))
    state_store, block_store = StateStore(state_db), BlockStore(block_db)
    state_store.save(state)
    app = KVStoreApplication(snapshot_interval=snapshot_interval)
    if init_chain:
        from .consensus.replay import Handshaker

        genesis = GenesisDoc.from_json(genesis_json)
        hs = Handshaker(state_store, state, block_store, genesis)
        state = hs._apply_init_chain_response(state, app.init_chain(hs._init_chain_request()))
        state_store.save(state)
    executor = BlockExecutor(
        state_store, LocalClient(app), NopMempool(), block_store=block_store
    )
    return ExecNode(state, app, executor, state_store, block_store, (state_db, block_db))


def serve_chain(genesis_json: str, privs: Sequence, txs: Sequence[list], seed: int,
                snapshot_interval: int = 0, init_chain: bool = False) -> tuple:
    """(build_block_chain's chain, the node that applied it, the State
    after each height): the node's stores hold every block, its commits
    and validator sets, and its app the snapshots of every
    snapshot_interval heights, as a peer serving the chain holds them.
    init_chain: the chain starts from the app's InitChain
    (block_exec_node)."""
    node = block_exec_node(genesis_json, snapshot_interval=snapshot_interval, init_chain=init_chain)
    chain_id = node.state.chain_id
    state = node.state
    last_commit = Commit(height=0)
    out, states = [], []
    for h, block_txs_ in enumerate(txs, start=state.initial_height):
        proposer = state.validators.get_proposer().address
        block, parts = state.make_block(h, list(block_txs_), last_commit, [], proposer)
        block_id = BlockID(hash=block.hash(), part_set_header=parts.header())
        seen = sign_commit(chain_id, state.validators, block_id, h,
                           block.header.time_ns, privs, seed)
        node.block_store.save_block(block, parts, seen)
        state = asyncio.run(node.executor.apply_block(state, block_id, block))
        out.append(ChainBlock(block, block_id, parts, seen))
        states.append(state)
        last_commit = seen
    return out, node, states


def build_block_chain(genesis_json: str, privs: Sequence, txs: Sequence[list],
                      seed: int) -> List[ChainBlock]:
    """Blocks 1..len(txs) of the genesis's chain, block h holding txs[h-1]:
    each made by State.make_block from the state after the height before
    (its proposer the set's, its LastCommit that height's commit, signed
    by sign_commit), then applied on a node of block_exec_node so that the
    next block carries its app and results hashes."""
    return serve_chain(genesis_json, privs, txs, seed)[0]


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
    _enter_propose; None when the chain stops before it), and the node's
    pool at the end in arrival order."""

    outcomes: list
    admit_s: float
    gossip_s: float
    late_outcomes: list
    runs: List[HeightRun]
    own_height_s: Optional[float]
    enter_propose_at: Optional[float]
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
    many. A chain that stops before A's own height (a reference run cut
    short) waits for every admitted tx in A's pool and admits no late
    txs. Raises what drive_heights raises, and when a pool does not fill
    within timeout_s."""
    own = next((ch for ch in chain if ch.node_proposes), None)
    own_height = own.height if own is not None else None
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
        if height == own_height:
            marks.setdefault("enter_propose", time.perf_counter())
        await enter_propose(height, round_)

    def end_height(height: int) -> None:
        write_end(height)
        if height == own_height:
            marks.setdefault("end_height", time.perf_counter())

    def first_message(h: int) -> None:
        if h == own_height:
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
        admitted = sum(1 for r in outcomes if not isinstance(r, Exception) and r.code == 0)
        want = len(own.block.txs) if own is not None else admitted
        gossip_s = await wait_for_pool(pool_a, want, timeout_s) - t0
        runs = await drive_heights(node, chain, before=first_message, after=after)
        late_outcomes = []
        if late_admission:
            late_outcomes, _ = await late_admission[0]
            await wait_for_pool(pool_a, len(late), timeout_s)
        await asyncio.sleep(0.05)  # a second copy would have landed by now
        own_s = marks["end_height"] - marks["enter_propose"] if own is not None else None
        return MempoolRun(outcomes, admit_s, gossip_s, late_outcomes, runs, own_s,
                          marks.get("enter_propose"), pool_a.reap_max_txs(-1))
    finally:
        for t in late_admission:
            t.cancel()
        await a.stop()
        await b.stop()
        node.cs._enter_propose = enter_propose
        node.cs.wal.write_end_height = write_end


# -- the consensus gossip harness --


def gossip_keys(privs: Sequence, heights: int, proposes_at: int) -> tuple:
    """The keys of three real validators (A, B, C) of a static set of
    equal-power validators holding privs: A proposes round 0 of height
    proposes_at and of no other height in 1..heights; B and C propose
    none of them, B the first such ed25519 key in the set's seeded order
    and C the first such sr25519 key (another ed25519 key where the set
    has none)."""
    vals = ValidatorSet([Validator(pub_key=p.pub_key(), voting_power=10) for p in privs])
    proposers = []
    for _ in range(heights):
        proposers.append(vals.get_proposer().address)
        vals = vals.copy_increment_proposer_priority(1)
    by_addr = {p.pub_key().address(): p for p in privs}
    a = by_addr[proposers[proposes_at - 1]]
    if proposers.count(proposers[proposes_at - 1]) != 1:
        raise ValueError(f"the proposer of height {proposes_at} proposes another height too")
    idle = [p for p in privs if p.pub_key().address() not in proposers]
    b = next(p for p in idle if p.type() == "ed25519")
    c = next((p for p in idle if p.type() == "sr25519"), None)
    if c is None:
        c = next(p for p in idle if p.type() == "ed25519" and p is not b)
    return a, b, c


def gossip_node_keys(seed: int) -> tuple:
    """Node key indexes (node_key) of A, B, C and the harness peer of a
    gossip network: 20, 21, 22 and the first index from 23 on whose node
    ID sorts after A's or B's, so that the half of C's three peers a
    Byzantine C targets (the first in node ID order) is a real node."""
    first = min(node_id_from_pubkey(node_key(seed, i).pub_key()) for i in (20, 21))
    h = 23
    while node_id_from_pubkey(node_key(seed, h).pub_key()) < first:
        h += 1
    return (20, 21, 22, h)


def seeded_witness(priv, seed: int) -> None:
    """Make an sr25519 key's signatures a function of the seed and the
    message: its signing witness takes SHA-256(seed, message) where it
    would take OS randomness (priv.sign is set on the instance; an
    ed25519 key, deterministic already, is left alone). Two runs of one
    seed then sign the same bytes."""
    if priv.type() != "sr25519":
        return
    inner = type(priv).sign

    def sign(msg: bytes, rng=None):
        fresh = hashlib.sha256(b"witness-%d-" % seed + msg).digest()
        return inner(priv, msg, rng or (lambda n: fresh[:n]))

    priv.sign = sign


@dataclass
class ValidatorNode:
    """A validator's node on a p2p network: consensus_node's step
    machine, pools and stores, its router and peer manager, and the
    consensus, mempool and evidence reactors on the router's channels."""

    node: ConsensusNode
    node_id: str
    moniker: str
    router: Router
    peer_manager: PeerManager
    consensus: ConsensusReactor
    mempool: MempoolReactor
    evidence: EvidenceReactor

    async def start(self) -> None:
        await self.node.event_bus.start()
        await self.router.start()
        await self.consensus.start()  # starts the step machine
        await self.mempool.start()
        await self.evidence.start()

    async def stop(self) -> None:
        """Stop every part; raise the first error one of them ended on
        (the step machine's loop, the evidence reactor's receive loop)."""
        errors = []
        for svc in (self.evidence, self.mempool, self.consensus, self.router):
            try:
                await svc.stop()
            except Exception as e:  # raised below, after the rest stopped
                errors.append(e)
        await self.node.event_bus.stop()
        if errors:
            raise errors[0]


def validator_node(node: ConsensusNode, key, transport: Transport, chain_id: str,
                   listen_addr: str = "", moniker: str = "") -> ValidatorNode:
    """node (a consensus_node with a TxMempool) on a router with the node
    key `key` on `transport`, the peer manager and router options from
    the JAX P2PConfig defaults, and the consensus reactor (channels
    0x20-0x23), the mempool reactor (0x30) and the evidence reactor
    (0x38) as node start wires them. Build it inside the running loop
    (a router spawns a task a channel)."""
    cfg = P2PConfig()
    node_id = node_id_from_pubkey(key.pub_key())
    info = NodeInfo(node_id=node_id, listen_addr=listen_addr, network=chain_id,
                    version="tendermint_tpu_torch", moniker=moniker)
    manager = PeerManager(node_id, peer_manager_options(cfg))
    router = Router(info, key, manager, transport, listen_addr=listen_addr,
                    options=router_options(cfg))
    cs_channels = {cid: router.open_channel(d) for cid, d in consensus_channel_descriptors().items()}
    consensus = ConsensusReactor(node.cs, cs_channels, manager.subscribe(), node.event_bus)
    pool = node.mempool
    mempool = MempoolReactor(
        pool, router.open_channel(mempool_channel_descriptor(pool.cfg.max_tx_bytes)),
        manager.subscribe(), broadcast=pool.cfg.broadcast,
    )
    evidence = EvidenceReactor(node.evpool, router.open_channel(evidence_channel_descriptor()),
                               manager.subscribe())
    return ValidatorNode(node, node_id, moniker, router, manager, consensus, mempool, evidence)


# a harness peer's channels hold a whole height's sends to one node
HARNESS_SEND_CAPACITY = 1 << 14


class _SendOnlyCodec:
    """The consensus channels' codec for a peer that reads nothing it
    receives: frames come in undecoded."""

    encode = staticmethod(encode_msg)

    @staticmethod
    def decode(data: bytes) -> bytes:
        return data


class HarnessPeer(Service):
    """A peer with a router and the four consensus channels and no
    step machine: it sends proposals, parts and votes it is handed, and
    drains what the nodes send it without decoding it (the nodes
    broadcast a HasVote a vote to every peer)."""

    def __init__(self, key, transport: Transport, chain_id: str, listen_addr: str = "",
                 moniker: str = "harness") -> None:
        super().__init__(name="harness")
        cfg = P2PConfig()
        self.node_id = node_id_from_pubkey(key.pub_key())
        info = NodeInfo(node_id=self.node_id, listen_addr=listen_addr, network=chain_id,
                        version="tendermint_tpu_torch", moniker=moniker)
        self.peer_manager = PeerManager(self.node_id, peer_manager_options(cfg))
        self.router = Router(info, key, self.peer_manager, transport, listen_addr=listen_addr,
                             options=router_options(cfg))
        self.channels = {}
        for cid, d in consensus_channel_descriptors().items():
            d = dataclasses.replace(d, send_queue_capacity=HARNESS_SEND_CAPACITY,
                                    message_type=_SendOnlyCodec)
            self.channels[cid] = self.router.open_channel(d)

    async def on_start(self) -> None:
        await self.router.start()
        for cid, ch in self.channels.items():
            self.spawn(self._drain(ch), f"drain-{cid}")

    async def on_stop(self) -> None:
        await self.router.stop()

    @staticmethod
    async def _drain(ch) -> None:
        async for _env in ch:
            pass

    async def send(self, channel_id: int, msg, to: str) -> None:
        await self.channels[channel_id].send(Envelope(message=msg, to=to))


async def _connect_mesh(members: Sequence, timeout_s: float) -> None:
    """Dial every pair of members (anything with peer_manager, node_id
    and router.listen_addr), the lower index dialing, and wait until each
    has every other one as a peer."""
    for i, a in enumerate(members):
        for b in members[i + 1:]:
            a.peer_manager.add(f"{b.node_id}@{b.router.listen_addr}")
    deadline = time.monotonic() + timeout_s
    while any(len(m.peer_manager.peers()) < len(members) - 1 for m in members):
        if time.monotonic() > deadline:
            raise RuntimeError("the gossip mesh did not connect")
        await asyncio.sleep(0.001)


@dataclass
class GossipHeight:
    """What drive_gossip_heights saw of one height (host clock,
    perf_counter seconds): who proposed it (a node's moniker, or
    "harness") and, for the harness's proposals, the node it went to;
    when the proposal first existed; by node, when its block was
    complete, when it wrote EndHeight, the round its seen commit has and
    the timeouts its loop handled, each (round, step, acted on)."""

    height: int
    proposer: str = ""
    sent_to: str = ""
    block: Optional[Block] = None
    proposal_at: float = 0.0
    complete_at: Dict[str, float] = None
    end_height_at: Dict[str, float] = None
    rounds: Dict[str, int] = None
    timeouts: Dict[str, list] = None


@dataclass
class GossipRun:
    """drive_gossip_heights' result: each height, the seconds from B's
    first admission until A and C held every tx, and, by node, the vote
    envelopes its consensus reactor took from the harness and from real
    peers, the duplicates among them, the messages its step machine's
    queue dropped, and every envelope its router delivered, by channel
    and height (HasVote apart, as "has_vote")."""

    heights: List[GossipHeight]
    tx_gossip_s: float
    votes_from_harness: Dict[str, Dict[int, int]]
    votes_from_peers: Dict[str, Dict[int, int]]
    duplicate_votes: Dict[str, Dict[int, int]]
    dropped: Dict[str, int]
    envelopes: Dict[str, Dict[int, Dict[str, int]]]


def _vote_of(node: ValidatorNode, height: int, vote_type: int, index: int) -> Optional[Vote]:
    """Validator `index`'s vote of (height, round 0, vote_type) as node
    holds it, if it does."""
    rs = node.node.cs.rs
    if rs.height == height and rs.votes is not None:
        vs = rs.votes.prevotes(0) if vote_type == PREVOTE_TYPE else rs.votes.precommits(0)
    elif rs.height == height + 1 and vote_type == PRECOMMIT_TYPE:
        vs = rs.last_commit
    else:
        vs = None
    return vs.get_by_index(index) if vs is not None else None


async def _poll(cond, timeout_s: float, what: str, alive=None) -> float:
    """Wait until cond(); raise when it does not hold within timeout_s,
    and at once when alive() raises."""
    deadline = time.monotonic() + timeout_s
    while not cond():
        if alive is not None:
            alive()
        if time.monotonic() > deadline:
            raise RuntimeError(f"{what} within {timeout_s} s")
        await asyncio.sleep(0.001)
    return time.perf_counter()


def _count_envelopes(vn: ValidatorNode, into: Dict[int, Dict[str, int]]) -> None:
    """vn's router's channels count what they deliver, by the node's
    height and channel (HasVote apart)."""
    names = {ch.id: ch.name for ch in vn.router._channels.values()}
    for ch in vn.router._channels.values():
        inner = ch.deliver

        def deliver(envelope, inner=inner, name=names[ch.id]):
            kind = "has_vote" if isinstance(envelope.message, HasVoteMessage) else name
            per = into.setdefault(vn.node.cs.rs.height, {})
            per[kind] = per.get(kind, 0) + 1
            return inner(envelope)

        ch.deliver = deliver


async def drive_gossip_heights(nodes: Sequence[ValidatorNode], harness: HarnessPeer, privs: Sequence,
                               genesis_json: str, txs: Sequence[list], pool_txs: Sequence[bytes],
                               seed: int, before=None, after=None, burst: int = PEER_DRAIN,
                               timeout_s: float = 120.0, before_votes=None) -> GossipRun:
    """Three validator nodes (A, B, C) and the harness peer on one
    network, started and connected in a full mesh, commit heights
    1..len(txs) through each other's gossip; the harness signs for every
    other validator of privs. Before height 1, B admits pool_txs, which
    the mempool reactors carry to A and C. At each height the harness
    takes the block from its proposer: where a validator of its own
    proposes, it makes block h of txs[h-1] (State.make_block from the
    state the nodes reached after h - 1, read from A's store; the
    LastCommit every validator's precommit of h - 1, the nodes' read
    from their vote sets) and sends the signed proposal and its parts to
    a node that stands at h, the others getting them by gossip; where a
    node proposes, it reads the block from that node's round state. Once every node holds the complete
    block and has signed its prevote, it sends its validators' prevotes
    and then their precommits, each to one node, validator index mod 3,
    in bursts of `burst` a node held back while the node's backlog is a
    burst or more. before(h) runs before height h's first message,
    `await before_votes(h)` before the harness's first vote of h, and
    after(h) once every node stands at h + 1. The clock is pinned to the
    harness's height (pinned_clock) for the whole run. Raises what a
    node raises (at once when a node's receive loop ends) and when a
    step does not happen within timeout_s."""
    chain_id = nodes[0].node.cs.state.chain_id
    state = state_from_genesis(GenesisDoc.from_json(genesis_json))
    by_addr = {p.pub_key().address(): p for p in privs}
    real = {vn.node.privval.key.address: vn for vn in nodes}
    cur = [0]
    heights: List[GossipHeight] = []
    by_h: Dict[int, GossipHeight] = {}
    names = [vn.moniker for vn in nodes]
    from_harness = {n: {} for n in names}
    from_peers = {n: {} for n in names}
    duplicates = {n: {} for n in names}
    dropped = {n: 0 for n in names}
    envelopes = {n: {} for n in names}
    seen: Dict[str, set] = {n: set() for n in names}
    sent: Dict[str, int] = {n: 0 for n in names}
    taken: Dict[str, int] = {n: 0 for n in names}

    def instrument(vn: ValidatorNode) -> None:
        cs, name = vn.node.cs, vn.moniker
        handle_vote = vn.consensus._handle_vote_msg

        async def on_vote(envelope):
            v = envelope.message.vote
            h = cs.rs.height
            src = from_harness if envelope.from_peer == harness.node_id else from_peers
            src[name][h] = src[name].get(h, 0) + 1
            if envelope.from_peer == harness.node_id:
                taken[name] += 1
            key = (v.height, v.round, v.type, v.validator_index)
            if key in seen[name]:
                duplicates[name][h] = duplicates[name].get(h, 0) + 1
            seen[name].add(key)
            await handle_vote(envelope)

        vn.consensus._handle_vote_msg = on_vote
        send_peer_msg = cs.send_peer_msg

        def counted_send(msg, peer_id):
            ok = send_peer_msg(msg, peer_id)
            if not ok:
                dropped[name] += 1
            return ok

        cs.send_peer_msg = counted_send
        _count_envelopes(vn, envelopes[name])
        write_end = cs.wal.write_end_height
        handle_complete = cs._handle_complete_proposal
        handle_timeout = cs._handle_timeout
        decide = cs.decide_proposal

        def end_height(height: int) -> None:
            write_end(height)
            by_h[height].end_height_at[name] = time.perf_counter()

        async def complete() -> None:
            g = by_h.get(cs.rs.height)
            if g is not None and cs.rs.proposal_block is not None:
                g.complete_at.setdefault(name, time.perf_counter())
            await handle_complete()

        async def timeout(ti):
            rs = cs.rs
            acted = not (ti.height != rs.height or ti.round < rs.round
                         or (ti.round == rs.round and ti.step < rs.step))
            g = by_h.get(ti.height)
            if g is not None:
                g.timeouts[name].append((ti.round, ti.step, acted))
            await handle_timeout(ti)

        async def deciding(height: int, round_: int) -> None:
            g = by_h.get(height)
            if g is not None and not g.proposal_at:
                g.proposal_at = time.perf_counter()
            await decide(height, round_)

        cs.wal.write_end_height = end_height
        cs._handle_complete_proposal = complete
        cs._handle_timeout = timeout
        cs.decide_proposal = deciding

    def height_record(h: int) -> GossipHeight:
        g = GossipHeight(height=h, complete_at={}, end_height_at={}, rounds={},
                         timeouts={n: [] for n in names})
        by_h[h] = g
        return g

    for h in range(1, len(txs) + 1):
        height_record(h)
    for vn in nodes:
        instrument(vn)

    async def send_votes(votes: List[Vote]) -> None:
        """Each vote to node index mod 3, a burst a node at a time, the
        node held back while its backlog is a burst or more."""
        queues = {vn.moniker: [] for vn in nodes}
        for v in votes:
            queues[nodes[v.validator_index % len(nodes)].moniker].append(v)
        pos = {n: 0 for n in queues}
        while any(pos[n] < len(q) for n, q in queues.items()):
            progressed = False
            for vn in nodes:
                name, q = vn.moniker, queues[vn.moniker]
                backlog = sent[name] - taken[name] + vn.node.cs.peer_msg_queue.qsize()
                if pos[name] >= len(q) or backlog >= burst:
                    continue
                for v in q[pos[name]:pos[name] + burst]:
                    await harness.send(VOTE_CHANNEL, VoteMessage(v), vn.node_id)
                    sent[name] += 1
                pos[name] += burst
                progressed = True
            if not progressed:
                await asyncio.sleep(0.001)

    def all_at(h: int) -> bool:
        return all(vn.node.cs.rs.height >= h for vn in nodes)

    def alive() -> None:
        for vn in nodes:
            task = vn.node.cs._task
            if (task is not None and task.done()) or vn.evidence.failure() is not None:
                raise RuntimeError(f"{vn.moniker}'s receive loop ended")

    with pinned_clock(lambda: cur[0]):
        await harness.start()
        for vn in nodes:
            await vn.start()
        try:
            await _connect_mesh([*nodes, harness], timeout_s)
            # the pool's txs reach A and C by the mempool reactors
            t0 = time.perf_counter()
            b_pool = nodes[1].node.mempool
            await admit(b_pool, pool_txs, b_pool.cfg.tx_batch_size)
            for vn in (nodes[0], nodes[2]):
                await wait_for_pool(vn.node.mempool, len(pool_txs), timeout_s)
            tx_gossip_s = time.perf_counter() - t0
            last_commit = Commit(height=0, round=0, block_id=BlockID(), signatures=[])
            for h, block_txs_ in enumerate(txs, start=state.initial_height):
                g = by_h[h]
                cur[0] = h
                vals = state.validators.validators
                proposer = state.validators.get_proposer()
                if before is not None:
                    before(h)
                if proposer.address in real:
                    owner = real[proposer.address]
                    g.proposer = owner.moniker
                    cs = owner.node.cs
                    await _poll(lambda: cs.rs.height > h or (
                        cs.rs.height == h and cs.rs.proposal_block is not None
                        and cs.rs.proposal is not None), timeout_s, f"{owner.moniker} proposed no block at {h}", alive)
                    if cs.rs.height != h:
                        raise RuntimeError(f"{owner.moniker} left height {h} before the harness read its block")
                    block = cs.rs.proposal_block
                    block_id = cs.rs.proposal.block_id
                else:
                    g.proposer = "harness"
                    block, parts = state.make_block(h, list(block_txs_), last_commit, [], proposer.address)
                    block_id = BlockID(hash=block.hash(), part_set_header=parts.header())
                    proposal = Proposal(height=h, round=0, pol_round=-1, block_id=block_id,
                                        timestamp_ns=block.header.time_ns)
                    proposal.signature = _sign_all(
                        [by_addr[proposer.address]], [proposal.sign_bytes(chain_id)],
                        np.random.default_rng([seed, 13, h]),
                    )[0]
                    await _poll(lambda: any(vn.node.cs.rs.height == h for vn in nodes), timeout_s,
                                f"no node entered height {h}", alive)
                    first = next(vn for vn in nodes if vn.node.cs.rs.height == h)
                    g.sent_to = first.moniker
                    g.proposal_at = time.perf_counter()
                    await harness.send(DATA_CHANNEL, ProposalMessage(proposal), first.node_id)
                    for i in range(parts.total):
                        await harness.send(DATA_CHANNEL, BlockPartMessage(height=h, round=0, part=parts.get_part(i)),
                                           first.node_id)
                g.block = block
                # every node holds the block and has signed its prevote
                await _poll(lambda: all(vn.moniker in g.complete_at for vn in nodes), timeout_s,
                            f"the block of height {h} did not reach every node", alive)
                await _poll(lambda: all(
                    _vote_of(vn, h, PREVOTE_TYPE, vn.node.cs.rs.validators.get_by_address(a)[0]) is not None
                    for a, vn in real.items()), timeout_s, f"a node did not prevote at {h}", alive)
                rng = np.random.default_rng([seed, 13, h])
                order = [i for i in rng.permutation(len(vals)).tolist() if vals[i].address not in real]
                votes = {}
                for vote_type in (PREVOTE_TYPE, PRECOMMIT_TYPE):
                    votes[vote_type] = [
                        Vote(type=vote_type, height=h, round=0, block_id=block_id,
                             timestamp_ns=block.header.time_ns + 1 + int(rng.integers(0, 1_000_000_000)),
                             validator_address=vals[i].address, validator_index=i)
                        for i in order
                    ]
                signed = votes[PREVOTE_TYPE] + votes[PRECOMMIT_TYPE]
                sigs = _sign_all([by_addr[v.validator_address] for v in signed],
                                 [v.sign_bytes(chain_id) for v in signed],
                                 np.random.default_rng([seed, 14, h]))
                for v, sig in zip(signed, sigs):
                    v.signature = sig
                if before_votes is not None:
                    await before_votes(h)
                await send_votes(votes[PREVOTE_TYPE])
                await send_votes(votes[PRECOMMIT_TYPE])
                await _poll(lambda: all_at(h + 1), timeout_s, f"a node did not commit height {h}", alive)
                # the nodes' own precommits join the harness's in the commit
                by_index = {v.validator_index: v for v in votes[PRECOMMIT_TYPE]}
                for addr in real:
                    idx, _ = state.validators.get_by_address(addr)
                    await _poll(lambda: any(_vote_of(vn, h, PRECOMMIT_TYPE, idx) is not None for vn in nodes),
                                timeout_s, f"no node holds validator {idx}'s precommit at {h}", alive)
                    by_index[idx] = next(_vote_of(vn, h, PRECOMMIT_TYPE, idx) for vn in nodes
                                         if _vote_of(vn, h, PRECOMMIT_TYPE, idx) is not None)
                last_commit = Commit(
                    height=h, round=0, block_id=block_id,
                    signatures=[
                        CommitSig.for_block(by_index[i].signature, vals[i].address, by_index[i].timestamp_ns)
                        if by_index[i].block_id == block_id
                        else CommitSig.for_nil(by_index[i].signature, vals[i].address, by_index[i].timestamp_ns)
                        for i in range(len(vals))
                    ],
                )
                for vn in nodes:
                    seen_commit = vn.node.block_store.load_seen_commit()
                    g.rounds[vn.moniker] = seen_commit.round if seen_commit.height == h else -1
                # the state after h, as every node applied it (they agree,
                # and the run's caller checks that they do)
                state = nodes[0].node.state_store.load()
                if after is not None:
                    after(h)
                heights.append(g)
        finally:
            errors = []
            for vn in nodes:
                try:
                    await vn.stop()
                except Exception as e:  # raised below, once every node stopped
                    errors.append(e)
            await harness.stop()
            if errors:
                raise errors[0]
    return GossipRun(heights, tx_gossip_s, from_harness, from_peers, duplicates, dropped, envelopes)


def run_gossip_network(genesis_json: str, privs: Sequence, keys: Sequence, node_keys: Sequence[int],
                       txs: Sequence[list], pool_txs: Sequence[bytes], home: str, seed: int,
                       cfg: Optional[ConsensusConfig] = None, mempool_cfg: Optional[MempoolConfig] = None,
                       instrument=None, before=None, after=None,
                       monikers: Sequence[str] = ("node-a", "node-b", "node-c"),
                       timeout_s: float = 120.0, before_votes=None) -> GossipRun:
    """drive_gossip_heights on a fresh network: nodes A, B and C, each a
    consensus_node (cfg, a TxMempool of mempool_cfg; SqliteKV files in
    home/<moniker>) validating with keys[i], on a validator_node with
    the node key node_key(seed, node_keys[i]) on one MemoryNetwork, and
    the harness peer with node_key(seed, node_keys[3]). instrument(nodes,
    harness), if given, runs once they are built, before anything starts;
    before, after and before_votes are drive_gossip_heights'. The nodes'
    stores are closed at the end."""
    made: List[ValidatorNode] = []
    chain_id = GenesisDoc.from_json(genesis_json).chain_id

    async def go() -> GossipRun:
        net = MemoryNetwork()
        for i, (priv, name) in enumerate(zip(keys, monikers)):
            cn = consensus_node(genesis_json, priv, os.path.join(home, name), cfg,
                                mempool_cfg=mempool_cfg or MempoolConfig())
            addr = f"{name}.mem:{i + 1}"
            made.append(validator_node(cn, node_key(seed, node_keys[i]), MemoryTransport(net, addr),
                                       chain_id, listen_addr=addr, moniker=name))
        harness = HarnessPeer(node_key(seed, node_keys[3]), MemoryTransport(net, "harness.mem:9"),
                              chain_id, listen_addr="harness.mem:9")
        if instrument is not None:
            instrument(made, harness)
        return await drive_gossip_heights(made, harness, privs, genesis_json, txs, pool_txs, seed,
                                          before, after, timeout_s=timeout_s,
                                          before_votes=before_votes)

    try:
        return asyncio.run(go())
    finally:
        for vn in made:
            vn.node.close()


# -- catch-up: block sync and state sync --


def forged_commit(commit: Commit, index: int) -> Commit:
    """A copy of commit with the first byte of its signature at index
    flipped."""
    out = Commit.from_proto(commit.to_proto())
    sig = bytearray(out.signatures[index].signature)
    sig[0] ^= 0x01
    out.signatures[index].signature = bytes(sig)
    return out


def forged_block(block: Block, last_commit: Commit) -> Block:
    """A copy of block carrying last_commit (its header's
    last_commit_hash re-hashed), as a peer serving a forged block would
    send it."""
    out = Block.from_proto(block.to_proto())
    out.last_commit = last_commit
    out.header.last_commit_hash = last_commit.hash()
    return out


class ServingStore:
    """A serving peer's read view of a BlockStore: `blocks`, `commits` and
    `metas` ({height: Block, Commit or BlockMeta}) are served in place of
    the stored ones; every other read goes to the store. With `claim`, a dict shared by
    the views of several peers, a replaced block is served only by the
    view first asked for its height (claim[height] is that view's
    `name`); the others serve the stored block. So exactly one of them
    sends it, whichever the fresh node's pool picks first."""

    def __init__(self, store: BlockStore, blocks: Optional[dict] = None,
                 commits: Optional[dict] = None, claim: Optional[dict] = None,
                 name: str = "", metas: Optional[dict] = None) -> None:
        self._store = store
        self._blocks = dict(blocks or {})
        self._commits = dict(commits or {})
        self._metas = dict(metas or {})
        self._claim = claim
        self.name = name

    def __getattr__(self, name):
        return getattr(self._store, name)

    def load_block(self, height: int) -> Optional[Block]:
        if height in self._blocks:
            if self._claim is None or self._claim.setdefault(height, self.name) == self.name:
                return self._blocks[height]
        return self._store.load_block(height)

    def load_block_commit(self, height: int) -> Optional[Commit]:
        if height in self._commits:
            return self._commits[height]
        return self._store.load_block_commit(height)

    def load_block_meta(self, height: int) -> Optional[BlockMeta]:
        if height in self._metas:
            return self._metas[height]
        return self._store.load_block_meta(height)


class ServingClient(LocalClient):
    """A serving peer's connection to the app: it lists a snapshot only
    once the block store holds the two heights above it, whose light
    blocks a restore verifies (the JAX reactor rejects the snapshot
    otherwise, after a light-block timeout a provider)."""

    def __init__(self, app: KVStoreApplication, block_store) -> None:
        super().__init__(app)
        self._block_store = block_store

    async def list_snapshots(self, req):
        res = await super().list_snapshots(req)
        tip = self._block_store.height()
        return abci_types.ResponseListSnapshots(
            snapshots=tuple(s for s in res.snapshots if s.height + 2 <= tip)
        )


@dataclass
class CatchupNode:
    """A peer of the catch-up harness: its router and peer manager, the
    block sync and state sync reactors on the router's channels, and for
    a fresh node its stores and app (`exec_node`), event bus and a
    consensus reactor that waits for block sync."""

    node_id: str
    router: Router
    peer_manager: PeerManager
    blocksync: BlocksyncReactor
    statesync: StatesyncReactor
    exec_node: Optional[ExecNode] = None
    consensus: Optional[ConsensusReactor] = None
    event_bus: Optional[EventBus] = None

    async def start(self) -> None:
        if self.event_bus is not None:
            await self.event_bus.start()
        await self.router.start()
        if self.consensus is not None:
            await self.consensus.start()
        await self.blocksync.start()
        await self.statesync.start()

    async def stop(self) -> None:
        """Stop every part; raise the first error one of them ended on
        (block sync's pool routine, the step machine's loop)."""
        errors = []
        for svc in (self.statesync, self.blocksync, self.consensus, self.router):
            if svc is None:
                continue
            try:
                await svc.stop()
            except Exception as e:  # raised below, after the rest stopped
                errors.append(e)
        if self.event_bus is not None:
            await self.event_bus.stop()
        if errors:
            raise errors[0]


def _catchup_router(key, transport: Transport, chain_id: str, listen_addr: str) -> tuple:
    cfg = P2PConfig()
    node_id = node_id_from_pubkey(key.pub_key())
    info = NodeInfo(node_id=node_id, listen_addr=listen_addr, network=chain_id,
                    version="tendermint_tpu_torch")
    manager = PeerManager(node_id, peer_manager_options(cfg))
    router = Router(info, key, manager, transport, listen_addr=listen_addr,
                    options=router_options(cfg))
    return node_id, router, manager


def serving_node(node: ExecNode, key, transport: Transport, chain_id: str, listen_addr: str,
                 block_store=None) -> CatchupNode:
    """A peer serving node's chain: block sync in serve mode over
    block_store (node's, or a ServingStore of it), and state sync serving
    node's app snapshots (through a ServingClient), light blocks and
    params. Build it inside the running loop."""
    block_store = block_store if block_store is not None else node.block_store
    node_id, router, manager = _catchup_router(key, transport, chain_id, listen_addr)
    blocksync = BlocksyncReactor(
        node.state, node.executor, block_store, router.open_channel(blocksync_channel_descriptor()),
        manager.subscribe(), block_sync=False,
    )
    statesync = StatesyncReactor(
        chain_id, node.state, ServingClient(node.app, block_store), node.state_store, block_store,
        {cid: router.open_channel(d) for cid, d in statesync_channel_descriptors().items()},
        manager.subscribe(),
    )
    return CatchupNode(node_id, router, manager, blocksync, statesync)


def fresh_node(genesis_json: str, key, transport: Transport, listen_addr: str,
               block_sync: bool, ss_cfg: Optional[StateSyncConfig] = None,
               init_chain: bool = False) -> CatchupNode:
    """A node at the genesis (block_exec_node's stores on MemKV and app;
    no validator key): block sync in sync mode when block_sync, state
    sync with ss_cfg, and a consensus reactor (a ConsensusState of the
    ConsensusConfig defaults, no WAL) that block sync switches on. Build
    it inside the running loop. init_chain: its app has taken the
    genesis's InitChain (block_exec_node)."""
    node = block_exec_node(genesis_json, init_chain=init_chain)
    chain_id = node.state.chain_id
    node_id, router, manager = _catchup_router(key, transport, chain_id, listen_addr)
    bus = EventBus()
    cs = ConsensusState(ConsensusConfig(), node.state, node.executor, node.block_store,
                        event_bus=bus)
    consensus = ConsensusReactor(
        cs, {cid: router.open_channel(d) for cid, d in consensus_channel_descriptors().items()},
        manager.subscribe(), bus, wait_sync=True,
    )
    blocksync = BlocksyncReactor(
        node.state, node.executor, node.block_store,
        router.open_channel(blocksync_channel_descriptor()), manager.subscribe(),
        block_sync=block_sync, consensus_reactor=consensus, event_bus=bus,
    )
    statesync = StatesyncReactor(
        chain_id, node.state, LocalClient(node.app), node.state_store, node.block_store,
        {cid: router.open_channel(d) for cid, d in statesync_channel_descriptors().items()},
        manager.subscribe(), cfg=ss_cfg,
    )
    return CatchupNode(node_id, router, manager, blocksync, statesync, node, consensus, bus)


@dataclass
class CatchupRun:
    """What run_catchup saw (host clock, perf_counter seconds): the run
    from the fresh node's start to its switch to consensus; for a state
    sync, sync() (its discovery sleep apart), the backfill and the block
    sync after it; the heights block sync applied, the peers its pool
    banned (in order), and the fresh node (its stores and app in `fresh.exec_node`)
    and its final state; for a state sync, the stored state's bytes right
    after the bootstrap."""

    mode: str
    seconds: float
    block_sync_s: float
    applied: int
    banned: List[str]
    fresh: CatchupNode
    state: State
    discovery_s: float = 0.0
    restore_s: float = 0.0
    backfill_s: float = 0.0
    backfilled: int = 0
    restored_height: int = 0
    bootstrapped: bytes = b""
    server_ids: List[str] = dataclasses.field(default_factory=list)


async def _wait_synced(fresh: CatchupNode, timeout_s: float) -> None:
    deadline = time.monotonic() + timeout_s
    while not fresh.blocksync.synced:
        err = fresh.blocksync.failure()
        if err is not None:
            raise err
        if time.monotonic() > deadline:
            raise TimeoutError(f"block sync did not catch up (at {fresh.blocksync.pool.height})")
        await asyncio.sleep(0.01)
    # the switch runs at the end of the pool routine
    while fresh.consensus.wait_sync:
        await asyncio.sleep(0.01)


def run_catchup(genesis_json: str, node: ExecNode, views: Sequence, node_keys: Sequence[int],
                seed: int, mode: str, ss_cfg: Optional[StateSyncConfig] = None,
                timeout_s: float = 300.0, instrument=None, init_chain: bool = False) -> CatchupRun:
    """A fresh node catching up from len(views) peers serving node's
    chain, all on one MemoryNetwork: mode "block" block-syncs from the
    genesis; mode "state" state-syncs a snapshot (ss_cfg's trust root;
    fresh.statesync.sync()), backfills the headers below it and
    block-syncs from there. Either ends when block sync switches the
    node's consensus on. views[i] is peer i's block store (node's, or a
    ServingStore); the fresh node's key is node_key(seed, node_keys[0]),
    peer i's node_key(seed, node_keys[i + 1]). instrument(fresh, servers),
    if given, runs once they are built, before anything starts. Every
    peer is stopped at the end; an error a peer ended on is raised.
    init_chain: the fresh node's app has taken the genesis's InitChain,
    as `node`'s must have (serve_chain)."""
    chain_id = node.state.chain_id

    async def go() -> CatchupRun:
        net = MemoryNetwork()
        servers = [
            serving_node(node, node_key(seed, k), MemoryTransport(net, f"server{i}.mem:{i + 1}"),
                         chain_id, f"server{i}.mem:{i + 1}", block_store=view)
            for i, (k, view) in enumerate(zip(node_keys[1:], views))
        ]
        fresh = fresh_node(genesis_json, node_key(seed, node_keys[0]),
                           MemoryTransport(net, "fresh.mem:9"), "fresh.mem:9",
                           block_sync=mode == "block", ss_cfg=ss_cfg, init_chain=init_chain)
        # the bans in order: a banned peer the router then drops leaves
        # the pool's peer list
        banned: List[str] = []
        ban = fresh.blocksync.pool.ban_peer
        fresh.blocksync.pool.ban_peer = lambda peer_id: (banned.append(peer_id), ban(peer_id))[1]
        if instrument is not None:
            instrument(fresh, servers)
        out = {}
        try:
            for peer in servers:
                await peer.start()
            t0 = time.perf_counter()
            await fresh.start()
            await _connect_mesh(servers + [fresh], 30.0)
            if mode == "state":
                state = await fresh.statesync.sync()
                out["sync_s"] = time.perf_counter() - t0
                out["restored_height"] = state.last_block_height
                out["bootstrapped"] = fresh.exec_node.state_store.load().to_proto()
                t1 = time.perf_counter()
                out["backfilled"] = await fresh.statesync.backfill(state)
                out["backfill_s"] = time.perf_counter() - t1
                start_height = state.last_block_height
                t_bs = time.perf_counter()
                await fresh.blocksync.start_sync(state)
            else:
                start_height = fresh.exec_node.state.last_block_height
                t_bs = t0
            await _wait_synced(fresh, timeout_s)
            t_end = time.perf_counter()
        finally:
            errors = []
            for peer in [fresh] + servers:
                try:
                    await peer.stop()
                except Exception as e:  # raised below, once every peer stopped
                    errors.append(e)
            if errors:
                raise errors[0]
        state = fresh.blocksync.state
        discovery = ss_cfg.discovery_time if mode == "state" else 0.0
        return CatchupRun(
            mode=mode,
            seconds=t_end - t0,
            block_sync_s=t_end - t_bs,
            applied=state.last_block_height - start_height,
            banned=banned,
            fresh=fresh,
            state=state,
            discovery_s=discovery,
            restore_s=out.get("sync_s", 0.0) - discovery,
            backfill_s=out.get("backfill_s", 0.0),
            backfilled=out.get("backfilled", 0),
            restored_height=out.get("restored_height", 0),
            bootstrapped=out.get("bootstrapped", b""),
            server_ids=[p.node_id for p in servers],
        )

    return asyncio.run(go())


# -- the RPC harness --


@contextlib.asynccontextmanager
async def rpc_serving(envs: Sequence, max_body_bytes: int = 1_000_000):
    """RPCServers for the Environments, on 127.0.0.1:0, started in the
    running loop; yields their addresses. On exit each is stopped, which
    raises an error its routes kept (rpc/server.py)."""
    from .rpc.server import RPCServer

    servers = [RPCServer(env, "tcp://127.0.0.1:0", max_body_bytes) for env in envs]
    started = []
    try:
        for srv in servers:
            await srv.start()
            started.append(srv)
        yield [f"127.0.0.1:{srv.bound_port}" for srv in servers]
    finally:
        for srv in started:
            await srv.stop()


def stored_light_blocks(block_store, state_store, heights) -> Dict[int, LightBlock]:
    """The light blocks of `heights` as a node's stores hold them (the tip
    with its seen commit), as the RPC routes assemble them."""
    from .rpc.servingcache import ServingCache

    cache = ServingCache(block_store, state_store, capacity=0)
    out = {h: cache.light_block_at(h) for h in heights}
    missing = [h for h, lb in out.items() if lb is None]
    if missing:
        raise ValueError(f"no light block at {missing}")
    return out


def conflicting_light_block(block_store, state_store, height: int, privs: Sequence,
                            seed: int, app_hash: bytes = b"\x5a" * 32) -> tuple:
    """(BlockMeta, Commit) of a header that conflicts with the stored one
    at height: the same header with another app hash, signed by every
    validator of the height's set whose key is in privs (sign_commit)."""
    meta = block_store.load_block_meta(height)
    vals = state_store.load_validators(height)
    header = meta.header
    header.app_hash = app_hash
    block_id = BlockID(hash=header.hash(), part_set_header=meta.block_id.part_set_header)
    commit = sign_commit(header.chain_id, vals, block_id, height, header.time_ns, privs, seed)
    return BlockMeta(block_id=block_id, block_size=meta.block_size, header=header,
                     num_txs=meta.num_txs), commit


def http_light_client(primary: str, witnesses: Sequence[str], chain_id: str, trusted: LightBlock,
                      pruning_size: int = 1000, timeout_s: float = 60.0) -> Client:
    """A fresh sequential light client of RPC servers (HTTPProviders of
    their addresses), trusting `trusted`, with a trusting period longer
    than any chain here."""
    return Client(
        chain_id,
        TrustOptions(period_ns=10**18, height=trusted.height, hash=trusted.signed_header.hash()),
        HTTPProvider(primary, timeout=timeout_s),
        [HTTPProvider(a, timeout=timeout_s) for a in witnesses],
        LightStore(MemKV()),
        sequential=True,
        pruning_size=pruning_size,
    )


async def http_light_sync(client: Client, height: int, now_ns: int, affinity: int) -> float:
    """Seconds of `client` verifying `height` at now_ns, the group
    affinity pinned to `affinity` (and restored after); its providers'
    connections closed after."""
    saved = batch.group_affinity_state()
    batch.set_group_affinity(affinity)
    try:
        t0 = time.perf_counter()
        await client.verify_light_block_at_height(height, now_ns)
        return time.perf_counter() - t0
    finally:
        batch.restore_group_affinity(saved)
        for p in [client.primary, *client.witnesses]:
            if isinstance(p, HTTPProvider):
                await p.close()


@dataclass
class RPCLightSync:
    """One light sync over HTTP (rpc_light_sync): its seconds, the client
    (its store holds what it verified), and each bulk fetch's seconds
    and pages (the fetch, the JSON and the proto decode)."""

    seconds: float
    client: Client
    fetch_s: List[float]
    pages: int


def rpc_light_sync(block_store, state_store, chain_id: str, affinity: int,
                   witnesses: int = 1, pruning_size: int = 1000) -> RPCLightSync:
    """A fresh sequential light client of an RPC server over the node's
    stores (and `witnesses` more, honest), trusting height 1, syncing the
    tip one second after its time, with the group affinity pinned."""
    from .rpc.core import LIGHT_BLOCKS_PAGE_CAP, Environment

    tip = block_store.height()
    trusted = stored_light_blocks(block_store, state_store, [1])[1]
    now = block_store.load_block_meta(tip).header.time_ns + 1_000_000_000
    envs = [Environment(chain_id=chain_id, block_store=block_store, state_store=state_store)
            for _ in range(1 + witnesses)]
    fetch_s: List[float] = []
    pages = [0]

    async def run() -> RPCLightSync:
        async with rpc_serving(envs) as addrs:
            client = http_light_client(addrs[0], addrs[1:], chain_id, trusted, pruning_size)
            inner = client.primary.light_blocks

            async def timed(first: int, last: int) -> list:
                t0 = time.perf_counter()
                out = await inner(first, last)
                fetch_s.append(time.perf_counter() - t0)
                pages[0] += -(-(last - first + 1) // LIGHT_BLOCKS_PAGE_CAP)
                return out

            client.primary.light_blocks = timed
            seconds = await http_light_sync(client, tip, now, affinity)
        lb = client.store.light_block(tip)
        if lb is None or lb.signed_header.hash() != block_store.load_block_meta(tip).header.hash():
            raise AssertionError(f"the HTTP light sync did not end at {tip}")
        return RPCLightSync(seconds, client, fetch_s, pages[0])

    return asyncio.run(run())


def publish_stored_height(bus: EventBus, block_store, state_store, height: int) -> int:
    """Publish a stored height's NewBlock, NewBlockHeader and Tx events on
    `bus`, as BlockExecutor._fire_events does after applying it; returns
    the txs published."""
    meta = block_store.load_block_meta(height)
    block = block_store.load_block(height)
    responses = state_store.load_abci_responses(height)
    # the executor's own publishing code, on a stand-in holding the bus
    BlockExecutor._fire_events(_BusHolder(bus), block, meta.block_id, responses, [])
    return len(block.txs)


@dataclass
class _BusHolder:
    event_bus: EventBus


# -- the node-start harness --

# the memory address of the node run_node_start starts
NODE_MEM_ADDR = "node.mem:9"


def _server_addr(i: int) -> str:
    return f"server{i}.mem:{i + 1}"


def catchup_peers(node_keys: Sequence[int], seed: int) -> str:
    """The p2p.persistent_peers value naming run_node_start's serving
    peers: peer i's node ID (node_key(seed, node_keys[i])) at its memory
    address."""
    return ",".join(
        f"{node_id_from_pubkey(node_key(seed, k).pub_key())}@{_server_addr(i)}"
        for i, k in enumerate(node_keys)
    )


def init_home(home: str, genesis_json: str, settings: Dict[str, dict]) -> None:
    """A home as an operator makes it: the CLI's `init` (node key,
    FilePV, config.toml), then genesis_json as its genesis
    (GenesisDoc.save_as) and `settings` ({section: {key: value}}) written
    into its config.toml (write_config)."""
    import io

    from .cmd import main
    from .config import load_config, write_config

    with contextlib.redirect_stdout(io.StringIO()):
        if main(["init", "--home", home]) != 0:
            raise RuntimeError(f"init of {home} failed")
    genesis = GenesisDoc.from_json(genesis_json)
    genesis.save_as(os.path.join(home, "config", "genesis.json"))
    path = os.path.join(home, "config", "config.toml")
    cfg = load_config(path)
    cfg.base.chain_id = genesis.chain_id
    for section, values in settings.items():
        for key, value in values.items():
            if not hasattr(getattr(cfg, section), key):
                raise KeyError(f"no setting {section}.{key}")
            setattr(getattr(cfg, section), key, value)
    write_config(cfg, path)


def stage_crash(home: str, block: ChainBlock) -> None:
    """The "crash before apply" of a node at `home`: `block` and its seen
    commit saved into the home's block store, the state left one height
    below it (the block store's save and the state's are two writes)."""
    from .config import load_config
    from .store.kv import open_db

    cfg = load_config(os.path.join(home, "config", "config.toml"))
    cfg.base.home = home
    db = open_db("blockstore", cfg.base.db_backend, cfg.base.path(cfg.base.db_dir))
    try:
        BlockStore(db).save_block(block.block, block.parts, block.seen_commit)
    finally:
        db.close()


def _db_closed(db) -> bool:
    conn = getattr(db, "_conn", None)
    if conn is None:
        return True
    import sqlite3

    try:
        conn.execute("SELECT 1")
    except sqlite3.ProgrammingError:
        return True
    return False


@dataclass
class NodeStartRun:
    """What run_node_start saw (perf_counter seconds): make_node, the
    node's start (its ABCI handshake among it), the handshake alone,
    from the start's return to the switch to consensus, and the whole;
    the heights block sync
    applied, the blocks the handshake replayed into the app, block
    sync's final state, the app's hash, and after the stop whether the
    data lock was free again and every DB closed; and, when the node
    serves Prometheus, its scrape just before the stop."""

    make_s: float
    start_s: float
    handshake_s: float
    sync_s: float
    seconds: float
    applied: int
    replayed: int
    state: State
    app_hash: bytes
    lock_released: bool
    dbs_closed: int
    dbs: int
    node: object
    # with [instrumentation] prometheus: the scrape before the stop, the
    # block store's height and gpu_verifier.stats() around it
    scraped: Optional["Scrape"] = None
    store_height: int = 0
    stats_at_scrape: Optional[dict] = None


def run_node_start(home: str, served: ExecNode, node_keys: Sequence[int], seed: int,
                   device="cuda", app=None, timeout_s: float = 300.0, instrument=None,
                   wait_synced: bool = True) -> NodeStartRun:
    """make_node(load_config(home)) on a MemoryNetwork where
    len(node_keys) peers serve `served`'s chain (block sync and state
    sync, as run_catchup's servers; peer i's key node_key(seed,
    node_keys[i]), catchup_peers names them), its app `app` (None: the
    builtin kvstore app). The home's config gives the node its peers,
    p2p.laddr tcp://NODE_MEM_ADDR and its sync settings. Runs until its
    block sync has switched consensus on (or, without wait_synced, until
    start() returns), then stops the node and the peers; an error a part
    ended on is raised. instrument(node), if given, runs after
    make_node, before the start. A node that serves Prometheus and was
    waited for until synced is scraped (scrape) just before its stop;
    gpu_verifier.stats() is read on both sides of the scrape, which must
    not move it."""
    from .config import load_config
    from .node import node as node_mod
    from .node.node import acquire_pid_lock, make_node, release_pid_lock

    chain_id = served.state.chain_id
    handshake_s = []

    class TimedHandshaker(node_mod.Handshaker):
        async def handshake(self, app_client):
            t0 = time.perf_counter()
            try:
                return await super().handshake(app_client)
            finally:
                handshake_s.append(time.perf_counter() - t0)

    async def go() -> NodeStartRun:
        net = MemoryNetwork()
        servers = [
            serving_node(served, node_key(seed, k), MemoryTransport(net, _server_addr(i)),
                         chain_id, _server_addr(i))
            for i, k in enumerate(node_keys)
        ]
        cfg = load_config(os.path.join(home, "config", "config.toml"))
        cfg.base.home = home
        # the height the node starts block sync from: the stored state's,
        # or one above it where the block store is (the handshake applies
        # that block)
        from .store.kv import open_db

        dbs = [open_db(name, cfg.base.db_backend, cfg.base.path(cfg.base.db_dir))
               for name in ("state", "blockstore")]
        try:
            stored = StateStore(dbs[0]).load()
            h_state = stored.last_block_height if stored is not None else 0
            h_store = BlockStore(dbs[1]).height()
        finally:
            for db in dbs:
                db.close()
        start_height = h_state + (h_store == h_state + 1)
        try:
            for peer in servers:
                await peer.start()
            t0 = time.perf_counter()
            node = make_node(cfg, app=app, transport=MemoryTransport(net, NODE_MEM_ADDR), device=device)
            t1 = time.perf_counter()
            if instrument is not None:
                instrument(node)
            try:
                node_mod.Handshaker = TimedHandshaker
                try:
                    await node.start()
                finally:
                    node_mod.Handshaker = TimedHandshaker.__base__
                t2 = time.perf_counter()
                deadline = time.monotonic() + timeout_s
                while wait_synced and (not node.blocksync_reactor.synced
                                       or node.consensus_reactor.wait_sync):
                    err = node.failure()
                    if err is not None:
                        raise err
                    if time.monotonic() > deadline:
                        raise TimeoutError(
                            f"block sync did not catch up (at {node.blocksync_reactor.pool.height})"
                        )
                    await asyncio.sleep(0.01)
                t3 = time.perf_counter()
                state = node.blocksync_reactor.state
                app_hash = (await node.proxy.query.info(abci_types.RequestInfo())).last_block_app_hash
                scraped, store_height, stats_at = None, 0, None
                if wait_synced and node.metrics_port is not None:
                    from .crypto import gpu_verifier

                    stats_at = gpu_verifier.stats()
                    store_height = node.block_store.height()
                    scraped = await scrape(node.metrics_port)
                    if gpu_verifier.stats() != stats_at:
                        raise RuntimeError("the device plane verified during the scrape")
            finally:
                dbs = list(node._dbs)
                if node.is_running:
                    await node.stop()
            lock = os.path.join(cfg.base.path(cfg.base.db_dir), "LOCK")
            try:
                release_pid_lock(lock, acquire_pid_lock(lock))
                released = not node.data_locked
            except RuntimeError:
                released = False
        finally:
            errors = []
            for peer in servers:
                try:
                    await peer.stop()
                except Exception as e:  # raised below, once every peer stopped
                    errors.append(e)
            if errors:
                raise errors[0]
        return NodeStartRun(
            make_s=t1 - t0, start_s=t2 - t1, handshake_s=handshake_s[0], sync_s=t3 - t2, seconds=t3 - t0,
            applied=state.last_block_height - start_height, replayed=node.handshaker.n_blocks,
            state=state, app_hash=app_hash, lock_released=released,
            dbs_closed=sum(_db_closed(db) for db in dbs), dbs=len(dbs), node=node,
            scraped=scraped, store_height=store_height, stats_at_scrape=stats_at,
        )

    return asyncio.run(go())


@dataclass
class Scrape:
    """One scrape of a node's Prometheus server: the /metrics text, the
    /healthz JSON, and the /metrics request's ms and bytes."""

    text: str
    health: dict
    ms: float
    nbytes: int


async def _http_get(port: int, path: str, timeout_s: float = 10.0) -> bytes:
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    try:
        writer.write(f"GET {path} HTTP/1.1\r\nHost: 127.0.0.1\r\n\r\n".encode())
        await writer.drain()
        data = await asyncio.wait_for(reader.read(-1), timeout_s)
    finally:
        writer.close()
    head, _, body = data.partition(b"\r\n\r\n")
    if not head.startswith(b"HTTP/1.1 200 "):
        raise RuntimeError(f"GET {path}: {head.splitlines()[0] if head else b'no answer'!r}")
    return body


async def scrape(port: int) -> Scrape:
    """GET /metrics, then /healthz, from a node's Prometheus server on
    127.0.0.1:port."""
    t0 = time.perf_counter()
    body = await _http_get(port, "/metrics")
    ms = (time.perf_counter() - t0) * 1e3
    health = json.loads(await _http_get(port, "/healthz"))
    return Scrape(text=body.decode(), health=health, ms=ms, nbytes=len(body))


# the device family's series a node's scrape is held against
# gpu_verifier.stats(), by stats() key
GPU_SCRAPE_SERIES = {
    "batches": "tendermint_tpu_gpu_verify_batches_total",
    "sigs": "tendermint_tpu_gpu_verify_sigs_total",
    "pad_waste": "tendermint_tpu_gpu_pad_waste_slots_total",
    "faults": "tendermint_tpu_gpu_device_faults_total",
}


def gpu_series() -> Dict[str, float]:
    """This process's GPU_SCRAPE_SERIES now, from DEFAULT_REGISTRY."""
    from .libs.metrics import DEFAULT_REGISTRY

    return {key: DEFAULT_REGISTRY.get(name).value() for key, name in GPU_SCRAPE_SERIES.items()}


def check_node_scrape(run: NodeStartRun, stats_before: dict, series_before: dict, peers: int) -> dict:
    """The checks of a run_node_start node's scrape: the exposition
    parses with no duplicate series; over the run, each GPU_SCRAPE_SERIES
    counter moved as its gpu_verifier.stats() key did (stats_before and
    series_before read at the run's start), and no fault; the
    state_block_processing count is the blocks block sync applied;
    /healthz's height is the block store's; p2p_peers is `peers`.
    Returns what was compared; raises AssertionError on a difference."""
    if run.scraped is None:
        raise AssertionError("the node served no Prometheus scrape")
    series = parse_exposition(run.scraped.text)
    moved = {key: series[name] - series_before[key] for key, name in GPU_SCRAPE_SERIES.items()}
    want = {key: run.stats_at_scrape[key] - stats_before[key] for key in GPU_SCRAPE_SERIES}
    if moved != want or moved["faults"]:
        raise AssertionError(f"the scrape's gpu_* deltas {moved}, stats() moved {want}")
    blocks = series["tendermint_tpu_state_block_processing_seconds_count"]
    if blocks != run.applied:
        raise AssertionError(f"block_processing counted {blocks} blocks, block sync applied {run.applied}")
    if run.scraped.health["height"] != run.store_height:
        raise AssertionError(f"/healthz height {run.scraped.health['height']}, store {run.store_height}")
    if series["tendermint_tpu_p2p_peers"] != peers:
        raise AssertionError(f"p2p_peers {series['tendermint_tpu_p2p_peers']}, not {peers}")
    return {"gpu_deltas": moved, "blocks_processed": blocks, "healthz": run.scraped.health,
            "p2p_peers": peers, "series": len(series), "scrape_ms": run.scraped.ms,
            "scrape_bytes": run.scraped.nbytes}


def check_cli_scrape(nd: CliNode, min_height: int) -> dict:
    """The checks of a cli_localnet process's scrape at min_height: it
    parses with no duplicate series, consensus_height reached min_height,
    and the gpu_* family is there with no batch (a net under the gate)."""
    if nd.scraped is None:
        raise AssertionError(f"{nd.home}: no scrape")
    series = parse_exposition(nd.scraped.text)
    height = series["tendermint_tpu_consensus_height"]
    gpu = {key: series[name] for key, name in GPU_SCRAPE_SERIES.items()}
    if height < min_height or gpu["batches"] != 0 or gpu["faults"] != 0:
        raise AssertionError(f"{nd.home}: consensus_height {height}, gpu series {gpu}")
    return {"consensus_height": height, "gpu": gpu, "scrape_ms": nd.scraped.ms,
            "scrape_bytes": nd.scraped.nbytes, "series": len(series)}


def parse_exposition(text: str) -> Dict[str, float]:
    """A Prometheus text exposition (0.0.4) as {series: value}, a series
    named by its metric and its labels sorted (`name{k=v,...}`). Raises
    ValueError on a line it cannot parse and on a series met twice."""
    out: Dict[str, float] = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        metric, _, value = line.rpartition(" ")
        if not metric:
            raise ValueError(f"unparseable exposition line: {line!r}")
        if "{" in metric:
            name, _, rest = metric.partition("{")
            if not rest.endswith('"}'):
                raise ValueError(f"unparseable labels: {line!r}")
            pairs = []
            for pair in rest[:-2].split('",'):
                k, eq, v = pair.partition('="')
                if not eq:
                    raise ValueError(f"unparseable labels: {line!r}")
                pairs.append(f"{k}={v}")
            key = name + "{" + ",".join(sorted(pairs)) + "}"
        else:
            key = metric
        if key in out:
            raise ValueError(f"duplicate series {key}")
        out[key] = float(value)
    return out


def _free_port_base(n: int) -> int:
    """A port p with p..p+n-1 all free on 127.0.0.1 just now."""
    import socket

    for _ in range(100):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            base = s.getsockname()[1]
        if base + n > 65535:
            continue
        socks = []
        try:
            for p in range(base, base + n):
                s = socket.socket()
                socks.append(s)
                s.bind(("127.0.0.1", p))
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise RuntimeError(f"no {n} consecutive free ports")


@dataclass
class CliNode:
    """One `start` process of cli_localnet: its home, the height its
    status read last, its exit code, its log's lines, and with
    prometheus its metrics port and its scrape at min_height."""

    home: str
    rpc: str
    height: int
    rc: Optional[int]
    log: List[str]
    metrics_port: Optional[int] = None
    scraped: Optional[Scrape] = None


def cli_localnet(out_dir: str, n: int, min_height: int, gpu: bool, device: str = "cuda",
                 timeout_s: float = 120.0, settings: Optional[Dict[str, dict]] = None,
                 prometheus: bool = False) -> List[CliNode]:
    """`testnet` writes n validator homes under out_dir (127.0.0.1 ports
    taken free, [gpu] enable = gpu, and `settings` written into each
    config.toml), then n `python3 -m tendermint_tpu_torch.cmd start`
    processes run over TCP until the port's HTTP client's `status` reads
    a height of at least min_height on every one; each is then sent
    SIGTERM and waited for. With prometheus, each serves /metrics on a
    127.0.0.1 port of its own, taken free, and is scraped once when its
    status first reads min_height. Every process is gone when this
    returns."""
    import io
    import signal
    import subprocess
    import sys

    from .cmd import main
    from .config import load_config, write_config
    from .rpc.client import HTTPClient

    base = _free_port_base(3 * n)
    with contextlib.redirect_stdout(io.StringIO()):
        if main(["testnet", "-v", str(n), "-o", out_dir, "--starting-port", str(base)]) != 0:
            raise RuntimeError("testnet failed")
    homes = [os.path.join(out_dir, f"node{i}") for i in range(n)]
    for home in homes:
        path = os.path.join(home, "config", "config.toml")
        cfg = load_config(path)
        cfg.gpu.enable = gpu
        if prometheus:
            cfg.instrumentation.prometheus = True
            cfg.instrumentation.prometheus_listen_addr = f"127.0.0.1:{base + 2 * n + homes.index(home)}"
        for section, values in (settings or {}).items():
            for key, value in values.items():
                setattr(getattr(cfg, section), key, value)
        write_config(cfg, path)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs, logs = [], []
    nodes = [CliNode(home, f"127.0.0.1:{base + 2 * i + 1}", 0, None, [],
                     base + 2 * n + i if prometheus else None) for i, home in enumerate(homes)]

    async def poll() -> None:
        deadline = time.monotonic() + timeout_s
        clients = [HTTPClient(nd.rpc, timeout=2.0) for nd in nodes]
        try:
            while any(nd.height < min_height for nd in nodes):
                for nd, client, proc in zip(nodes, clients, procs):
                    if proc.poll() is not None:
                        raise RuntimeError(f"{nd.home}: start exited with {proc.returncode}")
                    try:
                        st = await client.call("status")
                        nd.height = int(st["sync_info"]["latest_block_height"])
                    except (OSError, asyncio.TimeoutError, RuntimeError, ValueError):
                        await client.close()
                    if nd.metrics_port is not None and nd.scraped is None and nd.height >= min_height:
                        nd.scraped = await scrape(nd.metrics_port)
                if time.monotonic() > deadline:
                    raise TimeoutError(f"heights {[nd.height for nd in nodes]} after {timeout_s} s")
                await asyncio.sleep(0.2)
        finally:
            for client in clients:
                await client.close()

    try:
        for nd in nodes:
            log = open(os.path.join(nd.home, "start.log"), "w")
            logs.append(log)
            cmd = [sys.executable, "-m", "tendermint_tpu_torch.cmd", "--home", nd.home, "start",
                   "--device", device]
            procs.append(subprocess.Popen(cmd, cwd=root, env=env, stdout=log, stderr=subprocess.STDOUT))
        asyncio.run(poll())
        for proc in procs:
            proc.send_signal(signal.SIGTERM)
        for nd, proc in zip(nodes, procs):
            nd.rc = proc.wait(timeout=60)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for log in logs:
            log.close()
    for nd in nodes:
        with open(os.path.join(nd.home, "start.log")) as f:
            nd.log = f.read().splitlines()
    return nodes
