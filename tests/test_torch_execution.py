"""Block execution in the port, held against the JAX package.

Seeded kvstore chains (4 ed25519 validators; a mixed 4 ed25519 + 4
sr25519 set whose blocks add a validator, remove one and carry a
malformed update) are made and applied by the port
(workloads.build_block_chain), carried to the JAX package as genesis
JSON and block bytes, and replayed through both packages' BlockExecutor
on their kvstore apps. At every height the block each package's
State.make_block makes, the app hash, the stored state, the results
hash, the ABCI responses, the stored block and its meta must be equal
byte for byte. The rejections of tests/test_execution.py
(test_validate_block_rejects_tampering,
test_apply_block_rejects_bad_last_commit), and more fields out of step,
must raise the same exception type and message, and leave both stores
as they were. Tolerance: zero.

The JAX side runs as tests/test_execution.py runs it: its CPU
verifiers, with its verified-signature cache off and its metrics on a
private registry, so nothing is left in the process for a later test.
The port runs on its native CPU plane, and once through the device
plane's plain versions (gpu_verifier and merkle_kernel installed on the
CPU with small gates).
"""

import asyncio

import numpy as np
import pytest

from tendermint_tpu.abci.client import LocalClient as JaxLocalClient
from tendermint_tpu.abci.kvstore import KVStoreApplication as JaxKVStore
from tendermint_tpu.crypto import sigcache as jax_sigcache
from tendermint_tpu.crypto import sr25519 as _jax_sr  # noqa: F401  (registers the key type)
from tendermint_tpu.libs.metrics import Registry
from tendermint_tpu.mempool.nop import NopMempool as JaxNopMempool
from tendermint_tpu.state.execution import BlockExecutor as JaxBlockExecutor
from tendermint_tpu.state.execution import validate_block as jax_validate_block
from tendermint_tpu.state.metrics import StateMetrics
from tendermint_tpu.state.store import StateStore as JaxStateStore
from tendermint_tpu.state.types import state_from_genesis as jax_state_from_genesis
from tendermint_tpu.store.block_store import BlockStore as JaxBlockStore
from tendermint_tpu.store.kv import MemKV as JaxMemKV
from tendermint_tpu.types.block import Block as JaxBlock
from tendermint_tpu.types.block_id import BlockID as JaxBlockID
from tendermint_tpu.types.commit import Commit as JaxCommit
from tendermint_tpu.types.genesis import GenesisDoc as JaxGenesisDoc
from tendermint_tpu_torch import interop, workloads
from tendermint_tpu_torch.crypto import breaker, gpu_verifier
from tendermint_tpu_torch.ops import merkle_kernel
from tendermint_tpu_torch.state.execution import validate_block
from tendermint_tpu_torch.types.block_id import BlockID
from tendermint_tpu_torch.types.commit import Commit

CHAIN_ID = "torch-exec-chain"
SEED = 29
HEIGHTS = 5


def _outcome(fn):
    try:
        fn()
    except Exception as e:  # the outcome compared IS the exception
        return type(e).__name__, str(e)
    return "ok", ""


def _val_tx(priv, power: int) -> bytes:
    return b"val:%s!%d" % (priv.pub_key().bytes().hex().encode(), power)


def _chain(n_ed: int, n_sr: int, seed: int, updates: bool):
    """(genesis JSON, every signing key, blocks): heights 1..HEIGHTS of
    0-10 kvstore txs each; with `updates`, height 2 adds a validator
    (whose key then signs) and carries a malformed update, height 3
    removes a genesis validator and stores a bare key."""
    privs = workloads.seeded_keys(n_ed + n_sr, seed, n_sr)
    genesis = workloads.kv_genesis(CHAIN_ID, privs)
    rng = np.random.default_rng([seed, 1])
    txs = [workloads.kv_txs(seed, h, int(rng.integers(0, 11)), (34, 120)) for h in range(1, HEIGHTS + 1)]
    signers = list(privs)
    if updates:
        joiner = workloads.seeded_keys(1, seed + 1000)[0]
        leaver = next(p for p in privs if p.type() == "ed25519")
        signers.append(joiner)
        txs[1] += [_val_tx(joiner, 7), b"val:zz!1"]
        txs[2] += [_val_tx(leaver, 0), b"bare", txs[0][0] if txs[0] else b"k=v"]
    return genesis, signers, workloads.build_block_chain(genesis, signers, txs, seed)


@pytest.fixture(scope="module")
def chains():
    return {
        "ed25519": _chain(4, 0, SEED, False),
        "mixed": _chain(4, 4, SEED + 1, True),
    }


class _JaxNode:
    """A JAX-package node at the genesis, as tests/test_execution.py
    makes one, without an event bus and with a private metrics registry."""

    def __init__(self, genesis_json: str):
        self.state = jax_state_from_genesis(JaxGenesisDoc.from_json(genesis_json))
        self.state_store = JaxStateStore(JaxMemKV())
        self.state_store.save(self.state)
        self.block_store = JaxBlockStore(JaxMemKV())
        self.app = JaxKVStore()
        self.executor = JaxBlockExecutor(
            self.state_store, JaxLocalClient(self.app), JaxNopMempool(),
            block_store=self.block_store, metrics=StateMetrics(Registry()),
        )


def _record(node, h: int) -> dict:
    """What a height leaves behind on a node, as bytes."""
    meta = node.block_store.load_block_meta(h)
    return {
        "app_hash": node.app.app_hash,
        "state": node.state_store.load().to_proto(),
        "results_hash": node.state_store.load().last_results_hash,
        "abci_responses": node.state_store.load_abci_responses(h).to_proto(),
        "block": node.block_store.load_block(h).to_proto(),
        "meta": meta.to_proto(),
        "validators_next": node.state_store.load_validators(h + 1).to_proto(),
        "params": node.state_store.load_params(h + 1).to_proto(),
    }


def _replay_port(genesis, blocks, db_dir=None, upto=None):
    node = workloads.block_exec_node(genesis, db_dir)
    state, out = node.state, []
    for cb in blocks[:upto]:
        node.block_store.save_block(cb.block, cb.parts, cb.seen_commit)
        state = asyncio.run(node.executor.apply_block(state, cb.block_id, cb.block))
        out.append(_record(node, cb.block.header.height))
    return out, node, state


def _replay_jax(genesis, blocks, upto=None):
    """The JAX replay; before each height its State.make_block must make
    the block the port made, from the carried txs and LastCommit."""
    node = _JaxNode(genesis)
    state, out = node.state, []
    with jax_sigcache.disabled():
        for cb in blocks[:upto]:
            raw = cb.block.to_proto()
            carried = JaxBlock.from_proto(raw)
            made, parts = state.make_block(
                carried.header.height, carried.txs, carried.last_commit, [],
                carried.header.proposer_address,
            )
            assert made.to_proto() == raw
            bid = JaxBlockID.from_proto(cb.block_id.to_proto())
            assert parts.header().to_proto() == cb.parts.header().to_proto()
            node.block_store.save_block(made, parts, JaxCommit.from_proto(cb.seen_commit.to_proto()))
            state = asyncio.run(node.executor.apply_block(state, bid, made))
            out.append(_record(node, cb.block.header.height))
    return out, node, state


@pytest.mark.parametrize("name", ["ed25519", "mixed"])
def test_chain_applies_byte_equal_to_jax(chains, name, tmp_path):
    genesis, signers, blocks = chains[name]
    want, jnode, _ = _replay_jax(genesis, blocks)
    got, node, state = _replay_port(genesis, blocks, str(tmp_path))
    for h, (g, w) in enumerate(zip(got, want), start=1):
        for key in w:
            assert g[key] == w[key], f"height {h}: {key}"
    assert len(got) == HEIGHTS
    assert state.to_proto() == jnode.state_store.load().to_proto()
    assert node.app.state == jnode.app.state
    assert {k: v.power for k, v in node.app.validator_set.items()} == {
        k: v.power for k, v in jnode.app.validator_set.items()
    }
    if name == "mixed":
        # an update at height h takes effect at h + 2: the joiner signs
        # height 4 (block 5's LastCommit), the leaver is out of the set of 5
        sizes = [len(cb.block.last_commit.signatures) for cb in blocks[1:]]
        assert sizes == [8, 8, 8, 9]
        joiner = signers[-1]
        leaver = next(p for p in signers if p.type() == "ed25519")
        for vals in (state.last_validators, state.validators):
            assert vals.has_address(joiner.pub_key().address())
            assert not vals.has_address(leaver.pub_key().address())
        codes = [r.code for r in node.state_store.load_abci_responses(2).deliver_tx_objs]
        assert codes[-2:] == [0, 1]
    node.close()


def test_chain_through_the_device_plane_on_the_cpu_equals_jax(chains):
    """The mixed chain's first three heights with the port's device plane
    installed on the CPU (the kernels' plain versions): every LastCommit
    in one window a key type, every root of 4 leaves or more through X4's
    plain version; the same bytes as the JAX replay, no fault."""
    genesis, _signers, blocks = chains["mixed"]
    want, _jnode, _ = _replay_jax(genesis, blocks, upto=3)
    gpu_verifier.install(device="cpu", min_batch=2, gather_deadline_s=None)
    merkle_kernel.install(device="cpu", min_leaves=4)
    try:
        for route in gpu_verifier.ROUTES:
            t = breaker.breaker_for(route)._probe_thread
            if t is not None:
                t.join(10.0)
        before, roots0 = gpu_verifier.stats(), merkle_kernel.stats()
        got, _node, _state = _replay_port(genesis, blocks, upto=3)
        after, roots1 = gpu_verifier.stats(), merkle_kernel.stats()
    finally:
        merkle_kernel.uninstall()
        gpu_verifier.uninstall()
        breaker.reset_all()
    assert got == want
    # heights 2 and 3 verify a LastCommit of 4 + 4 signatures each
    for kt in ("ed25519", "sr25519"):
        assert after[f"batches_{kt}"] - before[f"batches_{kt}"] == 2
        assert after[f"sigs_{kt}"] - before[f"sigs_{kt}"] == 8
    assert after["faults"] == before["faults"]
    assert after["rerouted_sigs"] == before["rerouted_sigs"]
    assert sum(roots1.values()) > sum(roots0.values())


def test_create_proposal_block_equals_jax(chains):
    """A proposal from the empty mempool and evidence pool: the same
    block and parts as the JAX executor's, at a height with a LastCommit."""
    genesis, _signers, blocks = chains["ed25519"]
    (state, node), (jstate, jnode) = _states(genesis, blocks, 1)
    commit = blocks[1].block.last_commit
    proposer = state.validators.get_proposer().address
    pb, pparts = node.executor.create_proposal_block(2, state, commit, proposer)
    jb, jparts = jnode.executor.create_proposal_block(
        2, jstate, JaxCommit.from_proto(commit.to_proto()), proposer
    )
    assert pb.to_proto() == jb.to_proto()
    assert pparts.header().to_proto() == jparts.header().to_proto()
    assert pb.txs == [] and pb.last_commit.to_proto() == commit.to_proto()


# -- rejections --


def _other_block_id(block):
    """A block id in the block's own package, named nowhere in the chain."""
    bid = block.header.last_block_id
    return type(bid)(hash=b"\x07" * 32, part_set_header=type(bid.part_set_header)(1, b"\x08" * 32))


def _tamper_cases():
    """(name, edit of a block): every check of validate_block."""
    return [
        ("app_hash", lambda b: setattr(b.header, "app_hash", b"\xff" * 32)),
        ("chain_id", lambda b: setattr(b.header, "chain_id", "not-the-chain")),
        ("proposer", lambda b: setattr(b.header, "proposer_address", b"\x01" * 20)),
        ("height", lambda b: setattr(b.header, "height", b.header.height + 2)),
        ("version", lambda b: setattr(b.header, "version", type(b.header.version)(block=11, app=3))),
        ("last_block_id", lambda b: setattr(b.header, "last_block_id", _other_block_id(b))),
        ("consensus_hash", lambda b: setattr(b.header, "consensus_hash", b"\x02" * 32)),
        ("last_results_hash", lambda b: setattr(b.header, "last_results_hash", b"\x03" * 32)),
        ("validators_hash", lambda b: setattr(b.header, "validators_hash", b"\x04" * 32)),
        ("next_validators_hash", lambda b: setattr(b.header, "next_validators_hash", b"\x05" * 32)),
        ("time", lambda b: setattr(b.header, "time_ns", b.header.time_ns + 1)),
        ("data", lambda b: b.txs.append(b"late=1")),
        ("last_commit_hash", lambda b: setattr(b.header, "last_commit_hash", b"\x06" * 32)),
    ]


def _states(genesis, blocks, height):
    """Both packages' (state, node) after `height` heights."""
    _, node, state = _replay_port(genesis, blocks, upto=height)
    _, jnode, jstate = _replay_jax(genesis, blocks, upto=height)
    return (state, node), (jstate, jnode)


@pytest.mark.parametrize("height", [0, 2])
def test_validate_block_rejects_tampering_as_jax(chains, height):
    genesis, _signers, blocks = chains["mixed"]
    (state, _n), (jstate, _jn) = _states(genesis, blocks, height)
    raw = blocks[height].block.to_proto()
    outcomes = []
    for name, edit in _tamper_cases():
        pb, jb = interop.block_from_proto(raw), JaxBlock.from_proto(raw)
        edit(pb)
        edit(jb)
        with jax_sigcache.disabled():
            want = _outcome(lambda: jax_validate_block(jstate, jb))
        assert _outcome(lambda: validate_block(state, pb)) == want, name
        outcomes.append(want)
    assert all(o[0] != "ok" for o in outcomes)
    assert _outcome(lambda: validate_block(state, interop.block_from_proto(raw))) == ("ok", "")


def _forged_block(state, jstate, blocks, height, edit_commit):
    """Block height+1 made by both packages' make_block around a LastCommit
    edited alike (its header then names that commit's hash)."""
    cb = blocks[height]
    commit = Commit.from_proto(cb.block.last_commit.to_proto())
    edit_commit(commit)
    jcommit = JaxCommit.from_proto(commit.to_proto())
    proposer = cb.block.header.proposer_address
    pb, pparts = state.make_block(height + 1, list(cb.block.txs), commit, [], proposer)
    jb, _ = jstate.make_block(height + 1, list(cb.block.txs), jcommit, [], proposer)
    assert pb.to_proto() == jb.to_proto()
    bid = BlockID(hash=pb.hash(), part_set_header=pparts.header())
    return pb, bid, jb, JaxBlockID.from_proto(bid.to_proto())


def _flip(idx, byte=0):
    def edit(commit):
        sig = bytearray(commit.signatures[idx].signature)
        sig[byte] ^= 0x01
        commit.signatures[idx].signature = bytes(sig)

    return edit


def _impostor(commit):
    """Index 0 signed by a key outside the set (the JAX test's case)."""
    cs = commit.signatures[0]
    vote = commit.get_vote(0)
    cs.signature = workloads.seeded_keys(1, 999)[0].sign(vote.sign_bytes(CHAIN_ID))


def _drop_last(commit):
    commit.signatures.pop()


def _absent_most(commit):
    for cs in commit.signatures[:6]:
        cs.block_id_flag, cs.validator_address, cs.timestamp_ns, cs.signature = 1, b"", 0, b""


@pytest.mark.parametrize(
    "case", ["impostor", "flip_ed25519", "flip_sr25519", "wrong_size", "too_little_power", "initial_sigs"]
)
def test_apply_block_rejects_bad_last_commit_as_jax(chains, case):
    genesis, _signers, blocks = chains["mixed"]
    height = 0 if case == "initial_sigs" else 1
    (state, node), (jstate, jnode) = _states(genesis, blocks, height)
    vals = state.last_validators if height else state.validators
    kinds = [v.pub_key.type() for v in vals.validators]
    edit = {
        "impostor": _impostor,
        "flip_ed25519": _flip(kinds.index("ed25519"), 5),
        "flip_sr25519": _flip(kinds.index("sr25519"), 40),
        "wrong_size": _drop_last,
        "too_little_power": _absent_most,
    }.get(case)
    if case == "initial_sigs":
        pb, pparts = state.make_block(1, [], blocks[1].block.last_commit, [], blocks[0].block.header.proposer_address)
        jb = JaxBlock.from_proto(pb.to_proto())
        bid = BlockID(hash=pb.hash(), part_set_header=pparts.header())
        jbid = JaxBlockID.from_proto(bid.to_proto())
    else:
        pb, bid, jb, jbid = _forged_block(state, jstate, blocks, height, edit)
    stored = (node.state_store.load().to_proto(), jnode.state_store.load().to_proto())
    with jax_sigcache.disabled():
        want = _outcome(lambda: asyncio.run(jnode.executor.apply_block(jstate, jbid, jb)))
    got = _outcome(lambda: asyncio.run(node.executor.apply_block(state, bid, pb)))
    assert got == want
    assert got[0] != "ok"
    # nothing was executed or stored
    assert (node.state_store.load().to_proto(), jnode.state_store.load().to_proto()) == stored
    assert node.app.height == jnode.app.height == height
    assert node.state_store.load_abci_responses(height + 1) is None
    # the untouched block still applies on both
    cb = blocks[height]
    assert _outcome(lambda: asyncio.run(node.executor.apply_block(state, cb.block_id, cb.block))) == ("ok", "")
