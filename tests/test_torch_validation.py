"""The slice as a whole: a JAX-package Commit and ValidatorSet carried
across by their wire bytes (interop), verified by both packages.

The port runs with its device verifier installed on device="cpu" (the
batch goes through GpuEd25519BatchVerifier and Ed25519Verifier to the
kernels' plain versions); the JAX package runs as its own validation
tests run it. Sign-bytes must be identical at every index, and
verify_commit / verify_commit_light / verify_commit_light_trusting must
have the same outcome with byte-identical error messages. Vote
timestamps differ in varint length, so the port's digests come in more
than one message-length group. Tolerance: zero (exact bytes, exact
outcomes).
"""

import pytest

from tendermint_tpu.crypto.ed25519 import PrivKeyEd25519
from tendermint_tpu.types import (
    PRECOMMIT_TYPE,
    BlockID,
    Commit,
    CommitSig,
    Fraction,
    PartSetHeader,
    Validator,
    ValidatorSet,
    Vote,
)
from tendermint_tpu.types import validation as jax_validation
from tendermint_tpu_torch import interop
from tendermint_tpu_torch.crypto import gpu_verifier
from tendermint_tpu_torch.types import validation as port_validation
from tendermint_tpu_torch.types.block_id import BlockID as PortBlockID
from tendermint_tpu_torch.types.block_id import PartSetHeader as PortPSH

CHAIN_ID = "torch-port-chain"
HEIGHT = 7
N_VALS = 6
# one timestamp per validator, with nanos of 1-, 3- and 5-byte varints
NANOS = [5, 300_000, 900_000_000, 17, 2_000_000, 999_999_999]


def _jax_commit(signers, bad=None):
    privs = [PrivKeyEd25519.from_seed(bytes([40 + i]) * 32) for i in range(N_VALS)]
    vals = ValidatorSet(
        [Validator(pub_key=p.pub_key(), voting_power=10 + i) for i, p in enumerate(privs)]
    )
    by_addr = {p.pub_key().address(): p for p in privs}
    bid = BlockID(hash=b"\x05" * 32, part_set_header=PartSetHeader(total=2, hash=b"\x06" * 32))
    sigs = []
    for i, v in enumerate(vals.validators):
        if i not in signers:
            sigs.append(CommitSig.absent())
            continue
        ts = 1_700_000_000 * 10**9 + NANOS[i]
        vote = Vote(
            type=PRECOMMIT_TYPE, height=HEIGHT, round=1, block_id=bid,
            timestamp_ns=ts, validator_address=v.address, validator_index=i,
        )
        sig = by_addr[v.address].sign(vote.sign_bytes(CHAIN_ID))
        if i == bad:
            sig = sig[:20] + bytes([sig[20] ^ 0x08]) + sig[21:]
        sigs.append(CommitSig.for_block(sig, v.address, ts))
    return vals, bid, Commit(height=HEIGHT, round=1, block_id=bid, signatures=sigs)


def _carry(vals, bid, commit):
    return (
        interop.validator_set_from_proto(vals.to_proto()),
        PortBlockID(
            hash=bid.hash,
            part_set_header=PortPSH(
                total=bid.part_set_header.total, hash=bid.part_set_header.hash
            ),
        ),
        interop.commit_from_proto(commit.to_proto()),
    )


@pytest.fixture
def device_verifier():
    # min_batch 2 (the gate before it was measured on the card) keeps the
    # N_VALS-signature commits of these tests on the device path
    gpu_verifier.install(device="cpu", min_batch=2)
    try:
        yield
    finally:
        gpu_verifier.uninstall()


def _outcome(fn, *args):
    try:
        fn(*args)
    except Exception as e:  # the outcome compared IS the exception
        return type(e).__name__, str(e)
    return "ok", ""


def test_carried_state_is_identical():
    vals, bid, commit = _jax_commit(set(range(N_VALS)) - {4})
    pvals, pbid, pcommit = _carry(vals, bid, commit)
    assert pcommit.to_proto() == commit.to_proto()
    assert pvals.to_proto() == vals.to_proto()
    assert pvals.hash() == vals.hash()
    assert pcommit.hash() == commit.hash()
    assert pvals.get_proposer().address == vals.get_proposer().address
    assert pvals.total_voting_power() == vals.total_voting_power()
    lengths = set()
    for i, cs in enumerate(commit.signatures):
        if cs.is_absent():
            continue
        sb = commit.vote_sign_bytes(CHAIN_ID, i)
        assert pcommit.vote_sign_bytes(CHAIN_ID, i) == sb
        assert pcommit.get_vote(i).sign_bytes(CHAIN_ID) == sb
        lengths.add(len(sb))
    assert len(lengths) >= 2
    assert pcommit.sign_bytes_batch(CHAIN_ID) == commit.sign_bytes_batch(CHAIN_ID)


def test_validator_set_construction_matches_jax():
    """The port's own constructor (not from_proto): order, powers, total
    power and hash equal the JAX package's, and the set survives its own
    wire round-trip. Proposer priorities are not the port's to compute
    in this slice (types/validator.py), so they are not compared."""
    from tendermint_tpu_torch.crypto.ed25519 import PubKeyEd25519
    from tendermint_tpu_torch.types.validator import Validator as PortValidator
    from tendermint_tpu_torch.types.validator import ValidatorSet as PortValidatorSet

    privs = [PrivKeyEd25519.from_seed(bytes([90 + i]) * 32) for i in range(7)]
    powers = [5, 30, 5, 12, 1, 30, 7]
    vals = ValidatorSet(
        [Validator(pub_key=p.pub_key(), voting_power=w) for p, w in zip(privs, powers)]
    )
    pvals = PortValidatorSet(
        [
            PortValidator(pub_key=PubKeyEd25519(p.pub_key().bytes()), voting_power=w)
            for p, w in zip(privs, powers)
        ]
    )
    order = [(v.address, v.voting_power) for v in vals.validators]
    assert [(v.address, v.voting_power) for v in pvals.validators] == order
    assert pvals.hash() == vals.hash()
    assert pvals.total_voting_power() == vals.total_voting_power()
    for i, (addr, _w) in enumerate(order):
        assert pvals.get_by_address(addr)[0] == i
    again = interop.validator_set_from_proto(pvals.to_proto())
    assert again.to_proto() == pvals.to_proto() and again.hash() == vals.hash()
    with pytest.raises(ValueError, match="voting power 0"):
        PortValidatorSet([PortValidator(pub_key=PubKeyEd25519(bytes(32)), voting_power=0)])
    dup = PortValidator(pub_key=PubKeyEd25519(privs[0].pub_key().bytes()), voting_power=3)
    with pytest.raises(ValueError, match="duplicate entry"):
        PortValidatorSet([dup, dup])


CASES = {
    "valid": dict(signers=set(range(N_VALS))),
    "absent_one": dict(signers=set(range(N_VALS)) - {2}),
    "one_bad_signature": dict(signers=set(range(N_VALS)), bad=3),
    "insufficient_power": dict(signers={0, 1, 2}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_verify_outcomes_and_messages_match(case, device_verifier):
    vals, bid, commit = _jax_commit(**CASES[case])
    pvals, pbid, pcommit = _carry(vals, bid, commit)
    outcomes = {}
    for name in ("verify_commit", "verify_commit_light"):
        want = _outcome(getattr(jax_validation, name), CHAIN_ID, vals, bid, HEIGHT, commit)
        got = _outcome(getattr(port_validation, name), CHAIN_ID, pvals, pbid, HEIGHT, pcommit)
        assert got == want, name
        outcomes[name] = want
    want = _outcome(
        jax_validation.verify_commit_light_trusting, CHAIN_ID, vals, commit, Fraction(1, 3)
    )
    got = _outcome(
        port_validation.verify_commit_light_trusting,
        CHAIN_ID, pvals, pcommit, port_validation.Fraction(1, 3),
    )
    assert got == want
    full = outcomes["verify_commit"]
    if case == "one_bad_signature":
        assert full == ("InvalidCommitError", full[1])
        assert full[1].startswith("wrong signature (#3): ")
    elif case == "insufficient_power":
        assert full[0] == "NotEnoughVotingPowerError"
    else:
        assert full == ("ok", "")


def test_basic_check_messages_match():
    vals, bid, commit = _jax_commit(set(range(N_VALS)))
    pvals, pbid, pcommit = _carry(vals, bid, commit)
    other = BlockID(hash=b"\x09" * 32, part_set_header=PartSetHeader(total=1, hash=b"\x09" * 32))
    pother = _carry(vals, other, commit)[1]
    for args, pargs in (
        ((CHAIN_ID, vals, bid, HEIGHT + 1, commit), (CHAIN_ID, pvals, pbid, HEIGHT + 1, pcommit)),
        ((CHAIN_ID, vals, other, HEIGHT, commit), (CHAIN_ID, pvals, pother, HEIGHT, pcommit)),
        ((CHAIN_ID, None, bid, HEIGHT, commit), (CHAIN_ID, None, pbid, HEIGHT, pcommit)),
    ):
        want = _outcome(jax_validation.verify_commit, *args)
        assert want[0] == "InvalidCommitError"
        assert _outcome(port_validation.verify_commit, *pargs) == want


def test_device_verifier_streams_and_reports_in_add_order(device_verifier, monkeypatch):
    """STREAM_CHUNK windows dispatch from add(); the bitmap comes back in
    add order with the bad index False, and stats() counts integers."""
    from tendermint_tpu_torch.crypto.batch import create_batch_verifier

    monkeypatch.setattr(gpu_verifier.GpuEd25519BatchVerifier, "STREAM_CHUNK", 4)
    vals, bid, commit = _jax_commit(set(range(N_VALS)), bad=4)
    pvals, _pbid, pcommit = _carry(vals, bid, commit)
    sbs = pcommit.sign_bytes_batch(CHAIN_ID)
    before = gpu_verifier.stats()
    bv = create_batch_verifier(pvals.validators[0].pub_key, size_hint=N_VALS)
    assert isinstance(bv, gpu_verifier.GpuEd25519BatchVerifier)
    for i, v in enumerate(pvals.validators):
        bv.add(v.pub_key, sbs[i], pcommit.signatures[i].signature)
    assert len(bv._handles) == 1  # the first window went out from add()
    ok, bits = bv.verify()
    assert (ok, bits) == (False, [i != 4 for i in range(N_VALS)])
    assert bv.verify() == (False, [])
    after = gpu_verifier.stats()
    assert after["batches"] - before["batches"] == 2
    assert after["sigs"] - before["sigs"] == N_VALS
    with pytest.raises(ValueError, match="malformed signature size"):
        bv.add(pvals.validators[0].pub_key, b"m", b"\x00" * 63)
