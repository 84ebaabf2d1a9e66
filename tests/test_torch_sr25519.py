"""The port's sr25519 verification against the JAX package and the oracle.

Merlin, keys and signatures: the port's transcripts, challenges, keygen
and signatures against the JAX package's and the published vectors.
Then each plain PyTorch function that stands beside kernel X3
(ristretto_decode, _verify_tile_sr, and verify_hybrid_sr with kernel K1's
plain version) gets the same inputs as its JAX namesake, passed across as
numpy; the JAX side runs as tests/test_ops_sr25519.py runs it on the CPU,
at the same shapes, so the compiled programs are shared through the
persistent cache. Last the seam: Sr25519Verifier and the installed
gpu_verifier on device="cpu", and a mixed ed25519/sr25519 Commit carried
across by its wire bytes and verified by both packages. Tolerance: zero
everywhere (bytes, bitmaps, canonical limbs and outcomes identical).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tendermint_tpu.crypto import ristretto as jrst
from tendermint_tpu.crypto import sr25519 as JS
from tendermint_tpu.crypto.ed25519 import PrivKeyEd25519 as JaxPrivKeyEd
from tendermint_tpu.ops import ed25519_kernel as JK
from tendermint_tpu.ops import sr25519_kernel as JSK
from tendermint_tpu.types import (
    PRECOMMIT_TYPE,
    BlockID,
    Commit,
    CommitSig,
    PartSetHeader,
    Validator,
    ValidatorSet,
    Vote,
)
from tendermint_tpu.types import validation as jax_validation
from tendermint_tpu_torch import interop
from tendermint_tpu_torch.crypto import gpu_verifier, merlin
from tendermint_tpu_torch.crypto import ristretto as rst
from tendermint_tpu_torch.crypto import sr25519 as PS
from tendermint_tpu_torch.crypto.batch import create_batch_verifier
from tendermint_tpu_torch.crypto.ed25519 import PrivKeyEd25519
from tendermint_tpu_torch.ops import field25519 as F
from tendermint_tpu_torch.ops import sr25519_kernel as SK
from tendermint_tpu_torch.types import validation as port_validation
from tendermint_tpu_torch.types.block_id import BlockID as PortBlockID
from tendermint_tpu_torch.types.block_id import PartSetHeader as PortPSH

BUCKET = 8  # the JAX tests' bucket: its compiled program is reused


def _seeded_rng(seed: int):
    """A seeded stand-in for os.urandom, for reproducible signatures."""
    rng = np.random.default_rng(seed)
    return lambda n: rng.bytes(n)


# -- merlin, keys, signatures --


def test_merlin_published_vector():
    """merlin's transcript test vector (tests/test_sr25519.py:33)."""
    t = merlin.Transcript(b"test protocol")
    t.append_message(b"some label", b"some data")
    assert t.challenge_bytes(b"challenge", 32).hex() == (
        "d5a21972d0d5fe320c0d263fac7fffb8145aa640af6e9bca177c03c7efcf0615"
    )


def test_keccak_f_matches_the_per_row_oracle():
    """The numpy permutation over a group equals the pure-Python one on
    every row: seeded states, the all-zero state and the all-ones one."""
    rng = np.random.default_rng(9)
    states = rng.integers(0, 256, (6, 200), dtype=np.uint8)
    states[4] = 0
    states[5] = 255
    got = merlin.keccak_f(states)
    for i in range(states.shape[0]):
        row = bytearray(states[i].tobytes())
        merlin._keccak_f_py(row)
        assert got[i].tobytes() == bytes(row), i


def test_challenge_batch_matches_jax():
    """The lengths of tests/test_ops_sr25519.py:116-134 (empty, one
    byte, and either side of the 166-byte rate): the batched
    challenges equal the JAX package's and the port's own scalar
    transcripts'."""
    rng = np.random.default_rng(3)
    pks = [bytes(rng.integers(0, 256, 32, dtype=np.uint8)) for _ in range(40)]
    rs = [bytes(rng.integers(0, 256, 32, dtype=np.uint8)) for _ in range(40)]
    msgs = [b"m" * (0, 1, 100, 166, 167, 400)[i % 6] for i in range(40)]
    got = PS.challenge_batch(pks, msgs, rs)
    assert got == JS.challenge_batch(pks, msgs, rs)
    assert got == [
        PS._challenge(PS._signing_transcript(m), pk, r)
        for pk, m, r in zip(pks, msgs, rs)
    ]


def test_ristretto_rfc9496_generator_multiples():
    """RFC 9496's encodings of 0..4 B (tests/test_sr25519.py:44), and
    decoding rejects an odd and an over-p encoding."""
    vectors = [
        "0000000000000000000000000000000000000000000000000000000000000000",
        "e2f2ae0a6abc4e71a884a961c500515f58e30b6aa582dd8db6a65945e08d2d76",
        "6a493210f7499cd17fecb510ae0cea23a110e8d5b901f8acadd3095c73a3b919",
        "94741f5d5d52755ece4f23f044ee27d5d1ea1e2bd196b462166b16152a9d0259",
        "da80862773358b466ffadfe0b3293ab3d9fd53c5ea6c955358f568322daf6a57",
    ]
    for k, want in enumerate(vectors):
        enc = rst.encode(rst.mul_base(k))
        assert enc.hex() == want
        assert rst.eq(rst.decode(enc), rst.mul_base(k))
    assert rst.decode(b"\x01" + b"\x00" * 31) is None
    assert rst.decode(b"\xff" * 32) is None


def test_keygen_is_the_jax_packages_byte_for_byte():
    for i in range(3):
        mini = bytes([70 + i]) * 32
        ours, theirs = PS.PrivKeySr25519(mini), JS.PrivKeySr25519(mini)
        assert ours.pub_key().bytes() == theirs.pub_key().bytes()
        assert ours.pub_key().address() == theirs.pub_key().address()


def test_signatures_cross_between_packages():
    """Witnesses are random, so signatures differ; each package accepts
    the other's, and rejects them on another message. sign_batch gives
    sign's signatures for the same random bytes."""
    msgs = [b"cross %d" % i for i in range(3)]
    ours = [PS.PrivKeySr25519(bytes([80 + i]) * 32) for i in range(3)]
    theirs = [JS.PrivKeySr25519(bytes([80 + i]) * 32) for i in range(3)]
    for p, t, m in zip(ours, theirs, msgs):
        pk = p.pub_key().bytes()
        s_ours, s_theirs = p.sign(m), t.sign(m)
        assert s_ours[63] & 0x80 and s_theirs[63] & 0x80
        assert JS.PubKeySr25519(pk).verify_signature_cpu(m, s_ours)
        assert PS.PubKeySr25519(pk).verify_signature(m, s_theirs)
        assert not JS.PubKeySr25519(pk).verify_signature_cpu(m + b"!", s_ours)
        assert not PS.PubKeySr25519(pk).verify_signature(m + b"!", s_theirs)
    one_by_one = [p.sign(m, _seeded_rng(5)) for p, m in zip(ours, msgs)]
    batched = [PS.sign_batch([p], [m], _seeded_rng(5))[0] for p, m in zip(ours, msgs)]
    assert batched == one_by_one
    assert PS.sign_batch(ours, msgs, _seeded_rng(6)) == PS.sign_batch(
        ours, msgs, _seeded_rng(6)
    )


# -- the plain versions against the JAX programs --


def _cols(items, width, pad=0):
    return JK._join_cols(items, width, pad)


def test_ristretto_decode_matches_jax():
    """The 64-row random corpus of tests/test_ops_sr25519.py:64 (a
    quarter valid points): ok bits and the canonical limbs of all four
    coordinates equal ristretto_decode_dev's, and ok equals the host
    oracle's."""
    rng = np.random.default_rng(7)
    encs = [bytes(rng.integers(0, 256, 32, dtype=np.uint8)) for _ in range(64)]
    for j in range(0, 64, 4):
        encs[j] = jrst.encode(jrst.mul_base(int(rng.integers(1, 2**62))))
    rows = _cols(encs, 32).astype(np.int32)
    want_pt, want_ok = jax.jit(JSK.ristretto_decode_dev)(jnp.asarray(rows))
    want_pt, want_ok = np.asarray(want_pt), np.asarray(want_ok)
    pt, ok = SK.ristretto_decode(torch.from_numpy(rows))
    assert ok.tolist() == want_ok.tolist()
    assert ok.tolist() == [rst.decode(e) is not None for e in encs]
    assert int(ok.sum()) >= 16
    canon = F.canonical(pt).numpy()
    for c in range(4):
        for i in range(len(encs)):
            v = sum(int(x) << (13 * k) for k, x in enumerate(want_pt[c, :, i]))
            assert canon[c, :, i].tolist() == F.to_limbs(v).tolist(), (c, i)


def _corruption_corpus():
    """tests/test_ops_sr25519.py:87's eight rows: valid, marker off,
    s = L, tampered message, undecodable pk, undecodable R, a malformed
    size, valid. Keys and signatures from the JAX package."""
    privs = [JS.PrivKeySr25519.from_seed(bytes([i + 1]) * 32) for i in range(8)]
    msgs = [b"vote-%d" % i for i in range(8)]
    sigs = [p.sign(m) for p, m in zip(privs, msgs)]
    pks = [p.pub_key().bytes() for p in privs]
    sigs[1] = sigs[1][:63] + bytes([sigs[1][63] & 0x7F])
    l_bytes = bytearray(int(jrst.L).to_bytes(32, "little"))
    l_bytes[31] |= 0x80
    sigs[2] = sigs[2][:32] + bytes(l_bytes)
    msgs[3] = b"tampered"
    pks[4] = (1).to_bytes(32, "little")
    sigs[5] = (1).to_bytes(32, "little") + sigs[5][32:]
    sigs[6] = b"short"
    return pks, msgs, sigs


@pytest.fixture(scope="module")
def corruption_corpus():
    """Signed once for the module; tests copy before they change it."""
    return _corruption_corpus()


def test_verify_tile_sr_plain_and_hybrid_match_jax_and_oracle(
    corruption_corpus,
):
    """The corruption corpus at bucket 8, rows packed as the JAX
    Sr25519Verifier packs them (a malformed size as zero rows): the
    plain _verify_tile_sr and verify_hybrid_sr (K1's plain version on
    the CPU) equal _jit_verify_tile_sr()'s bitmap on every lane, and,
    masked by size, the host oracle's."""
    pks, msgs, sigs = corruption_corpus
    size_ok = [len(p) == 32 and len(s) == 64 for p, s in zip(pks, sigs)]
    pks = [p if ok else bytes(32) for p, ok in zip(pks, size_ok)]
    sigs = [s if ok else bytes(64) for s, ok in zip(sigs, size_ok)]
    ks = [
        k.to_bytes(32, "little")
        for k in JS.challenge_batch(pks, msgs, [s[:32] for s in sigs])
    ]
    rows = [_cols(pks, 32), _cols(sigs, 64), _cols(ks, 32)]
    assert [r.shape[1] for r in rows] == [BUCKET] * 3
    want = np.asarray(JSK._jit_verify_tile_sr()(*(jnp.asarray(r) for r in rows)))
    tensors = [torch.from_numpy(np.ascontiguousarray(r)) for r in rows]
    assert SK._verify_tile_sr(*tensors).tolist() == want.tolist()
    assert SK.verify_hybrid_sr(*tensors).tolist() == want.tolist()
    oracle = [
        ok and PS.PubKeySr25519(p).verify_signature(m, s)
        for p, m, s, ok in zip(pks, msgs, sigs, size_ok)
    ]
    assert (want & np.array(size_ok)).tolist() == oracle
    assert oracle == [True, False, False, False, False, False, False, True]


# -- the verifier and the seam --


@pytest.mark.parametrize("program", ["tile", "hybrid"])
def test_verifier_pads_without_leaking_and_masks_malformed_sizes(
    program, corruption_corpus
):
    """Three valid signatures in bucket 8 (five zero lanes) and a fourth
    of malformed size: the bitmap has one entry per triple, the padding
    lanes are gone, the malformed one is False and nothing raises."""
    pks, msgs, sigs = corruption_corpus
    pks, msgs, sigs = [pks[0], pks[7], pks[0], pks[7]], [msgs[0], msgs[7], msgs[0], msgs[7]], [
        sigs[0], sigs[7], sigs[0], sigs[7][:40]
    ]
    v = SK.Sr25519Verifier(bucket_sizes=[BUCKET, 32], device="cpu", program=program)
    w = v.upload(pks, msgs, sigs)
    assert [t.shape for t in (w.pk_b, w.sig_b, w.k_b)] == [(32, 8), (64, 8), (32, 8)]
    assert not w.pk_b[:, 3:].any() and not w.sig_b[:, 3:].any()
    got = v.verify(pks, msgs, sigs)
    assert got.shape == (4,) and got.tolist() == [True, True, True, False]
    assert v.verify([], [], []).tolist() == []


def test_verifier_refuses_an_unknown_program():
    with pytest.raises(ValueError, match="program"):
        SK.Sr25519Verifier(device="cpu", program="full")


@pytest.fixture
def device_verifier():
    # gates of 1 send even one signature to the device path, which the
    # test below exercises (the default gates keep small batches on the
    # native CPU plane: tests/test_torch_faults.py)
    gpu_verifier.install(device="cpu", min_batch=1)
    try:
        yield
    finally:
        gpu_verifier.uninstall()


def test_install_routes_sr25519_and_streams_in_add_order(device_verifier, monkeypatch):
    """With a gate of 1 sr25519's device factory serves even one
    signature; STREAM_CHUNK
    windows dispatch from add(); the bitmap comes back in add order with
    the bad index False; stats() counts per key type, in integers."""
    monkeypatch.setattr(gpu_verifier.GpuSr25519BatchVerifier, "STREAM_CHUNK", 4)
    privs = [PS.PrivKeySr25519(bytes([100 + i]) * 32) for i in range(6)]
    msgs = [b"m%d" % i for i in range(6)]
    sigs = PS.sign_batch(privs, msgs, _seeded_rng(1))
    sigs[2] = sigs[2][:8] + bytes([sigs[2][8] ^ 1]) + sigs[2][9:]
    one = create_batch_verifier(privs[0].pub_key(), size_hint=1)
    assert isinstance(one, gpu_verifier.GpuSr25519BatchVerifier)
    before = gpu_verifier.stats()
    bv = create_batch_verifier(privs[0].pub_key(), size_hint=6)
    for p, m, s in zip(privs, msgs, sigs):
        bv.add(p.pub_key(), m, s)
    assert len(bv._handles) == 1  # the first window went out from add()
    assert bv.verify() == (False, [i != 2 for i in range(6)])
    assert bv.verify() == (False, [])
    after = gpu_verifier.stats()
    assert all(isinstance(v, int) for v in after.values())
    assert after["batches_sr25519"] - before["batches_sr25519"] == 2
    assert after["sigs_sr25519"] - before["sigs_sr25519"] == 6
    assert after["batches_ed25519"] == before["batches_ed25519"]
    assert after["sigs"] - before["sigs"] == 6
    with pytest.raises(TypeError, match="requires sr25519 keys"):
        bv.add(PrivKeyEd25519.from_seed(bytes(32)).pub_key(), b"m", sigs[0])
    with pytest.raises(ValueError, match="malformed signature size"):
        bv.add(privs[0].pub_key(), b"m", b"\x00" * 63)


CHAIN_ID = "mixed-port-chain"
HEIGHT = 5


def _mixed(n_ed: int, n_sr: int):
    """A JAX-package (ValidatorSet, BlockID, Commit) of n_ed ed25519 and
    n_sr sr25519 validators that all signed."""
    privs = [JaxPrivKeyEd.from_seed(bytes([10 + i]) * 32) for i in range(n_ed)]
    privs += [JS.PrivKeySr25519.from_seed(bytes([60 + i]) * 32) for i in range(n_sr)]
    vals = ValidatorSet([Validator(pub_key=p.pub_key(), voting_power=10) for p in privs])
    by_addr = {p.pub_key().address(): p for p in privs}
    bid = BlockID(hash=b"\x11" * 32, part_set_header=PartSetHeader(total=1, hash=b"\x22" * 32))
    sigs = []
    for i, v in enumerate(vals.validators):
        ts = 1_700_000_000 * 10**9 + 1000 * i
        vote = Vote(
            type=PRECOMMIT_TYPE, height=HEIGHT, round=0, block_id=bid,
            timestamp_ns=ts, validator_address=v.address, validator_index=i,
        )
        sig = by_addr[v.address].sign(vote.sign_bytes(CHAIN_ID))
        sigs.append(CommitSig.for_block(sig, v.address, ts))
    return vals, bid, Commit(height=HEIGHT, round=0, block_id=bid, signatures=sigs)


def _corrupted(commit, bad):
    """A copy of the commit with the signatures at the indices in `bad`
    corrupted."""
    sigs = []
    for i, cs in enumerate(commit.signatures):
        sig = cs.signature
        if i in bad:
            sig = sig[:40] + bytes([sig[40] ^ 4]) + sig[41:]
        sigs.append(CommitSig.for_block(sig, cs.validator_address, cs.timestamp_ns))
    return Commit(height=commit.height, round=commit.round, block_id=commit.block_id, signatures=sigs)


@pytest.fixture(scope="module")
def mixed_set():
    """Three ed25519 and three sr25519 validators, signed once for the
    module; tests corrupt copies of the commit."""
    return _mixed(3, 3)


def _carry(vals, bid, commit):
    return (
        interop.validator_set_from_proto(vals.to_proto()),
        PortBlockID(
            hash=bid.hash,
            part_set_header=PortPSH(total=bid.part_set_header.total, hash=bid.part_set_header.hash),
        ),
        interop.commit_from_proto(commit.to_proto()),
    )


def _outcome(fn, *args):
    try:
        fn(*args)
    except Exception as e:  # the outcome compared IS the exception
        return type(e).__name__, str(e)
    return "ok", ""


def test_mixed_set_round_trips_through_interop(mixed_set):
    vals, bid, commit = mixed_set
    pvals, _pbid, pcommit = _carry(vals, bid, commit)
    assert {v.pub_key.type() for v in pvals.validators} == {"ed25519", "sr25519"}
    assert pvals.to_proto() == vals.to_proto() and pvals.hash() == vals.hash()
    assert pcommit.to_proto() == commit.to_proto() and pcommit.hash() == commit.hash()
    assert pcommit.sign_bytes_batch(CHAIN_ID) == commit.sign_bytes_batch(CHAIN_ID)


@pytest.mark.parametrize("case", ["valid", "bad_sr_then_ed", "bad_ed_then_sr"])
def test_mixed_commit_outcomes_and_messages_match_jax(
    case, mixed_set, device_verifier
):
    """Three ed25519 and three sr25519 validators through the installed
    device verifiers (device="cpu": one batch per key type): the same
    outcome as the JAX package with the same message, byte for byte. With
    a bad signature in each group, the error names the lower index,
    whichever group holds it."""
    vals, bid, commit = mixed_set
    bad = ()
    if case != "valid":
        first, then = case[4:6], case[-2:]  # "sr" / "ed"
        kinds = [v.pub_key.type()[:2] for v in vals.validators]
        bad = next(
            (i, j)
            for i, ki in enumerate(kinds)
            for j, kj in enumerate(kinds)
            if i < j and (ki, kj) == (first, then)
        )
        commit = _corrupted(commit, bad)
    pvals, pbid, pcommit = _carry(vals, bid, commit)
    names = ("verify_commit", "verify_commit_light") if case == "valid" else ("verify_commit",)
    before = gpu_verifier.stats()
    for name in names:
        want = _outcome(getattr(jax_validation, name), CHAIN_ID, vals, bid, HEIGHT, commit)
        got = _outcome(getattr(port_validation, name), CHAIN_ID, pvals, pbid, HEIGHT, pcommit)
        assert got == want, name
    if case == "valid":
        assert want == ("ok", "")
    else:
        assert want[0] == "InvalidCommitError"
        assert want[1].startswith(f"wrong signature (#{min(bad)}): ")
    after = gpu_verifier.stats()
    assert after["batches_sr25519"] > before["batches_sr25519"]
    assert after["batches_ed25519"] > before["batches_ed25519"]
