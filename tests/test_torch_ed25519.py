"""The port's ed25519 verification against the JAX package and the oracle.

Each plain PyTorch function that stands beside a kernel (the scalar
preparation, dual_mult_sb_minus_ka for K1, _verify_tile for K2) gets the
same seeded inputs as its JAX namesake, passed across as numpy; the JAX
side runs as its own tests run it on the CPU (jitted XLA programs at
bucket 8, and verify_pallas in interpret mode with tile=8). Then the
port's Ed25519Verifier on device="cpu" is held against the host ZIP-215
oracle on the edge-case corpus (crypto/zip215_corpus.py: the classes of
tests/test_ops_ed25519.py). Tolerance: zero (integer arithmetic; bitmaps,
limbs and digits identical, points equal projectively).
"""

import hashlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tendermint_tpu.crypto import ed25519_math as jem
from tendermint_tpu.crypto.ed25519 import PrivKeyEd25519 as JaxPrivKey
from tendermint_tpu.ops import ed25519_kernel as JK
from tendermint_tpu.ops import field25519 as JF
from tendermint_tpu.ops.ed25519_pallas import verify_pallas
from tendermint_tpu_torch import interop
from tendermint_tpu_torch.crypto import ed25519_math as em
from tendermint_tpu_torch.crypto import zip215_corpus
from tendermint_tpu_torch.crypto.ed25519 import PrivKeyEd25519
from tendermint_tpu_torch.ops import ed25519_kernel as K
from tendermint_tpu_torch.ops import field25519 as F

BUCKET = 8  # the JAX tests' bucket: its compiled programs are reused


@pytest.fixture(scope="module")
def corpus():
    triples = zip215_corpus.corpus(16, seed=0)
    return triples, zip215_corpus.expected(triples)


def _rows(triples, pad=0):
    """Byte rows (pk, sig, digest) of well-sized triples, as numpy."""
    pks = [p for p, _m, _s in triples]
    sigs = [s for _p, _m, s in triples]
    digs = [hashlib.sha512(s[:32] + p + m).digest() for p, m, s in triples]
    return (
        K._join_cols(pks, 32, pad),
        K._join_cols(sigs, 64, pad),
        K._join_cols(digs, 64, pad),
    )


def _well_sized(triples):
    return [t for t in triples if len(t[0]) == 32 and len(t[2]) == 64]


def test_signing_is_the_jax_packages_byte_for_byte():
    for i in range(3):
        seed = hashlib.sha256(b"sign-%d" % i).digest()
        msg = b"message %d" % i
        ours, theirs = PrivKeyEd25519.from_seed(seed), JaxPrivKey.from_seed(seed)
        assert ours.pub_key().bytes() == theirs.pub_key().bytes()
        assert ours.sign(msg) == theirs.sign(msg)


def _digest_inputs():
    rng = np.random.default_rng(21)
    cols = [rng.integers(0, 256, 64) for _ in range(BUCKET - 4)]
    cols += [
        np.full(64, 255),
        np.zeros(64),
        np.array(list(em.L.to_bytes(32, "little")) + [0] * 32),
        np.array(list((em.L - 1).to_bytes(32, "little")) + [255] * 32),
    ]
    return np.stack(cols, axis=1).astype(np.int32)  # (64, BUCKET)


@pytest.mark.parametrize(
    "name", ["fe_from_bytes", "mod_l", "s_lt_l", "nibbles", "recode_signed"]
)
def test_scalar_prep_matches_jax(name):
    d = _digest_inputs()
    s = d[:32].copy()
    s[31] &= 0x7F
    digits = (d % 16).astype(np.int32)
    digits[-1] = np.minimum(digits[-1], 6)  # no dropped carry (see below)
    cases = {
        "fe_from_bytes": (K._fe_from_bytes_dev, JK._fe_from_bytes_dev, s),
        "mod_l": (K._mod_l_dev, JK._mod_l_dev, d),
        "s_lt_l": (K._s_lt_l_dev, JK._s_lt_l_dev, d[:32]),
        "nibbles": (K._nibbles_dev, JK._nibbles_dev, d[:32]),
        "recode_signed": (K._recode_signed, JK._recode_signed, digits),
    }
    ours, theirs, x = cases[name]
    got = ours(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.jit(theirs)(jnp.asarray(x)))
    assert np.array_equal(got, want)
    if name == "mod_l":
        for i in range(BUCKET):
            v = int.from_bytes(bytes(d[:, i].astype(np.uint8)), "little")
            assert int.from_bytes(bytes(got[:, i].astype(np.uint8)), "little") == v % em.L


def test_recode_signed_drops_the_top_carry_like_jax():
    """Digit 63 >= 8 carries out of the 64 digits; both sides drop it
    (only S >= L can produce it, and S < L rejects those)."""
    d = np.full((64, 2), 15, dtype=np.int32)
    d[:, 1] = 8
    got = K._recode_signed(torch.from_numpy(d)).numpy()
    assert np.array_equal(got, np.asarray(jax.jit(JK._recode_signed)(jnp.asarray(d))))


def test_dual_mult_matches_jax_projectively(corpus):
    """A (the corpus's valid keys) decompressed by the JAX package's host
    oracle into its limb layout, then carried across with
    interop.points_from_numpy; seeded digits; [S]B - [k]A equal as
    projective points (X1 Z2 = X2 Z1, Y1 Z2 = Y2 Z1)."""
    triples, _want = corpus
    pts = [jem.decompress(pk) for pk, _m, _s in triples[-BUCKET:]]
    A = np.stack(
        [np.stack([JF.to_limbs(c % jem.P) for c in coords], axis=1) for coords in zip(*pts)]
    ).astype(np.int32)  # (4, 20, BUCKET)
    rng = np.random.default_rng(22)
    ds = rng.integers(0, 16, (64, BUCKET), dtype=np.int32)
    dk = rng.integers(0, 16, (64, BUCKET), dtype=np.int32)
    want = np.array(
        jax.jit(JK.dual_mult_sb_minus_ka)(jnp.asarray(A), jnp.asarray(ds), jnp.asarray(dk))
    )
    got = K.dual_mult_sb_minus_ka(
        interop.points_from_numpy(A, device="cpu"),
        torch.from_numpy(ds),
        torch.from_numpy(dk),
    )
    w = torch.from_numpy(want)
    for c in (0, 1):
        assert bool(F.eq(F.mul(got[c], w[2]), F.mul(w[c], got[2])).all())


def test_verify_tile_matches_jax_program_and_oracle(corpus):
    """The whole corpus, bucket-8 slices through the JAX XLA program (the
    program Ed25519Verifier(bucket_sizes=[8]) runs), all at once through
    the port's plain _verify_tile."""
    triples, want = corpus
    ok_idx = [i for i, t in enumerate(triples) if len(t[0]) == 32 and len(t[2]) == 64]
    well = [triples[i] for i in ok_idx]
    pad = -len(well) % BUCKET
    pk, sig, dig = _rows(well, pad)
    got = K._verify_tile(torch.from_numpy(pk), torch.from_numpy(sig), torch.from_numpy(dig)).numpy()
    prog = JK._jit_verify_tile()
    jax_bits = np.concatenate(
        [
            np.asarray(prog(*(jnp.asarray(a[:, j : j + BUCKET]) for a in (pk, sig, dig))))
            for j in range(0, pk.shape[1], BUCKET)
        ]
    )
    assert np.array_equal(got, jax_bits)  # padding lanes included
    assert got[: len(well)].tolist() == [want[i] for i in ok_idx]


def test_verify_tile_matches_pallas_interpret(corpus):
    """16 lanes (two tiles of 8) of the corpus's hardest classes through
    verify_pallas(interpret=True, tile=8): S >= L, a non-point key, the
    x = 0 encoding, non-canonical y, small-order A and R. Sixteen uint8
    lanes at tile 8 is the program tests/test_ops_pallas.py compiles, so
    the compile is shared through the persistent cache; one tile would
    save little of the trace and lowering, which dominate."""
    triples, _want = corpus
    well = _well_sized(triples)
    pick = well[3:11] + well[12:20]
    pk, sig, dig = _rows(pick)
    got = K._verify_tile(torch.from_numpy(pk), torch.from_numpy(sig), torch.from_numpy(dig)).numpy()
    pal = np.asarray(
        verify_pallas(jnp.asarray(pk), jnp.asarray(sig), jnp.asarray(dig), interpret=True, tile=BUCKET)
    )
    assert np.array_equal(got, pal)
    assert got.tolist() == zip215_corpus.expected(pick)


@pytest.mark.parametrize("program", ["tile", "hybrid"])
def test_verifier_bitmap_matches_oracle(corpus, program):
    """Ed25519Verifier on device="cpu" (the plain versions): malformed
    sizes masked, zero padding lanes sliced away, several message
    lengths grouped for the digests."""
    triples, want = corpus
    v = K.Ed25519Verifier(bucket_sizes=[BUCKET, 128], device="cpu", program=program)
    pks, msgs, sigs = (list(x) for x in zip(*triples))
    assert len({len(m) for m in msgs}) >= 2
    assert v.verify(pks, msgs, sigs).tolist() == want
    assert v.verify([], [], []).tolist() == []


def test_verifier_pack_pads_to_the_bucket_with_zero_lanes(corpus):
    triples, _want = corpus
    v = K.Ed25519Verifier(bucket_sizes=[BUCKET, 16], device="cpu")
    pks, msgs, sigs = (list(x) for x in zip(*triples[-10:]))
    pks[0] = pks[0][:31]
    pk_b, sig_b, dig_b, size_ok = v.pack(pks, msgs, sigs)
    assert [t.shape for t in (pk_b, sig_b, dig_b)] == [(32, 16), (64, 16), (64, 16)]
    assert all(t.dtype == torch.uint8 and t.is_contiguous() for t in (pk_b, sig_b, dig_b))
    assert size_ok.tolist() == [False] + [True] * 9
    assert not pk_b[:, 10:].any() and not pk_b[:, 0].any()
    assert K.bucket_for(9, [8, 16]) == 16 and K.bucket_for(17, [8, 16]) == 17


def test_verifier_refuses_an_unknown_program():
    with pytest.raises(ValueError, match="program"):
        K.Ed25519Verifier(device="cpu", program="full")
