"""The port's native CPU plane against the JAX package's.

tendermint_tpu_torch/native builds its copy of the JAX package's C batch
equation with the host compiler; crypto/ed25519.py and crypto/sr25519.py
verify through it (singles at n = 1, batches by the random-linear-
combination equation and then a signature at a time). Held here against
the JAX package's CPU verifiers and the pure-Python oracles on the port's
ZIP-215 and sr25519 corpora: singles, and batches of 1, 2, 8 and 64 with
0, 1 and 3 bad entries at fixed indices. ed25519 keygen and signing
take their fixed-base multiplies from the same library: its encodings
are held against the pure-Python multiply, and keys and signatures
against the JAX package's. Tolerance: zero (identical bitmaps and
bytes). A compiler that fails makes the loader raise.
"""

import hashlib

import numpy as np
import pytest

from tendermint_tpu.crypto import ed25519 as JE
from tendermint_tpu.crypto import sr25519 as JS
from tendermint_tpu_torch import native
from tendermint_tpu_torch.crypto import ed25519 as PE
from tendermint_tpu_torch.crypto import ed25519_math as em
from tendermint_tpu_torch.crypto import ristretto as rst
from tendermint_tpu_torch.crypto import sr25519 as PS
from tendermint_tpu_torch.crypto import sr25519_corpus, zip215_corpus

# (batch size, bad entries): 0, 1 and 3 bad where the batch holds them
CASES = [(n, k) for n in (1, 2, 8, 64) for k in (0, 1, 3) if k <= n]


def _seeded_rng(seed: int):
    rng = np.random.default_rng(seed)
    return lambda n: rng.bytes(n)


def _well_formed(triples):
    return [t for t in triples if len(t[0]) == 32 and len(t[2]) == 64]


@pytest.fixture(scope="module")
def ed_corpus():
    triples = zip215_corpus.corpus(16, seed=1)
    return triples, zip215_corpus.expected(triples)


@pytest.fixture(scope="module")
def sr_corpus():
    triples = sr25519_corpus.corpus(0)
    return triples, sr25519_corpus.expected(triples)


@pytest.fixture(scope="module")
def ed_pools(ed_corpus):
    """(good, bad) well-formed ed25519 triples: 64 fresh valid
    signatures, and the corpus's invalid ones."""
    triples, want = ed_corpus
    privs = [PE.PrivKeyEd25519.from_seed(bytes([200 - i]) * 32) for i in range(8)]
    good = []
    for i in range(64):
        p = privs[i % 8]
        m = b"native-ed-%d" % i
        good.append((p.pub_key().bytes(), m, p.sign(m)))
    bad = [t for t, ok in zip(triples, want) if not ok]
    return good, _well_formed(bad)


@pytest.fixture(scope="module")
def sr_pools(sr_corpus):
    triples, want = sr_corpus
    privs = [PS.PrivKeySr25519(bytes([150 + i]) * 32) for i in range(8)]
    msgs = [b"native-sr-%d" % i for i in range(64)]
    sigs = PS.sign_batch([privs[i % 8] for i in range(64)], msgs, _seeded_rng(7))
    good = [(privs[i % 8].pub_key().bytes(), msgs[i], sigs[i]) for i in range(64)]
    bad = [t for t, ok in zip(triples, want) if not ok]
    return good, _well_formed(bad)


def _bad_at(n: int, k: int):
    return {0: [], 1: [n - 1], 3: [0, n // 2, n - 1]}[k]


def _batch(pools, n, k):
    good, bad = pools
    at = _bad_at(n, k)
    out = []
    for i in range(n):
        out.append(bad[(i * 7 + k) % len(bad)] if i in at else good[(i * 5 + n) % len(good)])
    return out, at


def test_ed25519_singles_match_the_jax_package_and_the_oracle(ed_corpus):
    """Every well-formed triple of the ZIP-215 corpus (small-order and
    mixed-order points, non-canonical y, S >= L...): the port's single
    verify (the C equation at n = 1, the oracle where the C cannot
    decode) gives the JAX package's answer and the oracle's."""
    triples, want = ed_corpus
    n = 0
    for (pk, m, s), w in zip(triples, want):
        if len(pk) != 32 or len(s) != 64:
            continue
        got = PE.PubKeyEd25519(pk).verify_signature(m, s)
        assert got == JE.PubKeyEd25519(pk).verify_signature(m, s) == w
        assert got == em.zip215_verify(pk, m, s)
        native_only = PE._native_verify_one_zip215(pk, m, s)
        assert native_only in (None, w)
        n += 1
    assert n > 100


def test_sr25519_singles_match_the_jax_package_and_the_oracle(sr_corpus):
    """Every well-formed triple of the sr25519 corpus (undecodable
    encodings, the marker bit, s = L, forged second encodings...): the
    port's host-only verify gives the JAX package's answer and the
    pure-Python oracle's."""
    triples, want = sr_corpus
    n = 0
    for (pk, m, s), w in zip(triples, want):
        if len(pk) != 32 or len(s) != 64:
            continue
        port = PS.PubKeySr25519(pk)
        got = port.verify_signature_cpu(m, s)
        assert got == JS.PubKeySr25519(pk).verify_signature_cpu(m, s) == w
        assert got == port.verify_signature(m, s)  # not installed: the CPU
        assert PS._native_verify_one(pk, m, s) in (None, w)
        n += 1
    assert n > 30


@pytest.mark.parametrize("n, k", CASES)
def test_ed25519_batches_match_the_jax_package(ed_pools, n, k):
    """A batch of n with k bad entries at fixed indices: the same bitmap
    from the port's CPU batch verifier, the JAX package's and the
    oracle, False exactly at the bad indices."""
    items, at = _batch(ed_pools, n, k)
    port, jax = PE.Ed25519BatchVerifier(), JE.Ed25519BatchVerifier()
    for pk, m, s in items:
        port.add(PE.PubKeyEd25519(pk), m, s)
        jax.add(JE.PubKeyEd25519(pk), m, s)
    got = port.verify()
    assert got == jax.verify()
    assert got[1] == [em.zip215_verify(*t) for t in items]
    assert got[1] == [i not in at for i in range(n)]
    assert got[0] == (not at)


@pytest.mark.parametrize("n, k", CASES)
def test_sr25519_batches_match_the_jax_package(sr_pools, n, k):
    items, at = _batch(sr_pools, n, k)
    port, jax = PS.Sr25519BatchVerifier(), JS.Sr25519BatchVerifier()
    for pk, m, s in items:
        port.add(PS.PubKeySr25519(pk), m, s)
        jax.add(JS.PubKeySr25519(pk), m, s)
    got = port.verify()
    assert got == jax.verify()
    assert got[1] == [PS.PubKeySr25519(pk).verify_signature_oracle(m, s) for pk, m, s in items]
    assert got[1] == [i not in at for i in range(n)]


def test_sr25519_native_keygen_and_signing_match_the_pure_python_path():
    """[k]B in C is the host oracle's encode(mul_base_ct(k)); a signature
    from a seeded witness is the one the pure-Python challenge gives, and
    the JAX package's keygen makes the same public key."""
    for i in range(6):
        seed = bytes([i + 3]) * 32
        priv = PS.PrivKeySr25519(seed)
        assert priv.pub_key().bytes() == rst.encode(rst.mul_base_ct(priv._key))
        assert priv.pub_key().bytes() == JS.PrivKeySr25519.from_seed(seed).pub_key().bytes()
        msg = b"sign-%d" % i
        sig = priv.sign(msg, rng=_seeded_rng(i))
        r, r_bytes = priv._witness(msg, _seeded_rng(i))
        k = PS._challenge(PS._signing_transcript(msg), priv._pub, r_bytes)
        assert sig == priv._finish(r, r_bytes, k)
        assert PS.PubKeySr25519(priv._pub).verify_signature_oracle(msg, sig)
        assert JS.PubKeySr25519(priv._pub).verify_signature_cpu(msg, sig)


# scalars of the fixed-base multiply: zero, one, L - 1, L, L + 1, the
# largest 32-byte value, each byte's extremes, and seeded ones
_EDGE_SCALARS = [0, 1, em.L - 1, em.L, em.L + 1, (1 << 256) - 1, 0x0F << 248, 0xF0]


def test_ed25519_native_basemul_matches_the_python_oracle():
    """tm_ed25519_basemul(s) is compress(mul_base_ct(s)) for any 256-bit
    s: the RFC 8032 encoding, bit for bit."""
    rng = np.random.default_rng(7)
    scalars = _EDGE_SCALARS + [
        int.from_bytes(rng.bytes(32), "little") for _ in range(24)
    ]
    for s in scalars:
        got = native.ed25519_basemul(s.to_bytes(32, "little"))
        assert got == em.compress(em.mul_base_ct(s)), hex(s)
    with pytest.raises(ValueError, match="32 bytes"):
        native.ed25519_basemul(b"\x01" * 31)


def test_ed25519_keygen_and_signing_match_the_jax_package():
    """Keys and signatures from the native multiply: the JAX package's
    (OpenSSL's) public keys and signatures on seeded keys and messages,
    and the pure-Python RFC 8032 route's."""
    rng = np.random.default_rng(11)
    for i in range(12):
        seed = rng.bytes(32)
        msg = rng.bytes(int(rng.integers(0, 300)))
        port, jax = PE.PrivKeyEd25519(seed), JE.PrivKeyEd25519.from_seed(seed)
        assert port.pub_key().bytes() == jax.pub_key().bytes()
        sig = port.sign(msg)
        assert sig == jax.sign(msg)
        a, prefix = PE._expand_seed(seed)
        r = int.from_bytes(hashlib.sha512(prefix + msg).digest(), "little") % em.L
        R = em.compress(em.mul_base_ct(r))
        k = em.sha512_mod_l(R, port.pub_key().bytes(), msg)
        assert sig == R + ((r + k * a) % em.L).to_bytes(32, "little")
        assert port.pub_key().bytes() == em.compress(em.mul_base_ct(a))


def test_a_failing_compiler_makes_the_loader_raise(monkeypatch, tmp_path):
    """No silent fallback: with a CC that fails, building the library
    raises, and nothing is left in the build directory."""
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setenv("CC", "false")
    with pytest.raises(RuntimeError, match="failed on ed25519_batch.c"):
        native.ed25519_batch_lib()
    assert native._LIB is None
    assert list((tmp_path / "native").iterdir()) == []
    with pytest.raises(RuntimeError, match="failed"):
        PE.PubKeyEd25519(bytes(32)).verify_signature(b"m", bytes(64))
