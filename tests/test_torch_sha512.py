"""The port's plain SHA-512 (the plain version of kernel X1) against the
JAX package's sha512_fixed and hashlib.

Same contract on both sides: (L, N) uint8 rows, batch axis minor ->
(64, N) digests. Lengths straddle the 128-byte block boundaries (111/112
is the one/two-block edge). Tolerance: zero (digests byte-identical).
"""

import hashlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tendermint_tpu.ops.sha512_kernel import sha512_fixed as jax_sha512_fixed
from tendermint_tpu_torch.ops import sha512_kernel as S

# the lengths and width of tests/test_ops_ed25519.py's device SHA-512
# test, so the JAX side reuses its compiled programs
LENGTHS = (0, 1, 111, 112, 127, 128, 250)
WIDTH = 4


def _rows(length, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (length, WIDTH), dtype=np.uint8)


@pytest.mark.parametrize("length", LENGTHS)
def test_plain_sha512_matches_jax_and_hashlib(length):
    rows = _rows(length, 100 + length)
    got = S.sha512_fixed(torch.from_numpy(rows))  # CPU: the plain version
    assert got.dtype == torch.uint8 and tuple(got.shape) == (64, WIDTH)
    want = np.asarray(jax.jit(jax_sha512_fixed)(jnp.asarray(rows)))
    assert np.array_equal(got.numpy(), want)
    for i in range(WIDTH):
        assert got[:, i].numpy().tobytes() == hashlib.sha512(
            rows[:, i].tobytes()
        ).digest()


@pytest.mark.parametrize("length", [175, 176, 239, 303])
def test_plain_sha512_three_blocks_and_more_match_hashlib(length):
    rows = _rows(length, length)
    got = S.sha512_fixed_plain(torch.from_numpy(rows)).numpy()
    for i in range(WIDTH):
        assert got[:, i].tobytes() == hashlib.sha512(rows[:, i].tobytes()).digest()


def test_plain_sha512_takes_a_non_contiguous_view():
    rows = _rows(130, 7)
    wide = torch.from_numpy(np.repeat(rows, 2, axis=1))
    got = S.sha512_fixed(wide[:, ::2])
    assert np.array_equal(got.numpy(), S.sha512_fixed(torch.from_numpy(rows)).numpy())


# -- the ragged function: SHA-512(R || A || M) of every lane, in lane order


def _mixed_batch():
    """tests/test_ops_ed25519.py's mixed batch (_sign_set(6, b"x") with a
    corrupted signature, message and key): sign-bytes of 6 and 8 bytes,
    so the JAX verifier hashes two length groups at bucket 8, shapes its
    own tests compile."""
    from tendermint_tpu.crypto.ed25519 import PrivKeyEd25519

    keys = [
        PrivKeyEd25519.from_seed(hashlib.sha256(b"x" + bytes([i])).digest())
        for i in range(6)
    ]
    msgs = [b"msg-x" + bytes([i]) for i in range(6)]
    sigs = [k.sign(m) for k, m in zip(keys, msgs)]
    pks = [k.pub_key().bytes() for k in keys]
    s1 = int.from_bytes(sigs[1][32:], "little") ^ 1
    sigs[1] = sigs[1][:32] + s1.to_bytes(32, "little")
    msgs[3] = b"tampered"
    pks[5] = hashlib.sha256(b"not a point seed").digest()
    return pks, msgs, sigs


def test_ragged_plain_matches_jax_digest_rows():
    """The port's one ragged function against the JAX verifier's
    per-length-group digests, on the lanes the batch fills."""
    from tendermint_tpu.ops.ed25519_kernel import Ed25519Verifier as JaxVerifier
    from tendermint_tpu_torch.ops.ed25519_kernel import Ed25519Verifier

    pks, msgs, sigs = _mixed_batch()
    assert len({len(m) for m in msgs}) == 2
    w = Ed25519Verifier(bucket_sizes=[8], device="cpu").upload(pks, msgs, sigs)
    got = S.sha512_ragged(w.sig_b, w.pk_b, w.msg, w.offsets, w.max_len)
    want = np.asarray(JaxVerifier(bucket_sizes=[8])._digest_rows(pks, msgs, sigs, 8))
    n = len(pks)
    assert np.array_equal(got.numpy()[:, :n], want[:, :n])


def _ragged_inputs(lens, lead, seed):
    """sig (64, n), pk (32, n) rows and a flat buffer holding the
    messages from byte `lead` on, with their offsets."""
    rng = np.random.default_rng(seed)
    n = len(lens)
    sig = rng.integers(0, 256, (64, n), dtype=np.uint8)
    pk = rng.integers(0, 256, (32, n), dtype=np.uint8)
    off = (np.concatenate([[0], np.cumsum(lens)]) + lead).astype(np.int32)
    flat = rng.integers(0, 256, int(off[-1]) + 16, dtype=np.uint8)
    return sig, pk, flat, off


def test_ragged_plain_matches_hashlib_across_block_edges():
    """Lengths either side of the one/two/three-block edges of 64 + M
    (M = 47/48, 111/112, 175/176), empty messages, and a first message
    that does not start the buffer."""
    lens = [0, 1, 46, 47, 48, 111, 112, 116, 117, 118, 175, 176, 239, 240, 0]
    sig, pk, flat, off = _ragged_inputs(lens, 5, 11)
    got = S.sha512_ragged(*(torch.from_numpy(a) for a in (sig, pk, flat, off)), max(lens))
    for i in range(len(lens)):
        msg = flat[off[i] : off[i + 1]].tobytes()
        want = hashlib.sha512(sig[:32, i].tobytes() + pk[:, i].tobytes() + msg)
        assert got[:, i].numpy().tobytes() == want.digest()
