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
