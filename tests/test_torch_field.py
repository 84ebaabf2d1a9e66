"""The port's GF(2^255 - 19) and Edwards point ops against the JAX package.

tendermint_tpu_torch.ops.field25519 and .edwards keep the JAX layout
(20 limbs of 13 bits in int32, batch axis minor) and the JAX algorithms,
so every function is compared limb for limb with its JAX namesake on the
same seeded inputs, passed across as numpy. Tolerance: zero (integer
arithmetic, exact equality).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tendermint_tpu.crypto import ed25519_math as jem
from tendermint_tpu.ops import edwards as JE
from tendermint_tpu.ops import field25519 as JF
from tendermint_tpu_torch import interop
from tendermint_tpu_torch.crypto import ed25519_math as em
from tendermint_tpu_torch.ops import edwards as E
from tendermint_tpu_torch.ops import field25519 as F

P = em.P
N = 8


def _limbs(values):
    """(20, n) int32 numpy limbs of Python ints (any value < 2^260)."""
    return np.array(
        [[(v >> (13 * i)) & 8191 for v in values] for i in range(20)],
        dtype=np.int32,
    )


def _field_inputs(seed):
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(32), "little") % P for _ in range(N - 4)]
    vals += [0, 1, P - 1, (1 << 255) - 1]  # the last is >= p: non-canonical
    return _limbs(vals)


def _same(t: torch.Tensor, j) -> bool:
    return np.array_equal(t.numpy(), np.asarray(j))


def _t(a) -> torch.Tensor:
    return interop.points_from_numpy(np.asarray(a), device="cpu")


def test_constants_match():
    assert (em.P, em.L, em.D, em.SQRT_M1) == (jem.P, jem.L, jem.D, jem.SQRT_M1)
    assert em.B_POINT == jem.B_POINT
    assert (F.NLIMBS, F.RADIX, F.FOLD) == (JF.NLIMBS, JF.RADIX, JF.FOLD)


@pytest.mark.parametrize(
    "name", ["mul", "sqr", "add", "sub", "neg", "canonical", "eq", "carry"]
)
def test_field_op_limb_for_limb(name):
    a, b = _field_inputs(1), _field_inputs(2)
    a[:, 0] = b[:, 0]  # one equal pair for eq
    ops = {
        "mul": (lambda m, x, y: m.mul(x, y)),
        "sqr": (lambda m, x, y: m.sqr(x)),
        "add": (lambda m, x, y: m.add(x, y)),
        "sub": (lambda m, x, y: m.sub(x, y)),
        "neg": (lambda m, x, y: m.neg(x)),
        "canonical": (lambda m, x, y: m.canonical(x)),
        "eq": (lambda m, x, y: m.eq(x, y)),
        "carry": (lambda m, x, y: m.carry(x * 4000 - y)),
    }
    got = ops[name](F, _t(a), _t(b))
    want = ops[name](JF, jnp.asarray(a), jnp.asarray(b))
    assert _same(got, want)


def test_pow_p58_limb_for_limb_and_value():
    a = _field_inputs(3)
    got = F.pow_p58(_t(a))
    want = jax.jit(JF.pow_p58)(jnp.asarray(a))
    assert _same(got, want)
    for i in range(N):
        x = sum(int(a[k, i]) << (13 * k) for k in range(20)) % P
        assert F.from_limbs(got[:, i]) == pow(x, (P - 5) // 8, P)


def _encodings():
    """y encodings: valid points, a non-square, y >= p, and x = 0 with
    the sign bit set (must be rejected)."""
    rng = np.random.default_rng(4)
    out = [em.compress(em.mul_base(int(rng.integers(1, 1 << 62)))) for _ in range(3)]
    out.append(next(
        int(y).to_bytes(32, "little")
        for y in range(2, 100)
        if em.decompress(int(y).to_bytes(32, "little")) is None
    ))
    out.append(int(P + 3).to_bytes(32, "little"))  # non-canonical y
    out.append(bytes([1]) + bytes(30) + bytes([0x80]))  # x = 0, sign 1
    out.append(int(P - 1).to_bytes(32, "little"))  # y = -1, order 2
    out.append(bytes(32))  # y = 0, order 4
    return out


def _y_sign(encs):
    ints = [int.from_bytes(e, "little") for e in encs]
    y = _limbs([v & ((1 << 255) - 1) for v in ints])
    sign = np.array([v >> 255 for v in ints], dtype=np.int32)
    return y, sign


def test_decompress_points_and_flags_match():
    encs = _encodings()
    y, sign = _y_sign(encs)
    pt, ok = E.decompress(_t(y), torch.from_numpy(sign))
    jpt, jok = jax.jit(JE.decompress)(jnp.asarray(y), jnp.asarray(sign))
    assert _same(pt, jpt) and _same(ok, jok)
    assert ok.tolist() == [em.decompress(e) is not None for e in encs]


def _points():
    """(4, 20, N) extended points from the host oracle."""
    rng = np.random.default_rng(5)
    pts = [em.mul_base(int(rng.integers(1, 1 << 62))) for _ in range(N - 1)]
    pts.append(em.IDENTITY)
    cols = []
    for X, Y, Z, T in pts:
        zi = pow(Z, P - 2, P)
        x, y = X * zi % P, Y * zi % P
        cols.append(np.asarray(JE.pack_point(x, y)))
    return np.stack(cols, axis=-1).astype(np.int32)


@pytest.mark.parametrize(
    "name",
    ["double", "double_no_t", "add_cached", "add_cached_no_t", "negate",
     "cache_point", "negate_cached", "is_identity"],
)
def test_point_op_limb_for_limb(name):
    p = _points()
    q = np.roll(p, 3, axis=-1)
    ops = {
        "double": (lambda m, x, y: m.point_double(x)),
        "double_no_t": (lambda m, x, y: m.point_double(x, with_t=False)),
        "add_cached": (lambda m, x, y: m.point_add_cached(x, m.cache_point(y))),
        "add_cached_no_t": (
            lambda m, x, y: m.point_add_cached(x, m.cache_point(y), with_t=False)
        ),
        "negate": (lambda m, x, y: m.negate(x)),
        "cache_point": (lambda m, x, y: m.cache_point(x)),
        "negate_cached": (lambda m, x, y: m.negate_cached(m.cache_point(x))),
        "is_identity": (lambda m, x, y: m.is_identity(x)),
    }
    got = ops[name](E, _t(p), _t(q))
    want = ops[name](JE, jnp.asarray(p), jnp.asarray(q))
    assert _same(got, want)


def test_niels_table_b_and_identity_match():
    assert _same(E.niels_table_b("cpu"), JE.niels_table_b())
    assert _same(E.identity(N, "cpu"), JE.identity(N))
    assert _same(E.pack_point(5, 7), JE.pack_point(5, 7))


def test_points_from_numpy_keeps_limbs_and_refuses_other_shapes():
    p = _points()
    t = interop.points_from_numpy(p, device="cpu")
    assert t.dtype == torch.int32 and t.is_contiguous()
    assert np.array_equal(t.numpy(), p)
    with pytest.raises(ValueError):
        interop.points_from_numpy(np.zeros((4, 19, 2), np.int32), device="cpu")
