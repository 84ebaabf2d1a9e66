"""GF(2^255 - 19) as plain PyTorch ops on batched int32 limb tensors.

Counterpart: tendermint_tpu/ops/field25519.py. The layout is kept at
every public function so the tests compare limb for limb with the JAX
functions: 20 limbs of 13 bits in int32, batch axis minor
((..., NLIMBS, N)). The TPU forced that shape (no 64-bit integer unit,
128-lane vectors); here it is the plain version the CUDA kernels in
csrc/ are held against, and those use their own radix-2^51 limbs.

torch's `>>` on int32 is arithmetic and `&` works on two's complement,
exactly like jnp's, so every carry pass below is the JAX one.

Invariant: every field element handed between public ops is
"normalized" (limbs in [0, 2^13] up to small loose slack, value >= 0);
values are made canonical only for comparisons and parity.
"""

from __future__ import annotations

import torch
import torch.nn.functional as Fn

__all__ = [
    "NLIMBS",
    "RADIX",
    "MASK",
    "P_INT",
    "to_limbs",
    "from_limbs",
    "const_limbs",
    "two_p",
    "add",
    "sub",
    "neg",
    "mul",
    "sqr",
    "carry",
    "carry1",
    "canonical",
    "is_zero",
    "eq",
    "select",
    "pow2k",
    "pow_p58",
]

NLIMBS = 20
RADIX = 13
BASE = 1 << RADIX
MASK = BASE - 1
P_INT = 2**255 - 19
# 2^260 mod p: limb index NLIMBS wraps with this factor
FOLD = 19 * (1 << (NLIMBS * RADIX - 255))  # 608


def _limbs_of(x: int) -> list:
    return [(x >> (RADIX * i)) & MASK for i in range(NLIMBS)]


def to_limbs(x: int) -> torch.Tensor:
    """(NLIMBS,) int32 CPU tensor for a scalar value (reduced mod p)."""
    return torch.tensor(_limbs_of(x % P_INT), dtype=torch.int32)


def from_limbs(limbs) -> int:
    """Integer value mod p of one (NLIMBS,) limb vector."""
    vals = [int(v) for v in torch.as_tensor(limbs).reshape(-1).tolist()]
    return sum(v << (RADIX * i) for i, v in enumerate(vals)) % P_INT


def const_limbs(x: int, device) -> torch.Tensor:
    """(NLIMBS, 1): broadcasts against any batch width."""
    return torch.tensor(
        _limbs_of(x % P_INT), dtype=torch.int32, device=device
    )[:, None]


def two_p(device) -> torch.Tensor:
    """2p in limbs, (NLIMBS, 1): the subtraction bias."""
    return torch.tensor(
        _limbs_of(2 * P_INT), dtype=torch.int32, device=device
    )[:, None]


# -- carrying --


def _pass(x: torch.Tensor) -> torch.Tensor:
    """One parallel carry pass over (..., NLIMBS, N); the top limb's
    carry folds into limb 0 with 2^260 = 608 (mod p)."""
    c = x >> RADIX
    d = x & MASK
    shifted = torch.cat([c[..., -1:, :] * FOLD, c[..., :-1, :]], dim=-2)
    return d + shifted


def carry(x: torch.Tensor) -> torch.Tensor:
    """Loose-normalize (two parallel passes): input limbs up to ~2^27.5,
    output limbs in [-2^11, 2^13 + 2^11)."""
    return _pass(_pass(x))


def carry1(x: torch.Tensor) -> torch.Tensor:
    """Single carry pass, for inputs below ~2^15."""
    return _pass(x)


# -- basic ops (return normalized elements) --


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return carry(a + b)


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    # a - b + 2p stays positive for normalized inputs
    return carry(a - b + two_p(a.device))


def neg(a: torch.Tensor) -> torch.Tensor:
    return carry(two_p(a.device) - a)


def _pad_limbs(x: torch.Tensor, before: int, after: int) -> torch.Tensor:
    """Zero-pad the limb axis (dim -2)."""
    return Fn.pad(x, (0, 0, before, after))


def _conv_tail(x: torch.Tensor) -> torch.Tensor:
    """(..., 39, N) raw convolution coefficients -> (..., 20, N)
    loose-normalized product limbs: one widening pass, one fold, two
    carry passes (bounds in the JAX counterpart's docstring)."""
    c = x >> RADIX
    d = x & MASK
    zero = torch.zeros_like(x[..., :1, :])
    x = torch.cat(
        [d + torch.cat([zero, c[..., :-1, :]], dim=-2), c[..., -1:, :]],
        dim=-2,
    )  # 40 slots
    low = x[..., :NLIMBS, :]
    hi = x[..., NLIMBS : 2 * NLIMBS, :] * FOLD
    return carry(low + hi)


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Schoolbook product as 20 shifted multiply-accumulates over 39
    convolution coefficients, then carried and folded mod p."""
    x = None
    for i in range(NLIMBS):
        term = a[..., i : i + 1, :] * b
        shifted = _pad_limbs(term, i, NLIMBS - 1 - i)
        x = shifted if x is None else x + shifted
    return _conv_tail(x)


def sqr(a: torch.Tensor) -> torch.Tensor:
    """Symmetric schoolbook square: off-diagonal half summed once and
    doubled. Inputs are tightened by one pass first (int32 bound)."""
    a = _pass(a)
    x = None
    diag = None
    for i in range(NLIMBS):
        ai = a[..., i : i + 1, :]
        row = ai * a[..., i:, :]
        shifted = _pad_limbs(row, 2 * i, NLIMBS - 1 - i)
        x = shifted if x is None else x + shifted
        d = _pad_limbs(ai * ai, 2 * i, 2 * (NLIMBS - 1 - i))
        diag = d if diag is None else diag + d
    x = x + x - diag
    return _conv_tail(x)


# -- canonical form and comparisons --


def _chain_cols(cols):
    """Sequential carry chain over a list of (..., N) tensors."""
    out = []
    c = None
    for x in cols:
        t = x if c is None else x + c
        out.append(t & MASK)
        c = t >> RADIX
    return out, c


_TOP_BITS = 255 - RADIX * (NLIMBS - 1)  # bits of limb 19 below 2^255


def canonical(x: torch.Tensor) -> torch.Tensor:
    """Fully reduce to [0, p): fold the high bits twice, then two
    conditional subtractions of p."""
    cols = [x[..., i, :] for i in range(NLIMBS)]
    for _ in range(2):
        hi = cols[NLIMBS - 1] >> _TOP_BITS
        cols[NLIMBS - 1] = cols[NLIMBS - 1] & ((1 << _TOP_BITS) - 1)
        cols[0] = cols[0] + hi * 19
        cols, c = _chain_cols(cols)
        cols[0] = cols[0] + c * FOLD
        cols, _ = _chain_cols(cols)
    v = torch.stack(cols, dim=-2)
    for _ in range(2):
        v = _cond_sub_p(v)
    return v


_P_LIMBS = _limbs_of(P_INT)


def _cond_sub_p(v: torch.Tensor) -> torch.Tensor:
    cols = [v[..., i, :] for i in range(NLIMBS)]
    diff = []
    borrow = None
    for i in range(NLIMBS):
        t = cols[i] - _P_LIMBS[i] - (0 if borrow is None else borrow)
        borrow = (t < 0).to(torch.int32)
        diff.append(t + borrow * BASE)
    ge = borrow == 0  # v >= p
    d = torch.stack(diff, dim=-2)
    return torch.where(ge[..., None, :], d, v)


def is_zero(x: torch.Tensor) -> torch.Tensor:
    """(..., NLIMBS, N) -> (..., N) bool: element = 0 mod p."""
    return torch.all(canonical(x) == 0, dim=-2)


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return is_zero(sub(a, b))


def select(
    cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor
) -> torch.Tensor:
    """Elementwise field select; cond shaped like the batch dims."""
    return torch.where(cond[..., None, :], a, b)


def pow2k(x: torch.Tensor, k: int) -> torch.Tensor:
    """x^(2^k): k repeated squarings."""
    for _ in range(k):
        x = sqr(x)
    return x


def pow_p58(x: torch.Tensor) -> torch.Tensor:
    """x^((p-5)/8) = x^(2^252 - 3): 251 squarings + 11 multiplies."""
    x2 = sqr(x)
    t = sqr(sqr(x2))
    x9 = mul(x, t)
    x11 = mul(x2, x9)
    x22 = sqr(x11)
    x_5_0 = mul(x9, x22)
    x_10_0 = mul(pow2k(x_5_0, 5), x_5_0)
    x_20_0 = mul(pow2k(x_10_0, 10), x_10_0)
    x_40_0 = mul(pow2k(x_20_0, 20), x_20_0)
    x_50_0 = mul(pow2k(x_40_0, 10), x_10_0)
    x_100_0 = mul(pow2k(x_50_0, 50), x_50_0)
    x_200_0 = mul(pow2k(x_100_0, 100), x_100_0)
    x_250_0 = mul(pow2k(x_200_0, 50), x_50_0)
    return mul(pow2k(x_250_0, 2), x)
