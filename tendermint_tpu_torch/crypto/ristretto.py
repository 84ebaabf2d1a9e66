"""ristretto255 (RFC 9496) over the curve25519 Edwards curve: the host
oracle of the sr25519 verifier.

Counterpart: tendermint_tpu/crypto/ristretto.py:43-147. Python ints on
the port's ed25519_math point arithmetic. Decode and encode follow RFC
9496 §4.3.1 / §4.3.2; equality is §4.4. Kernel X3 and its plain version
(ops/sr25519_kernel.py) are held against `decode`, and through it against
`crypto.sr25519.PubKeySr25519.verify_signature`.
"""

from __future__ import annotations

from typing import Optional, Tuple

from . import ed25519_math as em

__all__ = [
    "BASE",
    "L",
    "add",
    "decode",
    "encode",
    "eq",
    "mul_base",
    "mul_base_ct",
    "scalar_mult",
]

P = em.P
D = em.D
L = em.L

Point = Tuple[int, int, int, int]  # extended homogeneous (X, Y, Z, T)

_SQRT_M1 = pow(2, (P - 1) // 4, P)
# invsqrt(a - d) with a = -1: 1/sqrt(-1 - d)
_A_MINUS_D = (-1 - D) % P


def _is_negative(x: int) -> bool:
    return (x % P) & 1 == 1


def _abs(x: int) -> int:
    x %= P
    return P - x if _is_negative(x) else x


def _sqrt_ratio_m1(u: int, v: int) -> Tuple[bool, int]:
    """(was_square, r) with r = |sqrt(u/v)| when it exists, else
    |sqrt(i*u/v)| (RFC 9496 §4.2)."""
    v3 = v * v % P * v % P
    v7 = v3 * v3 % P * v % P
    r = u * v3 % P * pow(u * v7 % P, (P - 5) // 8, P) % P
    check = v * r % P * r % P
    u = u % P
    correct = check == u
    flipped = check == (P - u) % P
    flipped_i = check == (P - u) * _SQRT_M1 % P
    if flipped or flipped_i:
        r = r * _SQRT_M1 % P
    return correct or flipped, _abs(r)


_, _INVSQRT_A_MINUS_D = _sqrt_ratio_m1(1, _A_MINUS_D)


def decode(data: bytes) -> Optional[Point]:
    """RFC 9496 §4.3.1: 32 bytes -> extended point, or None."""
    if len(data) != 32:
        return None
    s = int.from_bytes(data, "little")
    if s >= P or _is_negative(s):
        return None
    ss = s * s % P
    u1 = (1 - ss) % P
    u2 = (1 + ss) % P
    u2_sqr = u2 * u2 % P
    v = (-(D * u1 % P * u1) - u2_sqr) % P
    was_square, invsqrt = _sqrt_ratio_m1(1, v * u2_sqr % P)
    den_x = invsqrt * u2 % P
    den_y = invsqrt * den_x % P * v % P
    x = _abs(2 * s % P * den_x % P)
    y = u1 * den_y % P
    t = x * y % P
    if not was_square or _is_negative(t) or y == 0:
        return None
    return (x, y, 1, t)


def encode(pt: Point) -> bytes:
    """RFC 9496 §4.3.2: extended point -> canonical 32 bytes."""
    x0, y0, z0, t0 = pt
    u1 = (z0 + y0) * (z0 - y0) % P
    u2 = x0 * y0 % P
    _, invsqrt = _sqrt_ratio_m1(1, u1 * u2 % P * u2 % P)
    den1 = invsqrt * u1 % P
    den2 = invsqrt * u2 % P
    z_inv = den1 * den2 % P * t0 % P
    if _is_negative(t0 * z_inv % P):
        x = y0 * _SQRT_M1 % P
        y = x0 * _SQRT_M1 % P
        den_inv = den1 * _INVSQRT_A_MINUS_D % P
    else:
        x = x0
        y = y0
        den_inv = den2
    if _is_negative(x * z_inv % P):
        y = (P - y) % P
    s = _abs(den_inv * ((z0 - y) % P) % P)
    return int(s).to_bytes(32, "little")


def eq(p: Point, q: Point) -> bool:
    """Ristretto equality (RFC 9496 §4.4): X1*Y2 == Y1*X2 or
    Y1*Y2 == X1*X2 (a = -1 form)."""
    x1, y1, _, _ = p
    x2, y2, _, _ = q
    return x1 * y2 % P == y1 * x2 % P or y1 * y2 % P == x1 * x2 % P


BASE: Point = em.B_POINT


def add(p: Point, q: Point) -> Point:
    return em.point_add(p, q)


def scalar_mult(k: int, p: Point) -> Point:
    return em.scalar_mult(k % L, p)


def mul_base(k: int) -> Point:
    """k*B for a public scalar (verification)."""
    return em.mul_base(k % L)


def mul_base_ct(k: int) -> Point:
    """k*B for a secret scalar: the fixed comb structure of
    ed25519_math.mul_base_ct."""
    return em.mul_base_ct(k % L)
