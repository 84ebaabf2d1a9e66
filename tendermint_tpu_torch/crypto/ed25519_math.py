"""Host ZIP-215 oracle: pure-Python ed25519 group arithmetic.

Counterpart: tendermint_tpu/crypto/ed25519_math.py, copied whole: the
port imports nothing of the JAX package. It defines the exact
verification semantics the kernels are held against, the constants L
and D, point decompression, and the comb base-point multiply used for
keygen and signing.

ZIP-215 rules (https://zips.z.cash/zip-0215):
  1. A and R are decoded per RFC 8032 5.1.3 *except* that non-canonical
     y-coordinates (y >= p) are accepted (decode y mod p).
  2. S must be canonical: 0 <= S < L.
  3. Accept iff [8][S]B == [8]R + [8][k]A, k = SHA512(R || A || M) mod L.
"""

from __future__ import annotations

import hashlib
from typing import Optional, Tuple

__all__ = [
    "P",
    "L",
    "D",
    "B_POINT",
    "Point",
    "decompress",
    "compress",
    "point_add",
    "point_double",
    "scalar_mult",
    "mul_base",
    "mul_base_ct",
    "zip215_verify",
    "sha512_mod_l",
]

P = 2**255 - 19
D = (-121665 * pow(121666, P - 2, P)) % P
L = 2**252 + 27742317777372353535851937790883648493
SQRT_M1 = pow(2, (P - 1) // 4, P)

# Extended homogeneous coordinates (X, Y, Z, T) with x = X/Z, y = Y/Z,
# x*y = T/Z on -x^2 + y^2 = 1 + d x^2 y^2.
Point = Tuple[int, int, int, int]

IDENTITY: Point = (0, 1, 1, 0)


def _recover_x(y: int, sign: int) -> Optional[int]:
    x2_num = (y * y - 1) % P
    x2_den = (D * y * y + 1) % P
    x2 = x2_num * pow(x2_den, P - 2, P) % P
    x = pow(x2, (P + 3) // 8, P)
    if (x * x - x2) % P != 0:
        x = x * SQRT_M1 % P
    if (x * x - x2) % P != 0:
        return None
    if x == 0 and sign == 1:
        # x = -0 is not representable; RFC 8032 and ZIP-215 both reject.
        return None
    if x & 1 != sign:
        x = P - x
    return x


def decompress(data: bytes, zip215: bool = True) -> Optional[Point]:
    """Decode a 32-byte point. ZIP-215 accepts non-canonical y (y >= p),
    reducing mod p; strict RFC 8032 rejects them."""
    if len(data) != 32:
        return None
    y = int.from_bytes(data, "little")
    sign = y >> 255
    y &= (1 << 255) - 1
    if y >= P:
        if not zip215:
            return None
        y %= P
    x = _recover_x(y, sign)
    if x is None:
        return None
    return (x, y, 1, x * y % P)


def compress(pt: Point) -> bytes:
    X, Y, Z, _ = pt
    zinv = pow(Z, P - 2, P)
    x, y = X * zinv % P, Y * zinv % P
    return (y | ((x & 1) << 255)).to_bytes(32, "little")


def point_add(p: Point, q: Point) -> Point:
    # add-2008-hwcd-3 for a = -1 twisted Edwards
    X1, Y1, Z1, T1 = p
    X2, Y2, Z2, T2 = q
    A = (Y1 - X1) * (Y2 - X2) % P
    B = (Y1 + X1) * (Y2 + X2) % P
    C = T1 * 2 * D * T2 % P
    Dv = Z1 * 2 * Z2 % P
    E, F, G, H = B - A, Dv - C, Dv + C, B + A
    return (E * F % P, G * H % P, F * G % P, E * H % P)


def point_double(p: Point) -> Point:
    # dbl-2008-hwcd
    X1, Y1, Z1, _ = p
    A = X1 * X1 % P
    B = Y1 * Y1 % P
    C = 2 * Z1 * Z1 % P
    H = A + B
    E = (H - (X1 + Y1) * (X1 + Y1)) % P
    G = A - B
    F = C + G
    return (E * F % P, G * H % P, F * G % P, E * H % P)


def point_neg(p: Point) -> Point:
    X, Y, Z, T = p
    return (P - X if X else 0, Y, Z, P - T if T else 0)


def point_eq(p: Point, q: Point) -> bool:
    X1, Y1, Z1, _ = p
    X2, Y2, Z2, _ = q
    return (X1 * Z2 - X2 * Z1) % P == 0 and (Y1 * Z2 - Y2 * Z1) % P == 0


def scalar_mult(k: int, p: Point) -> Point:
    q = IDENTITY
    while k:
        if k & 1:
            q = point_add(q, p)
        p = point_double(p)
        k >>= 1
    return q


_B_Y = 4 * pow(5, P - 2, P) % P
_B_X = _recover_x(_B_Y, 0)
assert _B_X is not None
B_POINT: Point = (_B_X, _B_Y, 1, _B_X * _B_Y % P)

# lazy 4-bit fixed-base comb: 64 windows x 15 multiples of B.
# mul_base costs 63 adds instead of ~380 double/adds — the pure-Python
# base-point multiply is what keygen and signing spend their time on.
_BASE_COMB: list | None = None


def _base_comb() -> list:
    global _BASE_COMB
    if _BASE_COMB is None:
        tbl = []
        base = B_POINT
        for _ in range(64):
            row = [IDENTITY]
            for _i in range(15):
                row.append(point_add(row[-1], base))
            tbl.append(row)
            base = point_add(row[15], base)  # base * 16
        _BASE_COMB = tbl
    return _BASE_COMB


def mul_base(k: int) -> Point:
    """k*B for any k: reduced mod L up front (B has order L, so the
    product is identical and the 64-window comb always covers it).

    PUBLIC-scalar path only (verification): the loop bound and the
    window branch depend on k. Secret scalars — signing nonces,
    expanded keys — go through mul_base_ct."""
    tbl = _base_comb()
    k %= L
    q = IDENTITY
    w = 0
    while k:
        d = k & 15
        if d:
            q = point_add(q, tbl[w][d])
        k >>= 4
        w += 1
    return q


def _comb_select(row: list, d: int) -> Point:
    """Constant-structure row lookup: scan all 16 entries, keep the
    match via an arithmetic mask — `((j ^ d) - 1) >> 4` is -1 exactly
    when j == d, else 0. No comparison or subscript on the secret."""
    x = y = z = t = 0
    for j in range(16):
        mask = ((j ^ d) - 1) >> 4
        ex, ey, ez, et = row[j]
        x |= ex & mask
        y |= ey & mask
        z |= ez & mask
        t |= et & mask
    return x, y, z, t


def mul_base_ct(k: int) -> Point:
    """k*B with a fixed execution structure for SECRET scalars: all 64
    comb windows are walked, every window does one masked row scan and
    one unified addition (add-2008-hwcd-3 is identity-safe on the
    prime-order subgroup), so neither the trace shape nor the table
    access order is a function of k's bits. Pure Python cannot be
    cycle-constant; the contract is structural."""
    tbl = _base_comb()
    k %= L
    q = IDENTITY
    for w in range(64):
        q = point_add(q, _comb_select(tbl[w], (k >> (4 * w)) & 15))
    return q


def sha512_mod_l(*chunks: bytes) -> int:
    h = hashlib.sha512()
    for c in chunks:
        h.update(c)
    return int.from_bytes(h.digest(), "little") % L


def zip215_verify(pubkey: bytes, msg: bytes, sig: bytes) -> bool:
    """ZIP-215 cofactored verification: [8][S]B == [8]R + [8][k]A."""
    if len(sig) != 64 or len(pubkey) != 32:
        return False
    A = decompress(pubkey, zip215=True)
    if A is None:
        return False
    R_bytes, S_bytes = sig[:32], sig[32:]
    R = decompress(R_bytes, zip215=True)
    if R is None:
        return False
    S = int.from_bytes(S_bytes, "little")
    if S >= L:
        return False
    k = sha512_mod_l(R_bytes, pubkey, msg)
    # [S]B - [k]A - R, then multiply by cofactor 8 and compare to identity.
    lhs = mul_base(S)
    rhs = point_add(scalar_mult(k, A), R)
    diff = point_add(lhs, point_neg(rhs))
    for _ in range(3):
        diff = point_double(diff)
    return point_eq(diff, IDENTITY)
