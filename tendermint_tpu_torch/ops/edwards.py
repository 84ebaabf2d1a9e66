"""Batched twisted-Edwards (ed25519) group ops as plain PyTorch ops.

Counterpart: tendermint_tpu/ops/edwards.py:53-251. Points are int32
tensors shaped (..., 4, NLIMBS, N) of extended coordinates (X, Y, Z, T),
batch axis minor, exactly the JAX layout. The second operand of an
addition is kept in cached form (Y-X, Y+X, 2d*T, 2Z). Formulas:
add-2008-hwcd-3 and dbl-2008-hwcd, complete for a = -1, so identity,
doubling and small-order inputs all take the same path. The CUDA
kernels (csrc/ed25519_device.cuh) use the same formulas in their own
limbs.
"""

from __future__ import annotations

import torch

from ..crypto import ed25519_math as em
from . import field25519 as F

__all__ = [
    "identity",
    "pack_point",
    "cache_point",
    "negate_cached",
    "point_add_cached",
    "point_double",
    "negate",
    "is_identity",
    "decompress",
    "niels_table_b",
]

D_INT = em.D
D2_INT = 2 * em.D % em.P
SQRT_M1_INT = em.SQRT_M1


def identity(n: int, device) -> torch.Tensor:
    """(0, 1, 1, 0) broadcast over the batch -> (4, NLIMBS, N)."""
    pt = torch.zeros((4, F.NLIMBS, 1), dtype=torch.int32, device=device)
    pt[1, 0, 0] = 1
    pt[2, 0, 0] = 1
    return pt.expand(4, F.NLIMBS, n)


def pack_point(x: int, y: int) -> torch.Tensor:
    """Host side: affine ints -> extended coordinates (4, NLIMBS)."""
    return torch.stack(
        [
            F.to_limbs(x),
            F.to_limbs(y),
            F.to_limbs(1),
            F.to_limbs(x * y % em.P),
        ]
    )


def _coords(p: torch.Tensor, k: int):
    return [p[..., i, :, :] for i in range(k)]


def cache_point(p: torch.Tensor) -> torch.Tensor:
    """Extended -> cached (Y-X, Y+X, 2d*T, 2Z)."""
    X, Y, Z, T = _coords(p, 4)
    pre = F.carry1(
        torch.stack([Y - X + F.two_p(p.device), Y + X, T, Z + Z], dim=-3)
    )
    one = F.const_limbs(1, p.device)
    consts = torch.stack([one, one, F.const_limbs(D2_INT, p.device), one])
    return F.mul(pre, consts.expand(pre.shape))


def negate_cached(qc: torch.Tensor) -> torch.Tensor:
    """Swap (Y-X, Y+X) and negate the 2dT slot: no multiplies."""
    ymx, ypx, t2d, z2 = _coords(qc, 4)
    return torch.stack([ypx, ymx, F.neg(t2d), z2], dim=-3)


def point_add_cached(
    p: torch.Tensor, qc: torch.Tensor, with_t: bool = True
) -> torch.Tensor:
    """p (extended) + q (cached) -> extended; with_t=False drops T."""
    X, Y, Z, T = _coords(p, 4)
    two_p = F.two_p(p.device)
    lhs = F.carry1(torch.stack([Y - X + two_p, Y + X, T, Z], dim=-3))
    A, B, C, Dv = _coords(F.mul(lhs, qc), 4)
    E, Fv, G, H = _coords(
        F.carry1(
            torch.stack(
                [B - A + two_p, Dv - C + two_p, Dv + C, B + A], dim=-3
            )
        ),
        4,
    )
    if with_t:
        out_l = torch.stack([E, G, Fv, E], dim=-3)
        out_r = torch.stack([Fv, H, G, H], dim=-3)
    else:
        out_l = torch.stack([E, G, Fv], dim=-3)
        out_r = torch.stack([Fv, H, G], dim=-3)
    return F.mul(out_l, out_r)


def point_double(p: torch.Tensor, with_t: bool = True) -> torch.Tensor:
    """Double; reads (X, Y, Z) only, so a T-less 3-stack is accepted."""
    X, Y, Z = _coords(p, 3)
    A, B, Zs, S = _coords(
        F.sqr(F.carry1(torch.stack([X, Y, Z, X + Y], dim=-3))), 4
    )
    two_p = F.two_p(p.device)
    E, Fv, G, H = _coords(
        F.carry1(
            torch.stack(
                [
                    A + B - S + two_p,
                    Zs + Zs + A - B + two_p,
                    A - B + two_p,
                    A + B,
                ],
                dim=-3,
            )
        ),
        4,
    )
    if with_t:
        out_l = torch.stack([E, G, Fv, E], dim=-3)
        out_r = torch.stack([Fv, H, G, H], dim=-3)
    else:
        out_l = torch.stack([E, G, Fv], dim=-3)
        out_r = torch.stack([Fv, H, G], dim=-3)
    return F.mul(out_l, out_r)


def negate(p: torch.Tensor) -> torch.Tensor:
    """(X, Y, Z, T) -> (-X, Y, Z, -T)."""
    X, Y, Z, T = _coords(p, 4)
    two_p = F.two_p(p.device)
    return F.carry(torch.stack([two_p - X, Y, Z, two_p - T], dim=-3))


def is_identity(p: torch.Tensor) -> torch.Tensor:
    """Projective identity test: X = 0 and Y = Z (mod p)."""
    X, Y, Z = _coords(p, 3)
    return F.is_zero(X) & F.eq(Y, Z)


def decompress(y: torch.Tensor, sign: torch.Tensor):
    """y (NLIMBS, N) field element (may be >= p: ZIP-215 accepts
    non-canonical y), sign (N,) int32 0/1 -> (point (4, NLIMBS, N),
    ok (N,) bool). x = u v^3 (u v^7)^((p-5)/8) with the sqrt(-1)
    correction; x = 0 with sign 1 is rejected."""
    dev = y.device
    one = F.const_limbs(1, dev).expand(y.shape)
    y2 = F.sqr(y)
    u = F.sub(y2, one)
    v = F.add(F.mul(y2, F.const_limbs(D_INT, dev).expand(y.shape)), one)
    v2 = F.sqr(v)
    v3 = F.mul(v2, v)
    v7 = F.mul(F.sqr(v3), v)
    t = F.pow_p58(F.mul(u, v7))
    x = F.mul(F.mul(u, v3), t)
    vx2 = F.mul(v, F.sqr(x))
    root_ok = F.eq(vx2, u)
    neg_root_ok = F.eq(vx2, F.neg(u))
    x_alt = F.mul(x, F.const_limbs(SQRT_M1_INT, dev).expand(x.shape))
    x = F.select(neg_root_ok, x_alt, x)
    ok = root_ok | neg_root_ok
    parity = F.canonical(x)[..., 0, :] & 1
    x = F.select(parity != sign, F.neg(x), x)
    ok = ok & ~(F.is_zero(x) & (sign == 1))
    xy = F.mul(x, y)
    pt = torch.stack([x, y, one, xy], dim=-3)
    return pt, ok


def niels_table_b(device, count: int = 9) -> torch.Tensor:
    """(count, 4, NLIMBS, 1): cached-form entries for j*B, j = 0..count-1,
    Z = 1: (y-x, y+x, 2d*xy, 2)."""
    entries = []
    pt = em.IDENTITY
    for _j in range(count):
        X, Y, Z, _T = pt
        zinv = pow(Z, em.P - 2, em.P)
        x, y = X * zinv % em.P, Y * zinv % em.P
        entries.append(
            torch.stack(
                [
                    F.to_limbs((y - x) % em.P),
                    F.to_limbs((y + x) % em.P),
                    F.to_limbs(D2_INT * x * y % em.P),
                    F.to_limbs(2),
                ]
            )
        )
        pt = em.point_add(pt, em.B_POINT)
    return torch.stack(entries)[..., None].to(device)
