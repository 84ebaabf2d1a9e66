"""Batched sr25519 (schnorrkel over ristretto255) verification: the plain
version of kernel X3, the hybrid program around kernel K1, and the
bucketed `Sr25519Verifier`.

Counterpart: tendermint_tpu/ops/sr25519_kernel.py (`_abs_dev` :63,
`_sqrt_ratio_m1_dev` :73, `ristretto_decode_dev` :96, `_ristretto_eq_dev`
:134, `_verify_tile_sr` :150, `_jit_verify_tile_sr_hybrid` :187,
`Sr25519Verifier` :204). The check, for a merlin challenge k computed on
the host (crypto/sr25519.challenge_rows, one C call a window):

    [s]B - [k]A == R   as ristretto255 elements,  s < L,  marker bit set,

with A and R decoded by RFC 9496 §4.3.1 (canonical, non-negative,
square, t non-negative, y != 0) and compared by §4.4. ristretto255 has
prime order: no cofactor.

The functions here are plain PyTorch on (rows, N) int32 tensors in the
JAX layout (20 x 13-bit limbs, batch axis minor), so the CPU tests
compare them with the JAX functions value for value. On the card the
verifier runs kernel X3 (ops/sr25519_cuda.py) for the whole check
(program="tile", the default), or these plain functions around kernel
K1 (program="hybrid", the counterpart of `_jit_verify_tile_sr_hybrid`,
selected explicitly, never as a fallback).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..crypto import ed25519_math as em
from . import field25519 as F
from .ed25519_kernel import (
    BucketedVerifier,
    _bytes_const,
    _col,
    _fe_from_bytes_dev,
    _lt_const_dev,
    _nibbles_dev,
    _s_lt_l_dev,
    bucket_for,
    dual_mult_sb_minus_ka,
    size_mask,
)

__all__ = [
    "Sr25519Verifier",
    "SrWindow",
    "ristretto_decode",
    "verify_hybrid_sr",
]

_P8 = _bytes_const(em.P, 32)  # the field prime as 32 LE bytes


def _topclear(device) -> torch.Tensor:
    """(32, 1): clears bit 255 of a 32-byte row."""
    return _col([0xFF] * 31 + [0x7F], device)


def _is_negative(x: torch.Tensor) -> torch.Tensor:
    """(NLIMBS, N) -> (N,) bool: the canonical value is odd."""
    return (F.canonical(x)[..., 0, :] & 1) == 1


def _abs(x: torch.Tensor) -> torch.Tensor:
    """CT_ABS (RFC 9496 §4.1): negate iff the canonical value is odd."""
    return F.select(_is_negative(x), F.neg(x), x)


def _sqrt_ratio_m1(u: torch.Tensor, v: torch.Tensor):
    """SQRT_RATIO_M1 (RFC 9496 §4.2): (was_square (N,), r) with
    r = |sqrt(u/v)| when u/v is square, else |sqrt(i u/v)|. r is
    multiplied by sqrt(-1) when v r^2 is -u or -i u; only the first of
    the two counts as square."""
    sqrt_m1 = F.const_limbs(em.SQRT_M1, u.device).expand(u.shape)
    v3 = F.mul(F.sqr(v), v)
    v7 = F.mul(F.sqr(v3), v)
    r = F.mul(F.mul(u, v3), F.pow_p58(F.mul(u, v7)))
    check = F.mul(v, F.sqr(r))
    u_neg = F.neg(u)
    correct = F.eq(check, u)
    flipped = F.eq(check, u_neg)
    flipped_i = F.eq(check, F.mul(u_neg, sqrt_m1))
    r = F.select(flipped | flipped_i, F.mul(r, sqrt_m1), r)
    return correct | flipped, _abs(r)


def ristretto_decode(b: torch.Tensor):
    """(32, N) int32 byte rows -> (point (4, NLIMBS, N) extended, ok (N,)
    bool), RFC 9496 §4.3.1. An invalid encoding (value >= p, bit 255
    included; negative; not square; t negative; y = 0) gives ok False
    and a bounded point that flows through the curve arithmetic."""
    nonneg = (b[0] & 1) == 0
    canon = _lt_const_dev(b, _P8)
    # bit 255 masked to keep the limbs bounded; canon already rejects it
    s = _fe_from_bytes_dev(b & _topclear(b.device))
    one = F.const_limbs(1, b.device).expand(s.shape)
    d = F.const_limbs(em.D, b.device).expand(s.shape)
    ss = F.sqr(s)
    u1 = F.sub(one, ss)
    u2 = F.add(one, ss)
    u2_sqr = F.sqr(u2)
    v = F.sub(F.neg(F.mul(d, F.sqr(u1))), u2_sqr)
    was_square, invsqrt = _sqrt_ratio_m1(one, F.mul(v, u2_sqr))
    den_x = F.mul(invsqrt, u2)
    den_y = F.mul(F.mul(invsqrt, den_x), v)
    x = _abs(F.mul(F.add(s, s), den_x))
    y = F.mul(u1, den_y)
    t = F.mul(x, y)
    ok = was_square & ~_is_negative(t) & ~F.is_zero(y) & nonneg & canon
    return torch.stack([x, y, one, t], dim=-3), ok


def _ristretto_eq(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """RFC 9496 §4.4: X1 Y2 == Y1 X2 or Y1 Y2 == X1 X2. Projective: each
    equation has one factor of each point on both sides, so T-less
    (X, Y, Z) stacks do. p, q: (>= 2, NLIMBS, N)."""
    x1, y1, x2, y2 = p[0], p[1], q[0], q[1]
    cross = F.eq(F.mul(x1, y2), F.mul(y1, x2))
    straight = F.eq(F.mul(y1, y2), F.mul(x1, x2))
    return cross | straight


def _verify_tile_sr(pk_b, sig_b, k_b, dual_fn=None) -> torch.Tensor:
    """The whole check as plain torch ops, the plain version of kernel
    X3: pk_b (32, N) ristretto public keys, sig_b (64, N) R || s with the
    marker in bit 511, k_b (32, N) challenges reduced mod L, as uint8 or
    int32 byte rows -> (N,) bool. `dual_fn` swaps in kernel K1 (the
    hybrid program)."""
    pk = pk_b.to(torch.int32)
    sig = sig_b.to(torch.int32)
    kb = k_b.to(torch.int32)
    marker_ok = (sig[63] >> 7) == 1
    s = sig[32:] & _topclear(sig.device)
    s_ok = _s_lt_l_dev(s)
    A, ok_a = ristretto_decode(pk)
    R, ok_r = ristretto_decode(sig[:32])
    dual = dual_mult_sb_minus_ka if dual_fn is None else dual_fn
    acc = dual(A, _nibbles_dev(s), _nibbles_dev(kb))  # [s]B - [k]A
    return _ristretto_eq(acc, R) & ok_a & ok_r & s_ok & marker_ok


def verify_hybrid_sr(pk_b, sig_b, k_b) -> torch.Tensor:
    """The hybrid program: plain decode, scalar checks and compare
    around kernel K1 (counterpart: `_jit_verify_tile_sr_hybrid`). On a
    CPU tensor K1's wrapper takes its plain version, so this equals
    _verify_tile_sr."""
    from .ed25519_cuda import dual_mult

    return _verify_tile_sr(pk_b, sig_b, k_b, dual_fn=dual_mult)


# -- host packing --


class SrWindow(NamedTuple):
    """One batch on the device (Sr25519Verifier.upload)."""

    pk_b: torch.Tensor  # (32, B) uint8
    sig_b: torch.Tensor  # (64, B) uint8
    k_b: torch.Tensor  # (32, B) uint8 challenges
    size_ok: np.ndarray  # (n,) bool, host


class Sr25519Verifier(BucketedVerifier):
    """Bucketed sr25519 batch verifier on one device (BucketedVerifier):
    kernel X3 for the whole check ("tile") or plain torch around kernel
    K1 ("hybrid"). The merlin challenges are computed on the host in
    upload(), before the window's one copy to the device."""

    def dispatch(self, pubkeys, msgs, sigs):
        """Enqueue one batch; returns the handle for gather()."""
        n = len(pubkeys)
        if n == 0:
            return (None, 0, np.zeros(0, dtype=bool))
        w = self.upload(pubkeys, msgs, sigs)
        if self.program == "hybrid":
            ok = verify_hybrid_sr(w.pk_b, w.sig_b, w.k_b)
        else:
            from .sr25519_cuda import verify_sr

            ok = verify_sr(w.pk_b, w.sig_b, w.k_b)
        return (ok, n, w.size_ok)

    def upload(self, pubkeys, msgs, sigs) -> SrWindow:
        """One non-empty batch on the device, in one host-to-device copy:
        pk, sig and challenge byte rows padded with zero lanes to the
        bucket B (lanes of malformed size as zero rows, masked after the
        fact), the challenges computed here by challenge_rows in one C
        call and written into the buffer as they come, 32-byte rows."""
        from ..crypto.sr25519 import challenge_rows

        n = len(pubkeys)
        size_ok, pubkeys, sigs = size_mask(pubkeys, sigs)
        ks = challenge_rows(pubkeys, msgs, [sig[:32] for sig in sigs])
        bucket = bucket_for(n, self.bucket_sizes)
        # [pk rows | sig rows | k rows], each (k, bucket), batch-minor
        buf = np.zeros(128 * bucket, dtype=np.uint8)
        self._pack_rows(buf, bucket, ((0, pubkeys, 32), (32, sigs, 64)))
        buf[96 * bucket :].reshape(32, bucket)[:, :n] = ks.T
        dev = torch.from_numpy(buf).to(self.device)
        return SrWindow(
            pk_b=dev[: 32 * bucket].view(32, bucket),
            sig_b=dev[32 * bucket : 96 * bucket].view(64, bucket),
            k_b=dev[96 * bucket :].view(32, bucket),
            size_ok=size_ok,
        )
