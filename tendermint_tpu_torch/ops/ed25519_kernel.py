"""Batched ed25519 verification: scalar preparation, the plain versions
of kernels K1 and K2, and the bucketed `Ed25519Verifier`.

Counterpart: tendermint_tpu/ops/ed25519_kernel.py (scalar prep :319-426,
`_recode_signed` :120, `dual_mult_sb_minus_ka` :181, `_scalar_mult_check`
:257, `_verify_tile` :429, `Ed25519Verifier` :518). Semantics: ZIP-215
cofactored verification,

    [8]([S]B - [k]A) == [8]R,  k = SHA512(R || A || M) mod L,  S < L,

with non-canonical y accepted for A and R, reported per signature.

Everything in this module is plain PyTorch on (rows, N) int32 tensors,
batch axis minor, exactly the JAX layout, so the CPU tests compare it
with the JAX functions value for value. On the card the verifier runs
the hand-written kernels instead (ops/ed25519_cuda.py): K2 for the whole
check (program="tile", the default), or these plain functions around
kernel K1 (program="hybrid", the counterpart of
ed25519_pallas.verify_hybrid). The JAX package's one-hot selects and MXU
einsum were forced by the TPU and are gone: tables are read by index.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..config import DEFAULT_BUCKET_SIZES
from ..crypto import ed25519_math as em
from . import edwards as E
from . import field25519 as F
from .sha512_kernel import sha512_ragged

__all__ = [
    "BucketedVerifier",
    "Ed25519Verifier",
    "Window",
    "bucket_for",
    "dual_mult_sb_minus_ka",
    "verify_hybrid",
]

PROGRAMS = ("tile", "hybrid")


def bucket_for(n: int, sizes: Sequence[int]) -> int:
    """Smallest configured bucket >= n, or n itself when oversized."""
    for b in sizes:
        if n <= b:
            return b
    return n


# -- the dual scalar multiplication (plain version of kernel K1) --


def _build_neg_a_table(A: torch.Tensor) -> torch.Tensor:
    """(4, L, N) extended -A -> (9, 4, L, N) cached table of j*(-A)."""
    negA = E.negate(A)
    cached_negA = E.cache_point(negA)
    e = {0: E.identity(A.shape[-1], A.device), 1: negA}
    e[2] = E.point_double(e[1])
    e[3] = E.point_add_cached(e[2], cached_negA)
    e[4] = E.point_double(e[2])
    e[5] = E.point_add_cached(e[4], cached_negA)
    e[6] = E.point_double(e[3])
    e[7] = E.point_add_cached(e[6], cached_negA)
    e[8] = E.point_double(e[4])
    return torch.stack([E.cache_point(e[j]) for j in range(9)], dim=0)


def _recode_signed(d: torch.Tensor) -> torch.Tensor:
    """(64, N) radix-16 digits in [0, 15], LE -> the same value as
    signed digits in [-8, 7]: e_i = t_i - 16*(t_i >= 8), t_i = d_i +
    c_i, c_{i+1} = (t_i >= 8), as a Kogge-Stone generate/propagate
    scan. A carry out of digit 63 is dropped (only S >= 2^256 -
    8*16^63 produces one, and such S fail the S < L check)."""
    g = (d >= 8).to(d.dtype)
    p = (d == 7).to(d.dtype)
    shift = 1
    while shift < d.shape[0]:
        zeros = torch.zeros_like(g[:shift])
        g = g | (p & torch.cat([zeros, g[:-shift]], dim=0))
        p = p & torch.cat([zeros, p[:-shift]], dim=0)
        shift *= 2
    c = torch.cat([torch.zeros_like(g[:1]), g[:-1]], dim=0)
    t = d + c
    return t - 16 * (t >= 8).to(d.dtype)


def _select_signed(table9: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """table9 (9, 4, L, {N|1}) cached j*P, e (N,) signed digits ->
    (4, L, N) cached |e|*P, negated where e < 0. A gather by index."""
    n = e.shape[0]
    idx = e.abs().long()
    table = table9.expand(*table9.shape[:-1], n)
    sel = table.gather(0, idx.view(1, 1, 1, n).expand(1, *table.shape[1:]))[0]
    return torch.where((e < 0)[None, None, :], E.negate_cached(sel), sel)


def dual_mult_sb_minus_ka(
    A: torch.Tensor, dS: torch.Tensor, dk: torch.Tensor
) -> torch.Tensor:
    """[S]B - [k]A as a T-less (3, NLIMBS, N) projective stack: the
    plain version of kernel K1. A (4, L, N) extended point, dS/dk
    (64, N) int32 radix-16 digits in [0, 15], little-endian. Horner
    over 64 windows, most significant first:
    acc <- 16*acc + e_k*(-A) + e_S*B."""
    TA = _build_neg_a_table(A)
    tb0 = E.niels_table_b(device=A.device)
    dS = _recode_signed(dS)
    dk = _recode_signed(dk)
    acc = E.identity(A.shape[-1], A.device)[:3]
    for w in range(63, -1, -1):
        for _ in range(3):
            acc = E.point_double(acc, with_t=False)
        acc = E.point_double(acc)
        acc = E.point_add_cached(acc, _select_signed(TA, dk[w]))
        acc = E.point_add_cached(
            acc, _select_signed(tb0, dS[w]), with_t=False
        )
    return acc


def _scalar_mult_check(yA, signA, yR, signR, dS, dk, dual_fn=None):
    """Decompress A and R, [S]B - [k]A (dual_fn, default the plain
    version), cofactor 8 on both sides, projective compare -> (N,)
    bool, ANDed with both decompressions' ok."""
    A, okA = E.decompress(yA, signA)
    R, okR = E.decompress(yR, signR)
    dual = dual_mult_sb_minus_ka if dual_fn is None else dual_fn
    acc = dual(A, dS, dk)
    for _ in range(3):
        acc = E.point_double(acc, with_t=False)
        R = E.point_double(R, with_t=False)
    lhs = torch.stack([acc[0], acc[1]], dim=0)
    rhs = torch.stack([R[0], R[1]], dim=0)
    cross_l = F.mul(lhs, R[2:3].expand(lhs.shape))
    cross_r = F.mul(rhs, acc[2:3].expand(rhs.shape))
    same = torch.all(F.eq(cross_l, cross_r), dim=0)
    return same & okA & okR


# -- scalar preparation --

_L_INT = em.L
_DELTA16_INT = 16 * (_L_INT - (1 << 252))  # 2^256 = -16*delta mod L


def _bytes_const(value: int, k: int) -> list:
    return [(value >> (8 * i)) & 0xFF for i in range(k)]


_C8 = _bytes_const(_DELTA16_INT, 17)
_L8 = _bytes_const(_L_INT, 32)


def _col(vals: list, device) -> torch.Tensor:
    return torch.tensor(vals, dtype=torch.int32, device=device)[:, None]


def _fe_from_bytes_dev(b: torch.Tensor) -> torch.Tensor:
    """(32, N) int32 byte rows (bit 7 of row 31 cleared) -> (NLIMBS, N)
    radix-2^13 limbs. The value may exceed p (ZIP-215 non-canonical y)."""
    b = torch.cat([b, torch.zeros_like(b[:2])], dim=0)
    limbs = []
    for i in range(F.NLIMBS):
        s = F.RADIX * i
        b0 = s >> 3
        v = b[b0] + (b[b0 + 1] << 8) + (b[b0 + 2] << 16)
        limbs.append((v >> (s & 7)) & F.MASK)
    return torch.stack(limbs, dim=0)


def _norm8(x: torch.Tensor, passes: int) -> torch.Tensor:
    """Radix-2^8 carry/borrow propagation for `passes` rounds: lower
    limbs land in [0, 2^8), the top limb keeps the value's sign."""
    zero = torch.zeros_like(x[:1])
    for _ in range(passes):
        c = x[:-1] >> 8
        x = torch.cat([x[:-1] - (c << 8), x[-1:]], dim=0)
        x = x + torch.cat([zero, c], dim=0)
    return x


def _mul_c8(a: torch.Tensor, width: int) -> torch.Tensor:
    """(ka, N) signed radix-2^8 limbs x 16*delta -> (width, N) raw
    convolution (partial sums < 2^22)."""
    ka = a.shape[0]
    acc = None
    for i, c in enumerate(_C8):
        t = torch.nn.functional.pad(a * c, (0, 0, i, width - i - ka))
        acc = t if acc is None else acc + t
    return acc


def _mod_l_dev(d: torch.Tensor) -> torch.Tensor:
    """(64, N) int32 digest byte rows (LE) -> (32, N) canonical byte rows
    of the value mod L: three folds of the high half with
    2^256 = -16*delta (mod L), then an approximate quotient by the top
    bits and conditional +L fixes (bounds in the JAX counterpart)."""
    x = d
    for split, width in ((32, 50), (32, 35)):
        lo = torch.nn.functional.pad(x[:split], (0, 0, 0, width - split))
        x = _norm8(lo - _mul_c8(x[split:], width), 2)
    x = _norm8(x, 36)
    lo = torch.nn.functional.pad(x[:32], (0, 0, 0, 1))
    x = _norm8(lo - _mul_c8(x[32:], 33), 34)
    l8_33 = _col(_L8 + [0], d.device)
    neg = (x[32] < 0).to(torch.int32)
    x = x + neg[None, :] * l8_33
    x = _norm8(x, 34)
    q = (x[31] >> 4) + (x[32] << 4)
    x = x - q[None, :] * l8_33
    x = _norm8(x, 34)
    neg = (x[32] < 0).to(torch.int32)
    x = x + neg[None, :] * l8_33
    return _norm8(x, 34)[:32]


def _lt_const_dev(rows: torch.Tensor, const8: list) -> torch.Tensor:
    """(32, N) canonical byte rows (LE) -> (N,) bool: value < const."""
    lt = torch.zeros(rows.shape[1], dtype=torch.bool, device=rows.device)
    decided = torch.zeros_like(lt)
    for i in range(31, -1, -1):
        lo = rows[i] < const8[i]
        hi = rows[i] > const8[i]
        lt = lt | (~decided & lo)
        decided = decided | lo | hi
    return lt


def _s_lt_l_dev(s: torch.Tensor) -> torch.Tensor:
    """(32, N) byte rows of S -> (N,) bool: S < L (ZIP-215 rule 2)."""
    return _lt_const_dev(s, _L8)


def _nibbles_dev(b: torch.Tensor) -> torch.Tensor:
    """(32, N) byte rows -> (64, N) radix-16 digits, LE."""
    return torch.stack([b & 0x0F, b >> 4], dim=1).reshape(64, b.shape[1])


def _verify_tile(pk_b, sig_b, dig_b, dual_fn=None) -> torch.Tensor:
    """The whole check as plain torch ops, the plain version of kernel
    K2: pk_b (32, N), sig_b (64, N) uint8/int32 byte rows, dig_b (64, N)
    SHA-512(R||A||M) rows -> (N,) bool. `dual_fn` swaps in kernel K1
    (the hybrid program)."""
    pk = pk_b.to(torch.int32)
    sig = sig_b.to(torch.int32)
    dig = dig_b.to(torch.int32)
    signA = pk[31] >> 7
    topclear = _col([0xFF] * 31 + [0x7F], pk.device)
    pk = pk & topclear
    r = sig[:32]
    signR = r[31] >> 7
    r = r & topclear
    s = sig[32:]
    yA = _fe_from_bytes_dev(pk)
    yR = _fe_from_bytes_dev(r)
    s_ok = _s_lt_l_dev(s)
    dS = _nibbles_dev(s)
    dk = _nibbles_dev(_mod_l_dev(dig))
    ok = _scalar_mult_check(yA, signA, yR, signR, dS, dk, dual_fn=dual_fn)
    return ok & s_ok


def verify_hybrid(pk_b, sig_b, dig_b) -> torch.Tensor:
    """The hybrid program: plain preparation and compare around kernel
    K1 (counterpart: ed25519_pallas.verify_hybrid). On a CPU tensor K1's
    wrapper takes its plain version, so this equals _verify_tile."""
    from .ed25519_cuda import dual_mult

    return _verify_tile(pk_b, sig_b, dig_b, dual_fn=dual_mult)


# -- host packing --


def _round16(k: int) -> int:
    return -(-k // 16) * 16


class Window(NamedTuple):
    """One batch on the device (Ed25519Verifier.upload)."""

    pk_b: torch.Tensor  # (32, B) uint8
    sig_b: torch.Tensor  # (64, B) uint8
    msg: torch.Tensor  # flat uint8, 16-byte aligned, length a multiple of 16
    offsets: torch.Tensor  # (B + 1,) int32 into msg
    max_len: int  # the longest message
    size_ok: np.ndarray  # (n,) bool, host


def size_mask(pubkeys, sigs):
    """(size_ok (n,) bool, pubkeys, sigs) with every triple of a
    malformed size given all-zero rows, so that a batch of any content
    packs; its lanes are masked by size_ok after the fact."""
    size_ok = np.array(
        [len(pk) == 32 and len(sig) == 64 for pk, sig in zip(pubkeys, sigs)],
        dtype=bool,
    )
    if not size_ok.all():
        pubkeys = [pk if ok else bytes(32) for pk, ok in zip(pubkeys, size_ok)]
        sigs = [sig if ok else bytes(64) for sig, ok in zip(sigs, size_ok)]
    return size_ok, pubkeys, sigs


class BucketedVerifier:
    """What the ed25519 and sr25519 batch verifiers share: the device
    (CUDA by default, raising when there is none; the tests pass
    device="cpu", which runs the plain versions), the program ("tile"
    for the whole-check kernel, "hybrid" for kernel K1 inside plain
    torch), the bucket sizes, verify() and gather(). Subclasses give
    dispatch(), which only enqueues device work."""

    def __init__(
        self,
        bucket_sizes: Optional[Sequence[int]] = None,
        device="cuda",
        program: str = "tile",
    ) -> None:
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"{type(self).__name__}: CUDA is not available "
                "(pass device='cpu' for the plain version)"
            )
        if program not in PROGRAMS:
            raise ValueError(f"program must be one of {PROGRAMS}")
        self.program = program
        self.bucket_sizes = sorted(bucket_sizes or DEFAULT_BUCKET_SIZES)

    def dispatch(self, pubkeys, msgs, sigs):
        """Enqueue one batch; returns the handle for gather()."""
        raise NotImplementedError

    @staticmethod
    def _pack_rows(buf: np.ndarray, bucket: int, parts) -> None:
        """Write each (first row, items, width) part into the flat host
        buffer as `width` byte rows of `bucket` lanes from row `first row`
        on, batch axis minor: item i in lane i, the lanes past the items
        left as they are (zero)."""
        for rows, items, k in parts:
            n = len(items)
            cols = np.frombuffer(b"".join(items), np.uint8).reshape(n, k)
            view = buf[rows * bucket : (rows + k) * bucket]
            view.reshape(k, bucket)[:, :n] = cols.T

    def verify(self, pubkeys, msgs, sigs) -> np.ndarray:
        """Bool bitmap, one entry per triple; malformed sizes are
        reported invalid rather than raising."""
        return self.gather(self.dispatch(pubkeys, msgs, sigs))

    def gather(self, handle) -> np.ndarray:
        """Wait for a dispatch() handle and return the bitmap."""
        ok, n, size_ok = handle
        if ok is None:
            return size_ok
        return ok.cpu().numpy()[:n] & size_ok


class Ed25519Verifier(BucketedVerifier):
    """Bucketed ed25519 batch verifier on one device: kernel X1 for the
    digests, then K2 for the whole check ("tile") or plain torch around
    kernel K1 ("hybrid")."""

    def _run(self, pk, sig, dig) -> torch.Tensor:
        if self.program == "hybrid":
            return verify_hybrid(pk, sig, dig)
        from .ed25519_cuda import verify_tile

        return verify_tile(pk, sig, dig)

    def dispatch(self, pubkeys, msgs, sigs):
        """Enqueue one batch; returns the handle for gather()."""
        n = len(pubkeys)
        if n == 0:
            return (None, 0, np.zeros(0, dtype=bool))
        pk_b, sig_b, dig_b, size_ok = self.pack(pubkeys, msgs, sigs)
        return (self._run(pk_b, sig_b, dig_b), n, size_ok)

    def pack(self, pubkeys, msgs, sigs):
        """The device inputs of one non-empty batch: (pk_b (32, B),
        sig_b (64, B), dig_b (64, B)) uint8 rows padded with zero lanes
        to the bucket B, and the host (n,) size_ok mask. Malformed sizes
        become zero rows, masked after the fact. dig_b is one launch of
        kernel X1 over upload()'s buffers."""
        w = self.upload(pubkeys, msgs, sigs)
        dig_b = sha512_ragged(w.sig_b, w.pk_b, w.msg, w.offsets, w.max_len)
        return w.pk_b, w.sig_b, dig_b, w.size_ok

    def upload(self, pubkeys, msgs, sigs) -> "Window":
        """One non-empty batch on the device, in one host-to-device copy:
        pk and sig byte rows padded with zero lanes to the bucket B (lanes
        of malformed size as zero rows), the messages as one flat buffer
        with B + 1 int32 offsets (padding lanes of length 0), as
        sha512_ragged takes them."""
        n = len(pubkeys)
        size_ok, pubkeys, sigs = size_mask(pubkeys, sigs)
        bucket = bucket_for(n, self.bucket_sizes)
        lens = np.fromiter(map(len, msgs), dtype=np.int64, count=n)
        offsets = np.zeros(bucket + 1, dtype=np.int32)
        np.cumsum(lens, out=offsets[1 : n + 1])
        offsets[n + 1 :] = offsets[n]
        total = int(offsets[n])
        # [pk rows | sig rows | offsets | messages], each part 16-byte
        # aligned and the messages padded to 16 bytes (the kernel's loads)
        at_off = 96 * bucket
        at_msg = _round16(at_off + 4 * (bucket + 1))
        buf = np.zeros(at_msg + _round16(total), dtype=np.uint8)
        self._pack_rows(buf, bucket, ((0, pubkeys, 32), (32, sigs, 64)))
        buf[at_off : at_off + 4 * (bucket + 1)] = offsets.view(np.uint8)
        buf[at_msg : at_msg + total] = np.frombuffer(b"".join(msgs), np.uint8)
        dev = torch.from_numpy(buf).to(self.device)
        return Window(
            pk_b=dev[: 32 * bucket].view(32, bucket),
            sig_b=dev[32 * bucket : at_off].view(64, bucket),
            msg=dev[at_msg:],
            offsets=dev[at_off : at_off + 4 * (bucket + 1)].view(torch.int32),
            max_len=int(lens.max()),
            size_ok=size_ok,
        )
