"""A seeded ZIP-215 edge-case corpus of (pubkey, message, signature)
triples, for holding the device verifier against the host oracle.

The classes are those of tests/test_ops_ed25519.py in the JAX package:
valid signatures, corrupted signatures and messages, S >= L, a
non-canonical y (y >= p) for R, small-order and mixed-order A and R
(identity, order 2, order 4, order 8), an x = 0 encoding with the sign
bit set (rejected), and malformed sizes. The expected bitmap is the host
oracle's, ed25519_math.zip215_verify, with malformed sizes False.
"""

from __future__ import annotations

import hashlib
from typing import List, Tuple

from . import ed25519_math as em
from .ed25519 import PrivKeyEd25519

__all__ = ["corpus", "expected", "small_order_encodings"]

Triple = Tuple[bytes, bytes, bytes]


def small_order_encodings() -> List[bytes]:
    """Identity, order 2, both order-4 encodings, and an order-8 point
    with its negation, derived from the curve rather than hard-coded."""
    ident = bytes([1]) + bytes(31)
    small = [
        ident,
        int(em.P - 1).to_bytes(32, "little"),  # y = -1, order 2
        bytes(32),  # y = 0, order 4
        bytes(31) + bytes([0x80]),  # y = 0, the other root
    ]
    for y in range(2, 200):
        pt = em.decompress(int(y).to_bytes(32, "little"))
        if pt is None:
            continue
        t = em.scalar_mult(em.L, pt)  # lands in the 8-torsion
        if (
            em.compress(em.scalar_mult(4, t)) != ident
            and em.compress(em.scalar_mult(8, t)) == ident
        ):
            enc = em.compress(t)
            return small + [enc, enc[:31] + bytes([enc[31] ^ 0x80])]
    raise AssertionError("no order-8 torsion point found")


def _flip(b: bytes, i: int, mask: int) -> bytes:
    return b[:i] + bytes([b[i] ^ mask]) + b[i + 1 :]


def _signers(n: int, seed: int) -> List[PrivKeyEd25519]:
    return [
        PrivKeyEd25519.from_seed(
            hashlib.sha256(b"zip215-corpus-%d-%d" % (seed, i)).digest()
        )
        for i in range(n)
    ]


def corpus(n_valid: int = 16, seed: int = 0) -> List[Triple]:
    """The edge cases followed by valid signatures, `n_valid` signers in
    all (each edge class reuses the first signers' keys)."""
    privs = _signers(max(n_valid, 4), seed)
    pks = [p.pub_key().bytes() for p in privs]
    msgs = [
        b"corpus-%d-msg-%d" % (seed, i) * (1 + i % 3)
        for i in range(len(privs))
    ]
    sigs = [p.sign(m) for p, m in zip(privs, msgs)]
    out: List[Triple] = []
    # corrupted signature bytes (R and S halves) and a tampered message
    out.append((pks[0], msgs[0], _flip(sigs[0], 5, 0x01)))
    out.append((pks[1], msgs[1], _flip(sigs[1], 40, 0x10)))
    out.append((pks[2], b"tampered", sigs[2]))
    # S >= L: the curve equation still holds for S + L, the S < L rule
    # alone must reject; also S with the top bits set (recode carry out)
    s = int.from_bytes(sigs[3][32:], "little")
    high_s = (s + em.L).to_bytes(32, "little")
    out.append((pks[3], msgs[3], sigs[3][:32] + high_s))
    out.append((pks[3], msgs[3], sigs[3][:32] + b"\xff" * 32))
    # a public key that is not a curve point
    bad_pk = next(
        bytes(h)
        for h in (
            hashlib.sha256(b"not-a-point-%d" % j).digest() for j in range(64)
        )
        if em.decompress(h) is None
    )
    out.append((bad_pk, msgs[0], sigs[0]))
    # x = 0 with the sign bit set: y = 1 | sign (the "-0" identity)
    out.append((bytes([1]) + bytes(30) + bytes([0x80]), msgs[0], sigs[0]))
    # non-canonical y (y >= p) for R and A: y in [p, 2^255) that decode
    for y in range(em.P, em.P + 19):
        enc = int(y).to_bytes(32, "little")
        if em.decompress(enc) is not None:
            out.append((pks[0], msgs[0], enc + sigs[0][32:]))
            out.append((enc, msgs[0], bytes(32) + bytes(32)))
    # small-order A and R with S in {0, 1}, and an honest S with a
    # small-order R
    small = small_order_encodings()
    for a in small:
        for r in small:
            for s_int in (0, 1):
                s_b = int(s_int).to_bytes(32, "little")
                out.append((a, b"small-order", r + s_b))
    for r in small:
        out.append((pks[0], msgs[0], r + sigs[0][32:]))
    # mixed order: a key plus an order-8 component under the key's own
    # signature (k now hashes the mixed encoding): the cofactored check
    # must agree with the oracle
    tors = em.decompress(small[4])
    a_pt = em.decompress(pks[1])
    mixed = em.compress(em.point_add(a_pt, tors))
    out.append((mixed, msgs[1], sigs[1]))
    # malformed sizes
    out.append((pks[0][:31], msgs[0], sigs[0]))
    out.append((pks[1], msgs[1], sigs[1][:63]))
    out.extend(zip(pks[:n_valid], msgs[:n_valid], sigs[:n_valid]))
    return out


def expected(triples) -> List[bool]:
    """The host oracle's bitmap (malformed sizes are False)."""
    return [em.zip215_verify(pk, m, s) for pk, m, s in triples]
