"""A seeded sr25519 edge-case corpus of (pubkey, message, signature)
triples, for holding kernel X3 and its plain version against the host
oracle.

The classes are those of tests/test_ops_sr25519.py in the JAX package,
and more: valid signatures, the marker bit off, s = L, s = L - 1 with a
wrong R, a tampered message, another key, public keys and R that RFC
9496 decoding rejects (1, p, p + 2, all ones, and one encoding that fails
each of its checks alone: not canonical, negative, not square, t
negative, y = 0), all-zero public key and signature, the identity with
s = 0 (valid), and malformed sizes. The expected bitmap is the host oracle's,
PubKeySr25519.verify_signature_oracle, with malformed sizes False.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Optional, Tuple

from . import ristretto as rst
from .sr25519 import (
    PrivKeySr25519,
    PubKeySr25519,
    _challenge,
    _signing_transcript,
)

__all__ = ["corpus", "expected", "undecodable_encodings"]

Triple = Tuple[bytes, bytes, bytes]

P = rst.P


def _failures(enc: bytes) -> List[str]:
    """Every check of RFC 9496 decoding that enc fails (empty when it
    decodes), each evaluated as the device evaluates it, on the field
    element of the low 255 bits."""
    v = int.from_bytes(enc, "little")
    s = (v & ((1 << 255) - 1)) % P
    ss = s * s % P
    u1, u2 = (1 - ss) % P, (1 + ss) % P
    w = (-(rst.D * u1 % P * u1) - u2 * u2) % P
    was_square, invsqrt = rst._sqrt_ratio_m1(1, w * u2 * u2 % P)
    den_x = invsqrt * u2 % P
    x = rst._abs(2 * s * den_x % P)
    y = u1 * (invsqrt * den_x % P * w % P) % P
    checks = {
        "not canonical": v >= P,
        "negative": v & 1 == 1,
        "not square": not was_square,
        "t negative": rst._is_negative(x * y % P),
        "y zero": y == 0,
    }
    return [why for why, failed in checks.items() if failed]


def undecodable_encodings() -> Dict[str, bytes]:
    """Encodings decoding rejects: the JAX package's tests' (1, p, p + 2,
    all ones) and one that fails each check alone, among them an even
    value above p and a valid encoding with bit 255 set, which only the
    canonicity check rejects."""
    out = {
        "1": (1).to_bytes(32, "little"),
        "p": P.to_bytes(32, "little"),
        "p + 2": (P + 2).to_bytes(32, "little"),
        "all ones": b"\xff" * 32,
        "valid | 2^255": (
            int.from_bytes(rst.encode(rst.BASE), "little") | 1 << 255
        ).to_bytes(32, "little"),
    }
    alone = {}
    for v in list(range(2, 4000)) + [P - 1] + [P + k for k in range(19)]:
        enc = v.to_bytes(32, "little")
        why = _failures(enc)
        if len(why) == 1 and why[0] not in alone:
            alone[why[0]] = enc
    for why, enc in sorted(alone.items()):
        out[why + " alone"] = enc
    if len(alone) != 5:
        raise AssertionError(f"checks failed alone: {sorted(alone)}")
    for why, enc in out.items():
        if rst.decode(enc) is not None or not _failures(enc):
            raise AssertionError(f"{why}: {enc.hex()} decodes")
    return out


def _with_bit_255(enc: bytes) -> bytes:
    return enc[:31] + bytes([enc[31] | 0x80])


def _negated(enc: bytes) -> bytes:
    """p - s: odd, and decoded without the sign check it is s's point."""
    return (P - int.from_bytes(enc, "little")).to_bytes(32, "little")


def corpus(seed: int = 0) -> List[Triple]:
    """The edge cases, signed with keys and witnesses from the seed."""

    def h(*parts) -> bytes:
        tag = [b"sr-corpus", str(seed).encode(), *parts]
        return hashlib.sha256(b"|".join(tag)).digest()

    rng_state = [h(b"witness")]

    def rng(n: int) -> bytes:  # a seeded stand-in for os.urandom
        rng_state[0] = hashlib.sha256(rng_state[0]).digest()
        return rng_state[0][:n]

    privs = [PrivKeySr25519(h(b"key", bytes([i]))) for i in range(4)]
    pks = [p.pub_key().bytes() for p in privs]
    msgs = [b"sr25519 corpus %d " % i + b"x" * (37 * i) for i in range(4)]
    sigs = [p.sign(m, rng) for p, m in zip(privs, msgs)]
    out: List[Triple] = list(zip(pks, msgs, sigs))
    pk, msg, sig = pks[0], msgs[0], sigs[0]

    out.append((pk, msg, sig[:63] + bytes([sig[63] & 0x7F])))  # marker off
    l_bytes = bytearray(rst.L.to_bytes(32, "little"))
    l_bytes[31] |= 0x80
    out.append((pk, msg, sig[:32] + bytes(l_bytes)))  # s = L
    lm1 = bytearray((rst.L - 1).to_bytes(32, "little"))
    lm1[31] |= 0x80
    out.append((pk, msg, sigs[1][:32] + bytes(lm1)))  # s = L - 1, wrong R
    out.append((pk, msg + b"!", sig))  # tampered message
    out.append((pks[1], msg, sig))  # another key
    for enc in undecodable_encodings().values():
        out.append((enc, msg, sig))  # undecodable public key
        out.append((pk, msg, enc + sig[32:]))  # undecodable R
    # signed over another encoding of the same point: they verify only
    # where decoding wrongly accepts bit 255 set or a negative encoding
    priv = privs[2]
    for alt in (_with_bit_255, _negated):
        r, r_bytes = priv._witness(msg, rng)
        for pk_enc, r_enc in ((alt(pks[2]), r_bytes), (pks[2], alt(r_bytes))):
            k = _challenge(_signing_transcript(msg), pk_enc, r_enc)
            s_part = priv._finish(r, r_bytes, k)[32:]
            out.append((pk_enc, msg, r_enc + s_part))
    out.append((bytes(32), msg, bytes(64)))  # all zero
    identity = rst.encode((0, 1, 1, 0))
    out.append((identity, msg, identity + bytes(31) + b"\x80"))  # s = 0
    out.append((pk, msg, b"short"))  # malformed sizes
    out.append((pk[:31], msg, sig))
    out.append((pk, msg, sig + b"\x00"))
    return out


def expected(triples: List[Triple]) -> List[bool]:
    """The host oracle's bitmap; malformed sizes are False."""
    return [
        len(p) == 32
        and len(s) == 64
        and PubKeySr25519(p).verify_signature_oracle(m, s)
        for p, m, s in triples
    ]
