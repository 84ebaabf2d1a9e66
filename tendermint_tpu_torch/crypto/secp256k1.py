"""secp256k1 ECDSA keys, in pure Python.

Counterpart: tendermint_tpu/crypto/secp256k1.py (reference:
crypto/secp256k1/secp256k1.go): the constant-structure secret plane
(RCB15 complete formulas, `_ct_select`, branch-free low-s, :68-163),
the Jacobian and interleaved-wNAF Strauss/Shamir public plane
(:180-340), RFC 6979 nonces (:366), strict low-s verification, the
RIPEMD160(SHA256(pubkey)) address (:404-408), `verify_batch` and
`Secp256k1BatchVerifier` (:520-574). 33-byte compressed public keys,
64-byte r||s signatures.

Two arithmetic planes, split by what touches key material:

- secret plane (signing, public-key derivation): Renes-Costello-Batina
  2015 complete projective formulas for j-invariant-0 curves (Algorithm
  7 addition, Algorithm 9 doubling), straight-line code with no
  exceptional case, so the scalar multiplication has no branch on the
  secret, and a table entry is selected by an arithmetic mask, not an
  index;
- public plane (verification): branchy Jacobian formulas and an
  interleaved-wNAF u1*G + u2*Q multi-scalar multiply. All of it is
  published data.

There is no device path: the JAX package has none, and ECDSA admits no
random-linear-combination batch equation over r||s signatures (R's
y-coordinate is discarded). `verify_batch` is the Strauss/Shamir path a
signature, with the basepoint table shared and each public key
decompressed once a batch; crypto/batch.py registers
Secp256k1BatchVerifier as the key type's CPU factory, and no device
factory, so a Commit's secp256k1 signatures verify on the host while its
ed25519 and sr25519 ones go to the card. The address's RIPEMD-160 is
hashlib's, as in the JAX module: OpenSSL 3 keeps it in its default
provider since 3.0.7 (the H100's host has OpenSSL 3.0.13; chip_smoke.py
phase secp256k1 prints whether hashlib has it).
"""

from __future__ import annotations

import hashlib
import hmac as _hmac
import os
import threading
from typing import Dict, List, Optional, Sequence, Tuple

from .keys import Address, BatchVerifier, PrivKey, PubKey, register_key_type

__all__ = [
    "PubKeySecp256k1",
    "PrivKeySecp256k1",
    "Secp256k1BatchVerifier",
    "verify_batch",
    "KEY_TYPE",
]

KEY_TYPE = "secp256k1"
PUBKEY_SIZE = 33
SIGNATURE_LEN = 64

# Curve: y^2 = x^3 + 7 over F_P, prime group order N, generator G.
_P = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFC2F
_ORDER = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
_HALF_ORDER = _ORDER >> 1
_B3 = 21  # 3*b for the complete-formula b3 constant (b = 7)
_GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
_GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8

# projective identity for the complete formulas
_INF = (0, 1, 0)


# ---------------------------------------------------------------------------
# secret plane: complete projective formulas (RCB15, a=0), branch-free
# ---------------------------------------------------------------------------


def _ct_add(p: Tuple[int, int, int], q: Tuple[int, int, int]):
    """Complete projective addition (RCB15 Algorithm 7, b3=21).

    Straight-line: valid for every input pair including P+P, P+(-P),
    and the identity — the property that lets the secret-scalar ladder
    run with a fixed instruction trace."""
    x1, y1, z1 = p
    x2, y2, z2 = q
    t0 = x1 * x2 % _P
    t1 = y1 * y2 % _P
    t2 = z1 * z2 % _P
    t3 = (x1 + y1) * (x2 + y2) % _P
    t3 = (t3 - t0 - t1) % _P
    t4 = (y1 + z1) * (y2 + z2) % _P
    t4 = (t4 - t1 - t2) % _P
    x3 = (x1 + z1) * (x2 + z2) % _P
    y3 = (x3 - t0 - t2) % _P
    x3 = (t0 + t0 + t0) % _P
    t2 = _B3 * t2 % _P
    z3 = (t1 + t2) % _P
    t1 = (t1 - t2) % _P
    y3 = _B3 * y3 % _P
    out_x = (t3 * t1 - t4 * y3) % _P
    out_y = (y3 * x3 + t1 * z3) % _P
    out_z = (z3 * t4 + x3 * t3) % _P
    return out_x, out_y, out_z


def _ct_double(p: Tuple[int, int, int]):
    """Exception-free projective doubling (RCB15 Algorithm 9, a=0)."""
    x, y, z = p
    t0 = y * y % _P
    z3 = 8 * t0 % _P
    t1 = y * z % _P
    t2 = _B3 * (z * z) % _P
    x3 = t2 * z3 % _P
    y3 = (t0 + t2) % _P
    z3 = t1 * z3 % _P
    t2 = 3 * t2 % _P
    t0 = (t0 - t2) % _P
    y3 = (t0 * y3 + x3) % _P
    x3 = 2 * (t0 * (x * y % _P)) % _P
    return x3, y3, z3


def _ct_select(table, idx: int) -> Tuple[int, int, int]:
    """Constant-structure table lookup: scan every entry, keep the one
    whose index matches via an arithmetic mask. For j, idx in [0, 15]
    `((j ^ idx) - 1) >> 4` is -1 (all ones) exactly when j == idx and
    0 otherwise — no comparison, no branch, no secret index."""
    x = y = z = 0
    for j in range(16):
        mask = ((j ^ idx) - 1) >> 4
        ex, ey, ez = table[j]
        x |= ex & mask
        y |= ey & mask
        z |= ez & mask
    return x, y, z


_CT_BASE_TABLE: Optional[List[Tuple[int, int, int]]] = None
_ct_table_lock = threading.Lock()


def _ct_base_table() -> List[Tuple[int, int, int]]:
    """[O, G, 2G, ..., 15G] projective — public constants, built once
    with the same complete formulas (cheap: 15 adds)."""
    global _CT_BASE_TABLE
    with _ct_table_lock:
        if _CT_BASE_TABLE is None:
            g = (_GX, _GY, 1)
            tbl = [_INF, g]
            for _ in range(14):
                tbl.append(_ct_add(tbl[-1], g))
            _CT_BASE_TABLE = tbl
        return _CT_BASE_TABLE


def _ct_mul_base(k: int) -> Tuple[int, int, int]:
    """k*G with a fixed execution structure: 64 4-bit windows walked
    most-significant first, four doublings and one masked-table
    addition per window regardless of the scalar's bits. k is secret;
    the loop bound, the branch structure, and the table-scan order are
    not functions of it."""
    table = _ct_base_table()
    acc = _INF
    for i in range(63, -1, -1):
        acc = _ct_double(acc)
        acc = _ct_double(acc)
        acc = _ct_double(acc)
        acc = _ct_double(acc)
        acc = _ct_add(acc, _ct_select(table, (k >> (4 * i)) & 15))
    return acc


def _ct_to_affine(p: Tuple[int, int, int]) -> Tuple[int, int]:
    """Projective -> affine; the inverse is a 3-argument pow (Fermat)."""
    x, y, z = p
    zi = pow(z, _P - 2, _P)
    return x * zi % _P, y * zi % _P


# ---------------------------------------------------------------------------
# public plane: branchy Jacobian + Strauss/Shamir (verification only)
# ---------------------------------------------------------------------------

_JPoint = Optional[Tuple[int, int, int]]  # None = infinity


def _jac_double(p: _JPoint) -> _JPoint:
    if p is None:
        return None
    x, y, z = p
    if y == 0:
        return None
    a = x * x % _P
    b = y * y % _P
    c = b * b % _P
    d = 2 * ((x + b) * (x + b) - a - c) % _P
    e = 3 * a % _P
    x3 = (e * e - 2 * d) % _P
    y3 = (e * (d - x3) - 8 * c) % _P
    z3 = 2 * y * z % _P
    return x3, y3, z3


def _jac_add_affine(p: _JPoint, q: Tuple[int, int]) -> _JPoint:
    """Mixed Jacobian + affine addition (q has Z=1)."""
    x2, y2 = q
    if p is None:
        return (x2, y2, 1)
    x1, y1, z1 = p
    z1z1 = z1 * z1 % _P
    u2 = x2 * z1z1 % _P
    s2 = y2 * z1 * z1z1 % _P
    if u2 == x1:
        if s2 == y1:
            return _jac_double(p)
        return None
    h = (u2 - x1) % _P
    hh = h * h % _P
    i = 4 * hh % _P
    j = h * i % _P
    rr = 2 * (s2 - y1) % _P
    v = x1 * i % _P
    x3 = (rr * rr - j - 2 * v) % _P
    y3 = (rr * (v - x3) - 2 * y1 * j) % _P
    z3 = ((z1 + h) * (z1 + h) - z1z1 - hh) % _P
    return x3, y3, z3


def _batch_to_affine(points: Sequence[Tuple[int, int, int]]):
    """Montgomery-trick batch normalization: one field inversion for
    the whole table (public data; powers the wNAF precomputation)."""
    n = len(points)
    prefix = [1] * (n + 1)
    for i, (_, _, z) in enumerate(points):
        prefix[i + 1] = prefix[i] * z % _P
    inv_all = pow(prefix[n], _P - 2, _P)
    out: List[Tuple[int, int]] = [(0, 0)] * n
    for i in range(n - 1, -1, -1):
        x, y, z = points[i]
        zi = inv_all * prefix[i] % _P
        inv_all = inv_all * z % _P
        zi2 = zi * zi % _P
        out[i] = (x * zi2 % _P, y * zi2 * zi % _P)
    return out


def _wnaf(k: int, w: int) -> List[int]:
    """Width-w non-adjacent form, little-endian digits (odd or 0)."""
    digits: List[int] = []
    full = 1 << w
    half = full >> 1
    while k:
        if k & 1:
            d = k & (full - 1)
            if d >= half:
                d -= full
            k -= d
        else:
            d = 0
        digits.append(d)
        k >>= 1
    return digits


def _jac_add(p: _JPoint, q: _JPoint) -> _JPoint:
    """General Jacobian + Jacobian addition (public plane)."""
    if p is None:
        return q
    if q is None:
        return p
    x1, y1, z1 = p
    x2, y2, z2 = q
    z1z1 = z1 * z1 % _P
    z2z2 = z2 * z2 % _P
    u1 = x1 * z2z2 % _P
    u2 = x2 * z1z1 % _P
    s1 = y1 * z2 * z2z2 % _P
    s2 = y2 * z1 * z1z1 % _P
    if u1 == u2:
        if s1 != s2:
            return None
        return _jac_double(p)
    h = (u2 - u1) % _P
    i = 4 * h * h % _P
    j = h * i % _P
    rr = 2 * (s2 - s1) % _P
    v = u1 * i % _P
    x3 = (rr * rr - j - 2 * v) % _P
    y3 = (rr * (v - x3) - 2 * s1 * j) % _P
    z3 = ((z1 + z2) * (z1 + z2) - z1z1 - z2z2) * h % _P
    return x3, y3, z3


def _odd_multiples(point: Tuple[int, int], count: int):
    """[P, 3P, 5P, ...] as affine (batch-normalized), for wNAF tables.
    Valid curve points have prime order, so no chain element here is
    ever the identity."""
    p1 = (point[0], point[1], 1)
    twop = _jac_double(p1)
    jac: List[Tuple[int, int, int]] = [p1]
    for _ in range(count - 1):
        nxt = _jac_add(jac[-1], twop)
        if nxt is None:
            raise ArithmeticError("degenerate odd-multiple chain")
        jac.append(nxt)
    return _batch_to_affine(jac)


_G_WNAF_TABLE: Optional[List[Tuple[int, int]]] = None
_g_table_lock = threading.Lock()
_WNAF_W = 5  # window width: 8 odd multiples per table


def _g_wnaf_table() -> List[Tuple[int, int]]:
    global _G_WNAF_TABLE
    with _g_table_lock:
        if _G_WNAF_TABLE is None:
            _G_WNAF_TABLE = _odd_multiples((_GX, _GY), 1 << (_WNAF_W - 2))
        return _G_WNAF_TABLE


def _shamir(u1: int, u2: int, q: Tuple[int, int]) -> _JPoint:
    """u1*G + u2*Q by interleaved wNAF (Strauss/Shamir): one shared
    doubling chain, per-scalar sparse additions."""
    tg = _g_wnaf_table()
    tq = _odd_multiples(q, 1 << (_WNAF_W - 2))
    n1 = _wnaf(u1, _WNAF_W)
    n2 = _wnaf(u2, _WNAF_W)
    acc: _JPoint = None
    for i in range(max(len(n1), len(n2)) - 1, -1, -1):
        acc = _jac_double(acc)
        d1 = n1[i] if i < len(n1) else 0
        if d1:
            pt = tg[(d1 if d1 > 0 else -d1) >> 1]
            acc = _jac_add_affine(
                acc, pt if d1 > 0 else (pt[0], _P - pt[1])
            )
        d2 = n2[i] if i < len(n2) else 0
        if d2:
            pt = tq[(d2 if d2 > 0 else -d2) >> 1]
            acc = _jac_add_affine(
                acc, pt if d2 > 0 else (pt[0], _P - pt[1])
            )
    return acc


def _decompress(data: bytes) -> Optional[Tuple[int, int]]:
    """33-byte SEC1 compressed point -> affine, or None if invalid.
    Public data: pubkeys arrive on the wire."""
    if len(data) != PUBKEY_SIZE or data[0] not in (2, 3):
        return None
    x = int.from_bytes(data[1:], "big")
    if x >= _P:
        return None
    rhs = (x * x * x + 7) % _P
    y = pow(rhs, (_P + 1) >> 2, _P)
    if y * y % _P != rhs:
        return None  # x is not on the curve
    if (y & 1) != (data[0] & 1):
        y = _P - y
    return x, y


def _compress(x: int, y: int) -> bytes:
    return bytes([2 | (y & 1)]) + x.to_bytes(32, "big")


# ---------------------------------------------------------------------------
# RFC 6979 deterministic nonces
# ---------------------------------------------------------------------------


def _rfc6979_k(secret: bytes, h1: bytes) -> int:
    """HMAC-SHA256 deterministic nonce (RFC 6979 §3.2). qlen = hlen =
    256 bits, so bits2int is the identity and bits2octets is one mod."""
    z2 = (int.from_bytes(h1, "big") % _ORDER).to_bytes(32, "big")
    v = b"\x01" * 32
    key = b"\x00" * 32
    seed = secret + z2
    key = _hmac.new(key, v + b"\x00" + seed, hashlib.sha256).digest()
    v = _hmac.new(key, v, hashlib.sha256).digest()
    key = _hmac.new(key, v + b"\x01" + seed, hashlib.sha256).digest()
    v = _hmac.new(key, v, hashlib.sha256).digest()
    while True:
        v = _hmac.new(key, v, hashlib.sha256).digest()
        k = int.from_bytes(v, "big")
        if 1 <= k < _ORDER:  # rejection sampling per RFC 6979 §3.2: the retry event has probability ~2^-128 independent of long-term key bits
            return k
        key = _hmac.new(key, v + b"\x00", hashlib.sha256).digest()
        v = _hmac.new(key, v, hashlib.sha256).digest()


def _msg_scalar(msg: bytes) -> int:
    return int.from_bytes(hashlib.sha256(msg).digest(), "big") % _ORDER


# ---------------------------------------------------------------------------
# key classes
# ---------------------------------------------------------------------------


class PubKeySecp256k1(PubKey):
    __slots__ = ("_bytes", "_point")

    def __init__(self, data: bytes) -> None:
        if len(data) != PUBKEY_SIZE:
            raise ValueError(f"secp256k1 pubkey must be {PUBKEY_SIZE} bytes")
        self._bytes = bytes(data)
        self._point: Optional[Tuple[int, int]] = None  # lazy decompress

    def address(self) -> Address:
        sha = hashlib.sha256(self._bytes).digest()
        ripemd = hashlib.new("ripemd160")
        ripemd.update(sha)
        return ripemd.digest()

    def bytes(self) -> bytes:
        return self._bytes

    def type(self) -> str:
        return KEY_TYPE

    def point(self) -> Optional[Tuple[int, int]]:
        """Decompressed affine point, memoized (public data — the
        pubkey IS the wire encoding). None if the encoding is invalid."""
        if self._point is None:
            self._point = _decompress(self._bytes)
        return self._point

    def verify_signature(self, msg: bytes, sig: bytes) -> bool:
        if len(sig) != SIGNATURE_LEN:
            return False
        r = int.from_bytes(sig[:32], "big")
        s = int.from_bytes(sig[32:], "big")
        # Reject malleable (high-s) signatures like the reference
        # (crypto/secp256k1/secp256k1.go Verify requires normalized s).
        if s > _HALF_ORDER or r == 0 or s == 0:
            return False
        if r >= _ORDER:
            return False
        point = self.point()
        if point is None:
            return False
        e = _msg_scalar(msg)
        w = pow(s, _ORDER - 2, _ORDER)
        u1 = e * w % _ORDER
        u2 = r * w % _ORDER
        cap_r = _shamir(u1, u2, point)
        if cap_r is None:
            return False
        x, y, z = cap_r
        # affine x mod N == r, checked projectively: x == r * z^2 also
        # covers the (astronomically rare) r + N < P alias
        zz = z * z % _P
        if (r * zz - x) % _P == 0:
            return True
        alias = r + _ORDER
        return alias < _P and (alias * zz - x) % _P == 0


class PrivKeySecp256k1(PrivKey):
    __slots__ = ("_secret", "_d", "_pub")

    def __init__(self, data: bytes) -> None:
        if len(data) != 32:
            raise ValueError("secp256k1 privkey must be 32 bytes")
        d = int.from_bytes(data, "big")
        if not 1 <= d < _ORDER:  # scalar range check at key load rejects invalid keys; it reveals only validity, the same bit generate() conditions on
            raise ValueError("secp256k1 privkey scalar out of range")
        self._secret = bytes(data)
        self._d = d
        self._pub: Optional[PubKeySecp256k1] = None

    @classmethod
    def generate(cls) -> "PrivKeySecp256k1":
        while True:
            data = os.urandom(32)
            d = int.from_bytes(data, "big")
            if 1 <= d < _ORDER:  # rejection sampling at key birth (probability ~2^-128 of retry), standard for uniform scalars
                return cls(data)

    def bytes(self) -> bytes:
        return self._secret

    def sign(self, msg: bytes) -> bytes:
        """RFC 6979 deterministic ECDSA over SHA-256, low-s normalized.

        The nonce-secret path (k*G) runs entirely on the complete-
        formula ladder: fixed window count, masked table selection, no
        secret-dependent structure."""
        h1 = hashlib.sha256(msg).digest()
        e = int.from_bytes(h1, "big") % _ORDER
        extra = 0
        while True:
            k = _rfc6979_k(self._secret, h1) if extra == 0 else (
                _rfc6979_k(
                    self._secret + extra.to_bytes(4, "big"), h1
                )
            )
            x, _y = _ct_to_affine(_ct_mul_base(k))
            r = x % _ORDER
            s = pow(k, _ORDER - 2, _ORDER) * (e + r * self._d) % _ORDER
            if r != 0 and s != 0:  # r and s ARE the published signature; the zero test gates output validity (probability ~2^-256) and reveals nothing beyond the signature itself
                break
            extra += 1
        # low-s normalization, branch-free: flip = -1 iff s > N/2,
        # then an XOR-select between s and N-s
        flip = (_HALF_ORDER - s) >> 256
        s ^= (s ^ (_ORDER - s)) & flip
        return r.to_bytes(32, "big") + s.to_bytes(32, "big")

    def pub_key(self) -> PubKey:
        if self._pub is None:
            x, y = _ct_to_affine(_ct_mul_base(self._d))
            self._pub = PubKeySecp256k1(_compress(x, y))
        return self._pub

    def type(self) -> str:
        return KEY_TYPE


# ---------------------------------------------------------------------------
# batch verification (Strauss/Shamir path behind the plugin boundary)
# ---------------------------------------------------------------------------


def verify_batch(
    items: Sequence[Tuple[PubKeySecp256k1, bytes, bytes]],
) -> Tuple[bool, List[bool]]:
    """Verify a batch of (pubkey, msg, sig) triples.

    ECDSA's r||s encoding discards R's y-coordinate, so no sound
    random-linear-combination over the batch exists; the batch win is
    the shared Strauss/Shamir machinery — the module-level basepoint
    wNAF table and one decompression per distinct pubkey across the
    batch. Accept/reject is byte-identical to the single-verify loop
    (pinned by test)."""
    point_memo: Dict[bytes, Optional[Tuple[int, int]]] = {}
    bitmap: List[bool] = []
    for pk, msg, sig in items:
        raw = pk.bytes()
        if raw not in point_memo:
            point_memo[raw] = pk.point()
        if point_memo[raw] is None:
            bitmap.append(False)
            continue
        if pk._point is None:
            pk._point = point_memo[raw]
        bitmap.append(pk.verify_signature(msg, sig))
    return all(bitmap) if bitmap else False, bitmap


class Secp256k1BatchVerifier(BatchVerifier):
    """CPU batch verifier for secp256k1 behind the crypto.batch plugin
    boundary. Per-signature Strauss/Shamir with shared tables (see
    verify_batch); the exact-bitmap contract and one-shot drain match
    Ed25519BatchVerifier."""

    def __init__(self) -> None:
        self._items: List[Tuple[PubKeySecp256k1, bytes, bytes]] = []

    def add(self, pub_key: PubKey, message: bytes, signature: bytes) -> None:
        if not isinstance(pub_key, PubKeySecp256k1):
            raise TypeError("Secp256k1BatchVerifier requires secp256k1 keys")
        if len(signature) != SIGNATURE_LEN:
            raise ValueError("malformed signature size")
        self._items.append((pub_key, bytes(message), bytes(signature)))

    def verify(self) -> Tuple[bool, List[bool]]:
        """One-shot: drains the queue; a second verify() without new
        add()s returns (False, []) on every backend."""
        if not self._items:
            return False, []
        items, self._items = self._items, []
        return verify_batch(items)

    def __len__(self) -> int:
        return len(self._items)


register_key_type(KEY_TYPE, PubKeySecp256k1, proto_field=2)
