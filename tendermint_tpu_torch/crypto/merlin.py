"""Merlin transcripts over STROBE-128 (Keccak-f[1600]), on the host.

Counterpart: tendermint_tpu/crypto/merlin.py (`_keccak_f_py` :77,
`_Strobe128` :124, `Transcript` :227). The Fiat-Shamir transcript of
schnorrkel/sr25519 (merlin spec: merlin.cool, STROBE spec:
strobe.sourceforge.io), in Python: the tests' reference for the native C
transcript that computes every signature's challenge, signing's
(native.sr25519_challenge) and the device path's, a window in one call
(native.sr25519_challenge_batch through crypto/sr25519.challenge_rows).

The permutation is written once, `keccak_f`: numpy over a group of G
states at a time, the 25 lanes as a (25, G) uint64 array, 24 rounds of
whole-array operations and no loop over rows. A transcript is a group of
one. `_keccak_f_py`, the per-state pure-Python permutation, is kept as
the oracle the tests hold `keccak_f` against.
"""

from __future__ import annotations

import struct

import numpy as np

__all__ = ["Transcript", "keccak_f"]

# -- Keccak-f[1600] ---------------------------------------------------------

_ROUNDS = 24
_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]
# rotation offsets r[x][y]
_ROT = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]
_MASK = (1 << 64) - 1


def _rotl(v: int, n: int) -> int:
    return ((v << n) | (v >> (64 - n))) & _MASK


def _keccak_f_py(state: bytearray) -> None:
    """In-place permutation of one 200-byte state (lanes LE u64), one
    lane at a time in Python ints: the oracle for keccak_f."""
    lanes = list(struct.unpack("<25Q", state))
    A = [[lanes[x + 5 * y] for y in range(5)] for x in range(5)]
    for rnd in range(_ROUNDS):
        # theta
        C = [A[x][0] ^ A[x][1] ^ A[x][2] ^ A[x][3] ^ A[x][4] for x in range(5)]
        D = [C[(x - 1) % 5] ^ _rotl(C[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            for y in range(5):
                A[x][y] ^= D[x]
        # rho + pi
        B = [[0] * 5 for _ in range(5)]
        for x in range(5):
            for y in range(5):
                B[y][(2 * x + 3 * y) % 5] = _rotl(A[x][y], _ROT[x][y])
        # chi
        for x in range(5):
            for y in range(5):
                A[x][y] = B[x][y] ^ ((~B[(x + 1) % 5][y]) & B[(x + 2) % 5][y])
        # iota
        A[0][0] ^= _RC[rnd]
    out = [A[x % 5][x // 5] for x in range(25)]
    state[:] = struct.pack("<25Q", *[v & _MASK for v in out])


# Lane i = x + 5 y. rho + pi moves lane (x, y), rotated by r[x][y], to
# (y, 2x + 3y): destination j reads source _PI_SRC[j], rotated _PI_ROT[j].
_PI_SRC = np.zeros(25, dtype=np.intp)
_PI_ROT = np.zeros((25, 1), dtype=np.uint64)
for _x in range(5):
    for _y in range(5):
        _j = _y + 5 * ((2 * _x + 3 * _y) % 5)
        _PI_SRC[_j] = _x + 5 * _y
        _PI_ROT[_j, 0] = _ROT[_x][_y]
_PI_UNROT = (np.uint64(64) - _PI_ROT) & np.uint64(63)  # 0 stays 0
# chi: lane (x, y) reads (x + 1, y) and (x + 2, y)
_CHI1 = np.array([(i % 5 + 1) % 5 + 5 * (i // 5) for i in range(25)])
_CHI2 = np.array([(i % 5 + 2) % 5 + 5 * (i // 5) for i in range(25)])
_RC_NP = np.array(_RC, dtype=np.uint64)
_ONE = np.uint64(1)
_SIXTY_THREE = np.uint64(63)


def keccak_f(states: np.ndarray) -> np.ndarray:
    """Keccak-f[1600] of G states at once: (G, 200) uint8 in, the
    permuted (G, 200) uint8 out (a new array). Every operation writes
    into a preallocated buffer: at G ~ 2000 the time is memory passes."""
    g = states.shape[0]
    a = np.ascontiguousarray(states).view("<u8").T.copy()  # (25, G)
    a3 = a.reshape(5, 5, g)  # [y][x]
    b, t1, t2 = np.empty_like(a), np.empty_like(a), np.empty_like(a)
    c = np.empty((5, g), dtype=np.uint64)  # C[x]
    d, r = np.empty_like(c), np.empty_like(c)
    for rnd in range(_ROUNDS):
        # theta: D[x] = C[x - 1] ^ rotl(C[x + 1], 1)
        np.bitwise_xor(a3[0], a3[1], out=c)
        for y in (2, 3, 4):
            np.bitwise_xor(c, a3[y], out=c)
        np.left_shift(c, _ONE, out=d)
        np.right_shift(c, _SIXTY_THREE, out=r)
        np.bitwise_or(d, r, out=r)
        d[0] = c[4]
        d[1:] = c[:4]
        d[:4] ^= r[1:]
        d[4] ^= r[0]
        a3 ^= d[None]
        # rho + pi
        np.take(a, _PI_SRC, axis=0, out=b)
        np.left_shift(b, _PI_ROT, out=t1)
        np.right_shift(b, _PI_UNROT, out=t2)
        np.bitwise_or(t1, t2, out=b)
        # chi, iota
        np.take(b, _CHI1, axis=0, out=t1)
        np.invert(t1, out=t1)
        np.take(b, _CHI2, axis=0, out=t2)
        np.bitwise_and(t1, t2, out=t1)
        np.bitwise_xor(b, t1, out=a)
        a[0] ^= _RC_NP[rnd]
    return np.ascontiguousarray(a.T).view(np.uint8).reshape(g, 200)


def _keccak_f(state: bytearray) -> None:
    """In-place permutation of one 200-byte state: keccak_f on a group
    of one."""
    row = np.frombuffer(bytes(state), dtype=np.uint8).reshape(1, 200)
    state[:] = keccak_f(row).tobytes()


# -- STROBE-128 -------------------------------------------------------------

_R = 166  # rate for 128-bit security: 200 - 32 - 2
_FLAG_I = 1
_FLAG_A = 1 << 1
_FLAG_C = 1 << 2
_FLAG_M = 1 << 4
_FLAG_K = 1 << 5


def _initial_state() -> bytearray:
    st = bytearray(200)
    st[0:6] = bytes([1, _R + 2, 1, 0, 1, 96])
    st[6:18] = b"STROBEv1.0.2"
    _keccak_f(st)
    return st


_INIT = None  # computed once


class _Strobe128:
    """The subset of STROBE-128 that merlin's signing transcripts use:
    meta-AD, AD, PRF."""

    def __init__(self, protocol_label: bytes) -> None:
        global _INIT
        if _INIT is None:
            _INIT = _initial_state()
        self.state = bytearray(_INIT)
        self.pos = 0
        self.pos_begin = 0
        self.cur_flags = 0
        self.meta_ad(protocol_label, False)

    # operations

    def meta_ad(self, data: bytes, more: bool) -> None:
        self._begin_op(_FLAG_M | _FLAG_A, more)
        self._absorb(data)

    def ad(self, data: bytes, more: bool) -> None:
        self._begin_op(_FLAG_A, more)
        self._absorb(data)

    def prf(self, n: int, more: bool) -> bytes:
        self._begin_op(_FLAG_I | _FLAG_A | _FLAG_C, more)
        return self._squeeze(n)

    # internals

    def _begin_op(self, flags: int, more: bool) -> None:
        if more:
            if flags != self.cur_flags:
                raise ValueError("'more' must continue the same operation")
            return
        old_begin = self.pos_begin
        self.pos_begin = self.pos + 1
        self.cur_flags = flags
        self._absorb(bytes([old_begin, flags]))
        if (flags & (_FLAG_C | _FLAG_K)) and self.pos != 0:
            self._run_f()

    def _absorb(self, data: bytes) -> None:
        off = 0
        n = len(data)
        while off < n:
            take = min(n - off, _R - self.pos)
            p = self.pos
            chunk = data[off : off + take]
            cur = self.state[p : p + take]
            self.state[p : p + take] = (
                int.from_bytes(cur, "little")
                ^ int.from_bytes(chunk, "little")
            ).to_bytes(take, "little")
            self.pos += take
            off += take
            if self.pos == _R:
                self._run_f()

    def _squeeze(self, n: int) -> bytes:
        out = bytearray()
        while len(out) < n:
            take = min(n - len(out), _R - self.pos)
            p = self.pos
            out += self.state[p : p + take]
            self.state[p : p + take] = bytes(take)
            self.pos += take
            if self.pos == _R:
                self._run_f()
        return bytes(out)

    def _run_f(self) -> None:
        self.state[self.pos] ^= self.pos_begin
        self.state[self.pos + 1] ^= 0x04
        self.state[_R + 1] ^= 0x80
        _keccak_f(self.state)
        self.pos = 0
        self.pos_begin = 0


# -- merlin transcript ------------------------------------------------------

_MERLIN_LABEL = b"Merlin v1.0"


class Transcript:
    """merlin.Transcript: labeled append/challenge over STROBE-128."""

    def __init__(self, label: bytes) -> None:
        self._strobe = _Strobe128(_MERLIN_LABEL)
        self.append_message(b"dom-sep", label)

    def clone(self) -> "Transcript":
        t = object.__new__(Transcript)
        t._strobe = object.__new__(_Strobe128)
        t._strobe.state = bytearray(self._strobe.state)
        t._strobe.pos = self._strobe.pos
        t._strobe.pos_begin = self._strobe.pos_begin
        t._strobe.cur_flags = self._strobe.cur_flags
        return t

    def append_message(self, label: bytes, message: bytes) -> None:
        self._strobe.meta_ad(label, False)
        self._strobe.meta_ad(struct.pack("<I", len(message)), True)
        self._strobe.ad(message, False)

    def challenge_bytes(self, label: bytes, n: int) -> bytes:
        self._strobe.meta_ad(label, False)
        self._strobe.meta_ad(struct.pack("<I", n), True)
        return self._strobe.prf(n, False)
