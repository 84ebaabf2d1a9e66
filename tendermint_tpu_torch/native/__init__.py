"""The port's native CPU plane: the C batch equation, built at first use.

Counterpart: tendermint_tpu/native/__init__.py:41-98 (`load`, `_build`),
:99-121 (`signbytes_lib`) and :139-256 (`ed25519_batch_lib`,
`ristretto_basemul`, `sr25519_challenge`). ed25519_batch.c,
keccakf_core.h and signbytes.c beside this module are copies of the JAX
package's, byte for byte but for a first comment naming the original
and, at the end of ed25519_batch.c, two functions of the port's own.
ed25519_batch.c holds the cofactored random-linear-combination batch
equation for ed25519 (ZIP-215) and sr25519 (schnorrkel over
ristretto255), with SHA-512 and merlin challenges computed in C, the
fixed-base ristretto multiply of sr25519 keygen and signing, and the
port's two: its Edwards twin tm_ed25519_basemul (`ed25519_basemul`),
which ed25519 keygen and signing use, as the JAX package signs ed25519
natively through OpenSSL (tendermint_tpu/crypto/ed25519.py:143-145),
and tm_sr25519_challenge_batch (`sr25519_challenge_batch`), the merlin
challenges of a whole window in one call. signbytes.c splices a
commit's CanonicalVote sign-bytes around each vote's timestamp
(types/canonical.py VoteSignTemplate.sign_bytes_batch).

Each library is compiled by the host C compiler ($CC, else `cc`; -O3
-funroll-loops -shared -fPIC) into `build/native/` at the repository
root, named by a digest of the source, the headers and the command, so
an edited source is rebuilt and concurrent processes (test workers)
converge on one file: each compiles to a temporary name and renames it
into place. Importing this module builds nothing. A build that fails
raises: there is no switch that turns the native plane off and no
Python fallback behind it. keccakf.c is not ported: the merlin
transcripts it served are computed in ed25519_batch.c.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

__all__ = [
    "BUILD_DIR",
    "ed25519_basemul",
    "ed25519_batch_lib",
    "ristretto_basemul",
    "signbytes_lib",
    "sr25519_challenge",
    "sr25519_challenge_batch",
]

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = SRC_DIR.parents[1] / "build" / "native"
FLAGS = ["-O3", "-funroll-loops", "-shared", "-fPIC"]

_lock = threading.Lock()
_LIB = None
_SIGNBYTES_LIB = None

_P = ctypes.c_char_p
_U64 = ctypes.c_uint64


def _build(name: str) -> Path:
    """Compile <name>.c into BUILD_DIR unless its digest's library is
    there; the library's path. Raises on a compiler failure."""
    src = SRC_DIR / f"{name}.c"
    cmd = [os.environ.get("CC", "cc"), *FLAGS]
    h = hashlib.sha256()
    for part in [src, *sorted(SRC_DIR.glob("*.h"))]:
        h.update(part.name.encode())
        h.update(part.read_bytes())
    h.update(" ".join(cmd).encode())
    out = BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [*cmd, "-o", tmp, str(src)],
            capture_output=True,
            text=True,
            timeout=300,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"native: {' '.join(cmd)} failed on {src.name} "
                f"(exit {proc.returncode}):\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def ed25519_batch_lib() -> ctypes.CDLL:
    """The batch-equation library with the argtypes of what the CPU
    verifiers call, built on first use:

    - tm_ed25519_batch_verify(pk, r, zb, a, z, n) -> 1 / 0 / -1 (the
      equation over precomputed scalars; n = 1 is one ZIP-215 verify);
    - tm_ed25519_verify_full(pks, sigs, msgs, offsets, rand16, n) and
      tm_sr25519_verify_full(...) -> 1 all valid / 0 invalid somewhere /
      -1 undecodable or out of memory;
    - tm_sr25519_challenge(pk, r, msg, mlen, out32);
    - tm_sr25519_challenge_batch(n, pks, rs, msgs, offsets, out) -> 0:
      n rows of 32 bytes, each tm_sr25519_challenge's;
    - tm_ristretto_basemul(scalar32, out32) -> 0;
    - tm_ed25519_basemul(scalar32, out32) -> 0.
    """
    global _LIB
    with _lock:
        if _LIB is None:
            lib = ctypes.CDLL(str(_build("ed25519_batch")))
            lib.tm_ed25519_batch_verify.argtypes = [_P] * 5 + [_U64]
            lib.tm_ed25519_batch_verify.restype = ctypes.c_int
            full = [_P, _P, _P, ctypes.POINTER(_U64), _P, _U64]
            for fn in (lib.tm_ed25519_verify_full, lib.tm_sr25519_verify_full):
                fn.argtypes = full
                fn.restype = ctypes.c_int
            lib.tm_sr25519_challenge.argtypes = [_P, _P, _P, _U64, _P]
            lib.tm_sr25519_challenge.restype = None
            lib.tm_sr25519_challenge_batch.argtypes = [
                _U64, _P, _P, _P, ctypes.c_void_p, ctypes.c_void_p,
            ]
            lib.tm_sr25519_challenge_batch.restype = ctypes.c_int
            for fn in (lib.tm_ristretto_basemul, lib.tm_ed25519_basemul):
                fn.argtypes = [_P, _P]
                fn.restype = ctypes.c_int
            _LIB = lib
        return _LIB


def signbytes_lib() -> ctypes.CDLL:
    """The sign-bytes assembler, built on first use:
    tm_vote_sign_bytes_batch(prefix, prefix_len, suffix, suffix_len,
    ts_tag, ts_ns, n, out, out_cap, lens) -> bytes written, or -1 when
    out_cap is too small (signbytes.c has the byte contract)."""
    global _SIGNBYTES_LIB
    with _lock:
        if _SIGNBYTES_LIB is None:
            lib = ctypes.CDLL(str(_build("signbytes")))
            fn = lib.tm_vote_sign_bytes_batch
            fn.argtypes = [
                _P, ctypes.c_long, _P, ctypes.c_long, ctypes.c_uint8,
                ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p,
                ctypes.c_long, ctypes.c_void_p,
            ]
            fn.restype = ctypes.c_long
            _SIGNBYTES_LIB = lib
        return _SIGNBYTES_LIB


def ristretto_basemul(scalar_le32: bytes) -> bytes:
    """encode(scalar B), scalar 32 little-endian bytes below L."""
    if len(scalar_le32) != 32:
        raise ValueError(f"scalar must be 32 bytes, got {len(scalar_le32)}")
    out = ctypes.create_string_buffer(32)
    ed25519_batch_lib().tm_ristretto_basemul(scalar_le32, out)
    return out.raw


def ed25519_basemul(scalar_le32: bytes) -> bytes:
    """The RFC 8032 encoding of scalar B, scalar 32 little-endian
    bytes."""
    if len(scalar_le32) != 32:
        raise ValueError(f"scalar must be 32 bytes, got {len(scalar_le32)}")
    out = ctypes.create_string_buffer(32)
    ed25519_batch_lib().tm_ed25519_basemul(scalar_le32, out)
    return out.raw


def sr25519_challenge(pub: bytes, r: bytes, msg: bytes) -> bytes:
    """The merlin signing-context challenge k of (pub, R, msg), 32
    little-endian bytes, reduced mod L."""
    if len(pub) != 32 or len(r) != 32:
        raise ValueError("pub and R must be 32 bytes each")
    out = ctypes.create_string_buffer(32)
    ed25519_batch_lib().tm_sr25519_challenge(pub, r, msg, len(msg), out)
    return out.raw


def sr25519_challenge_batch(pks: bytes, rs: bytes, msgs):
    """The merlin challenges of n = len(msgs) signatures in one C call,
    an (n, 32) uint8 array of little-endian scalars mod L, row i equal
    to sr25519_challenge(pk_i, R_i, msg_i). pks and rs are the n 32-byte
    keys and R's concatenated."""
    n = len(msgs)
    if len(pks) != 32 * n or len(rs) != 32 * n:
        raise ValueError("pks and rs must be 32 bytes a message each")
    offsets = np.zeros(n + 1, dtype=np.uint64)
    offsets[1:] = np.cumsum([len(m) for m in msgs], dtype=np.uint64)
    out = np.empty((n, 32), dtype=np.uint8)
    ed25519_batch_lib().tm_sr25519_challenge_batch(
        n, pks, rs, b"".join(msgs), offsets.ctypes.data, out.ctypes.data
    )
    return out
