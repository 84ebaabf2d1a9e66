"""The CUDA kernels' device code, built with the host C++ compiler.

ops/csrc/ed25519_device.cuh and sha512.cuh hold the per-item bodies of
kernels K1, K2 and X1 and include no CUDA header, so with the CUDA
qualifiers defined away a host compiler builds them into a small shared
library. That library runs each body over a batch, one column at a time,
and is held against the host ZIP-215 oracle, hashlib and the plain
PyTorch versions. It checks the kernels' arithmetic, limbs, constants
and byte layout here; that they compile for sm_90a and launch is shown
on the card (chip_smoke.py). Tolerance: zero (exact bitmaps, digests and
projective points).
"""

import ctypes
import hashlib
import pathlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

from tendermint_tpu_torch.crypto import zip215_corpus
from tendermint_tpu_torch.ops import ed25519_kernel as K
from tendermint_tpu_torch.ops import edwards as E
from tendermint_tpu_torch.ops import field25519 as F

CSRC = pathlib.Path(__file__).resolve().parents[1] / "tendermint_tpu_torch" / "ops" / "csrc"

HARNESS = r"""
#define __device__
#define __constant__
#define __forceinline__ inline
#include "ed25519_device.cuh"
#include "sha512.cuh"

extern "C" {
// (k, n) byte rows, batch-minor, as the kernels read them
void host_verify(const uint8_t *pk, const uint8_t *sig, const uint8_t *dig,
                 bool *out, int n) {
  for (int i = 0; i < n; i++) {
    uint8_t a[32], s[64], d[64];
    for (int j = 0; j < 32; j++) a[j] = pk[(size_t)j * n + i];
    for (int j = 0; j < 64; j++) {
      s[j] = sig[(size_t)j * n + i];
      d[j] = dig[(size_t)j * n + i];
    }
    out[i] = ed25519_verify_one(a, s, d);
  }
}
void host_sha512(const uint8_t *data, uint8_t *out, int len, int n) {
  for (int i = 0; i < n; i++) sha512_row(data, out, len, n, i);
}
void host_dual_mult(const int32_t *a, const int32_t *ds, const int32_t *dk,
                    int32_t *out, int n) {
  for (int i = 0; i < n; i++) ed25519_dual_mult_one(a, ds, dk, out, n, i);
}
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++") or shutil.which("clang++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the device headers with")
    d = tmp_path_factory.mktemp("csrc_host")
    src = d / "harness.cpp"
    src.write_text(HARNESS)
    so = d / "libharness.so"
    subprocess.run(
        [cxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-I", str(CSRC),
         "-o", str(so), str(src)],
        check=True,
        capture_output=True,
        timeout=300,
    )
    return ctypes.CDLL(str(so))


@pytest.fixture(scope="module")
def corpus():
    return zip215_corpus.corpus(16, seed=1)


def _ptr(a: np.ndarray):
    assert a.flags.c_contiguous
    return ctypes.c_void_p(a.ctypes.data)


def test_verify_body_matches_oracle_and_plain(lib, corpus):
    triples = corpus
    want = zip215_corpus.expected(triples)
    size_ok = np.array([len(p) == 32 and len(s) == 64 for p, _m, s in triples])
    tr = [
        (p, m, s) if ok else (bytes(32), m, bytes(64))
        for (p, m, s), ok in zip(triples, size_ok)
    ]
    pad = 5  # all-zero lanes must not fault, and match the plain version
    pk = K._join_cols([p for p, _m, _s in tr], 32, pad)
    sig = K._join_cols([s for _p, _m, s in tr], 64, pad)
    dig = K._join_cols(
        [hashlib.sha512(s[:32] + p + m).digest() for p, m, s in tr], 64, pad
    )
    n = pk.shape[1]
    out = np.zeros(n, dtype=np.bool_)
    lib.host_verify(_ptr(pk), _ptr(sig), _ptr(dig), _ptr(out), ctypes.c_int(n))
    assert (out[: len(tr)] & size_ok).tolist() == want
    plain = K._verify_tile(torch.from_numpy(pk), torch.from_numpy(sig), torch.from_numpy(dig))
    assert np.array_equal(out, plain.numpy())


@pytest.mark.parametrize("m", [0, 47, 48, 111, 112, 175, 176, 239])
def test_sha512_body_matches_hashlib(lib, m):
    rng = np.random.default_rng(m)
    n = 5
    data = rng.integers(0, 256, (64 + m, n), dtype=np.uint8)
    out = np.zeros((64, n), dtype=np.uint8)
    lib.host_sha512(_ptr(data), _ptr(out), ctypes.c_int(64 + m), ctypes.c_int(n))
    for i in range(n):
        assert out[:, i].tobytes() == hashlib.sha512(data[:, i].tobytes()).digest()


def test_dual_mult_body_matches_plain_with_canonical_limbs(lib, corpus):
    """The JAX contract at K1's interface: loose 13-bit limbs in (as the
    plain decompression leaves them), canonical 13-bit limbs out."""
    triples = corpus[-8:]
    pk = torch.from_numpy(K._join_cols([p for p, _m, _s in triples], 32, 0)).int()
    topclear = K._col([0xFF] * 31 + [0x7F], "cpu")
    A, _ok = E.decompress(K._fe_from_bytes_dev(pk & topclear), pk[31] >> 7)
    A = A.contiguous()
    n = A.shape[-1]
    rng = np.random.default_rng(3)
    ds = rng.integers(0, 16, (64, n), dtype=np.int32)
    dk = rng.integers(0, 16, (64, n), dtype=np.int32)
    a = A.numpy()
    out = np.zeros((3, 20, n), dtype=np.int32)
    lib.host_dual_mult(_ptr(a), _ptr(ds), _ptr(dk), _ptr(out), ctypes.c_int(n))
    assert ((out >= 0) & (out < 8192)).all()
    got = torch.from_numpy(out)
    plain = K.dual_mult_sb_minus_ka(A, torch.from_numpy(ds), torch.from_numpy(dk))
    for c in (0, 1):
        assert bool(F.eq(F.mul(got[c], plain[2]), F.mul(plain[c], got[2])).all())
