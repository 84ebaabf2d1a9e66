"""The CUDA kernels' device code, built with the host C++ compiler.

ops/csrc/ed25519_device.cuh, sr25519_device.cuh, sha512.cuh and
sha256.cuh hold the per-item bodies of kernels K1, K2, X3, X1, X4 and X5
and include no CUDA header,
so with the CUDA qualifiers defined away a host compiler builds them
into a small shared library. That library runs each body over a batch,
one column at a time, and is held against the host ZIP-215 and sr25519
oracles, hashlib and the plain PyTorch versions. It checks the kernels' arithmetic, limbs, constants
and byte layout here; that they compile for sm_90a and launch is shown
on the card (chip_smoke.py). Tolerance: zero (exact bitmaps, digests and
projective points).
"""

import ctypes
import hashlib
import pathlib
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from tendermint_tpu.ops import ed25519_kernel as JK
from tendermint_tpu_torch.crypto import merkle
from tendermint_tpu_torch.crypto import ristretto as rst
from tendermint_tpu_torch.crypto import sr25519_corpus, zip215_corpus
from tendermint_tpu_torch.ops import ed25519_kernel as K
from tendermint_tpu_torch.ops import edwards as E
from tendermint_tpu_torch.ops import field25519 as F
from tendermint_tpu_torch.ops import merkle_kernel as MK
from tendermint_tpu_torch.ops import sha256_kernel as S256
from tendermint_tpu_torch.ops import sha512_kernel as S
from tendermint_tpu_torch.ops import sr25519_kernel as SK

CSRC = pathlib.Path(__file__).resolve().parents[1] / "tendermint_tpu_torch" / "ops" / "csrc"

HARNESS = r"""
#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#include <ucontext.h>
#define __device__
#define __constant__
#define __forceinline__ inline

// The lanes of a signature (four for K1 and K2, X3_LANES for X3) as
// contexts on one host thread, run round-robin: every exchange deposits
// this lane's value and yields to the next lane, so a lane reads its
// source's deposit only after all lanes have reached the same exchange
// (lock-step, round by round). Two slot sets alternate, so the first lane
// through the next exchange cannot overwrite a value the others have yet
// to read. lane_shfl reads within the lane's four-lane segment (width 4),
// x3_shfl any lane of the signature (width X3_LANES), as on the card.
#define ED25519_HOST_LANES
#define HOST_MAX_LANES 16
static int g_lane, g_nlanes = 4;
static uint32_t g_slot[2][HOST_MAX_LANES];
static int g_parity[HOST_MAX_LANES];
static long g_rounds[HOST_MAX_LANES];
static ucontext_t g_ctx[HOST_MAX_LANES], g_main;
static char g_stack[HOST_MAX_LANES][1 << 18];

static uint32_t exchange(uint32_t v, int src) {
  const int l = g_lane, p = g_parity[l], next = (l + 1) % g_nlanes;
  g_slot[p][l] = v;
  g_parity[l] = p ^ 1;
  g_rounds[l]++;
  g_lane = next;
  swapcontext(&g_ctx[l], &g_ctx[next]);
  g_lane = l;
  return g_slot[p][src];
}
static inline int lane_id() { return g_lane & 3; }
static uint32_t lane_shfl(uint32_t v, int src) {
  return exchange(v, (g_lane & ~3) | (src & 3));
}
static inline void lane_sync() { exchange(0, 0); }
static inline int x3_lane() { return g_lane; }
static uint32_t x3_shfl(uint32_t v, int src) {
  return exchange(v, src & (g_nlanes - 1));
}

#include "ed25519_device.cuh"
#include "sha256.cuh"
#include "sha512.cuh"
#include "sr25519_device.cuh"

static void (*g_body)(void);
static void lane_entry(void) { g_body(); }

// runs body on n lanes; the exchanges they made, or -1 when the lanes
// made different numbers of them (they would not be in lock-step)
static long run_lanes(void (*body)(void), int n) {
  g_body = body;
  g_nlanes = n;
  for (int l = 0; l < n; l++) {
    getcontext(&g_ctx[l]);
    g_ctx[l].uc_stack.ss_sp = g_stack[l];
    g_ctx[l].uc_stack.ss_size = sizeof g_stack[l];
    g_ctx[l].uc_link = l < n - 1 ? &g_ctx[l + 1] : &g_main;
    makecontext(&g_ctx[l], lane_entry, 0);
    g_parity[l] = 0;
    g_rounds[l] = 0;
  }
  g_lane = 0;
  swapcontext(&g_main, &g_ctx[0]);
  for (int l = 1; l < n; l++)
    if (g_rounds[l] != g_rounds[0]) return -1;
  return g_rounds[0];
}

static struct {
  const uint8_t *pk, *sig, *dig, *k;
  const int32_t *a, *ds, *dk;
  bool *out;
  int32_t *out32;
  uint8_t *xy;
  int n, es, i;
  uint32_t tab[9 * 10 * 4];
} g;

static void verify_body(void) {
  ed25519_verify_lane(g.pk, g.sig, g.dig, g.out, g.n, g.es, g.i, g.tab, 4,
                      &GE_BASE_TABLE[0][0][0]);
}
static void sr_verify_body(void) {
  sr25519_verify_lane(g.pk, g.sig, g.k, g.out, g.n, g.es, g.i, g.tab, 4);
}
// every lane decodes column i of g.pk; lane 0 writes ok and the canonical
// x and y
static void sr_decode_body(void) {
  uint64_t w[4];
  load_words<4>(w, g.pk, 0, g.n, g.i, 1, true);
  ge_p3 p;
  const bool ok = ristretto_decode(p, w);
  fe_canonical(p.X);
  fe_canonical(p.Y);
  if (x3_lane() != 0) return;
  g.out[g.i] = ok;
  fe_to_words(w, p.X);
  memcpy(g.xy + 64 * g.i, w, 32);
  fe_to_words(w, p.Y);
  memcpy(g.xy + 64 * g.i + 32, w, 32);
}
static void dual_mult_body(void) {
  ed25519_dual_mult_lane(g.a, g.ds, g.dk, g.out32, g.n, g.i, g.tab, 4,
                         &GE_BASE_TABLE[0][0][0]);
}

// every signature of the blocks a launch of n would run, as the kernels
// run them, on `lanes` lanes each: the lanes of i >= n on zeros, writing
// nothing. Returns the exchanges of one signature, or -1.
static long run_blocks(void (*body)(void), int n, int lanes) {
  const int padded = (n + ED25519_SIGS_PER_BLOCK - 1) /
                     ED25519_SIGS_PER_BLOCK * ED25519_SIGS_PER_BLOCK;
  long rounds = 0;
  for (int i = 0; i < padded; i++) {
    g.i = i;
    const long r = run_lanes(body, lanes);
    if (r < 0 || (i > 0 && r != rounds)) return -1;
    rounds = r;
  }
  return rounds;
}

extern "C" {
// (k, n) byte rows, batch-minor, elements es bytes wide, as K2 reads them
long host_verify(const uint8_t *pk, const uint8_t *sig, const uint8_t *dig,
                 bool *out, int n, int es) {
  g.pk = pk; g.sig = sig; g.dig = dig; g.out = out; g.n = n; g.es = es;
  return run_blocks(verify_body, n, 4);
}
// X3's body, the same way: (32, n) pk, (64, n) sig and (32, n) k rows
long host_sr_verify(const uint8_t *pk, const uint8_t *sig, const uint8_t *k,
                    bool *out, int n, int es) {
  g.pk = pk; g.sig = sig; g.k = k; g.out = out; g.n = n; g.es = es;
  return run_blocks(sr_verify_body, n, X3_LANES);
}
// X3's ristretto decode, column by column of (32, n) uint8 rows, on
// X3_LANES lanes in lock-step: ok, and the canonical x and y as 32
// little-endian bytes each. Returns -1 when the lanes fell out of step.
long host_sr_decode(const uint8_t *enc, int n, bool *ok, uint8_t *xy) {
  g.pk = enc; g.n = n; g.out = ok; g.xy = xy;
  for (int i = 0; i < n; i++) {
    g.i = i;
    if (run_lanes(sr_decode_body, X3_LANES) < 0) return -1;
  }
  return 0;
}
long host_dual_mult(const int32_t *a, const int32_t *ds, const int32_t *dk,
                    int32_t *out, int n) {
  g.a = a; g.ds = ds; g.dk = dk; g.out32 = out; g.n = n;
  return run_blocks(dual_mult_body, n, 4);
}
void host_sha512(const uint8_t *data, uint8_t *out, int len, int n) {
  for (int i = 0; i < n; i++) sha512_row(data, out, len, n, i);
}
// X1's ragged launch, a block of SHA512_ROWS_PER_BLOCK rows at a time:
// every thread of the block stages its share of the block's span, then
// each row hashes R || A || M. The stage is filled with 0xA5 first, so a
// row reading bytes nobody staged gets them wrong. Returns -1 when a
// block's span does not fit the stage max_len sizes.
int host_sha512_ram(const uint8_t *sig, const uint8_t *pk, const uint8_t *msg,
                    const int32_t *off, uint8_t *out, int n, int max_len) {
  static sha_v16 stage[(SHA512_STAGE_BYTES(512) + 15) / 16];
  if (SHA512_STAGE_BYTES(max_len) > (int)sizeof stage) return -1;
  for (int r0 = 0; r0 < n; r0 += SHA512_ROWS_PER_BLOCK) {
    const int r1 = r0 + SHA512_ROWS_PER_BLOCK < n ? r0 + SHA512_ROWS_PER_BLOCK : n;
    memset(stage, 0xA5, sizeof stage);
    int a0 = 0;
    for (int t = 0; t < SHA512_ROWS_PER_BLOCK; t++)
      a0 = sha512_stage(msg, off[r0], off[r1], stage, t, SHA512_ROWS_PER_BLOCK,
                        SHA512_STAGE_CAP(max_len));
    if (a0 < 0) return -1;
    for (int i = r0; i < r1; i++)
      sha512_ram_row(sig, pk, n, i, (const uint8_t *)stage, off[i] - a0,
                     off[i + 1] - off[i], out);
  }
  return 0;
}
// X4: every thread of a launch of n rows, carry_tail's extra one too
void host_sha256_rows(const uint8_t *data, uint8_t *out, int len, int n,
                      int prefix, int carry_tail) {
  for (int i = 0; i <= n; i++)
    sha256_rows_item(data, out, len, n, prefix, carry_tail, i);
}
// X4's tree kernel on one thread (nt = 1), phase by phase as its blocks
// run them: each block's aligned subtree, then the blocks' roots
int host_sha256_tree(const uint8_t *leaves, uint8_t *root, int n) {
  alignas(16) static uint8_t a[SHA256_TREE_LEAVES * 16], b[SHA256_TREE_LEAVES * 16];
  const int nb = (n + SHA256_TREE_LEAVES - 1) / SHA256_TREE_LEAVES;
  const int up = (nb + 1) / 2;
  uint8_t *work = (uint8_t *)aligned_alloc(16, 32 * (nb + 2 * up) + 16);
  if (work == NULL) return -1;
  for (int blk = 0; blk < nb; blk++) {
    const int first = blk * SHA256_TREE_LEAVES;
    const int m = n - first < SHA256_TREE_LEAVES ? n - first : SHA256_TREE_LEAVES;
    memcpy(work + 32 * blk,
           sha256_tree_reduce(leaves + 32 * (size_t)first, a, b, m, 0, 1), 32);
  }
  memcpy(root, sha256_tree_reduce(work, work + 32 * nb, work + 32 * (nb + up), nb, 0, 1), 32);
  free(work);
  return 0;
}
// X5: every proof of a batch
void host_merkle_proofs(const uint8_t *leaf, const uint8_t *aunts,
                        const int32_t *off, const uint64_t *sides,
                        const uint8_t *want, const uint8_t *ok_in,
                        uint8_t *roots, uint8_t *ok, int k) {
  for (int i = 0; i < k; i++)
    merkle_proof_item(leaf, aunts, off, sides, want, ok_in, roots, ok, i);
}
// (m, 10) radix-2^25.5 limbs
void host_fe_mul(const uint32_t *f, const uint32_t *h, uint32_t *out, int m) {
  for (int i = 0; i < m; i++)
    fe_mul(*(fe *)(out + 10 * i), *(const fe *)(f + 10 * i),
           *(const fe *)(h + 10 * i));
}
void host_fe_sq(const uint32_t *f, uint32_t *out, int m) {
  for (int i = 0; i < m; i++)
    fe_sq(*(fe *)(out + 10 * i), *(const fe *)(f + 10 * i));
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
    dll = ctypes.CDLL(str(so))
    dll.host_verify.restype = ctypes.c_long
    dll.host_dual_mult.restype = ctypes.c_long
    dll.host_sr_verify.restype = ctypes.c_long
    dll.host_sr_decode.restype = ctypes.c_long
    dll.host_sha256_tree.restype = ctypes.c_int
    return dll


@pytest.fixture(scope="module")
def corpus():
    return zip215_corpus.corpus(16, seed=1)


def _join_cols(items, width, pad):
    """(width, n + pad) batch-minor byte rows, C-contiguous."""
    return np.ascontiguousarray(JK._join_cols(items, width, pad))


def _ptr(a: np.ndarray):
    assert a.flags.c_contiguous
    return ctypes.c_void_p(a.ctypes.data)


SIGS_PER_BLOCK = 16  # ED25519_SIGS_PER_BLOCK
SENTINEL = 7


def _verify_rows(triples, pad):
    """Byte rows of the triples (malformed sizes as zero rows, as the
    verifier packs them) and pad all-zero lanes, and the size mask."""
    size_ok = np.array([len(p) == 32 and len(s) == 64 for p, _m, s in triples])
    tr = [
        (p, m, s) if ok else (bytes(32), m, bytes(64))
        for (p, m, s), ok in zip(triples, size_ok)
    ]
    pk = _join_cols([p for p, _m, _s in tr], 32, pad)
    sig = _join_cols([s for _p, _m, s in tr], 64, pad)
    dig = _join_cols(
        [hashlib.sha512(s[:32] + p + m).digest() for p, m, s in tr], 64, pad
    )
    return pk, sig, dig, size_ok


def _host_verify(lib, pk, sig, dig):
    """The four-lane K2 body over every block a launch would run: (n,)
    bool. The lanes of the last block's signatures past n must write
    nothing, and the four lanes must exchange in lock-step."""
    n = pk.shape[1]
    padded = -(-n // SIGS_PER_BLOCK) * SIGS_PER_BLOCK
    out = np.full(padded, SENTINEL, dtype=np.uint8)
    rounds = lib.host_verify(
        _ptr(pk), _ptr(sig), _ptr(dig), _ptr(out), ctypes.c_int(n),
        ctypes.c_int(pk.itemsize),
    )
    assert rounds > 0, "the four lanes fell out of lock-step"
    assert (out[n:] == SENTINEL).all()
    assert np.isin(out[:n], (0, 1)).all()
    return out[:n].astype(bool)


def test_verify_body_matches_oracle_and_plain(lib, corpus):
    """The whole corpus and 5 all-zero padding lanes: 133 signatures, not
    a multiple of a block's 16, so the last block runs lanes past n."""
    want = zip215_corpus.expected(corpus)
    pad = 5  # all-zero lanes must not fault, and match the plain version
    pk, sig, dig, size_ok = _verify_rows(corpus, pad)
    assert pk.shape[1] % SIGS_PER_BLOCK
    out = _host_verify(lib, pk, sig, dig)
    assert (out[: len(corpus)] & size_ok).tolist() == want
    plain = K._verify_tile(torch.from_numpy(pk), torch.from_numpy(sig), torch.from_numpy(dig))
    assert np.array_equal(out, plain.numpy())


def test_verify_body_reads_int32_rows(lib, corpus):
    """The JAX contract's int32 byte rows (elements 4 bytes wide) give
    the uint8 rows' bitmap, at a ragged width of 37."""
    pk, sig, dig, _ok = _verify_rows(corpus[:35], 2)
    as_u8 = _host_verify(lib, pk, sig, dig)
    as_i32 = _host_verify(lib, *(a.astype(np.int32) for a in (pk, sig, dig)))
    assert np.array_equal(as_u8, as_i32)
    assert as_u8[:35].tolist() == zip215_corpus.expected(corpus[:35])


@pytest.mark.parametrize("m", [0, 47, 48, 111, 112, 175, 176, 239])
def test_sha512_body_matches_hashlib(lib, m):
    rng = np.random.default_rng(m)
    n = 5
    data = rng.integers(0, 256, (64 + m, n), dtype=np.uint8)
    out = np.zeros((64, n), dtype=np.uint8)
    lib.host_sha512(_ptr(data), _ptr(out), ctypes.c_int(64 + m), ctypes.c_int(n))
    for i in range(n):
        assert out[:, i].tobytes() == hashlib.sha512(data[:, i].tobytes()).digest()


def _aligned(nbytes: int) -> np.ndarray:
    """A zeroed uint8 buffer whose first byte is 16-byte aligned, its
    length rounded up to 16 (what X1's 16-byte loads need)."""
    size = -(-nbytes // 16) * 16
    raw = np.zeros(size + 16, dtype=np.uint8)
    shift = -raw.ctypes.data % 16
    return raw[shift : shift + size]


# 64 + M either side of the one/two/three-block edges (110-112, 174-176,
# 238-240... as M = 46-48, 111-112, 175-176), the commit's sign-bytes
# (116-118), empty and one-byte messages
RAGGED_LENS = [0, 1, 46, 47, 48, 111, 112, 116, 117, 118, 175, 176, 239, 240]


@pytest.mark.parametrize("lead", [0, 5])
def test_sha512_ram_body_matches_hashlib(lib, lead):
    """X1's ragged body, blocks of 32 rows staged as the kernel stages
    them: R and A from batch-minor sig/pk rows, the messages of one
    batch in all of RAGGED_LENS (shuffled, 3 rows each: the blocks'
    spans start at unaligned offsets), the first message `lead` bytes
    into the buffer, and 7 zero padding lanes of length 0 on zero rows
    (n = 49, so the last block is partly empty)."""
    rng = np.random.default_rng(40 + lead)
    lens = list(rng.permutation(RAGGED_LENS * 3))
    n = len(lens) + 7
    sig = np.zeros((64, n), dtype=np.uint8)
    pk = np.zeros((32, n), dtype=np.uint8)
    sig[:, : len(lens)] = rng.integers(0, 256, (64, len(lens)))
    pk[:, : len(lens)] = rng.integers(0, 256, (32, len(lens)))
    off = np.full(n + 1, lead, dtype=np.int32)
    off[1 : len(lens) + 1] += np.cumsum(lens)
    off[len(lens) + 1 :] = off[len(lens)]
    msg = _aligned(int(off[-1]))
    msg[lead : off[-1]] = rng.integers(0, 256, off[-1] - lead)
    out = np.zeros((64, n), dtype=np.uint8)
    rc = lib.host_sha512_ram(
        _ptr(sig), _ptr(pk), _ptr(msg), _ptr(off), _ptr(out), ctypes.c_int(n),
        ctypes.c_int(max(lens)),
    )
    assert rc == 0
    for i in range(n):
        m = msg[off[i] : off[i + 1]].tobytes()
        want = hashlib.sha512(sig[:32, i].tobytes() + pk[:, i].tobytes() + m)
        assert out[:, i].tobytes() == want.digest(), (i, len(m))
    plain = S.sha512_ragged(*(torch.from_numpy(a) for a in (sig, pk, msg, off)), max(lens))
    assert np.array_equal(out, plain.numpy())


def test_sha512_stage_refuses_a_span_longer_than_max_len(lib):
    """A block whose messages exceed the max_len its stage was sized by
    is refused (the kernel traps), not read past its shared memory."""
    n, long = 4, 300
    off = np.array([0, 10, 10 + long, 20 + long, 30 + long], dtype=np.int32)
    msg = _aligned(int(off[-1]))
    sig = np.zeros((64, n), dtype=np.uint8)
    pk = np.zeros((32, n), dtype=np.uint8)
    out = np.zeros((64, n), dtype=np.uint8)
    args = [_ptr(a) for a in (sig, pk, msg, off, out)] + [ctypes.c_int(n)]
    assert lib.host_sha512_ram(*args, ctypes.c_int(long)) == 0
    assert lib.host_sha512_ram(*args, ctypes.c_int(8)) == -1


def test_dual_mult_body_matches_plain_with_canonical_limbs(lib, corpus):
    """The JAX contract at K1's interface: loose 13-bit limbs in (as the
    plain decompression leaves them), canonical 13-bit limbs out; 11
    signatures, so five lanes of the block run past n."""
    triples = corpus[-11:]
    pk = torch.from_numpy(_join_cols([p for p, _m, _s in triples], 32, 0)).int()
    topclear = K._col([0xFF] * 31 + [0x7F], "cpu")
    A, _ok = E.decompress(K._fe_from_bytes_dev(pk & topclear), pk[31] >> 7)
    A = A.contiguous()
    n = A.shape[-1]
    rng = np.random.default_rng(3)
    ds = rng.integers(0, 16, (64, n), dtype=np.int32)
    dk = rng.integers(0, 16, (64, n), dtype=np.int32)
    a = A.numpy()
    out = np.zeros((3, 20, n), dtype=np.int32)
    rounds = lib.host_dual_mult(_ptr(a), _ptr(ds), _ptr(dk), _ptr(out), ctypes.c_int(n))
    assert rounds > 0, "the four lanes fell out of lock-step"
    assert ((out >= 0) & (out < 8192)).all()
    got = torch.from_numpy(out)
    plain = K.dual_mult_sb_minus_ka(A, torch.from_numpy(ds), torch.from_numpy(dk))
    for c in (0, 1):
        assert bool(F.eq(F.mul(got[c], plain[2]), F.mul(plain[c], got[2])).all())


P25519 = 2**255 - 19
# radix 2^25.5: limb k holds 26 bits at even k, 25 at odd
WIDTH = np.array([26 - (k & 1) for k in range(10)], dtype=np.uint64)
OFF = [sum(int(w) for w in WIDTH[:k]) for k in range(10)]


def _value(limbs) -> int:
    return sum(int(x) << OFF[k] for k, x in enumerate(limbs))


def test_fe_sq_equals_fe_mul(lib):
    """The dedicated squaring gives fe_mul(f, f)'s limbs exactly, on
    seeded carried field elements (every limb within its width), on limbs
    at their carried maximum, and on loose ones up to the bounds the
    group operations keep (a first operand of fe_mul up to 4x a limb's
    width, a second operand or a square up to 3x: the second is the one
    multiplied by 19 in 32 bits); the value is f^2 mod p (f g mod p for
    fe_mul) and the limbs out are carried."""
    rng = np.random.default_rng(5)

    def rows(k, seeded):
        top = (k << WIDTH) - 1
        return np.concatenate(
            [
                rng.integers(0, k << WIDTH, (seeded, 10)),
                top[None, :],
                np.where(np.arange(10) % 2 == 0, top, 0)[None, :],
                np.zeros((1, 10), dtype=np.uint64),
            ]
        ).astype(np.uint32)

    g = np.concatenate([rows(1, 200), rows(3, 100)])
    f = np.concatenate([rows(1, 200), rows(4, 100)])
    m = f.shape[0]
    sq = np.zeros_like(g)
    gg = np.zeros_like(g)
    fg = np.zeros_like(g)
    lib.host_fe_sq(_ptr(g), _ptr(sq), ctypes.c_int(m))
    lib.host_fe_mul(_ptr(g), _ptr(g), _ptr(gg), ctypes.c_int(m))
    lib.host_fe_mul(_ptr(f), _ptr(g), _ptr(fg), ctypes.c_int(m))
    assert np.array_equal(sq, gg)
    carried = (1 << WIDTH) + (1 << 18)
    for a, b, got_sq, got_fg in zip(f, g, sq, fg):
        va, vb = _value(a), _value(b)
        assert _value(got_sq) % P25519 == vb * vb % P25519
        assert _value(got_fg) % P25519 == va * vb % P25519
        assert (got_sq < carried).all() and (got_fg < carried).all()


def test_x3_comb_table_is_the_generators():
    """csrc/sr25519_comb.cuh is what ops/x3_comb.py generates, and its
    entries are [j 16^w]B of the host oracle, cached with Z = 1."""
    from tendermint_tpu_torch.crypto import ed25519_math as em
    from tendermint_tpu_torch.ops import x3_comb

    assert (CSRC / "sr25519_comb.cuh").read_text() == x3_comb.header_text()
    rows = x3_comb.entries()
    for w, j in [(0, 0), (0, 1), (5, 8), (63, 7)]:
        X, Y, Z, _T = em.scalar_mult(j * 16**w, em.B_POINT)
        zi = pow(Z, em.P - 2, em.P)
        x, y = X * zi % em.P, Y * zi % em.P
        assert rows[w][j] == ((y - x) % em.P, (y + x) % em.P, 2 * em.D * x * y % em.P)


def test_x3_variants_find_their_anchors():
    """ops/x3_variants.py builds X3's other designs from copies of the
    kernel's sources by text replacement: every anchor is in them once,
    the kernel's own design is the sources unchanged, each design has its
    lane count, the designs without the comb walk with K1's ge4_dual_mult
    over B's table in shared memory, the split designs replace fe_mul
    alone, and a missing anchor raises."""
    from tendermint_tpu_torch.ops import x3_variants as XV

    src = {f: (CSRC / f).read_text() for f in XV.SOURCES}
    assert XV.variant_sources(XV.SHIPPED, src) == src
    assert XV.SHIPPED in XV.CANDIDATES and "four" not in XV.CANDIDATES
    mul = src["ed25519_device.cuh"]
    head = mul[: mul.index("// h = f g: f_i g_j")]
    tail = mul[mul.index("// 2^dbl f^2") :]
    for name, (lanes, comb, pair) in XV.VARIANTS.items():
        out = XV.variant_sources(name, src)
        assert f"#define X3_LANES {lanes}\n" in out["sr25519_device.cuh"]
        walk = "ge4_dual_mult(acc, av, esd, ekd, tab, stride, btab);"
        assert (walk in out["sr25519_device.cuh"]) == (not comb)
        assert ("__shared__ uint32_t btab[" in out["sr25519_verify.cu"]) == (not comb)
        ed = out["ed25519_device.cuh"]
        assert ed.count("void fe_mul(") == 1
        assert ("__shfl_xor_sync" in ed) == pair
        assert ed.startswith(head) and ed.endswith(tail)
    broken = dict(src)
    broken["sr25519_device.cuh"] = src["sr25519_device.cuh"].replace(
        "x3_dual_mult(acc, av", "x3_dual_mult(acc,  av")
    with pytest.raises(RuntimeError, match="x3_dual_mult"):
        XV.variant_sources("four", broken)


def test_x1_latency_stamps_find_their_anchors():
    """ops/x1_latency.py stamps a copy of sha512.cuh before a row's
    first compression and after each; each anchor must be there, once."""
    from tendermint_tpu_torch.ops import x1_latency

    out = x1_latency.stamped((CSRC / "sha512.cuh").read_text())
    assert out.count("PSTAMP(0);") == 1 and out.count("PSTAMP(1 + b);") == 1


def test_x1_variants_replace_only_the_compression():
    """ops/x1_variants.py swaps sha512_compress of a copy of sha512.cuh
    for each variant: the copy keeps one compression and the rest of the
    header as it is."""
    from tendermint_tpu_torch.ops import x1_variants

    header = (CSRC / "sha512.cuh").read_text()
    tail = header[header.index("// The big-endian word of bytes") :]
    head = header[: header.index("// One compression")]
    for compress in x1_variants.VARIANTS.values():
        out = x1_variants.variant_header(header, compress)
        assert out.count("void sha512_compress(") == 1
        assert out.startswith(head) and out.endswith(tail)


def test_k2_phase_stamps_find_their_anchors():
    """ops/k2_phases.py stamps a copy of the device header after six of
    ed25519_verify_lane's lines; each must still be there, once."""
    from tendermint_tpu_torch.ops import k2_phases

    header = (CSRC / "ed25519_device.cuh").read_text()
    out = k2_phases.stamped(header)
    assert [out.count(f"PSTAMP({k});") for k in range(6)] == [1] * 6


# -- kernel X3 --


@pytest.fixture(scope="module")
def sr_corpus():
    triples = sr25519_corpus.corpus(seed=1)
    return triples, sr25519_corpus.expected(triples)


def _sr_rows(triples, pad):
    """(pk, sig, k) byte rows of the triples as the verifier uploads
    them (challenges from the host, malformed sizes as zero rows), with
    pad all-zero lanes, and the size mask."""
    pks, msgs, sigs = (list(x) for x in zip(*triples))
    v = SK.Sr25519Verifier(bucket_sizes=[len(triples) + pad], device="cpu")
    w = v.upload(pks, msgs, sigs)
    rows = [np.ascontiguousarray(t.numpy()) for t in (w.pk_b, w.sig_b, w.k_b)]
    return rows, w.size_ok


def _host_sr_verify(lib, pk, sig, k):
    """The X3 body over every block a launch would run, X3_LANES lanes a
    signature in lock-step, as _host_verify runs K2's four."""
    n = pk.shape[1]
    padded = -(-n // SIGS_PER_BLOCK) * SIGS_PER_BLOCK
    out = np.full(padded, SENTINEL, dtype=np.uint8)
    rounds = lib.host_sr_verify(
        _ptr(pk), _ptr(sig), _ptr(k), _ptr(out), ctypes.c_int(n),
        ctypes.c_int(pk.itemsize),
    )
    assert rounds > 0, "the lanes fell out of lock-step"
    assert (out[n:] == SENTINEL).all()
    assert np.isin(out[:n], (0, 1)).all()
    return out[:n].astype(bool)


@pytest.mark.parametrize("dtype", [np.uint8, np.int32])
def test_sr25519_body_matches_oracle_and_plain(lib, sr_corpus, dtype):
    """The corpus (every class of sr25519_corpus) and 5 all-zero padding
    lanes, 33 signatures, so the last block runs lanes past n; uint8
    rows and the JAX contract's int32 rows give the same bitmap, that of
    the host oracle and of the plain version on every lane."""
    triples, want = sr_corpus
    (pk, sig, k), size_ok = _sr_rows(triples, 5)
    assert pk.shape[1] % SIGS_PER_BLOCK
    out = _host_sr_verify(lib, *(a.astype(dtype) for a in (pk, sig, k)))
    assert (out[: len(triples)] & size_ok).tolist() == want
    assert any(want) and not all(want)
    if dtype is np.uint8:
        plain = SK._verify_tile_sr(*(torch.from_numpy(a) for a in (pk, sig, k)))
        assert np.array_equal(out, plain.numpy())


def _sqrt_ratio_branch(enc: bytes) -> str:
    """Which case of SQRT_RATIO_M1(1, v u2^2) decoding enc takes: v r^2
    is 1 (correct), -1 (flipped), -sqrt(-1) (flipped_i) or neither."""
    P, D = rst.P, rst.D
    s = int.from_bytes(enc, "little") & ((1 << 255) - 1)
    ss = s * s % P
    u1, u2 = (1 - ss) % P, (1 + ss) % P
    w = (-(D * u1 * u1) - u2 * u2) * u2 * u2 % P
    r = pow(w, 3, P) * pow(pow(w, 7, P), (P - 5) // 8, P) % P
    check = w * r * r % P
    cases = {1: "correct", P - 1: "flipped", (P - rst._SQRT_M1) % P: "flipped_i"}
    return cases.get(check, "neither")


def test_sr25519_decode_matches_oracle_on_every_branch(lib):
    """X3's ristretto decode, one lane at a time, on every reason RFC
    9496 rejects an encoding, small multiples of B (the identity
    included) and seeded even values below p that take each case of
    sqrt_ratio_m1: ok equals the oracle's, x and y equal the oracle's
    point where it decodes, and equal the plain version's canonical
    limbs everywhere (where it does not, too: the flips still decide
    the limbs)."""
    encs = list(sr25519_corpus.undecodable_encodings().values())
    encs += [rst.encode(rst.mul_base(k)) for k in range(8)]
    rng = np.random.default_rng(11)
    for _ in range(40):
        v = int.from_bytes(rng.bytes(32), "little") % rst.P
        encs.append((v & ~1).to_bytes(32, "little"))
    assert {_sqrt_ratio_branch(e) for e in encs} == {
        "correct", "flipped", "flipped_i", "neither"
    }
    n = len(encs)
    rows = _join_cols(encs, 32, 0)
    ok = np.zeros(n, dtype=np.bool_)
    xy = np.zeros((n, 64), dtype=np.uint8)
    assert lib.host_sr_decode(_ptr(rows), ctypes.c_int(n), _ptr(ok), _ptr(xy)) == 0
    pt, plain_ok = SK.ristretto_decode(torch.from_numpy(rows.astype(np.int32)))
    assert ok.tolist() == plain_ok.tolist()
    for i, e in enumerate(encs):
        x = int.from_bytes(xy[i, :32].tobytes(), "little")
        y = int.from_bytes(xy[i, 32:].tobytes(), "little")
        assert (x, y) == (
            F.from_limbs(F.canonical(pt[0, :, i : i + 1])[:, 0]),
            F.from_limbs(F.canonical(pt[1, :, i : i + 1])[:, 0]),
        ), e.hex()
        d = rst.decode(e)
        assert bool(ok[i]) == (d is not None), e.hex()
        if d is not None:
            assert (x, y) == (d[0], d[1])


# -- X4 and X5: SHA-256 rows, tree levels and merkle proof walks --

SHA256_LENS = [0, 1, 31, 32, 33, 55, 56, 63, 64, 65, 119, 200]


def _sha256_host(lib, data, length, n, prefix, carry=False):
    out = np.full((n + 1, 32), 0xEE, dtype=np.uint8)
    lib.host_sha256_rows(
        _ptr(data), _ptr(out), ctypes.c_int(length), ctypes.c_int(n),
        ctypes.c_int(-1 if prefix is None else prefix), ctypes.c_int(int(carry)),
    )
    return out


@pytest.mark.parametrize("length", SHA256_LENS)
@pytest.mark.parametrize("prefix", [None, 0, 1])
def test_sha256_body_matches_hashlib_across_padding(lib, length, prefix):
    """X4's row body across the one/two/three/four-block edges (55/56,
    119/120 with the prefix byte counted), with and without a prefix; the
    65-byte inner-node message (64 bytes behind 0x01) takes the word path,
    every other row the byte path. Row n (no carry_tail) writes nothing."""
    n = 5
    rng = np.random.default_rng(1000 + length)
    rows = rng.integers(0, 256, (n, length), dtype=np.uint8)
    out = _sha256_host(lib, np.ascontiguousarray(rows), length, n, prefix)
    head = b"" if prefix is None else bytes([prefix])
    for i in range(n):
        want = hashlib.sha256(head + rows[i].tobytes()).digest()
        assert out[i].tobytes() == want, i
    assert (out[n] == 0xEE).all()
    plain = S256.sha256_rows(torch.from_numpy(rows), prefix)
    assert np.array_equal(out[:n], plain.numpy())


def test_sha256_inner_rows_at_an_odd_address_take_the_byte_path(lib):
    """64-byte rows behind 0x01 that start one byte past an aligned
    address are read a byte at a time, with the word path's digests."""
    n = 6
    rng = np.random.default_rng(64)
    raw = _aligned(64 * n + 16)
    raw[1 : 1 + 64 * n] = rng.integers(0, 256, 64 * n)
    out = np.full((n + 1, 32), 0xEE, dtype=np.uint8)
    lib.host_sha256_rows(
        ctypes.c_void_p(raw.ctypes.data + 1), _ptr(out), ctypes.c_int(64),
        ctypes.c_int(n), ctypes.c_int(1), ctypes.c_int(0),
    )
    aligned = _sha256_host(lib, np.ascontiguousarray(raw[1 : 1 + 64 * n]), 64, n, 1)
    assert np.array_equal(out[:n], aligned[:n])
    for i in range(n):
        m = b"\x01" + raw[1 + 64 * i : 65 + 64 * i].tobytes()
        assert out[i].tobytes() == hashlib.sha256(m).digest()


@pytest.mark.parametrize("m", [2, 3, 7, 8, 13, 64, 257])
def test_sha256_level_body_carries_the_odd_tail(lib, m):
    """One tree level as X4 runs it: m digests as m // 2 rows of 64 bytes
    behind 0x01, and with m odd the extra thread copies the trailing
    digest; against hashlib and the plain level."""
    rng = np.random.default_rng(m)
    level = rng.integers(0, 256, (m, 32), dtype=np.uint8)
    out = _sha256_host(lib, level, 64, m // 2, 1, carry=bool(m % 2))
    got = out[: (m + 1) // 2]
    for i in range(m // 2):
        pair = level[2 * i].tobytes() + level[2 * i + 1].tobytes()
        assert got[i].tobytes() == merkle.inner_hash(pair[:32], pair[32:])
    if m % 2:
        assert got[-1].tobytes() == level[-1].tobytes()
    else:
        assert (out[m // 2] == 0xEE).all()
    plain = S256.sha256_level(torch.from_numpy(level))
    assert np.array_equal(got, plain.numpy())


def _walk_host(lib, batch):
    """X5's body over every proof of a packed batch: (roots, ok)."""
    k = batch.k
    base = batch.buf.ctypes.data
    roots = np.full((k, 32), 0xEE, dtype=np.uint8)
    ok = np.full(k, 7, dtype=np.uint8)
    parts = [ctypes.c_void_p(base + batch.at[p])
             for p in ("leaf", "aunts", "off", "sides", "want", "ok_in")]
    lib.host_merkle_proofs(*parts, _ptr(roots), _ptr(ok), ctypes.c_int(k))
    assert np.isin(ok, (0, 1)).all()
    return roots, ok.astype(bool)


def _proofs_with_faults():
    """(root, proofs, bad): 37 proofs of one tree and 3 + 64 of two
    others, with an aunt zeroed, a leaf hash zeroed, an index moved, an
    aunt dropped, total = 0, an aunt of 31 bytes, a leaf hash of 33 bytes
    and an index past total; `bad` the indices that must be False."""
    root, proofs = merkle.proofs_from_byte_slices([b"item-%d" % i for i in range(37)])
    _r3, p3 = merkle.proofs_from_byte_slices([b"a%d" % i for i in range(3)])
    _r64, p64 = merkle.proofs_from_byte_slices([b"b%d" % i for i in range(64)])
    proofs[5].aunts[0] = bytes(32)
    proofs[11].leaf_hash = bytes(32)
    proofs[20].index = 21
    proofs[3].aunts = proofs[3].aunts[:-1]
    proofs[7].total = 0
    proofs[9].aunts[2] = proofs[9].aunts[2][:31]
    proofs[13].leaf_hash += b"\x00"
    proofs[15].index = 37
    bad = [3, 5, 7, 9, 11, 13, 15, 20] + list(range(37, 37 + 67))
    return root, proofs + p3 + p64, bad


def test_merkle_proof_body_matches_compute_hash_from_aunts(lib):
    """X5's walk on valid and malformed proofs of mixed depths (0 to 6,
    the 3-leaf tree's proofs against another root): the bitmap is the
    host's, every structurally sound proof's root is
    _compute_hash_from_aunts', every malformed one's is 32 zero bytes,
    and the plain version agrees on both."""
    root, proofs, bad = _proofs_with_faults()
    batch = MK.pack_proofs(proofs, root)
    roots, ok = _walk_host(lib, batch)
    want_ok = np.ones(len(proofs), dtype=bool)
    want_ok[bad] = False
    assert np.array_equal(ok, want_ok), np.nonzero(ok != want_ok)
    for i, p in enumerate(proofs):
        h = merkle._compute_hash_from_aunts(p.index, p.total, p.leaf_hash, p.aunts)
        sound = h is not None and len(p.leaf_hash) == 32 and all(
            len(a) == 32 for a in p.aunts
        )
        assert roots[i].tobytes() == (h if sound else bytes(32)), i
    plain_roots, plain_ok = MK.verify_program_plain(
        *batch.to("cpu")
    )
    assert np.array_equal(roots, plain_roots.numpy())
    assert np.array_equal(ok, plain_ok.numpy())


def _rfc6962_root(hashes):
    """RFC 6962 MTH over leaf hashes, by hashlib: split at the largest
    power of two below the count."""
    if len(hashes) == 1:
        return hashes[0]
    k = 1 << ((len(hashes) - 1).bit_length() - 1)
    left, right = _rfc6962_root(hashes[:k]), _rfc6962_root(hashes[k:])
    return hashlib.sha256(b"\x01" + left + right).digest()


TREE_LEAF_COUNTS = [1, 2, 3, 127, 128, 129, 255, 256, 257, 511, 512, 513,
                    1023, 1024, 1025, 10_000, 16_385]


@pytest.mark.parametrize("n", TREE_LEAF_COUNTS)
def test_sha256_tree_body_matches_rfc6962(lib, n):
    """X4's tree kernel as its blocks run it (aligned subtrees of
    SHA256_TREE_LEAVES leaves, a partial last block, then the blocks'
    roots) gives hashlib's RFC 6962 root for every count, 2^k - 1, 2^k and
    2^k + 1 about the block size and above, 10,000 and 16,385 (odd at every
    level); the plain version agrees up to 513 leaves."""
    rng = np.random.default_rng(n)
    leaves = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    root = np.zeros(32, dtype=np.uint8)
    assert lib.host_sha256_tree(_ptr(leaves), _ptr(root), ctypes.c_int(n)) == 0
    want = _rfc6962_root([r.tobytes() for r in leaves])
    assert root.tobytes() == want
    if n <= 513:
        plain = S256.sha256_tree_plain(torch.from_numpy(leaves))
        assert plain.numpy().tobytes() == want


# -- X5's candidate designs (ops/x5_variants.py) --

X5_HARNESS = r"""
#include <stdint.h>
#include <string.h>
#include <ucontext.h>
#define __device__
#define __constant__
#define __forceinline__ inline
static int x5_host_warp_max(int v);
static void x5_host_bar(void);
#include "sha256.cuh"

// A block of the split design (two warps of 32) as 64 contexts on one
// host thread, run round-robin: X5_BAR() yields to the next context, so
// every context reaches a barrier before any passes it, as
// __syncthreads() holds them on the card. A context that would hand over
// to one already finished (the contexts met different numbers of
// barriers) stops the block.
#define X5_CTX 64
static int g_c, g_err;
static int g_done[X5_CTX], g_dep[X5_CTX];
static long g_bars[X5_CTX];
static ucontext_t g_ctx[X5_CTX], g_main;
static char g_stack[X5_CTX][1 << 16];

static void x5_host_bar(void) {
  const int c = g_c, next = (c + 1) % X5_CTX;
  g_bars[c]++;
  if (g_done[next]) {
    g_err = 1;
    swapcontext(&g_ctx[c], &g_main);
  }
  g_c = next;
  swapcontext(&g_ctx[c], &g_ctx[next]);
  g_c = c;
}
static int x5_host_warp_max(int v) {
  g_dep[g_c] = v;
  x5_host_bar();
  const int w = g_c & ~31;
  int m = 0;
  for (int i = 0; i < 32; i++) m = g_dep[w + i] > m ? g_dep[w + i] : m;
  return m;
}

static struct {
  const uint8_t *leaf, *aunts, *want, *ok_in;
  const int32_t *off;
  const uint64_t *sides;
  uint8_t *roots, *ok;
  int n, blk;
} g;

#if X5_SPLIT
static uint32_t sh_h[8][32], sh_w[X5_SH_ROWS][32];
static void entry(void) {
  const int c = g_c;
  x5_split_item(g.leaf, g.aunts, g.off, g.sides, g.want, g.ok_in, g.roots,
                g.ok, g.n, 32 * g.blk + (c & 31), c & 31, c >> 5, sh_h, sh_w);
  g_done[c] = 1;
}
#endif

extern "C" long host_x5(const uint8_t *leaf, const uint8_t *aunts,
                        const int32_t *off, const uint64_t *sides,
                        const uint8_t *want, const uint8_t *ok_in,
                        uint8_t *roots, uint8_t *ok, int n) {
#if X5_SPLIT
  g.leaf = leaf; g.aunts = aunts; g.off = off; g.sides = sides;
  g.want = want; g.ok_in = ok_in; g.roots = roots; g.ok = ok; g.n = n;
  long bars = 0;
  for (g.blk = 0; 32 * g.blk < n; g.blk++) {
    for (int c = 0; c < X5_CTX; c++) {
      getcontext(&g_ctx[c]);
      g_ctx[c].uc_stack.ss_sp = g_stack[c];
      g_ctx[c].uc_stack.ss_size = sizeof g_stack[c];
      g_ctx[c].uc_link = c < X5_CTX - 1 ? &g_ctx[c + 1] : &g_main;
      makecontext(&g_ctx[c], entry, 0);
      g_done[c] = 0;
      g_bars[c] = 0;
    }
    g_c = 0;
    g_err = 0;
    swapcontext(&g_main, &g_ctx[0]);
    for (int c = 0; c < X5_CTX; c++)
      if (g_err || !g_done[c] || g_bars[c] != g_bars[0]) return -1;
    bars += g_bars[0];
  }
  return bars;
#else
  for (int i = 0; i < n; i++)
    x5_item(leaf, aunts, off, sides, want, ok_in, roots, ok, i);
  return 0;
#endif
}
"""


@pytest.fixture(scope="module")
def x5_libs(tmp_path_factory):
    """Each X5 candidate's device body built by the host compiler: name
    -> library exporting host_x5."""
    from tendermint_tpu_torch.ops import x5_variants as XV

    cxx = shutil.which("g++") or shutil.which("c++") or shutil.which("clang++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the device headers with")
    src = {f: (CSRC / f).read_text() for f in XV.SOURCES}
    procs = {}
    for name in XV.VARIANTS:
        if name == XV.SHIPPED:
            continue
        d = tmp_path_factory.mktemp(f"x5_{name}")
        for fname, text in XV.variant_sources(name, src).items():
            (d / fname).write_text(text)
        (d / "harness.cpp").write_text(X5_HARNESS)
        so = d / "libx5.so"
        procs[name] = (so, subprocess.Popen(
            [cxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-I", str(d),
             "-I", str(CSRC), "-o", str(so), str(d / "harness.cpp")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate(timeout=300)[0]
        assert proc.returncode == 0, f"{name}:\n{log}"
        libs[name] = ctypes.CDLL(str(so))
        libs[name].host_x5.restype = ctypes.c_long
    return libs


def test_x5_pad_table_is_the_second_block_schedule():
    """csrc/sha256_pad.cuh is what ops/sha256_pad.py generates, and row b
    is K[t] + W[t] (t >= 16) of the second block of 0x01 || L || R whose
    R ends in b: rebuilt here by the FIPS 180-4 recurrence with numpy."""
    from tendermint_tpu_torch.ops import sha256_pad

    assert (CSRC / "sha256_pad.cuh").read_text() == sha256_pad.header_text()
    table = np.array(sha256_pad.table(), dtype=np.uint64)
    assert table.shape == (256, 48)
    k = np.array(sha256_pad.K256, dtype=np.uint64)
    m = np.uint64(0xFFFFFFFF)

    def rotr(x, n):
        return ((x >> np.uint64(n)) | (x << np.uint64(32 - n))) & m

    w = np.zeros((256, 64), dtype=np.uint64)
    w[:, 0] = (np.arange(256, dtype=np.uint64) << np.uint64(24)) | np.uint64(0x800000)
    w[:, 15] = 520
    for t in range(16, 64):
        s0 = rotr(w[:, t - 15], 7) ^ rotr(w[:, t - 15], 18) ^ (w[:, t - 15] >> np.uint64(3))
        s1 = rotr(w[:, t - 2], 17) ^ rotr(w[:, t - 2], 19) ^ (w[:, t - 2] >> np.uint64(10))
        w[:, t] = (w[:, t - 16] + s0 + w[:, t - 7] + s1) & m
    assert np.array_equal(table, (w[:, 16:] + k[16:]) & m)
    text = sha256_pad.header_text()
    assert len(re.findall(r"0x[0-9A-F]{8}u", text)) == 256 * 48


def test_x5_variants_find_their_anchors():
    """ops/x5_variants.py builds X5's candidates from copies of the
    kernel's sources by text replacement: the shipped design is the
    sources unchanged, every other keeps the shipped header as its head,
    the split designs launch blocks of two warps for 32 proofs, and a
    missing anchor raises."""
    from tendermint_tpu_torch.ops import x5_variants as XV

    src = {f: (CSRC / f).read_text() for f in XV.SOURCES}
    assert XV.variant_sources(XV.SHIPPED, src) == src
    for name, (fixed, split, prefetch) in XV.VARIANTS.items():
        if name == XV.SHIPPED:
            continue
        out = XV.variant_sources(name, src)
        assert out["sha256.cuh"].startswith(src["sha256.cuh"])
        assert f"#define X5_FIXED {int(fixed)}" in out["sha256.cuh"]
        assert f"#define X5_PREFETCH {int(prefetch)}" in out["sha256.cuh"]
        cu = out["merkle_proofs.cu"]
        assert ("x5_split_item(" in cu) == split
        assert ("x5_item(" in cu) == (not split)
        assert ("constexpr int kThreads = 64;" in cu) == split
    broken = dict(src)
    broken["merkle_proofs.cu"] = src["merkle_proofs.cu"].replace(
        "merkle_proof_item(leaf", "merkle_proof_item( leaf")
    with pytest.raises(RuntimeError, match="merkle_proof_item"):
        XV.variant_sources("word", broken)


def _x5_batches():
    """Packed batches: the faulted mix of _proofs_with_faults, and all
    proofs of trees of 1, 33 and 100 leaves (one block partly filled,
    depths 0-7 in one block)."""
    root, proofs, _bad = _proofs_with_faults()
    out = [MK.pack_proofs(proofs, root)]
    for n in (1, 33, 100):
        r, ps = merkle.proofs_from_byte_slices([b"x5-%d-%d" % (n, i) for i in range(n)])
        out.append(MK.pack_proofs(ps, r))
    return out


@pytest.mark.parametrize("name", ["word", "fixed", "prefetch", "split", "fixed_split"])
def test_x5_candidate_body_matches_the_shipped_walk(lib, x5_libs, name):
    """Each other design's device body, built by the host compiler (the
    split designs as 64 contexts a block meeting at every barrier), gives
    the shipped body's roots and bitmap, which are hashlib's
    (_compute_hash_from_aunts) for every sound proof."""
    from tendermint_tpu_torch.ops import x5_variants as XV

    assert name in XV.VARIANTS
    for batch in _x5_batches():
        k = batch.k
        base = batch.buf.ctypes.data
        roots = np.full((k, 32), 0xEE, dtype=np.uint8)
        ok = np.full(k, 7, dtype=np.uint8)
        parts = [ctypes.c_void_p(base + batch.at[p])
                 for p in ("leaf", "aunts", "off", "sides", "want", "ok_in")]
        rc = x5_libs[name].host_x5(*parts, _ptr(roots), _ptr(ok), ctypes.c_int(k))
        assert rc >= 0, "the two warps met different numbers of barriers"
        want_roots, want_ok = _walk_host(lib, batch)
        assert np.array_equal(roots, want_roots)
        assert np.array_equal(ok.astype(bool), want_ok)
