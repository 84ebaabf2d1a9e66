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

from tendermint_tpu.ops import ed25519_kernel as JK
from tendermint_tpu_torch.crypto import zip215_corpus
from tendermint_tpu_torch.ops import ed25519_kernel as K
from tendermint_tpu_torch.ops import edwards as E
from tendermint_tpu_torch.ops import field25519 as F
from tendermint_tpu_torch.ops import sha512_kernel as S

CSRC = pathlib.Path(__file__).resolve().parents[1] / "tendermint_tpu_torch" / "ops" / "csrc"

HARNESS = r"""
#include <stdint.h>
#include <string.h>
#include <ucontext.h>
#define __device__
#define __constant__
#define __forceinline__ inline

// The four lanes of a signature as four contexts on one host thread, run
// round-robin: lane_shfl deposits this lane's value and yields to the
// next lane, so a lane reads its source's deposit only after all four
// lanes have reached the same exchange (lock-step, round by round). Two
// slot sets alternate, so the first lane through the next exchange cannot
// overwrite a value the others have yet to read.
#define ED25519_HOST_LANES
static int g_lane;
static uint32_t g_slot[2][4];
static int g_parity[4];
static long g_rounds[4];
static ucontext_t g_ctx[4], g_main;
static char g_stack[4][1 << 18];

static inline int lane_id() { return g_lane; }
static uint32_t lane_shfl(uint32_t v, int src) {
  const int l = g_lane, p = g_parity[l];
  g_slot[p][l] = v;
  g_parity[l] = p ^ 1;
  g_rounds[l]++;
  g_lane = (l + 1) & 3;
  swapcontext(&g_ctx[l], &g_ctx[(l + 1) & 3]);
  g_lane = l;
  return g_slot[p][src & 3];
}
static inline void lane_sync() { lane_shfl(0, 0); }

#include "ed25519_device.cuh"
#include "sha512.cuh"

static void (*g_body)(void);
static void lane_entry(void) { g_body(); }

// runs body on the four lanes; the exchanges they made, or -1 when the
// lanes made different numbers of them (they would not be in lock-step)
static long run4(void (*body)(void)) {
  g_body = body;
  for (int l = 0; l < 4; l++) {
    getcontext(&g_ctx[l]);
    g_ctx[l].uc_stack.ss_sp = g_stack[l];
    g_ctx[l].uc_stack.ss_size = sizeof g_stack[l];
    g_ctx[l].uc_link = l < 3 ? &g_ctx[l + 1] : &g_main;
    makecontext(&g_ctx[l], lane_entry, 0);
    g_parity[l] = 0;
    g_rounds[l] = 0;
  }
  g_lane = 0;
  swapcontext(&g_main, &g_ctx[0]);
  for (int l = 1; l < 4; l++)
    if (g_rounds[l] != g_rounds[0]) return -1;
  return g_rounds[0];
}

static struct {
  const uint8_t *pk, *sig, *dig;
  const int32_t *a, *ds, *dk;
  bool *out;
  int32_t *out32;
  int n, es, i;
  uint32_t tab[9 * 10 * 4];
} g;

static void verify_body(void) {
  ed25519_verify_lane(g.pk, g.sig, g.dig, g.out, g.n, g.es, g.i, g.tab, 4,
                      &GE_BASE_TABLE[0][0][0]);
}
static void dual_mult_body(void) {
  ed25519_dual_mult_lane(g.a, g.ds, g.dk, g.out32, g.n, g.i, g.tab, 4,
                         &GE_BASE_TABLE[0][0][0]);
}

// every signature of the blocks a launch of n would run, as the kernels
// run them: the lanes of i >= n on zeros, writing nothing. Returns the
// exchanges of one signature, or -1.
static long run_blocks(void (*body)(void), int n) {
  const int padded = (n + ED25519_SIGS_PER_BLOCK - 1) /
                     ED25519_SIGS_PER_BLOCK * ED25519_SIGS_PER_BLOCK;
  long rounds = 0;
  for (int i = 0; i < padded; i++) {
    g.i = i;
    const long r = run4(body);
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
  return run_blocks(verify_body, n);
}
long host_dual_mult(const int32_t *a, const int32_t *ds, const int32_t *dk,
                    int32_t *out, int n) {
  g.a = a; g.ds = ds; g.dk = dk; g.out32 = out; g.n = n;
  return run_blocks(dual_mult_body, n);
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
