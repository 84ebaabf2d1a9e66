// SHA-512 device functions for kernel X1 (sha512.cu): the compression,
// the Merkle-Damgard padding laid out one 64-bit word at a time, and the
// two ways a row's bytes are read: from (L, n) batch-minor byte rows
// (sha512_row, the JAX contract of sha512_fixed) and as R || A || M with R
// and A from the verifier's batch-minor sig and pk rows and M from a
// block's span of one flat message buffer staged in shared memory
// (sha512_stage, sha512_ram_row). Every row lays out its own padding and
// block count, so rows of any lengths share one launch.
//
// Hopper's integer pipes are 32 bits wide: a 64-bit add is a pair of
// IADD3 (the second taking the carries), a 64-bit rotate a pair of
// funnel shifts (SHF.W), a 64-bit logic op one LOP3 per half. The
// rotates are written as those pairs and Ch and Maj as one three-input
// function per half; a compression is then ~3,660 SASS instructions,
// nearly all on the integer pipe (ops/sass_count.py).
//
// The header includes no CUDA runtime header, so a host compiler can build
// it too (with the CUDA qualifiers defined away) for checking the arithmetic
// against hashlib without a card; under a host compiler the two intrinsics
// below are plain C.

#pragma once
#include <stddef.h>
#include <stdint.h>

__device__ __constant__ uint64_t K512[80] = {
    0x428A2F98D728AE22ULL, 0x7137449123EF65CDULL, 0xB5C0FBCFEC4D3B2FULL,
    0xE9B5DBA58189DBBCULL, 0x3956C25BF348B538ULL, 0x59F111F1B605D019ULL,
    0x923F82A4AF194F9BULL, 0xAB1C5ED5DA6D8118ULL, 0xD807AA98A3030242ULL,
    0x12835B0145706FBEULL, 0x243185BE4EE4B28CULL, 0x550C7DC3D5FFB4E2ULL,
    0x72BE5D74F27B896FULL, 0x80DEB1FE3B1696B1ULL, 0x9BDC06A725C71235ULL,
    0xC19BF174CF692694ULL, 0xE49B69C19EF14AD2ULL, 0xEFBE4786384F25E3ULL,
    0x0FC19DC68B8CD5B5ULL, 0x240CA1CC77AC9C65ULL, 0x2DE92C6F592B0275ULL,
    0x4A7484AA6EA6E483ULL, 0x5CB0A9DCBD41FBD4ULL, 0x76F988DA831153B5ULL,
    0x983E5152EE66DFABULL, 0xA831C66D2DB43210ULL, 0xB00327C898FB213FULL,
    0xBF597FC7BEEF0EE4ULL, 0xC6E00BF33DA88FC2ULL, 0xD5A79147930AA725ULL,
    0x06CA6351E003826FULL, 0x142929670A0E6E70ULL, 0x27B70A8546D22FFCULL,
    0x2E1B21385C26C926ULL, 0x4D2C6DFC5AC42AEDULL, 0x53380D139D95B3DFULL,
    0x650A73548BAF63DEULL, 0x766A0ABB3C77B2A8ULL, 0x81C2C92E47EDAEE6ULL,
    0x92722C851482353BULL, 0xA2BFE8A14CF10364ULL, 0xA81A664BBC423001ULL,
    0xC24B8B70D0F89791ULL, 0xC76C51A30654BE30ULL, 0xD192E819D6EF5218ULL,
    0xD69906245565A910ULL, 0xF40E35855771202AULL, 0x106AA07032BBD1B8ULL,
    0x19A4C116B8D2D0C8ULL, 0x1E376C085141AB53ULL, 0x2748774CDF8EEB99ULL,
    0x34B0BCB5E19B48A8ULL, 0x391C0CB3C5C95A63ULL, 0x4ED8AA4AE3418ACBULL,
    0x5B9CCA4F7763E373ULL, 0x682E6FF3D6B2B8A3ULL, 0x748F82EE5DEFB2FCULL,
    0x78A5636F43172F60ULL, 0x84C87814A1F0AB72ULL, 0x8CC702081A6439ECULL,
    0x90BEFFFA23631E28ULL, 0xA4506CEBDE82BDE9ULL, 0xBEF9A3F7B2C67915ULL,
    0xC67178F2E372532BULL, 0xCA273ECEEA26619CULL, 0xD186B8C721C0C207ULL,
    0xEADA7DD6CDE0EB1EULL, 0xF57D4F7FEE6ED178ULL, 0x06F067AA72176FBAULL,
    0x0A637DC5A2C898A6ULL, 0x113F9804BEF90DAEULL, 0x1B710B35131C471BULL,
    0x28DB77F523047D84ULL, 0x32CAAB7B40C72493ULL, 0x3C9EBE0A15C9BEBCULL,
    0x431D67C49C100D4CULL, 0x4CC5D4BECB3E42B6ULL, 0x597F299CFC657E2AULL,
    0x5FCB6FAB3AD6FAECULL, 0x6C44198C4A475817ULL};

__device__ __constant__ uint64_t H512[8] = {
    0x6A09E667F3BCC908ULL, 0xBB67AE8584CAA73BULL, 0x3C6EF372FE94F82BULL,
    0xA54FF53A5F1D36F1ULL, 0x510E527FADE682D1ULL, 0x9B05688C2B3E6C1FULL,
    0x1F83D9ABFB41BD6BULL, 0x5BE0CD19137E2179ULL};

#ifdef __CUDACC__
typedef uint4 sha_v16;  // one 16-byte load or store
__device__ __forceinline__ uint32_t sha_prmt(uint32_t x, uint32_t y,
                                             uint32_t s) {
  return __byte_perm(x, y, s);
}
__device__ __forceinline__ uint32_t sha_shf(uint32_t lo, uint32_t hi, int n) {
  return __funnelshift_r(lo, hi, n);
}
#else
typedef struct alignas(16) { uint32_t x, y, z, w; } sha_v16;
// __byte_perm without the sign-replicate mode (selector bit 3), unused here
inline uint32_t sha_prmt(uint32_t x, uint32_t y, uint32_t s) {
  const uint64_t v = ((uint64_t)y << 32) | x;
  uint32_t r = 0;
  for (int k = 0; k < 4; k++)
    r |= (uint32_t)((v >> (8 * ((s >> (4 * k)) & 7))) & 0xff) << (8 * k);
  return r;
}
inline uint32_t sha_shf(uint32_t lo, uint32_t hi, int n) {
  return (uint32_t)((((uint64_t)hi << 32) | lo) >> (n & 31));
}
#endif

__device__ __forceinline__ uint64_t sha_join(uint32_t hi, uint32_t lo) {
  return ((uint64_t)hi << 32) | lo;
}

// x rotated right by the constant n, as two funnel shifts
__device__ __forceinline__ uint64_t rotr64(uint64_t x, int n) {
  const uint32_t lo = (uint32_t)x, hi = (uint32_t)(x >> 32);
  if (n < 32) return sha_join(sha_shf(hi, lo, n), sha_shf(lo, hi, n));
  return sha_join(sha_shf(lo, hi, n - 32), sha_shf(hi, lo, n - 32));
}

// x >> n for a constant n < 32
__device__ __forceinline__ uint64_t shr64(uint64_t x, int n) {
  const uint32_t lo = (uint32_t)x, hi = (uint32_t)(x >> 32);
  return sha_join(hi >> n, sha_shf(lo, hi, n));
}

__device__ __forceinline__ uint64_t sha_ch(uint64_t e, uint64_t f,
                                           uint64_t g) {
  return g ^ (e & (f ^ g));
}

__device__ __forceinline__ uint64_t sha_maj(uint64_t a, uint64_t b,
                                            uint64_t c) {
  return (a & b) | (c & (a | b));
}

// One compression, the rounds in the textbook order. Keeping h + K[t] +
// W[t] and d + h + K[t] + W[t] off the path of e (h was e three rounds
// earlier) costs two more IADD3 a round, and one warp's rounds are bound
// by the 16-lane integer pipe's issue rate, not by that path: on an H100
// it was 2-12% slower a launch, and the 64-bit adds moved to the FMA
// pipe (IMAD.WIDE pairs) spilled and were slower still
// (ops/x1_variants.py times these forms).
__device__ __forceinline__ void sha512_compress(uint64_t *h, uint64_t *w) {
  uint64_t a = h[0], b = h[1], c = h[2], d = h[3], e = h[4], f = h[5],
           g = h[6], hh = h[7];
#pragma unroll
  for (int t = 0; t < 80; t++) {
    if (t >= 16) {
      const uint64_t w15 = w[(t - 15) & 15], w2 = w[(t - 2) & 15];
      const uint64_t s0 = rotr64(w15, 1) ^ rotr64(w15, 8) ^ shr64(w15, 7);
      const uint64_t s1 = rotr64(w2, 19) ^ rotr64(w2, 61) ^ shr64(w2, 6);
      w[t & 15] += s0 + w[(t - 7) & 15] + s1;
    }
    const uint64_t S1 = rotr64(e, 14) ^ rotr64(e, 18) ^ rotr64(e, 41);
    const uint64_t t1 = hh + S1 + sha_ch(e, f, g) + K512[t] + w[t & 15];
    const uint64_t S0 = rotr64(a, 28) ^ rotr64(a, 34) ^ rotr64(a, 39);
    const uint64_t t2 = S0 + sha_maj(a, b, c);
    hh = g;
    g = f;
    f = e;
    e = d + t1;
    d = c;
    c = b;
    b = a;
    a = t1 + t2;
  }
  h[0] += a; h[1] += b; h[2] += c; h[3] += d;
  h[4] += e; h[5] += f; h[6] += g; h[7] += hh;
}

// The big-endian word of bytes v0 (most significant) .. v3.
__device__ __forceinline__ uint32_t sha_be32(uint32_t v0, uint32_t v1,
                                             uint32_t v2, uint32_t v3) {
  return sha_prmt(sha_prmt(v3, v2, 0x0040), sha_prmt(v1, v0, 0x0040), 0x5410);
}

// Word k of the padded message, given nb = len - 8k (the message bytes the
// word holds; <= 0 for none) and m, the word's message bytes (those past
// len arbitrary): message bytes kept, the 0x80 marker after the last one,
// zeros after that. Selects, no branch.
__device__ __forceinline__ uint64_t sha512_pad_word(uint64_t m, int nb) {
  const uint64_t keep =
      nb >= 8 ? ~0ull : nb <= 0 ? 0ull : ~0ull << (64 - 8 * nb);
  const uint64_t mark = nb >= 0 && nb < 8 ? 0x80ull << (56 - 8 * nb) : 0ull;
  return (m & keep) | mark;
}

// SHA-512 state of one message of len bytes. src.word(b, j) gives word j
// (a constant after unrolling) of block b, bytes past len arbitrary; it is
// called only for words that hold message bytes. The block count is the
// row's own: rows of a warp with fewer blocks leave the loop early.
template <class Src>
__device__ __forceinline__ void sha512_message(const Src &src, int len,
                                               uint64_t *h) {
#pragma unroll
  for (int j = 0; j < 8; j++) h[j] = H512[j];
  const int nblocks = (len + 17 + 127) >> 7;
#pragma unroll 1
  for (int b = 0; b < nblocks; b++) {
    uint64_t w[16];
#pragma unroll
    for (int j = 0; j < 16; j++) {
      const int nb = len - 128 * b - 8 * j;
      uint64_t m = 0;
      if (nb > 0) m = src.word(b, j);
      w[j] = sha512_pad_word(m, nb);
    }
    // words 14 and 15 of the last block: the 128-bit bit length (its upper
    // half is 0, which word 14 already holds: no message byte reaches it)
    if (b == nblocks - 1) w[15] = (uint64_t)len << 3;
    sha512_compress(h, w);
  }
}

// The 64 digest bytes to out[k * n + i], batch-minor.
__device__ __forceinline__ void sha512_store(const uint64_t *h, uint8_t *out,
                                             int n, int i) {
#pragma unroll
  for (int j = 0; j < 8; j++)
#pragma unroll
    for (int k = 0; k < 8; k++)
      out[(size_t)(8 * j + k) * n + i] = (uint8_t)(h[j] >> (56 - 8 * k));
}

// Bytes r .. r+7 of column i of batch-minor rows (byte r of column i at
// rows[r * n + i]) as a big-endian word; rows at or past len read as 0.
__device__ __forceinline__ uint64_t sha_minor_word(const uint8_t *rows, int r,
                                                   int len, int n, int i) {
  uint32_t v[8];
#pragma unroll
  for (int q = 0; q < 8; q++)
    v[q] = r + q < len ? rows[(size_t)(r + q) * n + i] : 0;
  return sha_join(sha_be32(v[0], v[1], v[2], v[3]),
                  sha_be32(v[4], v[5], v[6], v[7]));
}

// Column i of (len, n) batch-minor rows.
struct Sha512Rows {
  const uint8_t *data;
  int len, n, i;
  __device__ __forceinline__ uint64_t word(int b, int j) const {
    return sha_minor_word(data, 128 * b + 8 * j, len, n, i);
  }
};

// SHA-512 of column i of (len, n) uint8 rows, batch-minor (byte j of row i
// at data[j * n + i]) -> 64 digest bytes at out[k * n + i].
__device__ __forceinline__ void sha512_row(const uint8_t *data, uint8_t *out,
                                           int len, int n, int i) {
  uint64_t h[8];
  sha512_message(Sha512Rows{data, len, n, i}, len, h);
  sha512_store(h, out, n, i);
}

// The rows of one ragged block and the shared memory their messages are
// staged in.
#define SHA512_ROWS_PER_BLOCK 32
// Bytes of stage a block of rows of at most max_len message bytes needs:
// 32 messages and up to 15 bytes of alignment at each end, rounded to
// 16, and 16 bytes past that which a row's last word may read.
#define SHA512_STAGE_CAP(max_len) \
  ((SHA512_ROWS_PER_BLOCK * (max_len) + 32 + 15) / 16 * 16)
#define SHA512_STAGE_BYTES(max_len) (SHA512_STAGE_CAP(max_len) + 16)

// Copies msg[s0, s1) (the messages of a block's rows, one contiguous
// span) to stage, widened to 16-byte boundaries of msg, in 16-byte loads,
// thread tid of nthreads taking every nthreads-th: msg must be 16-byte
// aligned and readable up to s1 rounded up to 16. Returns the offset in
// msg of stage's first byte, or -1 when the span needs more than cap
// bytes (nothing is copied then).
__device__ __forceinline__ int sha512_stage(const uint8_t *msg, int s0, int s1,
                                            sha_v16 *stage, int tid,
                                            int nthreads, int cap) {
  const int a0 = s0 & ~15, a1 = (s1 + 15) & ~15;
  if (a1 - a0 > cap) return -1;
  const sha_v16 *src = (const sha_v16 *)(msg + a0);
  for (int c = tid; c < (a1 - a0) >> 4; c += nthreads) stage[c] = src[c];
  return a0;
}

// R || A || M of one row: R and A as eight words in registers, M read from
// the staged span as two big-endian halves, each one PRMT of two aligned
// 32-bit shared-memory words.
struct Sha512Ram {
  uint64_t ra[8];
  const uint32_t *stage;
  int m0;        // index of M's first 32-bit word in stage, less 16
  uint32_t sel;  // the PRMT selector for M's first byte mod 4
  __device__ __forceinline__ uint64_t word(int b, int j) const {
    if (b == 0 && j < 8) return ra[j];
    const uint32_t *p = stage + (m0 + 32 * b + 2 * j);
    return sha_join(sha_prmt(p[0], p[1], sel), sha_prmt(p[1], p[2], sel));
  }
};

// SHA-512(R || A || M) of row i: R is sig rows 0..31 and A pk rows 0..31
// of column i (batch-minor, n columns), M the mlen bytes at stage[start..]
// -> 64 digest bytes at out[k * n + i].
__device__ __forceinline__ void sha512_ram_row(const uint8_t *sig,
                                               const uint8_t *pk, int n, int i,
                                               const uint8_t *stage, int start,
                                               int mlen, uint8_t *out) {
  Sha512Ram src;
#pragma unroll
  for (int j = 0; j < 4; j++) {
    src.ra[j] = sha_minor_word(sig, 8 * j, 32, n, i);
    src.ra[4 + j] = sha_minor_word(pk, 8 * j, 32, n, i);
  }
  // word j >= 8 of block b holds M's bytes from 128 b + 8 j - 64 on
  src.stage = (const uint32_t *)stage;
  src.m0 = (start >> 2) - 16;
  src.sel = 0x0123 + 0x1111 * (uint32_t)(start & 3);
  uint64_t h[8];
  sha512_message(src, 64 + mlen, h);
  sha512_store(h, out, n, i);
}
