// SHA-256 device functions for kernels X4 (sha256.cu) and X5
// (merkle_proofs.cu): the compression, the hash of one row of bytes behind
// an optional one-byte prefix, the RFC 6962 inner hash of two digests held
// as words (X5's with its second block's schedule read from the table
// sha256_pad.cuh), and the walk of one merkle inclusion proof.
//
// Words are 32 bits, so every operation is one instruction of the integer
// pipe: a rotate is one funnel shift (SHF), Ch and Maj and the three-way
// xors of the sigmas one three-input logic op (LOP3) each, and the adds
// three-input IADD3s. A compression is then about 1,380 instructions
// (chip_smoke.py counts them).
//
// The inner-node message is 0x01 || L || R, 65 bytes: the prefix shifts
// the 64 digest bytes by one, so each big-endian message word is the last
// byte of one digest word and the first three of the next (one funnel
// shift by 8), and the second block holds R's last byte, the 0x80 marker,
// zeros and the bit length 520.
//
// The header includes no CUDA header, so a host compiler can build it too
// (with the CUDA qualifiers defined away) for checking the arithmetic
// against hashlib without a card; under a host compiler the intrinsics
// below are plain C.

#pragma once
#include <stdint.h>

#include "sha256_pad.cuh"

__device__ __constant__ uint32_t K256[64] = {
    0x428A2F98u, 0x71374491u, 0xB5C0FBCFu, 0xE9B5DBA5u, 0x3956C25Bu,
    0x59F111F1u, 0x923F82A4u, 0xAB1C5ED5u, 0xD807AA98u, 0x12835B01u,
    0x243185BEu, 0x550C7DC3u, 0x72BE5D74u, 0x80DEB1FEu, 0x9BDC06A7u,
    0xC19BF174u, 0xE49B69C1u, 0xEFBE4786u, 0x0FC19DC6u, 0x240CA1CCu,
    0x2DE92C6Fu, 0x4A7484AAu, 0x5CB0A9DCu, 0x76F988DAu, 0x983E5152u,
    0xA831C66Du, 0xB00327C8u, 0xBF597FC7u, 0xC6E00BF3u, 0xD5A79147u,
    0x06CA6351u, 0x14292967u, 0x27B70A85u, 0x2E1B2138u, 0x4D2C6DFCu,
    0x53380D13u, 0x650A7354u, 0x766A0ABBu, 0x81C2C92Eu, 0x92722C85u,
    0xA2BFE8A1u, 0xA81A664Bu, 0xC24B8B70u, 0xC76C51A3u, 0xD192E819u,
    0xD6990624u, 0xF40E3585u, 0x106AA070u, 0x19A4C116u, 0x1E376C08u,
    0x2748774Cu, 0x34B0BCB5u, 0x391C0CB3u, 0x4ED8AA4Au, 0x5B9CCA4Fu,
    0x682E6FF3u, 0x748F82EEu, 0x78A5636Fu, 0x84C87814u, 0x8CC70208u,
    0x90BEFFFAu, 0xA4506CEBu, 0xBEF9A3F7u, 0xC67178F2u};

__device__ __constant__ uint32_t H256[8] = {
    0x6A09E667u, 0xBB67AE85u, 0x3C6EF372u, 0xA54FF53Au,
    0x510E527Fu, 0x9B05688Cu, 0x1F83D9ABu, 0x5BE0CD19u};
// the same IV as literals, for an initialiser the compiler folds
#define SHA256_IV                                        \
  {0x6A09E667u, 0xBB67AE85u, 0x3C6EF372u, 0xA54FF53Au, \
   0x510E527Fu, 0x9B05688Cu, 0x1F83D9ABu, 0x5BE0CD19u}

#ifdef __CUDACC__
// (hi:lo) >> n, the low 32 bits: one SHF
#define SHA256_FSHR(hi, lo, n) __funnelshift_r((lo), (hi), (n))
#define SHA256_BSWAP(x) __byte_perm((x), 0u, 0x0123)
#define SHA256_TREE_SYNC() __syncthreads()
// 16 bytes at a 16-byte aligned address, through the read-only cache
typedef uint4 sha256_u4;
#define SHA256_LD4(p) __ldg((const uint4 *)(p))
#else
#define SHA256_FSHR(hi, lo, n) \
  ((uint32_t)(((((uint64_t)(hi)) << 32) | (uint32_t)(lo)) >> (n)))
#define SHA256_BSWAP(x) __builtin_bswap32((uint32_t)(x))
#define SHA256_TREE_SYNC() ((void)0)
struct sha256_u4 { uint32_t x, y, z, w; };
#define SHA256_LD4(p) (*(const sha256_u4 *)(p))
#endif
#define SHA256_ROTR(x, n) SHA256_FSHR((x), (x), (n))

// One round on the working variables a..hh with kw = K[t] + W[t], the
// round of X4's compression and of X5's table-fed second block. A macro,
// and kw pasted unparenthesised, so that X4's compression compiles as the
// round written in place, `... + K256[t] + w[t & 15]`: through an inlined
// function with reference arguments nvcc gave X4's tree kernel 74
// registers instead of 68.
#define SHA256_ROUND(a, b, c, d, e, f, g, hh, kw)                           \
  do {                                                                      \
    const uint32_t S1_ =                                                    \
        SHA256_ROTR(e, 6) ^ SHA256_ROTR(e, 11) ^ SHA256_ROTR(e, 25);        \
    const uint32_t t1_ = hh + S1_ + (g ^ (e & (f ^ g))) + kw;               \
    const uint32_t S0_ =                                                    \
        SHA256_ROTR(a, 2) ^ SHA256_ROTR(a, 13) ^ SHA256_ROTR(a, 22);        \
    const uint32_t t2_ = S0_ + ((a & b) | (c & (a | b)));                   \
    hh = g;                                                                 \
    g = f;                                                                  \
    f = e;                                                                  \
    e = d + t1_;                                                            \
    d = c;                                                                  \
    c = b;                                                                  \
    b = a;                                                                  \
    a = t1_ + t2_;                                                          \
  } while (0)

// SHA256_ROUND as a function, for X5's second block (and x5_variants).
__device__ __forceinline__ void sha256_round(uint32_t &a, uint32_t &b,
                                             uint32_t &c, uint32_t &d,
                                             uint32_t &e, uint32_t &f,
                                             uint32_t &g, uint32_t &hh,
                                             uint32_t kw) {
  SHA256_ROUND(a, b, c, d, e, f, g, hh, kw);
}

// One compression of the 16 big-endian words w (overwritten: the schedule
// runs in place, a ring of 16) into the state h.
__device__ __forceinline__ void sha256_compress(uint32_t *h, uint32_t *w) {
  uint32_t a = h[0], b = h[1], c = h[2], d = h[3], e = h[4], f = h[5],
           g = h[6], hh = h[7];
#pragma unroll
  for (int t = 0; t < 64; t++) {
    if (t >= 16) {
      const uint32_t w15 = w[(t - 15) & 15], w2 = w[(t - 2) & 15];
      const uint32_t s0 = SHA256_ROTR(w15, 7) ^ SHA256_ROTR(w15, 18) ^ (w15 >> 3);
      const uint32_t s1 = SHA256_ROTR(w2, 17) ^ SHA256_ROTR(w2, 19) ^ (w2 >> 10);
      w[t & 15] += s0 + w[(t - 7) & 15] + s1;
    }
    SHA256_ROUND(a, b, c, d, e, f, g, hh, K256[t] + w[t & 15]);
  }
  h[0] += a; h[1] += b; h[2] += c; h[3] += d;
  h[4] += e; h[5] += f; h[6] += g; h[7] += hh;
}

// Byte p of the padded message prefix || row: plen (0 or 1) prefix bytes,
// then the len bytes of row, the 0x80 marker, zeros.
__device__ __forceinline__ uint32_t sha256_msg_byte(const uint8_t *row,
                                                    int len, int plen,
                                                    uint32_t prefix, int p) {
  if (p < plen) return prefix;
  if (p < plen + len) return row[p - plen];
  return p == plen + len ? 0x80u : 0u;
}

// SHA-256 state of prefix || row, plen (0 or 1) prefix bytes before the
// len bytes of row, read a byte at a time (any length, any alignment).
__device__ __forceinline__ void sha256_row_state(const uint8_t *row, int len,
                                                 int plen, uint32_t prefix,
                                                 uint32_t *h) {
#pragma unroll
  for (int j = 0; j < 8; j++) h[j] = H256[j];
  const int mlen = plen + len;
  const int nblocks = (mlen + 9 + 63) >> 6;
#pragma unroll 1
  for (int b = 0; b < nblocks; b++) {
    uint32_t w[16];
#pragma unroll
    for (int j = 0; j < 16; j++) {
      uint32_t v = 0;
#pragma unroll
      for (int k = 0; k < 4; k++)
        v = (v << 8) |
            sha256_msg_byte(row, len, plen, prefix, 64 * b + 4 * j + k);
      w[j] = v;
    }
    if (b == nblocks - 1) {  // the 64-bit bit length, past the marker
      const uint64_t bits = (uint64_t)mlen << 3;
      w[14] = (uint32_t)(bits >> 32);
      w[15] = (uint32_t)bits;
    }
    sha256_compress(h, w);
  }
}

// The first block's sixteen words of 0x01 || L || R, L and R digests as
// big-endian words: each word the last byte of one digest word and the
// first three of the next.
__device__ __forceinline__ void sha256_inner_block1(const uint32_t *l,
                                                    const uint32_t *r,
                                                    uint32_t *w) {
  w[0] = SHA256_FSHR(0x01u, l[0], 8);
#pragma unroll
  for (int j = 1; j < 8; j++) w[j] = SHA256_FSHR(l[j - 1], l[j], 8);
  w[8] = SHA256_FSHR(l[7], r[0], 8);
#pragma unroll
  for (int j = 9; j < 16; j++) w[j] = SHA256_FSHR(r[j - 9], r[j - 8], 8);
}

// The RFC 6962 inner hash sha256(0x01 || L || R) of two digests given as
// big-endian words -> out, big-endian words (out may alias l or r).
__device__ __forceinline__ void sha256_inner_words(const uint32_t *l,
                                                   const uint32_t *r,
                                                   uint32_t *out) {
  uint32_t h[8], w[16];
#pragma unroll
  for (int j = 0; j < 8; j++) h[j] = H256[j];
  sha256_inner_block1(l, r, w);
  const uint32_t tail = r[7] << 24;  // R's last byte, before w is reused
  sha256_compress(h, w);
  w[0] = tail | 0x00800000u;
#pragma unroll
  for (int j = 1; j < 15; j++) w[j] = 0;
  w[15] = 65 * 8;
  sha256_compress(h, w);
#pragma unroll
  for (int j = 0; j < 8; j++) out[j] = h[j];
}

// A 32-byte digest at p (4-byte aligned) as eight big-endian words.
__device__ __forceinline__ void sha256_load_digest(const uint8_t *p,
                                                   uint32_t *w) {
  const uint32_t *q = (const uint32_t *)p;
#pragma unroll
  for (int j = 0; j < 8; j++) w[j] = SHA256_BSWAP(q[j]);
}

// Eight big-endian words as the 32 digest bytes at p (4-byte aligned).
__device__ __forceinline__ void sha256_store_digest(const uint32_t *w,
                                                    uint8_t *p) {
  uint32_t *q = (uint32_t *)p;
#pragma unroll
  for (int j = 0; j < 8; j++) q[j] = SHA256_BSWAP(w[j]);
}

// Row i of X4: the digest of prefix || data[len i .. len i + len) to
// out[32 i ..]; prefix < 0 for none. A 64-byte row behind the 0x01 prefix
// at a 4-byte aligned address (an inner node: a tree level's pair, or
// L || R) is read as sixteen words, any other a byte at a time. The thread
// i == n of a launch with carry_tail copies the 32 bytes at data + len n to
// out[32 n ..] (the odd node a tree level carries up unchanged).
__device__ __forceinline__ void sha256_rows_item(const uint8_t *data,
                                                 uint8_t *out, int len, int n,
                                                 int prefix, int carry_tail,
                                                 int i) {
  const uint8_t *row = data + (size_t)len * i;
  uint32_t h[8];
  if (i == n) {
    if (!carry_tail) return;
    sha256_load_digest(row, h);
  } else if (i > n) {
    return;
  } else if (len == 64 && prefix == 1 && ((uintptr_t)row & 3) == 0) {
    uint32_t l[8], r[8];
    sha256_load_digest(row, l);
    sha256_load_digest(row + 32, r);
    sha256_inner_words(l, r, h);
  } else {
    sha256_row_state(row, len, prefix >= 0, (uint32_t)prefix & 0xff, h);
  }
  sha256_store_digest(h, out + (size_t)32 * i);
}

// -- a tree root in one launch (X4's tree kernel, sha256.cu) --

// leaves a block of the tree kernel reduces: its aligned subtree
#define SHA256_TREE_LEAVES 128

// Node t of the level above the m digests at src, to dst[32 t ..]: the
// inner hash of src's nodes 2t and 2t + 1, or, for t = (m - 1) / 2 with m
// odd, the odd node carried up unchanged (RFC 6962 level order).
__device__ __forceinline__ void sha256_tree_node(const uint8_t *src,
                                                 uint8_t *dst, int m, int t) {
  uint32_t h[8];
  if (2 * t + 1 < m) {
    uint32_t l[8], r[8];
    sha256_load_digest(src + (size_t)64 * t, l);
    sha256_load_digest(src + (size_t)64 * t + 32, r);
    sha256_inner_words(l, r, h);
  } else if (2 * t + 1 == m) {
    sha256_load_digest(src + (size_t)64 * t, h);
  } else {
    return;
  }
  sha256_store_digest(h, dst + (size_t)32 * t);
}

// The root of the m >= 1 digests at src, level by level: thread tid of nt
// takes nodes tid, tid + nt, ... of each level, levels alternate between
// a and b (room for (m + 1) / 2 digests each), and the threads meet at
// SHA256_TREE_SYNC() between levels (one thread, nt = 1, needs none).
// Returns where the root is: src itself when m = 1. Every thread of the
// block must call it with the same m.
__device__ __forceinline__ const uint8_t *sha256_tree_reduce(
    const uint8_t *src, uint8_t *a, uint8_t *b, int m, int tid, int nt) {
  const uint8_t *cur = src;
  uint8_t *next = a;
  while (m > 1) {
    const int up = (m + 1) >> 1;
    for (int t = tid; t < up; t += nt) sha256_tree_node(cur, next, m, t);
    SHA256_TREE_SYNC();
    cur = next;
    next = next == a ? b : a;
    m = up;
  }
  return cur;
}

// -- X5: the inner hash with its second block from a table, the walk --

// Row b of sha256_pad.cuh, K[t] + W[t] for t = 16..63 of the second block
// whose R ends in byte b, in twelve 16-byte loads.
__device__ __forceinline__ void sha256_pad_row(uint32_t b, uint32_t *kw) {
  const sha256_u4 *row = (const sha256_u4 *)(SHA256_PAD_KW + 48 * b);
#pragma unroll
  for (int j = 0; j < 12; j++) {
    const sha256_u4 v = SHA256_LD4(row + j);
    kw[4 * j] = v.x;
    kw[4 * j + 1] = v.y;
    kw[4 * j + 2] = v.z;
    kw[4 * j + 3] = v.w;
  }
}

// The second compression of 0x01 || L || R into h: W[0] = b << 24 |
// 0x800000 for R's last byte b, W[1..14] = 0 and W[15] = 520 folded into
// the round constants, K[t] + W[t] for t >= 16 from the table row kw. No
// schedule is expanded: 48 steps of ~10 integer instructions saved.
__device__ __forceinline__ void sha256_compress_pad(uint32_t *h, uint32_t b,
                                                    const uint32_t *kw) {
  uint32_t a = h[0], bb = h[1], c = h[2], d = h[3], e = h[4], f = h[5],
           g = h[6], hh = h[7];
#pragma unroll
  for (int t = 0; t < 64; t++) {
    const uint32_t k = t == 0    ? K256[0] + ((b << 24) | 0x00800000u)
                       : t == 15 ? K256[15] + 65u * 8u
                       : t < 16  ? K256[t]
                                 : kw[t - 16];
    sha256_round(a, bb, c, d, e, f, g, hh, k);
  }
  h[0] += a; h[1] += bb; h[2] += c; h[3] += d;
  h[4] += e; h[5] += f; h[6] += g; h[7] += hh;
}

// sha256_inner_words with the second block from the table: the row's
// loads are issued before the first compression, which hides them; the
// first block starts from the IV as literals, so its first round folds.
__device__ __forceinline__ void sha256_inner_pad(const uint32_t *l,
                                                 const uint32_t *r,
                                                 uint32_t *out) {
  uint32_t h[8] = SHA256_IV, w[16], kw[48];
  const uint32_t b = r[7] & 0xffu;
  sha256_pad_row(b, kw);
  sha256_inner_block1(l, r, w);
  sha256_compress(h, w);
  sha256_compress_pad(h, b, kw);
#pragma unroll
  for (int j = 0; j < 8; j++) out[j] = h[j];
}

// Two 16-byte halves of a digest as eight big-endian words.
__device__ __forceinline__ void sha256_words4(sha256_u4 lo, sha256_u4 hi,
                                              uint32_t *w) {
  w[0] = SHA256_BSWAP(lo.x);
  w[1] = SHA256_BSWAP(lo.y);
  w[2] = SHA256_BSWAP(lo.z);
  w[3] = SHA256_BSWAP(lo.w);
  w[4] = SHA256_BSWAP(hi.x);
  w[5] = SHA256_BSWAP(hi.y);
  w[6] = SHA256_BSWAP(hi.z);
  w[7] = SHA256_BSWAP(hi.w);
}

// Proof k of X5: from its leaf hash (leaf[32 k ..]) up through its aunts
// aunts[32 (off[k] + d) ..] for d < off[k + 1] - off[k], bottom-up; bit d
// of sides[k] set when aunt d is the left child (the node so far on the
// right). Each step is one sha256_inner_pad whose halves are picked by a
// select on that bit: one code path for both sides. The next aunt is
// loaded a step ahead (two 16-byte loads; aunts 16-byte aligned), so the
// walk does not wait on memory at each step. A proof's walk ends at its
// own depth, which is what the JAX program's no-op steps pad for. Writes
// the computed root to roots[32 k ..] and to ok[k] whether the proof
// passed its host checks (ok_in[k]) and its root equals want.
__device__ __forceinline__ void merkle_proof_item(
    const uint8_t *leaf, const uint8_t *aunts, const int32_t *off,
    const uint64_t *sides, const uint8_t *want, const uint8_t *ok_in,
    uint8_t *roots, uint8_t *ok, int k) {
  uint32_t h[8], a[8], l[8], r[8];
  sha256_load_digest(leaf + (size_t)32 * k, h);
  const int d0 = off[k], depth = off[k + 1] - d0;
  const uint64_t s = sides[k];
  sha256_u4 n0 = {0, 0, 0, 0}, n1 = {0, 0, 0, 0};
  if (depth > 0) {
    n0 = SHA256_LD4(aunts + (size_t)32 * d0);
    n1 = SHA256_LD4(aunts + (size_t)32 * d0 + 16);
  }
#pragma unroll 1
  for (int d = 0; d < depth; d++) {
    sha256_words4(n0, n1, a);
    if (d + 1 < depth) {
      n0 = SHA256_LD4(aunts + (size_t)32 * (d0 + d + 1));
      n1 = SHA256_LD4(aunts + (size_t)32 * (d0 + d + 1) + 16);
    }
    const bool left = (s >> d) & 1;
#pragma unroll
    for (int j = 0; j < 8; j++) {
      l[j] = left ? a[j] : h[j];
      r[j] = left ? h[j] : a[j];
    }
    sha256_inner_pad(l, r, h);
  }
  sha256_store_digest(h, roots + (size_t)32 * k);
  uint32_t w[8], diff = 0;
  sha256_load_digest(want, w);
#pragma unroll
  for (int j = 0; j < 8; j++) diff |= w[j] ^ h[j];
  ok[k] = ok_in[k] != 0 && diff == 0;
}
