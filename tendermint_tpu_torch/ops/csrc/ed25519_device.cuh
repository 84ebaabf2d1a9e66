// GF(2^255 - 19) and ed25519 group arithmetic for one thread per
// signature: the device functions shared by kernels K1
// (ed25519_dual_mult.cu) and K2 (ed25519_verify.cu).
//
// Counterparts: tendermint_tpu/ops/field25519.py (field) and
// tendermint_tpu/ops/edwards.py (points). The TPU forced 20 x 13-bit int32
// limbs in a batch-minor vector layout; a Hopper thread has native 64-bit
// adds and 32x32->64 multiplies, so one field element here is five 51-bit
// limbs in uint64 (radix 2^51) and products are taken in unsigned __int128.
// Formulas are the same as the JAX package's (add-2008-hwcd-3 with the
// second operand in cached form, dbl-2008-hwcd), so every intermediate is
// the same field element, only in other limbs.
//
// The header includes no CUDA runtime header, so a host compiler can build
// it too (with the CUDA qualifiers defined away) for checking the arithmetic
// against the host oracle without a card.
//
// Limb invariant: every fe handed between functions here is "carried":
// every limb < 2^52. fe_mul's column sums then stay below 2^111, its top
// carry times 19 below 2^60, and fe_sub's 4p bias exceeds every limb.

#pragma once
#include <stddef.h>
#include <stdint.h>

typedef unsigned __int128 u128;

#define FE_MASK51 0x7ffffffffffffULL

struct fe {
  uint64_t v[5];
};

// extended homogeneous coordinates: x = X/Z, y = Y/Z, xy = T/Z
struct ge_p3 {
  fe X, Y, Z, T;
};

// second operand of an addition: (Y - X, Y + X, 2d*T, 2Z)
struct ge_cached {
  fe YmX, YpX, T2d, Z2;
};

// -- constants (radix 2^51 limbs; tests/test_torch_csrc.py builds this
//    header with the host C++ compiler and holds it against the oracle) --

__device__ __constant__ uint64_t FE_D[5] = {
    0x34dca135978a3ULL, 0x1a8283b156ebdULL, 0x5e7a26001c029ULL,
    0x739c663a03cbbULL, 0x52036cee2b6ffULL};
__device__ __constant__ uint64_t FE_D2[5] = {
    0x69b9426b2f159ULL, 0x35050762add7aULL, 0x3cf44c0038052ULL,
    0x6738cc7407977ULL, 0x2406d9dc56dffULL};
__device__ __constant__ uint64_t FE_SQRTM1[5] = {
    0x61b274a0ea0b0ULL, 0x0d5a5fc8f189dULL, 0x7ef5e9cbd0c60ULL,
    0x78595a6804c9eULL, 0x2b8324804fc1dULL};

// j*B for j = 0..8 in cached form with Z = 1: (y-x, y+x, 2d*xy, 2).
// Counterpart: tendermint_tpu/ops/edwards.py niels_table_b.
__device__ __constant__ uint64_t GE_BASE_TABLE[9][4][5] = {
    {{0x0000000000001ULL, 0x0000000000000ULL, 0x0000000000000ULL, 0x0000000000000ULL, 0x0000000000000ULL},
     {0x0000000000001ULL, 0x0000000000000ULL, 0x0000000000000ULL, 0x0000000000000ULL, 0x0000000000000ULL},
     {0x0000000000000ULL, 0x0000000000000ULL, 0x0000000000000ULL, 0x0000000000000ULL, 0x0000000000000ULL},
     {0x0000000000002ULL, 0x0000000000000ULL, 0x0000000000000ULL, 0x0000000000000ULL, 0x0000000000000ULL}},
    {{0x03905d740913eULL, 0x0ba2817d673a2ULL, 0x23e2827f4e67cULL, 0x133d2e0c21a34ULL, 0x44fd2f9298f81ULL},
     {0x493c6f58c3b85ULL, 0x0df7181c325f7ULL, 0x0f50b0b3e4cb7ULL, 0x5329385a44c32ULL, 0x07cf9d3a33d4bULL},
     {0x11205877aaa68ULL, 0x479955893d579ULL, 0x50d66309b67a0ULL, 0x2d42d0dbee5eeULL, 0x6f117b689f0c6ULL},
     {0x0000000000002ULL, 0x0000000000000ULL, 0x0000000000000ULL, 0x0000000000000ULL, 0x0000000000000ULL}},
    {{0x1a56042b4d5a8ULL, 0x189cc159ed153ULL, 0x5b8deaa3cae04ULL, 0x2aaf04f11b5d8ULL, 0x6bb595a669c92ULL},
     {0x4e7fc933c71d7ULL, 0x2cf41feb6b244ULL, 0x7581c0a7d1a76ULL, 0x7172d534d32f0ULL, 0x590c063fa87d2ULL},
     {0x2a8b3a59b7a5fULL, 0x3abb359ef087fULL, 0x4f5a8c4db05afULL, 0x5b9a807d04205ULL, 0x701af5b13ea50ULL},
     {0x0000000000002ULL, 0x0000000000000ULL, 0x0000000000000ULL, 0x0000000000000ULL, 0x0000000000000ULL}},
    {{0x11fe8a4fcd265ULL, 0x7bcb8374faaccULL, 0x52f5af4ef4d4fULL, 0x5314098f98d10ULL, 0x2ab91587555bdULL},
     {0x5b0a84cee9730ULL, 0x61d10c97155e4ULL, 0x4059cc8096a10ULL, 0x47a608da8014fULL, 0x7a164e1b9a80fULL},
     {0x6933f0dd0d889ULL, 0x44386bb4c4295ULL, 0x3cb6d3162508cULL, 0x26368b872a2c6ULL, 0x5a2826af12b9bULL},
     {0x0000000000002ULL, 0x0000000000000ULL, 0x0000000000000ULL, 0x0000000000000ULL, 0x0000000000000ULL}},
    {{0x6050a056818bfULL, 0x62acc1f5532bfULL, 0x28141ccc9fa25ULL, 0x24d61f471e683ULL, 0x27933f4c7445aULL},
     {0x351b98efc099fULL, 0x68fbfa4a7050eULL, 0x42a49959d971bULL, 0x393e51a469efdULL, 0x680e910321e58ULL},
     {0x3fbe9c476ff09ULL, 0x0af6b982e4b42ULL, 0x0ad1251ba78e5ULL, 0x715aeedee7c88ULL, 0x7f9d0cbf63553ULL},
     {0x0000000000002ULL, 0x0000000000000ULL, 0x0000000000000ULL, 0x0000000000000ULL, 0x0000000000000ULL}},
    {{0x182c3a447d6baULL, 0x22964e536eff2ULL, 0x192821f540053ULL, 0x2f9f19e788e5cULL, 0x154a7e73eb1b5ULL},
     {0x2bc4408a5bb33ULL, 0x078ebdda05442ULL, 0x2ffb112354123ULL, 0x375ee8df5862dULL, 0x2945ccf146e20ULL},
     {0x3dbf1812a8285ULL, 0x0fa17ba3f9797ULL, 0x6f69cb49c3820ULL, 0x34d5a0db3858dULL, 0x43aabe696b3bbULL},
     {0x0000000000002ULL, 0x0000000000000ULL, 0x0000000000000ULL, 0x0000000000000ULL, 0x0000000000000ULL}},
    {{0x006b67b7d8ca4ULL, 0x084fa44e72933ULL, 0x1154ee55d6f8aULL, 0x4425d842e7390ULL, 0x38b64c41ae417ULL},
     {0x4eeeb77157131ULL, 0x1201915f10741ULL, 0x1669cda6c9c56ULL, 0x45ec032db346dULL, 0x51e57bb6a2cc3ULL},
     {0x4326702ea4b71ULL, 0x06834376030b5ULL, 0x0ef0512f9c380ULL, 0x0f1a9f2512584ULL, 0x10b8e91a9f0d6ULL},
     {0x0000000000002ULL, 0x0000000000000ULL, 0x0000000000000ULL, 0x0000000000000ULL, 0x0000000000000ULL}},
    {{0x72c9aaa3221b1ULL, 0x267774474f74dULL, 0x064b0e9b28085ULL, 0x3f04ef53b27c9ULL, 0x1d6edd5d2e531ULL},
     {0x25cd0944ea3bfULL, 0x75673b81a4d63ULL, 0x150b925d1c0d4ULL, 0x13f38d9294114ULL, 0x461bea69283c9ULL},
     {0x36dc801b8b3a2ULL, 0x0e0a7d4935e30ULL, 0x1deb7cecc0d7dULL, 0x053a94e20dd2cULL, 0x7a9fbb1c6a0f9ULL},
     {0x0000000000002ULL, 0x0000000000000ULL, 0x0000000000000ULL, 0x0000000000000ULL, 0x0000000000000ULL}},
    {{0x75dedf39234d9ULL, 0x01c36ab1f3c54ULL, 0x0f08fee58f5daULL, 0x0e19613a0d637ULL, 0x3a9024a1320e0ULL},
     {0x7596604dd3e8fULL, 0x6fc510e058b36ULL, 0x3670c8db2cc0dULL, 0x297d899ce332fULL, 0x0915e76061bceULL},
     {0x1f5d9c9a2911aULL, 0x7117994fafcf8ULL, 0x2d8a8cae28dc5ULL, 0x74ab1b2090c87ULL, 0x26907c5c2ecc4ULL},
     {0x0000000000002ULL, 0x0000000000000ULL, 0x0000000000000ULL, 0x0000000000000ULL, 0x0000000000000ULL}},
};

// L = 2^252 + 27742317777372353535851937790883648493, little-endian bytes
__device__ __constant__ uint8_t SC_L[32] = {
    237, 211, 245, 92, 26, 99, 18, 88, 214, 156, 247, 162, 222, 249, 222, 20,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 16};

// -- field --

__device__ __forceinline__ void fe_set_u64(fe &h, uint64_t x) {
  h.v[0] = x; h.v[1] = 0; h.v[2] = 0; h.v[3] = 0; h.v[4] = 0;
}

__device__ __forceinline__ void fe_load_const(fe &h, const uint64_t *c) {
#pragma unroll
  for (int i = 0; i < 5; i++) h.v[i] = c[i];
}

// one carry pass; the carry out of limb 4 wraps into limb 0 times 19
// (2^255 = 19 mod p)
__device__ __forceinline__ void fe_carry(fe &h) {
  uint64_t c;
  c = h.v[0] >> 51; h.v[0] &= FE_MASK51; h.v[1] += c;
  c = h.v[1] >> 51; h.v[1] &= FE_MASK51; h.v[2] += c;
  c = h.v[2] >> 51; h.v[2] &= FE_MASK51; h.v[3] += c;
  c = h.v[3] >> 51; h.v[3] &= FE_MASK51; h.v[4] += c;
  c = h.v[4] >> 51; h.v[4] &= FE_MASK51; h.v[0] += c * 19;
}

__device__ __forceinline__ void fe_add(fe &h, const fe &f, const fe &g) {
#pragma unroll
  for (int i = 0; i < 5; i++) h.v[i] = f.v[i] + g.v[i];
  fe_carry(h);
}

// f - g + 4p: every limb of 4p exceeds any carried limb of g
__device__ __forceinline__ void fe_sub(fe &h, const fe &f, const fe &g) {
  h.v[0] = f.v[0] + 0x1fffffffffffb4ULL - g.v[0];
  h.v[1] = f.v[1] + 0x1ffffffffffffcULL - g.v[1];
  h.v[2] = f.v[2] + 0x1ffffffffffffcULL - g.v[2];
  h.v[3] = f.v[3] + 0x1ffffffffffffcULL - g.v[3];
  h.v[4] = f.v[4] + 0x1ffffffffffffcULL - g.v[4];
  fe_carry(h);
}

__device__ __forceinline__ void fe_neg(fe &h, const fe &f) {
  fe z;
  fe_set_u64(z, 0);
  fe_sub(h, z, f);
}

__device__ void fe_mul(fe &h, const fe &f, const fe &g) {
  const uint64_t f0 = f.v[0], f1 = f.v[1], f2 = f.v[2], f3 = f.v[3],
                 f4 = f.v[4];
  const uint64_t g0 = g.v[0], g1 = g.v[1], g2 = g.v[2], g3 = g.v[3],
                 g4 = g.v[4];
  const uint64_t g1_19 = 19 * g1, g2_19 = 19 * g2, g3_19 = 19 * g3,
                 g4_19 = 19 * g4;
  u128 t0 = (u128)f0 * g0 + (u128)f1 * g4_19 + (u128)f2 * g3_19 +
            (u128)f3 * g2_19 + (u128)f4 * g1_19;
  u128 t1 = (u128)f0 * g1 + (u128)f1 * g0 + (u128)f2 * g4_19 +
            (u128)f3 * g3_19 + (u128)f4 * g2_19;
  u128 t2 = (u128)f0 * g2 + (u128)f1 * g1 + (u128)f2 * g0 +
            (u128)f3 * g4_19 + (u128)f4 * g3_19;
  u128 t3 = (u128)f0 * g3 + (u128)f1 * g2 + (u128)f2 * g1 +
            (u128)f3 * g0 + (u128)f4 * g4_19;
  u128 t4 = (u128)f0 * g4 + (u128)f1 * g3 + (u128)f2 * g2 +
            (u128)f3 * g1 + (u128)f4 * g0;
  uint64_t r0, r1, r2, r3, r4, c;
  r0 = (uint64_t)t0 & FE_MASK51; t1 += (uint64_t)(t0 >> 51);
  r1 = (uint64_t)t1 & FE_MASK51; t2 += (uint64_t)(t1 >> 51);
  r2 = (uint64_t)t2 & FE_MASK51; t3 += (uint64_t)(t2 >> 51);
  r3 = (uint64_t)t3 & FE_MASK51; t4 += (uint64_t)(t3 >> 51);
  r4 = (uint64_t)t4 & FE_MASK51; c = (uint64_t)(t4 >> 51);
  r0 += c * 19;
  c = r0 >> 51; r0 &= FE_MASK51; r1 += c;
  h.v[0] = r0; h.v[1] = r1; h.v[2] = r2; h.v[3] = r3; h.v[4] = r4;
}

__device__ __forceinline__ void fe_sq(fe &h, const fe &f) { fe_mul(h, f, f); }

// h = f^(2^k)
__device__ void fe_pow2k(fe &h, const fe &f, int k) {
  fe_sq(h, f);
  for (int i = 1; i < k; i++) fe_sq(h, h);
}

// Fully reduce to [0, p): two carry passes leave every limb below 2^51
// (value < 2^255 < 2p), then subtract p once if value + 19 reaches 2^255.
__device__ void fe_canonical(fe &h) {
  fe_carry(h);
  fe_carry(h);
  uint64_t q = (h.v[0] + 19) >> 51;
  q = (h.v[1] + q) >> 51;
  q = (h.v[2] + q) >> 51;
  q = (h.v[3] + q) >> 51;
  q = (h.v[4] + q) >> 51;
  h.v[0] += 19 * q;
  uint64_t c;
  c = h.v[0] >> 51; h.v[0] &= FE_MASK51; h.v[1] += c;
  c = h.v[1] >> 51; h.v[1] &= FE_MASK51; h.v[2] += c;
  c = h.v[2] >> 51; h.v[2] &= FE_MASK51; h.v[3] += c;
  c = h.v[3] >> 51; h.v[3] &= FE_MASK51; h.v[4] += c;
  h.v[4] &= FE_MASK51;
}

__device__ __forceinline__ bool fe_is_zero(const fe &f) {
  fe t = f;
  fe_canonical(t);
  return (t.v[0] | t.v[1] | t.v[2] | t.v[3] | t.v[4]) == 0;
}

__device__ __forceinline__ bool fe_eq(const fe &a, const fe &b) {
  fe d;
  fe_sub(d, a, b);
  return fe_is_zero(d);
}

// 32 little-endian bytes with bit 255 already cleared. The value may be
// >= p (ZIP-215 accepts non-canonical y); every op here takes any
// representative.
__device__ void fe_from_bytes(fe &h, const uint8_t *s) {
  uint64_t w[4];
#pragma unroll
  for (int i = 0; i < 4; i++) {
    uint64_t x = 0;
#pragma unroll
    for (int j = 7; j >= 0; j--) x = (x << 8) | s[8 * i + j];
    w[i] = x;
  }
  h.v[0] = w[0] & FE_MASK51;
  h.v[1] = ((w[0] >> 51) | (w[1] << 13)) & FE_MASK51;
  h.v[2] = ((w[1] >> 38) | (w[2] << 26)) & FE_MASK51;
  h.v[3] = ((w[2] >> 25) | (w[3] << 39)) & FE_MASK51;
  h.v[4] = (w[3] >> 12) & FE_MASK51;
}

// x^((p-5)/8) = x^(2^252 - 3): the addition chain of field25519.pow_p58
__device__ void fe_pow_p58(fe &out, const fe &x) {
  fe x2, t, x9, x11, x22, x5, x10, x20, x40, x50, x100, x200, x250;
  fe_sq(x2, x);
  fe_sq(t, x2);
  fe_sq(t, t);
  fe_mul(x9, x, t);
  fe_mul(x11, x2, x9);
  fe_sq(x22, x11);
  fe_mul(x5, x9, x22);
  fe_pow2k(t, x5, 5);
  fe_mul(x10, t, x5);
  fe_pow2k(t, x10, 10);
  fe_mul(x20, t, x10);
  fe_pow2k(t, x20, 20);
  fe_mul(x40, t, x20);
  fe_pow2k(t, x40, 10);
  fe_mul(x50, t, x10);
  fe_pow2k(t, x50, 50);
  fe_mul(x100, t, x50);
  fe_pow2k(t, x100, 100);
  fe_mul(x200, t, x100);
  fe_pow2k(t, x200, 50);
  fe_mul(x250, t, x50);
  fe_pow2k(t, x250, 2);
  fe_mul(out, t, x);
}

// -- points --

__device__ __forceinline__ void ge_identity(ge_p3 &p) {
  fe_set_u64(p.X, 0);
  fe_set_u64(p.Y, 1);
  fe_set_u64(p.Z, 1);
  fe_set_u64(p.T, 0);
}

__device__ void ge_to_cached(ge_cached &c, const ge_p3 &p) {
  fe d2;
  fe_load_const(d2, FE_D2);
  fe_sub(c.YmX, p.Y, p.X);
  fe_add(c.YpX, p.Y, p.X);
  fe_mul(c.T2d, p.T, d2);
  fe_add(c.Z2, p.Z, p.Z);
}

__device__ __forceinline__ void ge_neg(ge_p3 &r, const ge_p3 &p) {
  fe_neg(r.X, p.X);
  r.Y = p.Y;
  r.Z = p.Z;
  fe_neg(r.T, p.T);
}

// p + q (q cached). with_t = false skips the T output (the next op is a
// doubling or a projective compare, neither reads T).
__device__ void ge_add_cached(ge_p3 &r, const ge_p3 &p, const ge_cached &q,
                              bool with_t) {
  fe a, b, c, d, e, f, g, h;
  fe_sub(a, p.Y, p.X);
  fe_mul(a, a, q.YmX);
  fe_add(b, p.Y, p.X);
  fe_mul(b, b, q.YpX);
  fe_mul(c, p.T, q.T2d);
  fe_mul(d, p.Z, q.Z2);
  fe_sub(e, b, a);
  fe_sub(f, d, c);
  fe_add(g, d, c);
  fe_add(h, b, a);
  fe_mul(r.X, e, f);
  fe_mul(r.Y, g, h);
  fe_mul(r.Z, f, g);
  if (with_t) fe_mul(r.T, e, h);
}

// dbl-2008-hwcd in the sign convention of edwards.point_double: reads
// X, Y, Z only
__device__ void ge_double(ge_p3 &r, const ge_p3 &p, bool with_t) {
  fe a, b, zs, s, e, f, g, h, xy;
  fe_sq(a, p.X);
  fe_sq(b, p.Y);
  fe_sq(zs, p.Z);
  fe_add(xy, p.X, p.Y);
  fe_sq(s, xy);
  fe_add(h, a, b);   // H = A + B
  fe_sub(e, h, s);   // E = A + B - S
  fe_sub(g, a, b);   // G = A - B
  fe_add(f, zs, zs);
  fe_add(f, f, g);   // F = 2Zs + A - B
  fe_mul(r.X, e, f);
  fe_mul(r.Y, g, h);
  fe_mul(r.Z, f, g);
  if (with_t) fe_mul(r.T, e, h);
}

// -- scalars --

// (64,) radix-16 digits in [0, 15], little-endian -> signed digits in
// [-8, 7]. A carry out of digit 63 is dropped, exactly as
// ed25519_kernel._recode_signed drops it (only S >= 2^256 - 8*16^63 can
// produce one, and such S fail the S < L check anyway).
__device__ __forceinline__ void sc_recode_signed(int8_t *e, const uint8_t *d) {
  int c = 0;
  for (int i = 0; i < 64; i++) {
    int t = d[i] + c;
    c = t >= 8;
    e[i] = (int8_t)(t - 16 * c);
  }
}

__device__ __forceinline__ void sc_nibbles(uint8_t *d, const uint8_t *b) {
  for (int i = 0; i < 32; i++) {
    d[2 * i] = b[i] & 15;
    d[2 * i + 1] = b[i] >> 4;
  }
}

// value < L for 32 little-endian bytes (ZIP-215 rule 2: S canonical)
__device__ __forceinline__ bool sc_lt_l(const uint8_t *s) {
  for (int i = 31; i >= 0; i--) {
    if (s[i] < SC_L[i]) return true;
    if (s[i] > SC_L[i]) return false;
  }
  return false;
}

// 64 little-endian digest bytes -> 32 little-endian bytes of the value
// mod L. Bit-serial shift-and-subtract over the 512 bits (r < L < 2^253
// so 2r + 1 fits four 64-bit words). Simple and exact; about 5% of the
// per-signature work.
__device__ void sc_reduce512(uint8_t *out, const uint8_t *dig) {
  uint64_t l[4], r[4] = {0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < 4; i++) {
    uint64_t x = 0;
#pragma unroll
    for (int j = 7; j >= 0; j--) x = (x << 8) | SC_L[8 * i + j];
    l[i] = x;
  }
  for (int bit = 511; bit >= 0; bit--) {
    uint64_t in = (dig[bit >> 3] >> (bit & 7)) & 1;
    r[3] = (r[3] << 1) | (r[2] >> 63);
    r[2] = (r[2] << 1) | (r[1] >> 63);
    r[1] = (r[1] << 1) | (r[0] >> 63);
    r[0] = (r[0] << 1) | in;
    // t = r - L; keep it when no borrow (r >= L)
    uint64_t t[4], borrow = 0;
#pragma unroll
    for (int i = 0; i < 4; i++) {
      uint64_t a = r[i], b = l[i];
      uint64_t d = a - b - borrow;
      borrow = (a < b) | ((a == b) & borrow);
      t[i] = d;
    }
    if (!borrow) {
#pragma unroll
      for (int i = 0; i < 4; i++) r[i] = t[i];
    }
  }
#pragma unroll
  for (int i = 0; i < 4; i++)
#pragma unroll
    for (int j = 0; j < 8; j++) out[8 * i + j] = (uint8_t)(r[i] >> (8 * j));
}

// -- the dual scalar multiplication (body of K1, called inside K2) --

// r may alias q
__device__ __forceinline__ void ge_cached_neg(ge_cached &r, const ge_cached &q) {
  fe ymx = q.YmX;
  r.YmX = q.YpX;
  r.YpX = ymx;
  fe_neg(r.T2d, q.T2d);
  r.Z2 = q.Z2;
}

__device__ __forceinline__ void ge_base_entry(ge_cached &r, int j) {
  fe_load_const(r.YmX, GE_BASE_TABLE[j][0]);
  fe_load_const(r.YpX, GE_BASE_TABLE[j][1]);
  fe_load_const(r.T2d, GE_BASE_TABLE[j][2]);
  fe_load_const(r.Z2, GE_BASE_TABLE[j][3]);
}

// [S]B - [k]A for one signature: dS, dk are 64 radix-16 digits in
// [0, 15], little-endian. Horner over 64 windows, most significant
// first: acc <- 16*acc + e_k*(-A) + e_S*B with signed digits, a 9-entry
// cached table of -A built here and the constant table of B. Entries are
// read by index: verification handles public data only.
// Counterpart: ed25519_kernel.dual_mult_sb_minus_ka.
__device__ void ge_dual_mult(ge_p3 &acc, const ge_p3 &A, const uint8_t *dS,
                             const uint8_t *dk) {
  ge_cached ta[9];
  ge_p3 e1, e2, e3, e4, t;
  ge_neg(e1, A);
  ge_p3 id;
  ge_identity(id);
  ge_to_cached(ta[0], id);
  ge_to_cached(ta[1], e1);
  ge_double(e2, e1, true);
  ge_to_cached(ta[2], e2);
  ge_add_cached(e3, e2, ta[1], true);
  ge_to_cached(ta[3], e3);
  ge_double(e4, e2, true);
  ge_to_cached(ta[4], e4);
  ge_add_cached(t, e4, ta[1], true);
  ge_to_cached(ta[5], t);
  ge_double(t, e3, true);
  ge_to_cached(ta[6], t);
  ge_add_cached(t, t, ta[1], true);
  ge_to_cached(ta[7], t);
  ge_double(t, e4, true);
  ge_to_cached(ta[8], t);

  int8_t es[64], ek[64];
  sc_recode_signed(es, dS);
  sc_recode_signed(ek, dk);

  ge_identity(acc);
  ge_cached q;
  for (int w = 63; w >= 0; w--) {
    ge_double(acc, acc, false);
    ge_double(acc, acc, false);
    ge_double(acc, acc, false);
    ge_double(acc, acc, true);
    int e = ek[w];
    if (e < 0) {
      ge_cached_neg(q, ta[-e]);
    } else {
      q = ta[e];
    }
    ge_add_cached(acc, acc, q, true);
    e = es[w];
    ge_base_entry(q, e < 0 ? -e : e);
    if (e < 0) ge_cached_neg(q, q);
    ge_add_cached(acc, acc, q, false);
  }
}

// ZIP-215 decompression (RFC 8032 5.1.3 accepting y >= p): y already has
// bit 255 cleared, sign is that bit. Returns ok; rejects x = 0 with
// sign = 1. Counterpart: edwards.decompress.
__device__ bool ge_decompress(ge_p3 &p, const fe &y, int sign) {
  fe one, d, y2, u, v, v2, v3, v7, uv7, t, x, vx2, nu, sqm1;
  fe_set_u64(one, 1);
  fe_load_const(d, FE_D);
  fe_sq(y2, y);
  fe_sub(u, y2, one);
  fe_mul(v, y2, d);
  fe_add(v, v, one);
  fe_sq(v2, v);
  fe_mul(v3, v2, v);
  fe_sq(v7, v3);
  fe_mul(v7, v7, v);
  fe_mul(uv7, u, v7);
  fe_pow_p58(t, uv7);
  fe_mul(x, u, v3);
  fe_mul(x, x, t);
  fe_sq(vx2, x);
  fe_mul(vx2, vx2, v);
  fe_neg(nu, u);
  bool root_ok = fe_eq(vx2, u);
  bool neg_root_ok = fe_eq(vx2, nu);
  if (neg_root_ok) {
    fe_load_const(sqm1, FE_SQRTM1);
    fe_mul(x, x, sqm1);
  }
  bool ok = root_ok || neg_root_ok;
  fe xc = x;
  fe_canonical(xc);
  if ((int)(xc.v[0] & 1) != sign) fe_neg(x, x);
  if (fe_is_zero(x) && sign == 1) ok = false;
  p.X = x;
  p.Y = y;
  fe_set_u64(p.Z, 1);
  fe_mul(p.T, x, y);
  return ok;
}

// -- one signature: the bodies of kernels K2 and K1 --

// The whole ZIP-215 cofactored check for one signature: a (32) public key,
// sig (64) = R || S, dig (64) = SHA-512(R || A || M), all little-endian
// bytes. Counterpart: ed25519_kernel._verify_tile.
__device__ bool ed25519_verify_one(const uint8_t *a, const uint8_t *sig,
                                   const uint8_t *dig) {
  uint8_t a_b[32], r_b[32], s_b[32], k_b[32];
  for (int j = 0; j < 32; j++) {
    a_b[j] = a[j];
    r_b[j] = sig[j];
    s_b[j] = sig[32 + j];
  }
  int sign_a = a_b[31] >> 7;
  a_b[31] &= 0x7f;
  int sign_r = r_b[31] >> 7;
  r_b[31] &= 0x7f;
  bool s_ok = sc_lt_l(s_b);

  fe ya, yr;
  fe_from_bytes(ya, a_b);
  fe_from_bytes(yr, r_b);
  ge_p3 A, R, acc;
  bool ok_a = ge_decompress(A, ya, sign_a);
  bool ok_r = ge_decompress(R, yr, sign_r);

  uint8_t ds[64], dk[64];
  sc_nibbles(ds, s_b);
  sc_reduce512(k_b, dig);
  sc_nibbles(dk, k_b);
  ge_dual_mult(acc, A, ds, dk);

  for (int j = 0; j < 3; j++) {  // cofactor 8, both sides
    ge_double(acc, acc, false);
    ge_double(R, R, false);
  }
  fe l, r;
  fe_mul(l, acc.X, R.Z);
  fe_mul(r, R.X, acc.Z);
  bool same = fe_eq(l, r);
  fe_mul(l, acc.Y, R.Z);
  fe_mul(r, R.Y, acc.Z);
  same = same && fe_eq(l, r);
  return same && ok_a && ok_r && s_ok;
}

// 20 x 13-bit limbs (any normalized representative, nonnegative value)
// at rows[limb * n + i] -> radix 2^51
__device__ void fe_from_limbs13(fe &h, const int32_t *rows, int n, int i) {
  int64_t d[20];
  int64_t c = 0;
  for (int k = 0; k < 20; k++) {
    int64_t t = (int64_t)rows[(size_t)k * n + i] + c;
    d[k] = t & 8191;
    c = t >> 13;
  }
  // 2^260 = 608 mod p: fold the carry out once more
  for (int pass = 0; pass < 2 && c != 0; pass++) {
    int64_t cin = c * 608;
    c = 0;
    for (int k = 0; k < 20; k++) {
      int64_t t = d[k] + (k == 0 ? cin : 0) + c;
      d[k] = t & 8191;
      c = t >> 13;
    }
  }
  uint64_t acc[6] = {0, 0, 0, 0, 0, 0};
  for (int k = 0; k < 20; k++) {
    int bit = 13 * k;
    int w = bit / 51, off = bit % 51;
    uint64_t v = (uint64_t)d[k] << off;  // < 2^63
    acc[w] += v & FE_MASK51;
    acc[w + 1] += v >> 51;
  }
  h.v[0] = acc[0] + 19 * acc[5];  // bits >= 255: 2^255 = 19 mod p
  h.v[1] = acc[1];
  h.v[2] = acc[2];
  h.v[3] = acc[3];
  h.v[4] = acc[4];
  fe_carry(h);
  fe_carry(h);
}

// canonical value -> 20 x 13-bit limbs at rows[limb * n + i]
__device__ void fe_to_limbs13(int32_t *rows, const fe &f, int n, int i) {
  fe t = f;
  fe_canonical(t);
  for (int k = 0; k < 20; k++) {
    int bit = 13 * k;
    int w = bit / 51, off = bit % 51;
    uint64_t v = t.v[w] >> off;
    if (off > 38 && w < 4) v |= t.v[w + 1] << (51 - off);
    rows[(size_t)k * n + i] = (int32_t)(v & 8191);
  }
}

// [S]B - [k]A for column i of the JAX contract: a (4, 20, n) int32 extended
// point, ds/dk (64, n) int32 digits in [0, 15] -> out (3, 20, n) int32
// canonical limbs of (X, Y, Z). Counterpart: dual_mult_sb_minus_ka.
__device__ void ed25519_dual_mult_one(const int32_t *a, const int32_t *ds,
                                      const int32_t *dk, int32_t *out, int n,
                                      int i) {
  const size_t coord = (size_t)20 * n;
  ge_p3 A, acc;
  fe_from_limbs13(A.X, a, n, i);
  fe_from_limbs13(A.Y, a + coord, n, i);
  fe_from_limbs13(A.Z, a + 2 * coord, n, i);
  fe_from_limbs13(A.T, a + 3 * coord, n, i);
  uint8_t dsv[64], dkv[64];
  for (int j = 0; j < 64; j++) {
    dsv[j] = (uint8_t)ds[(size_t)j * n + i];
    dkv[j] = (uint8_t)dk[(size_t)j * n + i];
  }
  ge_dual_mult(acc, A, dsv, dkv);
  fe_to_limbs13(out, acc.X, n, i);
  fe_to_limbs13(out + coord, acc.Y, n, i);
  fe_to_limbs13(out + 2 * coord, acc.Z, n, i);
}
