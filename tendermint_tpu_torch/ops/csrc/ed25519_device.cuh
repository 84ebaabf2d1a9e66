// GF(2^255 - 19) and ed25519 group arithmetic with four threads ("lanes")
// per signature: the device functions shared by kernels K1
// (ed25519_dual_mult.cu) and K2 (ed25519_verify.cu).
//
// Counterparts: tendermint_tpu/ops/field25519.py (field) and
// tendermint_tpu/ops/edwards.py (points). The TPU forced 20 x 13-bit int32
// limbs in a batch-minor vector layout; a Hopper thread multiplies 32x32->64
// and adds into 64 bits in one instruction (IMAD.WIDE), so one field
// element here is ten limbs of 26 and 25 bits in uint32 (radix 2^25.5, as
// ref10), a product 100 such multiply-adds. Radix 2^51 (five limbs,
// unsigned __int128 products) takes 341 SASS instructions a multiply and
// 227 a squaring against 205 and 152 here (ops/sass_count.py). Formulas
// are the same as the JAX package's (add-2008-hwcd-3 with the second
// operand in cached form, dbl-2008-hwcd), split over four lanes
// (see "the four lanes of one signature" below), so every intermediate is
// the same field element, only in other limbs.
//
// The header includes no CUDA runtime header, so a host compiler can build
// it too (with the CUDA qualifiers defined away and the lane exchange
// emulated) for checking the arithmetic against the host oracle without a
// card.
//
// Limb invariants, in multiples of a limb's width w (26 or 25 bits). A
// "carried" fe has every limb < 2^w + 2^18: fe_add, fe_sub, fe_mul and
// fe_sq return carried values, and fe_sub's 2p bias exceeds every carried
// limb of what it subtracts. Sums and differences of carried values
// without a carry pass (fe_add_nc, fe_sub_nc) are "k-loose", every limb <
// k 2^w, and go only into fe_mul and fe_sq: fe_mul(h, f, g) takes f up to
// 4-loose and g up to 3-loose (19 g must fit 32 bits), fe_sq up to
// 3-loose; every column sum then stays below 2^63.

#pragma once
#include <stddef.h>
#include <stdint.h>

struct fe {
  uint32_t v[10];
};

// extended homogeneous coordinates: x = X/Z, y = Y/Z, xy = T/Z
struct ge_p3 {
  fe X, Y, Z, T;
};

#define FE_M26 0x3ffffffu
#define FE_M25 0x1ffffffu

// limb i holds bits FE_OFF(i) .. FE_OFF(i + 1) - 1: 26 bits at even i,
// 25 at odd
#define FE_OFF(i) (((i) * 51 + 1) / 2)
#define FE_BITS(i) (((i) & 1) ? 25 : 26)

// -- constants (radix 2^25.5 limbs; tests/test_torch_csrc.py builds this
//    header with the host C++ compiler and holds it against the oracle) --

__device__ __constant__ uint32_t FE_D[10] = {0x35978a3, 0x0d37284, 0x3156ebd, 0x06a0a0e, 0x001c029, 0x179e898, 0x3a03cbb, 0x1ce7198, 0x2e2b6ff, 0x1480db3};
__device__ __constant__ uint32_t FE_D2[10] = {0x2b2f159, 0x1a6e509, 0x22add7a, 0x0d4141d, 0x0038052, 0x0f3d130, 0x3407977, 0x19ce331, 0x1c56dff, 0x0901b67};
__device__ __constant__ uint32_t FE_SQRTM1[10] = {0x20ea0b0, 0x186c9d2, 0x08f189d, 0x035697f, 0x0bd0c60, 0x1fbd7a7, 0x2804c9e, 0x1e16569, 0x004fc1d, 0x0ae0c92};
__device__ __constant__ uint32_t GE_BASE_TABLE[9][4][10] = {
    {{0x0000001, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000},
     {0x0000001, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000},
     {0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000},
     {0x0000002, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000}},
    {{0x340913e, 0x00e4175, 0x3d673a2, 0x02e8a05, 0x3f4e67c, 0x08f8a09, 0x0c21a34, 0x04cf4b8, 0x1298f81, 0x113f4be},
     {0x18c3b85, 0x124f1bd, 0x1c325f7, 0x037dc60, 0x33e4cb7, 0x03d42c2, 0x1a44c32, 0x14ca4e1, 0x3a33d4b, 0x01f3e74},
     {0x37aaa68, 0x0448161, 0x093d579, 0x11e6556, 0x09b67a0, 0x143598c, 0x1bee5ee, 0x0b50b43, 0x289f0c6, 0x1bc45ed},
     {0x0000002, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000}},
    {{0x2b4d5a8, 0x0695810, 0x19ed153, 0x0627305, 0x23cae04, 0x16e37aa, 0x311b5d8, 0x0aabc13, 0x2669c92, 0x1aed656},
     {0x33c71d7, 0x139ff24, 0x2b6b244, 0x0b3d07f, 0x27d1a76, 0x1d60702, 0x34d32f0, 0x1c5cb54, 0x3fa87d2, 0x1643018},
     {0x19b7a5f, 0x0aa2ce9, 0x1ef087f, 0x0eaecd6, 0x0db05af, 0x13d6a31, 0x3d04205, 0x16e6a01, 0x313ea50, 0x1c06bd6},
     {0x0000002, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000}},
    {{0x0fcd265, 0x047fa29, 0x34faacc, 0x1ef2e0d, 0x0ef4d4f, 0x14bd6bd, 0x0f98d10, 0x14c5026, 0x07555bd, 0x0aae456},
     {0x0ee9730, 0x16c2a13, 0x17155e4, 0x1874432, 0x0096a10, 0x1016732, 0x1a8014f, 0x11e9823, 0x1b9a80f, 0x1e85938},
     {0x1d0d889, 0x1a4cfc3, 0x34c4295, 0x110e1ae, 0x162508c, 0x0f2db4c, 0x072a2c6, 0x098da2e, 0x2f12b9b, 0x168a09a},
     {0x0000002, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000}},
    {{0x16818bf, 0x1814281, 0x35532bf, 0x18ab307, 0x0c9fa25, 0x0a05073, 0x071e683, 0x093587d, 0x0c7445a, 0x09e4cfd},
     {0x2fc099f, 0x0d46e63, 0x0a7050e, 0x1a3efe9, 0x19d971b, 0x10a9265, 0x2469efd, 0x0e4f946, 0x0321e58, 0x1a03a44},
     {0x076ff09, 0x0fefa71, 0x02e4b42, 0x02bdae6, 0x1ba78e5, 0x02b4494, 0x1ee7c88, 0x1c56bbb, 0x3f63553, 0x1fe7432},
     {0x0000002, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000}},
    {{0x047d6ba, 0x060b0e9, 0x136eff2, 0x08a5939, 0x3540053, 0x064a087, 0x2788e5c, 0x0be7c67, 0x33eb1b5, 0x05529f9},
     {0x0a5bb33, 0x0af1102, 0x1a05442, 0x01e3af7, 0x2354123, 0x0bfec44, 0x1f5862d, 0x0dd7ba3, 0x3146e20, 0x0a51733},
     {0x12a8285, 0x0f6fc60, 0x23f9797, 0x03e85ee, 0x09c3820, 0x1bda72d, 0x1b3858d, 0x0d35683, 0x296b3bb, 0x10eaaf9},
     {0x0000002, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000}},
    {{0x37d8ca4, 0x001ad9e, 0x0e72933, 0x0213e91, 0x15d6f8a, 0x04553b9, 0x02e7390, 0x1109761, 0x01ae417, 0x0e2d931},
     {0x3157131, 0x13bbadd, 0x1f10741, 0x0480645, 0x26c9c56, 0x059a736, 0x2db346d, 0x117b00c, 0x36a2cc3, 0x14795ee},
     {0x2ea4b71, 0x10c99c0, 0x36030b5, 0x01a0d0d, 0x2f9c380, 0x03bc144, 0x2512584, 0x03c6a7c, 0x1a9f0d6, 0x042e3a4},
     {0x0000002, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000}},
    {{0x23221b1, 0x1cb26aa, 0x074f74d, 0x099ddd1, 0x1b28085, 0x0192c3a, 0x13b27c9, 0x0fc13bd, 0x1d2e531, 0x075bb75},
     {0x04ea3bf, 0x0973425, 0x01a4d63, 0x1d59cee, 0x1d1c0d4, 0x0542e49, 0x1294114, 0x04fce36, 0x29283c9, 0x1186fa9},
     {0x1b8b3a2, 0x0db7200, 0x0935e30, 0x03829f5, 0x2cc0d7d, 0x077adf3, 0x220dd2c, 0x014ea53, 0x1c6a0f9, 0x1ea7eec},
     {0x0000002, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000}},
    {{0x39234d9, 0x1d77b7c, 0x31f3c54, 0x0070daa, 0x258f5da, 0x03c23fb, 0x3a0d637, 0x0386584, 0x21320e0, 0x0ea4092},
     {0x0dd3e8f, 0x1d65981, 0x2058b36, 0x1bf1443, 0x1b2cc0d, 0x0d9c323, 0x1ce332f, 0x0a5f626, 0x2061bce, 0x024579d},
     {0x1a2911a, 0x07d7672, 0x0fafcf8, 0x1c45e65, 0x2e28dc5, 0x0b62a32, 0x2090c87, 0x1d2ac6c, 0x1c2ecc4, 0x09a41f1},
     {0x0000002, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000, 0x0000000}},
};

// -- field --

__device__ __forceinline__ void fe_set_u32(fe &h, uint32_t x) {
  h.v[0] = x;
#pragma unroll
  for (int i = 1; i < 10; i++) h.v[i] = 0;
}

__device__ __forceinline__ void fe_load_const(fe &h, const uint32_t *c) {
#pragma unroll
  for (int i = 0; i < 10; i++) h.v[i] = c[i];
}

// one carry pass, limb 0 to limb 9; the carry out of limb 9 wraps into
// limb 0 times 19 (2^255 = 19 mod p)
__device__ __forceinline__ void fe_carry_seq(fe &h) {
#pragma unroll
  for (int i = 0; i < 9; i++) {
    const uint32_t c = h.v[i] >> FE_BITS(i);
    h.v[i] &= (i & 1) ? FE_M25 : FE_M26;
    h.v[i + 1] += c;
  }
  const uint32_t c = h.v[9] >> 25;
  h.v[9] &= FE_M25;
  h.v[0] += 19 * c;
}

// The carry pass in two interleaved chains (limbs 0-5 and 4-9, then the
// wrap), as ref10 orders it: half the dependent depth of fe_carry_seq.
// T is uint32_t (sums) or uint64_t (a product's column sums).
#define FE_CARRY_STEP(t, i)                 \
  {                                         \
    const auto c = (t)[i] >> FE_BITS(i);    \
    (t)[i + 1] += c;                        \
    (t)[i] &= (i & 1) ? FE_M25 : FE_M26;    \
  }
template <typename T>
__device__ __forceinline__ void fe_carry_chains(T *t) {
  FE_CARRY_STEP(t, 0) FE_CARRY_STEP(t, 4)
  FE_CARRY_STEP(t, 1) FE_CARRY_STEP(t, 5)
  FE_CARRY_STEP(t, 2) FE_CARRY_STEP(t, 6)
  FE_CARRY_STEP(t, 3) FE_CARRY_STEP(t, 7)
  FE_CARRY_STEP(t, 4) FE_CARRY_STEP(t, 8)
  {
    const auto c = t[9] >> 25;
    t[0] += 19 * c;
    t[9] &= FE_M25;
  }
  FE_CARRY_STEP(t, 0)
}
#undef FE_CARRY_STEP

__device__ __forceinline__ void fe_carry(fe &h) { fe_carry_chains(h.v); }

// 2p, limb by limb: every limb exceeds the same limb of any carried value
#define FE_2P0 0x7ffffdau
#define FE_2PE 0x7fffffeu
#define FE_2PO 0x3fffffeu

__device__ __forceinline__ void fe_add_nc(fe &h, const fe &f, const fe &g) {
#pragma unroll
  for (int i = 0; i < 10; i++) h.v[i] = f.v[i] + g.v[i];
}

// f - g + 2p, g carried
__device__ __forceinline__ void fe_sub_nc(fe &h, const fe &f, const fe &g) {
#pragma unroll
  for (int i = 0; i < 10; i++)
    h.v[i] = f.v[i] + (i == 0 ? FE_2P0 : (i & 1) ? FE_2PO : FE_2PE) - g.v[i];
}

__device__ __forceinline__ void fe_add(fe &h, const fe &f, const fe &g) {
  fe_add_nc(h, f, g);
  fe_carry(h);
}

__device__ __forceinline__ void fe_sub(fe &h, const fe &f, const fe &g) {
  fe_sub_nc(h, f, g);
  fe_carry(h);
}

__device__ __forceinline__ void fe_neg(fe &h, const fe &f) {
  fe z;
  fe_set_u32(z, 0);
  fe_sub(h, z, f);
}

// The column sums t of a product -> carried limbs
__device__ __forceinline__ void fe_reduce(fe &h, uint64_t *t) {
  fe_carry_chains(t);
#pragma unroll
  for (int i = 0; i < 10; i++) h.v[i] = (uint32_t)t[i];
}

// h = f g: f_i g_j lands in column (i + j) mod 10, times 19 past 2^255
// and times 2 where i and j are both odd (the radix's half bit); 100
// 32x32->64 products summed in 64 bits
__device__ __forceinline__ void fe_mul(fe &h, const fe &f, const fe &g) {
  uint32_t g19[10];
#pragma unroll
  for (int j = 0; j < 10; j++) g19[j] = 19 * g.v[j];
  uint64_t t[10] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < 10; i++) {
    const uint32_t fi = f.v[i], fi2 = 2 * f.v[i];
#pragma unroll
    for (int j = 0; j < 10; j++) {
      const uint32_t a = (i & 1) && (j & 1) ? fi2 : fi;
      const uint32_t b = i + j >= 10 ? g19[j] : g.v[j];
      t[(i + j) % 10] += (uint64_t)a * b;
    }
  }
  fe_reduce(h, t);
}

// 2^dbl f^2 (dbl 0 or 1; 1 only for a carried f) with the cross products
// doubled: 55 products where fe_mul takes 100. The column sums are
// fe_mul(f, f)'s, so fe_sq's limbs are fe_mul(f, f)'s.
__device__ __forceinline__ void fe_sq_shift(fe &h, const fe &f, int dbl) {
  uint32_t f19[10], f2[10];
#pragma unroll
  for (int j = 0; j < 10; j++) {
    f19[j] = 19 * f.v[j];
    f2[j] = 2 * f.v[j];
  }
  uint64_t t[10] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < 10; i++) {
#pragma unroll
    for (int j = i; j < 10; j++) {
      // (2 if i != j) (2 if both odd) f_i f_j (19 if past 2^255)
      const int k = (i != j) + ((i & 1) && (j & 1));
      const uint32_t a = k == 0 ? f.v[i] : k == 1 ? f2[i] : 2 * f2[i];
      const uint32_t b = i + j >= 10 ? f19[j] : f.v[j];
      t[(i + j) % 10] += (uint64_t)a * b;
    }
  }
#pragma unroll
  for (int i = 0; i < 10; i++) t[i] <<= dbl;
  fe_reduce(h, t);
}

__device__ __forceinline__ void fe_sq(fe &h, const fe &f) {
  fe_sq_shift(h, f, 0);
}

// h = f^(2^k)
__device__ void fe_pow2k(fe &h, const fe &f, int k) {
  fe_sq(h, f);
  for (int i = 1; i < k; i++) fe_sq(h, h);
}

// Fully reduce a carried value to [0, p): two carry passes leave every
// limb within its width (value < 2^255 + 19), then subtract p once if
// value + 19 reaches 2^255.
__device__ void fe_canonical(fe &h) {
  fe_carry_seq(h);
  fe_carry_seq(h);
  uint32_t q = (h.v[0] + 19) >> 26;
#pragma unroll
  for (int i = 1; i < 10; i++) q = (h.v[i] + q) >> FE_BITS(i);
  h.v[0] += 19 * q;
#pragma unroll
  for (int i = 0; i < 9; i++) {
    const uint32_t c = h.v[i] >> FE_BITS(i);
    h.v[i] &= (i & 1) ? FE_M25 : FE_M26;
    h.v[i + 1] += c;
  }
  h.v[9] &= FE_M25;
}

__device__ __forceinline__ bool fe_is_zero(const fe &f) {
  fe t = f;
  fe_canonical(t);
  uint32_t x = 0;
#pragma unroll
  for (int i = 0; i < 10; i++) x |= t.v[i];
  return x == 0;
}

__device__ __forceinline__ bool fe_eq(const fe &a, const fe &b) {
  fe d;
  fe_sub(d, a, b);
  return fe_is_zero(d);
}

// 4 little-endian 64-bit words with bit 255 already cleared. The value may
// be >= p (ZIP-215 accepts non-canonical y); every op here takes any
// representative.
__device__ __forceinline__ void fe_from_words(fe &h, const uint64_t *w) {
#pragma unroll
  for (int i = 0; i < 10; i++) {
    const int off = FE_OFF(i), k = off >> 6, s = off & 63;
    uint64_t x = w[k] >> s;
    if (s + FE_BITS(i) > 64) x |= w[k + 1] << (64 - s);
    h.v[i] = (uint32_t)x & ((i & 1) ? FE_M25 : FE_M26);
  }
}

// a canonical value -> 4 little-endian 64-bit words
__device__ __forceinline__ void fe_to_words(uint64_t *w, const fe &f) {
#pragma unroll
  for (int k = 0; k < 4; k++) w[k] = 0;
#pragma unroll
  for (int i = 0; i < 10; i++) {
    const int off = FE_OFF(i), k = off >> 6, s = off & 63;
    w[k] |= (uint64_t)f.v[i] << s;
    if (s + FE_BITS(i) > 64) w[k + 1] |= (uint64_t)f.v[i] >> (64 - s);
  }
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

// -- the four lanes of one signature --
//
// Four consecutive threads work on one signature; lane l = thread & 3.
// A point is spread over the lanes one coordinate each: lane 0 holds X,
// 1 Y, 2 Z, 3 T. A cached operand likewise: (Y - X, Y + X, 2Z, 2d*T).
// Each group operation is two rounds of one field multiply per lane (the
// "4-processor" forms of Hisil, Wong, Carter, Dawson, Twisted Edwards
// Curves Revisited, 2008), with the operands exchanged between rounds by
// lane_shfl. Control flow is the same on the four lanes of a signature:
// they differ only in data, picked by lane with fe_sel4.
//
// lane_id, lane_shfl (this lane reads v of lane `src` of its group) and
// lane_sync are the device's __shfl_sync and __syncwarp; a host harness
// that runs the four lanes in lock-step defines ED25519_HOST_LANES and its
// own three functions before including this header.

#ifndef ED25519_HOST_LANES
__device__ __forceinline__ int lane_id() { return threadIdx.x & 3; }
__device__ __forceinline__ uint32_t lane_shfl(uint32_t v, int src) {
  return __shfl_sync(0xffffffffu, v, src, 4);
}
__device__ __forceinline__ void lane_sync() { __syncwarp(); }
#endif

// signatures per block of the kernels (four threads each)
#define ED25519_SIGS_PER_BLOCK 16

__device__ __forceinline__ void fe_shfl(fe &r, const fe &v, int src) {
#pragma unroll
  for (int i = 0; i < 10; i++) r.v[i] = lane_shfl(v.v[i], src);
}

// Selects by lane are masks, not conditional expressions: nvcc turns a
// chain of lane-dependent ?: into a divergent branch per limb, which
// serialises the four lanes of every signature.
__device__ __forceinline__ uint32_t fe_mask(bool p) {
  return 0u - (uint32_t)p;
}

// r = (a, b, c, d)[lane]
__device__ __forceinline__ void fe_sel4(fe &r, int lane, const fe &a,
                                        const fe &b, const fe &c,
                                        const fe &d) {
  const uint32_t m0 = fe_mask(lane == 0), m1 = fe_mask(lane == 1),
                 m2 = fe_mask(lane == 2), m3 = fe_mask(lane == 3);
#pragma unroll
  for (int i = 0; i < 10; i++)
    r.v[i] = (a.v[i] & m0) | (b.v[i] & m1) | (c.v[i] & m2) | (d.v[i] & m3);
}

// r = p ? a : b
__device__ __forceinline__ void fe_sel(fe &r, bool p, const fe &a,
                                       const fe &b) {
  const uint32_t m = fe_mask(p);
#pragma unroll
  for (int i = 0; i < 10; i++) r.v[i] = b.v[i] ^ ((a.v[i] ^ b.v[i]) & m);
}

// The second round shared by the doubling and the addition: from E, F, G,
// H (the same on every lane) lane 0 takes X3 = F E, lane 1 Y3 = G H,
// lane 2 Z3 = F G, lane 3 T3 = E H. F, the loosest, is never the second
// operand (the one fe_mul multiplies by 19).
__device__ __forceinline__ void ge4_finish(fe &v, int lane, const fe &e,
                                           const fe &f, const fe &g,
                                           const fe &h) {
  fe p, q;
  fe_sel4(p, lane, f, g, f, e);
  fe_sel4(q, lane, e, h, g, h);
  fe_mul(v, p, q);
}

// 2P, dbl-2008-hwcd in the sign convention of edwards.point_double. Round
// one squares X, Y, Z (doubled), X + Y. Lane 3's round-two product T3 is
// not read by the T-less doublings that follow, and costs them nothing:
// its lane has no other work in that round. Sums and differences feeding
// a multiply are left loose, but for H.
__device__ void ge4_double(fe &v) {
  const int lane = lane_id();
  fe x, y, u, s;
  fe_shfl(x, v, 0);
  fe_shfl(y, v, 1);
  fe_add_nc(u, x, y);
  fe_sel(u, lane == 3, u, v);
  fe_sq_shift(s, u, lane == 2);  // lanes: A = X^2, B = Y^2, 2 Z^2, S
  fe a, b, z2, sq, h, e, g, f;
  fe_shfl(a, s, 0);
  fe_shfl(b, s, 1);
  fe_shfl(z2, s, 2);
  fe_shfl(sq, s, 3);
  fe_add(h, a, b);      // H = A + B, carried: E below is then 3-loose
  fe_sub_nc(e, h, sq);  // E = A + B - S
  fe_sub_nc(g, a, b);   // G = A - B
  fe_add_nc(f, z2, a);
  fe_sub_nc(f, f, b);   // F = 2 Z^2 + A - B
  ge4_finish(v, lane, e, f, g, h);
}

// P + Q, add-2008-hwcd-3: q is this lane's coordinate of Q cached
// (carried).
__device__ void ge4_add_cached(fe &v, const fe &q) {
  const int lane = lane_id();
  fe x, y, ymx, ypx, u, m;
  fe_shfl(x, v, 0);
  fe_shfl(y, v, 1);
  fe_sub_nc(ymx, y, x);
  fe_add_nc(ypx, y, x);
  fe_sel4(u, lane, ymx, ypx, v, v);
  fe_mul(m, u, q);  // lanes: a, b, d = Z 2Z', c = T 2dT'
  fe a, b, d, c, e, f, g, h;
  fe_shfl(a, m, 0);
  fe_shfl(b, m, 1);
  fe_shfl(d, m, 2);
  fe_shfl(c, m, 3);
  fe_sub_nc(e, b, a);
  fe_sub_nc(f, d, c);
  fe_add_nc(g, d, c);
  fe_add_nc(h, b, a);
  ge4_finish(v, lane, e, f, g, h);
}

// this lane's coordinate of P cached
__device__ void ge4_to_cached(fe &c, const fe &v) {
  const int lane = lane_id();
  fe x, y, ymx, ypx, z2, t2d, d2;
  fe_shfl(x, v, 0);
  fe_shfl(y, v, 1);
  fe_load_const(d2, FE_D2);
  fe_sub(ymx, y, x);
  fe_add(ypx, y, x);
  fe_add(z2, v, v);
  fe_mul(t2d, v, d2);
  fe_sel4(c, lane, ymx, ypx, z2, t2d);
}

// -P (X and T negated)
__device__ __forceinline__ void ge4_neg(fe &v) {
  const int lane = lane_id();
  fe n;
  fe_neg(n, v);
  fe_sel(v, lane == 0 || lane == 3, n, v);
}

// this lane's coordinate of the identity (0, 1, 1, 0)
__device__ __forceinline__ void ge4_identity(fe &v) {
  const int lane = lane_id();
  fe_set_u32(v, lane == 1 || lane == 2 ? 1 : 0);
}

// ZIP-215 decompression (RFC 8032 5.1.3 accepting y >= p) on one lane: y
// already has bit 255 cleared, sign is that bit. Returns ok; rejects x = 0
// with sign = 1. Counterpart: edwards.decompress.
__device__ bool ge_decompress(ge_p3 &p, const fe &y, int sign) {
  fe one, d, y2, u, v, v2, v3, v7, uv7, t, x, vx2, nu, sqm1;
  fe_set_u32(one, 1);
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
  fe_load_const(sqm1, FE_SQRTM1);
  fe xi;
  fe_mul(xi, x, sqm1);
  fe_sel(x, neg_root_ok, xi, x);
  bool ok = root_ok || neg_root_ok;
  fe xc = x, xn;
  fe_canonical(xc);
  fe_neg(xn, x);
  fe_sel(x, (int)(xc.v[0] & 1) != sign, xn, x);
  if (fe_is_zero(x) && sign == 1) ok = false;
  p.X = x;
  p.Y = y;
  fe_set_u32(p.Z, 1);
  fe_mul(p.T, x, y);
  return ok;
}

// -- scalars, as little-endian 64-bit words --

// L = 2^252 + 27742317777372353535851937790883648493
__device__ __constant__ uint64_t SC_L64[4] = {
    0x5812631a5cf5d3edULL, 0x14def9dea2f79cd6ULL, 0, 0x1000000000000000ULL};

// s < L (ZIP-215 rule 2: S canonical)
__device__ __forceinline__ bool sc_lt_l(const uint64_t *s) {
  bool lt = false, decided = false;
#pragma unroll
  for (int i = 3; i >= 0; i--) {
    const uint64_t l = SC_L64[i];
    lt = lt || (!decided && s[i] < l);
    decided = decided || s[i] != l;
  }
  return lt;
}

// out = dig mod L for a 512-bit dig. Bit-serial shift-and-subtract (r < L <
// 2^253, so 2r + 1 fits four words); exact, and small beside the curve
// work. Every lane runs it: each needs all the digits.
__device__ __forceinline__ void sc_reduce512(uint64_t *out,
                                             const uint64_t *dig) {
  const uint64_t l0 = SC_L64[0], l1 = SC_L64[1], l2 = SC_L64[2],
                 l3 = SC_L64[3];
  uint64_t r0 = 0, r1 = 0, r2 = 0, r3 = 0;
#pragma unroll
  for (int wi = 7; wi >= 0; wi--) {
    const uint64_t w = dig[wi];
#pragma unroll 1
    for (int bit = 63; bit >= 0; bit--) {
      r3 = (r3 << 1) | (r2 >> 63);
      r2 = (r2 << 1) | (r1 >> 63);
      r1 = (r1 << 1) | (r0 >> 63);
      r0 = (r0 << 1) | ((w >> bit) & 1);
      uint64_t t0 = r0 - l0, b = r0 < l0;
      uint64_t t1 = r1 - l1 - b;
      b = (r1 < l1) | ((r1 == l1) & b);
      uint64_t t2 = r2 - l2 - b;
      b = (r2 < l2) | ((r2 == l2) & b);
      uint64_t t3 = r3 - l3 - b;
      b = (r3 < l3) | ((r3 == l3) & b);
      if (!b) {  // r >= L
        r0 = t0; r1 = t1; r2 = t2; r3 = t3;
      }
    }
  }
  out[0] = r0; out[1] = r1; out[2] = r2; out[3] = r3;
}

// 64 radix-16 digits in [0, 15], packed eight to a 32-bit word (digit i
// in bits 4(i % 8) of word i / 8, as a little-endian scalar's words hold
// them) -> the same value as signed digits in [-8, 7], packed alike as
// 4-bit two's complement. A carry out of digit 63 is dropped, exactly as
// ed25519_kernel._recode_signed drops it (only S >= 2^256 - 8*16^63 can
// produce one, and such S fail the S < L check anyway).
__device__ __forceinline__ void sc_recode_packed(uint32_t *e,
                                                 const uint32_t *d) {
  int c = 0;
#pragma unroll
  for (int m = 0; m < 8; m++) {
    uint32_t o = 0;
#pragma unroll
    for (int j = 0; j < 8; j++) {
      int t = (int)((d[m] >> (4 * j)) & 15) + c;
      c = t >= 8;
      o |= (uint32_t)((t - 16 * c) & 15) << (4 * j);
    }
    e[m] = o;
  }
}

__device__ __forceinline__ void sc_recode_words(uint32_t *e,
                                                const uint64_t *w) {
  uint32_t d[8];
#pragma unroll
  for (int m = 0; m < 8; m++) d[m] = (uint32_t)(w[m >> 1] >> (32 * (m & 1)));
  sc_recode_packed(e, d);
}

// -- the dual scalar multiplication (body of K1, inside K2) --

// Coordinate `coord` of cached entry m, negated for neg: -(Y-X, Y+X, 2Z,
// 2dT) = (Y+X, Y-X, 2Z, -2dT), so lanes 0 and 1 read each other's
// coordinate and lane 3 negates. tab holds entry j's coordinate c, limb k
// at tab[(10 j + k) * stride + c].
__device__ __forceinline__ void tab_load_signed(fe &q, const uint32_t *tab,
                                                int stride, int e, int lane) {
  const bool neg = e < 0;
  const int m = neg ? -e : e;
  const int coord = (neg && lane < 2) ? lane ^ 1 : lane;
#pragma unroll
  for (int k = 0; k < 10; k++) q.v[k] = tab[(10 * m + k) * stride + coord];
  fe n;
  fe_neg(n, q);
  fe_sel(q, neg && lane == 3, n, q);
}

// The same from B's table, a copy of GE_BASE_TABLE ([j][YmX, YpX, T2d,
// Z2][limb]: lanes 2 and 3 read its coordinates 3 and 2).
__device__ __forceinline__ void btab_load_signed(fe &q, const uint32_t *btab,
                                                 int e, int lane) {
  const bool neg = e < 0;
  const int m = neg ? -e : e;
  int coord = (neg && lane < 2) ? lane ^ 1 : lane;
  coord = coord < 2 ? coord : 5 - coord;
#pragma unroll
  for (int k = 0; k < 10; k++) q.v[k] = btab[(4 * m + coord) * 10 + k];
  fe n;
  fe_neg(n, q);
  fe_sel(q, neg && lane == 3, n, q);
}

__device__ __forceinline__ void tab_store(uint32_t *tab, int stride, int j,
                                          int lane, const fe &c) {
#pragma unroll
  for (int k = 0; k < 10; k++) tab[(10 * j + k) * stride + lane] = c.v[k];
}

// [S]B - [k]A for one signature, this lane's coordinate of each: a of A
// (extended), acc of the result (X, Y, Z valid; T not). es, ek: packed
// signed digits (sc_recode_packed). Horner over 64 windows, most
// significant first: acc <- 16*acc + e_k*(-A) + e_S*B, with the 9-entry
// cached table of -A built here into tab (shared by the four lanes) and
// B's table in btab. Entries are read by index: verification handles
// public data only. Counterpart: ed25519_kernel.dual_mult_sb_minus_ka.
__device__ __forceinline__ void ge4_dual_mult(fe &acc, const fe &a,
                                              const uint32_t *es_in,
                                              const uint32_t *ek_in,
                                              uint32_t *tab, int stride,
                                              const uint32_t *btab) {
  const int lane = lane_id();
  fe e1 = a, c1, c, e2, e3, e4, t;
  ge4_neg(e1);
  ge4_identity(t);
  ge4_to_cached(c, t);
  tab_store(tab, stride, 0, lane, c);
  ge4_to_cached(c1, e1);
  tab_store(tab, stride, 1, lane, c1);
  e2 = e1;
  ge4_double(e2);
  ge4_to_cached(c, e2);
  tab_store(tab, stride, 2, lane, c);
  e3 = e2;
  ge4_add_cached(e3, c1);
  ge4_to_cached(c, e3);
  tab_store(tab, stride, 3, lane, c);
  e4 = e2;
  ge4_double(e4);
  ge4_to_cached(c, e4);
  tab_store(tab, stride, 4, lane, c);
  t = e4;
  ge4_add_cached(t, c1);
  ge4_to_cached(c, t);
  tab_store(tab, stride, 5, lane, c);
  t = e3;
  ge4_double(t);
  ge4_to_cached(c, t);
  tab_store(tab, stride, 6, lane, c);
  ge4_add_cached(t, c1);
  ge4_to_cached(c, t);
  tab_store(tab, stride, 7, lane, c);
  t = e4;
  ge4_double(t);
  ge4_to_cached(c, t);
  tab_store(tab, stride, 8, lane, c);
  lane_sync();  // the table is read by the other lanes of the signature

  // digits in registers: the word of the current eight windows is taken
  // from the top and the words shifted up, so no array is indexed at run
  // time
  uint32_t es[8], ek[8];
#pragma unroll
  for (int m = 0; m < 8; m++) {
    es[m] = es_in[m];
    ek[m] = ek_in[m];
  }
  ge4_identity(acc);
  fe q;
#pragma unroll 1
  for (int wo = 0; wo < 8; wo++) {
    uint32_t cs = es[7], ck = ek[7];
#pragma unroll
    for (int m = 7; m > 0; m--) {
      es[m] = es[m - 1];
      ek[m] = ek[m - 1];
    }
#pragma unroll 1
    for (int j = 0; j < 8; j++) {
      const int ds = (int32_t)cs >> 28, dk = (int32_t)ck >> 28;
      cs <<= 4;
      ck <<= 4;
      ge4_double(acc);
      ge4_double(acc);
      ge4_double(acc);
      ge4_double(acc);
      tab_load_signed(q, tab, stride, dk, lane);
      ge4_add_cached(acc, q);
      btab_load_signed(q, btab, ds, lane);
      ge4_add_cached(acc, q);
    }
  }
}

// -- one signature on four lanes: the bodies of kernels K2 and K1 --

// NW little-endian 64-bit words of column i, rows row0 .. row0 + 8 NW - 1,
// of (k, n) byte rows, batch-minor, whose elements are `es` bytes wide (1
// for uint8 rows, 4 for int32 rows: the byte is the element's low byte on
// this little-endian card). Zero where !in.
template <int NW>
__device__ __forceinline__ void load_words(uint64_t *w, const uint8_t *rows,
                                           int row0, int n, int i, int es,
                                           bool in) {
#pragma unroll
  for (int k = 0; k < NW; k++) {
    uint64_t x = 0;
#pragma unroll
    for (int j = 7; j >= 0; j--) {
      const uint64_t b =
          in ? rows[((size_t)(row0 + 8 * k + j) * n + i) * es] : 0;
      x = (x << 8) | b;
    }
    w[k] = x;
  }
}

// The whole ZIP-215 cofactored check of signature i on this lane, from
// (32, n) public keys, (64, n) R || S and (64, n) SHA-512(R || A || M) byte
// rows; lane 0 writes out[i]. Lanes of an i >= n run on zeros and write
// nothing (every lane of a warp must reach each shuffle). tab: this
// signature's table of -A (9 x 10 rows of `stride` words, 4 used); btab: B's
// table. Counterpart: ed25519_kernel._verify_tile.
__device__ __forceinline__ void ed25519_verify_lane(
    const uint8_t *pk, const uint8_t *sig, const uint8_t *dig, bool *out,
    int n, int es, int i, uint32_t *tab, int stride, const uint32_t *btab) {
  const int lane = lane_id();
  const bool in = i < n;
  uint64_t aw[4], rw[4], sw[4], dw[8], yw[4];
  load_words<4>(aw, pk, 0, n, i, es, in);
  load_words<4>(rw, sig, 0, n, i, es, in);
  load_words<4>(sw, sig, 32, n, i, es, in);
  load_words<8>(dw, dig, 0, n, i, es, in);

  // lanes 0 and 1 decompress A, lanes 2 and 3 R: the two pow_p58 chains
  // run side by side
#pragma unroll
  for (int k = 0; k < 4; k++) yw[k] = lane < 2 ? aw[k] : rw[k];
  const int sign = (int)(yw[3] >> 63);
  yw[3] &= 0x7fffffffffffffffULL;
  fe y;
  fe_from_words(y, yw);
  ge_p3 P;
  const bool ok = ge_decompress(P, y, sign);
  fe one, zero, ax, ay, at, rx, ry, av, rv;
  fe_set_u32(one, 1);
  fe_set_u32(zero, 0);
  fe_shfl(ax, P.X, 0);
  fe_shfl(ay, P.Y, 0);
  fe_shfl(at, P.T, 0);
  fe_shfl(rx, P.X, 2);
  fe_shfl(ry, P.Y, 2);
  fe_sel4(av, lane, ax, ay, one, at);
  fe_sel4(rv, lane, rx, ry, one, zero);  // R: T is never read
  const bool ok_a = lane_shfl(ok, 0) != 0;
  const bool ok_r = lane_shfl(ok, 2) != 0;

  // the scalars, on every lane: each needs every digit
  const bool s_ok = sc_lt_l(sw);
  uint64_t kw[4];
  sc_reduce512(kw, dw);
  uint32_t esd[8], ekd[8];
  sc_recode_words(esd, sw);
  sc_recode_words(ekd, kw);

  fe acc;
  ge4_dual_mult(acc, av, esd, ekd, tab, stride, btab);
  for (int j = 0; j < 3; j++) {  // cofactor 8, both sides
    ge4_double(acc);
    ge4_double(rv);
  }
  // X_acc Z_R = X_R Z_acc and Y_acc Z_R = Y_R Z_acc: one product a lane,
  // lanes 0 and 1 compare the first, 2 and 3 the second
  fe xa, ya, za, xr, yr, zr, p, q, m, pm;
  fe_shfl(xa, acc, 0);
  fe_shfl(ya, acc, 1);
  fe_shfl(za, acc, 2);
  fe_shfl(xr, rv, 0);
  fe_shfl(yr, rv, 1);
  fe_shfl(zr, rv, 2);
  fe_sel4(p, lane, xa, xr, ya, yr);
  fe_sel4(q, lane, zr, za, zr, za);
  fe_mul(m, p, q);
  fe_shfl(pm, m, lane ^ 1);
  const bool eq = fe_eq(m, pm);
  // both exchanges on every lane: no short circuit around a shuffle
  const uint64_t eq0 = lane_shfl(eq, 0), eq2 = lane_shfl(eq, 2);
  const bool same = (eq0 & eq2) != 0;
  if (lane == 0 && in) out[i] = same && ok_a && ok_r && s_ok;
}

// 20 x 13-bit limbs (any normalized representative, nonnegative value)
// at rows[limb * n + i] -> radix 2^25.5
__device__ __forceinline__ void fe_from_limbs13(fe &h, const int32_t *rows,
                                                int n, int i) {
  int64_t d[20];
  int64_t c = 0;
#pragma unroll
  for (int k = 0; k < 20; k++) {
    int64_t t = (int64_t)rows[(size_t)k * n + i] + c;
    d[k] = t & 8191;
    c = t >> 13;
  }
  // 2^260 = 608 mod p: fold the carry out twice more
#pragma unroll
  for (int pass = 0; pass < 2; pass++) {
    int64_t cin = c * 608;
    c = 0;
#pragma unroll
    for (int k = 0; k < 20; k++) {
      int64_t t = d[k] + (k == 0 ? cin : 0) + c;
      d[k] = t & 8191;
      c = t >> 13;
    }
  }
  // digit k covers bits 13k .. 13k + 12: at most two limbs; bits >= 255
  // (limb 10) wrap into limb 0 times 19
  uint32_t acc[11] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
#pragma unroll
  for (int k = 0; k < 20; k++) {
    const int bit = 13 * k;
    int l = 0;
#pragma unroll
    for (int j = 1; j < 11; j++) l += FE_OFF(j) <= bit;
    const int s = bit - FE_OFF(l);
    const uint64_t v = (uint64_t)d[k] << s;
    const int w = l < 10 ? FE_BITS(l) : 64;
    acc[l] += (uint32_t)(v & ((1ULL << w) - 1));
    if (l < 10) acc[l + 1] += (uint32_t)(v >> w);
  }
#pragma unroll
  for (int l = 0; l < 10; l++) h.v[l] = acc[l];
  h.v[0] += 19 * acc[10];
  fe_carry(h);
  fe_carry(h);
}

// canonical value -> 20 x 13-bit limbs at rows[limb * n + i]
__device__ __forceinline__ void fe_to_limbs13(int32_t *rows, const fe &f,
                                              int n, int i) {
  fe t = f;
  fe_canonical(t);
  uint64_t w[4];
  fe_to_words(w, t);
#pragma unroll
  for (int k = 0; k < 20; k++) {
    const int bit = 13 * k, q = bit >> 6, s = bit & 63;
    uint64_t v = w[q] >> s;
    if (s > 51 && q < 3) v |= w[q + 1] << (64 - s);
    rows[(size_t)k * n + i] = (int32_t)(v & 8191);
  }
}

// [S]B - [k]A for column i of the JAX contract on this lane: a (4, 20, n)
// int32 extended point, ds/dk (64, n) int32 digits in [0, 15] -> out (3,
// 20, n) int32 canonical limbs of (X, Y, Z), lanes 0-2 writing one
// coordinate each. i >= n as in ed25519_verify_lane. Counterpart:
// dual_mult_sb_minus_ka.
__device__ __forceinline__ void ed25519_dual_mult_lane(
    const int32_t *a, const int32_t *ds, const int32_t *dk, int32_t *out,
    int n, int i, uint32_t *tab, int stride, const uint32_t *btab) {
  const int lane = lane_id();
  const bool in = i < n;
  const size_t coord = (size_t)20 * n;
  fe av, acc;
  fe_set_u32(av, 0);
  if (in) fe_from_limbs13(av, a + lane * coord, n, i);
  uint32_t dsw[8], dkw[8], esd[8], ekd[8];
#pragma unroll
  for (int m = 0; m < 8; m++) {
    uint32_t xs = 0, xk = 0;
#pragma unroll
    for (int j = 0; j < 8; j++) {
      const size_t at = (size_t)(8 * m + j) * n + i;
      xs |= (in ? (uint32_t)ds[at] & 15 : 0) << (4 * j);
      xk |= (in ? (uint32_t)dk[at] & 15 : 0) << (4 * j);
    }
    dsw[m] = xs;
    dkw[m] = xk;
  }
  sc_recode_packed(esd, dsw);
  sc_recode_packed(ekd, dkw);
  ge4_dual_mult(acc, av, esd, ekd, tab, stride, btab);
  if (in && lane < 3) fe_to_limbs13(out + lane * coord, acc, n, i);
}
