// SASS probe of one field multiply and one squaring in the two limb radixes
// considered for kernels K1 and K2: radix 2^25.5, the kernels' own (ten
// limbs of 26 and 25 bits in uint32, 32x32->64 products summed in
// uint64, as ref10 does: fe_mul and fe_sq of ed25519_device.cuh), and
// radix 2^51 (five limbs in uint64, products in unsigned __int128, the
// kernels' radix before; its multiply and squaring are kept here). Each
// kernel does one operation per thread, so its SASS (cuobjdump -sass) is
// the operation plus a few loads, stores and the exit. Built and counted
// by ops/sass_count.py; it is no part of the kernels' libraries.

#include <cuda_runtime.h>
#include <stdint.h>

#include "../csrc/ed25519_device.cuh"

typedef unsigned __int128 u128;
#define FE51_MASK 0x7ffffffffffffULL

struct fe51 {
  uint64_t v[5];
};

// column sums t -> limbs < 2^52
__device__ __forceinline__ void fe51_reduce(fe51 &h, u128 t0, u128 t1,
                                            u128 t2, u128 t3, u128 t4) {
  uint64_t r0, r1, r2, r3, r4, c;
  r0 = (uint64_t)t0 & FE51_MASK; t1 += (uint64_t)(t0 >> 51);
  r1 = (uint64_t)t1 & FE51_MASK; t2 += (uint64_t)(t1 >> 51);
  r2 = (uint64_t)t2 & FE51_MASK; t3 += (uint64_t)(t2 >> 51);
  r3 = (uint64_t)t3 & FE51_MASK; t4 += (uint64_t)(t3 >> 51);
  r4 = (uint64_t)t4 & FE51_MASK; c = (uint64_t)(t4 >> 51);
  const u128 w0 = (u128)c * 19 + r0;
  r0 = (uint64_t)w0 & FE51_MASK; r1 += (uint64_t)(w0 >> 51);
  h.v[0] = r0; h.v[1] = r1; h.v[2] = r2; h.v[3] = r3; h.v[4] = r4;
}

__device__ __forceinline__ void fe51_mul(fe51 &h, const fe51 &f,
                                         const fe51 &g) {
  const uint64_t f0 = f.v[0], f1 = f.v[1], f2 = f.v[2], f3 = f.v[3],
                 f4 = f.v[4];
  const uint64_t g0 = g.v[0], g1 = g.v[1], g2 = g.v[2], g3 = g.v[3],
                 g4 = g.v[4];
  const uint64_t g1_19 = 19 * g1, g2_19 = 19 * g2, g3_19 = 19 * g3,
                 g4_19 = 19 * g4;
  fe51_reduce(h,
              (u128)f0 * g0 + (u128)f1 * g4_19 + (u128)f2 * g3_19 +
                  (u128)f3 * g2_19 + (u128)f4 * g1_19,
              (u128)f0 * g1 + (u128)f1 * g0 + (u128)f2 * g4_19 +
                  (u128)f3 * g3_19 + (u128)f4 * g2_19,
              (u128)f0 * g2 + (u128)f1 * g1 + (u128)f2 * g0 +
                  (u128)f3 * g4_19 + (u128)f4 * g3_19,
              (u128)f0 * g3 + (u128)f1 * g2 + (u128)f2 * g1 +
                  (u128)f3 * g0 + (u128)f4 * g4_19,
              (u128)f0 * g4 + (u128)f1 * g3 + (u128)f2 * g2 +
                  (u128)f3 * g1 + (u128)f4 * g0);
}

__device__ __forceinline__ void fe51_sq(fe51 &h, const fe51 &f) {
  const uint64_t f0 = f.v[0], f1 = f.v[1], f2 = f.v[2], f3 = f.v[3],
                 f4 = f.v[4];
  const uint64_t d0 = 2 * f0, d1 = 2 * f1, d2 = 2 * f2, d3 = 2 * f3;
  const uint64_t f3_19 = 19 * f3, f4_19 = 19 * f4;
  fe51_reduce(h, (u128)f0 * f0 + (u128)d1 * f4_19 + (u128)d2 * f3_19,
              (u128)d0 * f1 + (u128)d2 * f4_19 + (u128)f3 * f3_19,
              (u128)d0 * f2 + (u128)f1 * f1 + (u128)d3 * f4_19,
              (u128)d0 * f3 + (u128)d1 * f2 + (u128)f4 * f4_19,
              (u128)d0 * f4 + (u128)d1 * f3 + (u128)f2 * f2);
}

extern "C" __global__ void probe_fe_mul_r51(const fe51 *f, const fe51 *g,
                                            fe51 *h) {
  const int i = threadIdx.x;
  fe51_mul(h[i], f[i], g[i]);
}
extern "C" __global__ void probe_fe_sq_r51(const fe51 *f, fe51 *h) {
  const int i = threadIdx.x;
  fe51_sq(h[i], f[i]);
}
extern "C" __global__ void probe_fe_mul_r25(const fe *f, const fe *g, fe *h) {
  const int i = threadIdx.x;
  fe_mul(h[i], f[i], g[i]);
}
extern "C" __global__ void probe_fe_sq_r25(const fe *f, fe *h) {
  const int i = threadIdx.x;
  fe_sq(h[i], f[i]);
}
