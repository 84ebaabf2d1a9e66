// SASS probe of one SHA-512 compression, kernel X1's (sha512_compress of
// csrc/sha512.cuh: rotates written as funnel-shift pairs of 32-bit
// halves) and the one X1 had before (kept here: the rounds in 64-bit C,
// rotates as shift-or). Each kernel does one compression per thread, so
// its SASS (cuobjdump -sass) is the compression plus 24 loads, 8 stores
// and the exit. Built and counted by ops/sass_count.py; it is no part of
// the kernels' libraries.

#include <cuda_runtime.h>
#include <stdint.h>

#include "../csrc/sha512.cuh"

__device__ __forceinline__ uint64_t rotr_before(uint64_t x, int n) {
  return (x >> n) | (x << (64 - n));
}

__device__ __forceinline__ void compress_before(uint64_t *h, uint64_t *w) {
  uint64_t a = h[0], b = h[1], c = h[2], d = h[3], e = h[4], f = h[5],
           g = h[6], hh = h[7];
#pragma unroll
  for (int t = 0; t < 80; t++) {
    if (t >= 16) {
      uint64_t w15 = w[(t - 15) & 15], w2 = w[(t - 2) & 15];
      uint64_t s0 = rotr_before(w15, 1) ^ rotr_before(w15, 8) ^ (w15 >> 7);
      uint64_t s1 = rotr_before(w2, 19) ^ rotr_before(w2, 61) ^ (w2 >> 6);
      w[t & 15] += s0 + w[(t - 7) & 15] + s1;
    }
    uint64_t S1 = rotr_before(e, 14) ^ rotr_before(e, 18) ^ rotr_before(e, 41);
    uint64_t ch = (e & f) ^ (~e & g);
    uint64_t t1 = hh + S1 + ch + K512[t] + w[t & 15];
    uint64_t S0 = rotr_before(a, 28) ^ rotr_before(a, 34) ^ rotr_before(a, 39);
    uint64_t maj = (a & b) ^ (a & c) ^ (b & c);
    uint64_t t2 = S0 + maj;
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

extern "C" __global__ void probe_sha512_compress(const uint64_t *in,
                                                 uint64_t *out) {
  const int i = threadIdx.x;
  uint64_t h[8], w[16];
#pragma unroll
  for (int j = 0; j < 8; j++) h[j] = in[24 * i + j];
#pragma unroll
  for (int j = 0; j < 16; j++) w[j] = in[24 * i + 8 + j];
  sha512_compress(h, w);
#pragma unroll
  for (int j = 0; j < 8; j++) out[8 * i + j] = h[j];
}

extern "C" __global__ void probe_sha512_compress_before(const uint64_t *in,
                                                        uint64_t *out) {
  const int i = threadIdx.x;
  uint64_t h[8], w[16];
#pragma unroll
  for (int j = 0; j < 8; j++) h[j] = in[24 * i + j];
#pragma unroll
  for (int j = 0; j < 16; j++) w[j] = in[24 * i + 8 + j];
  compress_before(h, w);
#pragma unroll
  for (int j = 0; j < 8; j++) out[8 * i + j] = h[j];
}
