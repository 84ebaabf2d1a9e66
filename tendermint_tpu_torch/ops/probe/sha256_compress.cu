// SASS probe of kernels X4's and X5's SHA-256 (csrc/sha256.cuh): one
// compression, and one inner hash sha256(0x01 || L || R) of two digests
// held as words (two compressions and the prefix shift). Each kernel does
// one per thread, so its SASS (cuobjdump -sass) is that plus its loads (24
// and 16), 8 stores and the exit. Built and counted by ops/sass_count.py;
// it is no part of the kernels' libraries.

#include <cuda_runtime.h>
#include <stdint.h>

#include "../csrc/sha256.cuh"

extern "C" __global__ void probe_sha256_compress(const uint32_t *in,
                                                 uint32_t *out) {
  const int i = threadIdx.x;
  uint32_t h[8], w[16];
#pragma unroll
  for (int j = 0; j < 8; j++) h[j] = in[24 * i + j];
#pragma unroll
  for (int j = 0; j < 16; j++) w[j] = in[24 * i + 8 + j];
  sha256_compress(h, w);
#pragma unroll
  for (int j = 0; j < 8; j++) out[8 * i + j] = h[j];
}

extern "C" __global__ void probe_sha256_inner(const uint32_t *in,
                                              uint32_t *out) {
  const int i = threadIdx.x;
  uint32_t l[8], r[8], h[8];
#pragma unroll
  for (int j = 0; j < 8; j++) {
    l[j] = in[16 * i + j];
    r[j] = in[16 * i + 8 + j];
  }
  sha256_inner_words(l, r, h);
#pragma unroll
  for (int j = 0; j < 8; j++) out[8 * i + j] = h[j];
}

// X5's inner hash: the second block's schedule from the table
// (sha256_pad.cuh), its 12 loads besides the 16 of the digests
extern "C" __global__ void probe_sha256_inner_pad(const uint32_t *in,
                                                  uint32_t *out) {
  const int i = threadIdx.x;
  uint32_t l[8], r[8], h[8];
#pragma unroll
  for (int j = 0; j < 8; j++) {
    l[j] = in[16 * i + j];
    r[j] = in[16 * i + 8 + j];
  }
  sha256_inner_pad(l, r, h);
#pragma unroll
  for (int j = 0; j < 8; j++) out[8 * i + j] = h[j];
}
