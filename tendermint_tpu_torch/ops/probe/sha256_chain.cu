// Latency probe of kernel X4's tree form: one thread computes `depth`
// dependent RFC 6962 inner hashes h <- sha256(0x01 || h || a_d) of
// csrc/sha256.cuh, its aunts a_d already in shared memory, and records
// clock64 and %globaltimer before the first and after the last, so it
// reads the chain a tree root cannot go below (14 hashes for 10,000
// leaves) with nothing else on the card. Built with -DCHAIN_PAD, each hash
// is X5's sha256_inner_pad (the second block from the table) instead, the
// chain of a proof of that depth. Built and run by ops/x4_latency.py; it
// is no part of the kernels' libraries.

#include <cuda_runtime.h>
#include <stdint.h>

#include "../csrc/sha256.cuh"

// the deepest chain the probe takes: a 2^64-leaf tree
#define CHAIN_MAX_DEPTH 64

// in: the start digest and depth <= CHAIN_MAX_DEPTH aunts, big-endian
// words; out: the end digest; stamps: cycles and nanoseconds of the
// chain. The aunts are staged in shared memory before the first stamp and
// each is read into registers one hash ahead, so the stamps hold the
// hashes' dependent chain and no load latency.
extern "C" __global__ void probe_sha256_chain(const uint32_t *in,
                                              uint32_t *out,
                                              long long *stamps, int depth) {
  __shared__ uint32_t aunts[8 * CHAIN_MAX_DEPTH];
  uint32_t h[8], a[8], next[8];
#pragma unroll
  for (int j = 0; j < 8; j++) h[j] = in[j];
  for (int j = 0; j < 8 * depth; j++) aunts[j] = in[8 + j];
#pragma unroll
  for (int j = 0; j < 8; j++) next[j] = aunts[j];
  long long c0, c1, t0, t1;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(c0));
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
  for (int d = 0; d < depth; d++) {
#pragma unroll
    for (int j = 0; j < 8; j++) {
      a[j] = next[j];
      next[j] = aunts[(8 * (d + 1) + j) % (8 * CHAIN_MAX_DEPTH)];
    }
#ifdef CHAIN_PAD
    sha256_inner_pad(h, a, h);
#else
    sha256_inner_words(h, a, h);
#endif
  }
  // the end stamps wait for the last hash
  asm volatile("" ::"r"(h[0]), "r"(h[1]), "r"(h[2]), "r"(h[3]), "r"(h[4]),
               "r"(h[5]), "r"(h[6]), "r"(h[7]));
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(c1));
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t1));
#pragma unroll
  for (int j = 0; j < 8; j++) out[j] = h[j];
  stamps[0] = c1 - c0;
  stamps[1] = t1 - t0;
}

extern "C" int tm_sha256_chain(const void *in, void *out, void *stamps,
                               int depth, void *stream) {
  if (depth < 1 || depth > CHAIN_MAX_DEPTH) return (int)cudaErrorInvalidValue;
  probe_sha256_chain<<<1, 1, 0, (cudaStream_t)stream>>>(
      (const uint32_t *)in, (uint32_t *)out, (long long *)stamps, depth);
  return (int)cudaGetLastError();
}
