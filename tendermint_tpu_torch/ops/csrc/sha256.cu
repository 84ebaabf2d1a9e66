// Kernel X4: SHA-256 of N rows of L bytes behind an optional one-byte
// prefix, one thread a row (device body: sha256.cuh).
//
// Replaces the JAX package's XLA programs tendermint_tpu/ops/
// sha256_kernel.py:125 `sha256_fixed`, :173 `inner_hash_batch` and :182
// `leaf_hash_batch` as tendermint_tpu/ops/merkle_kernel.py:49
// `_inner_jit` drives them, level by level of a tree root. It computes
// the same function; it is not carried over block by block.
//
// - Leaf hashes: prefix 0x00 before each row. Inner hashes: prefix 0x01
//   before rows of L || R, 64 bytes.
// - One level of a tree root with no copy: a level of m digests, viewed
//   as floor(m / 2) rows of 64 bytes, hashed behind 0x01; with carry_tail
//   (m odd) the launch's thread n copies the trailing digest to the last
//   output row. A level is one launch and nothing else.
//
// What bounds it on an H100. A 10,000-leaf root is 9,999 inner hashes,
// two compressions each, ~2.8e7 integer instructions: ~1.7 us of the
// card's int32 issue rate, and its 320 KB of leaves ~0.1 us of HBM. Both
// are far below a launch's latency, and a level's width halves every
// launch: the 14 levels of a 10k root are 14 dependent launches, each as
// long as one thread's two compressions plus the launch. The design keeps
// every level on the card (one upload, one 32-byte download) and adds no
// work to a level but the hashing.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sha256.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
    sha256_rows_kernel(const uint8_t *data, uint8_t *out, int len, int n,
                       int prefix, int carry_tail) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  sha256_rows_item(data, out, len, n, prefix, carry_tail, i);
}

}  // namespace

extern "C" {

// data: n rows of len bytes, row-major, plus (carry_tail) 32 bytes at
// data + len n; out (n + carry_tail, 32) uint8; prefix 0..255, or -1 for
// none; on card `device`. Returns cudaGetLastError().
int tm_sha256_rows(const void *data, void *out, int len, int n, int prefix,
                   int carry_tail, int device, void *stream) {
  const int threads = n + (carry_tail ? 1 : 0);
  if (threads <= 0) return 0;
  if (len < 0 || prefix < -1 || prefix > 255) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  sha256_rows_kernel<<<(threads + kThreads - 1) / kThreads, kThreads, 0,
                       (cudaStream_t)stream>>>((const uint8_t *)data,
                                               (uint8_t *)out, len, n, prefix,
                                               carry_tail ? 1 : 0);
  return (int)cudaGetLastError();
}

const char *tm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
