// Kernel X4: SHA-256 of N rows of L bytes behind an optional one-byte
// prefix, one thread a row, and the RFC 6962 root of N leaf hashes in one
// launch (device body: sha256.cuh).
//
// Replaces the JAX package's XLA programs tendermint_tpu/ops/
// sha256_kernel.py:125 `sha256_fixed`, :173 `inner_hash_batch` and :182
// `leaf_hash_batch` as tendermint_tpu/ops/merkle_kernel.py:49
// `_inner_jit` drives them, level by level of a tree root. It computes
// the same function; it is not carried over block by block.
//
// - Leaf hashes: prefix 0x00 before each row. Inner hashes: prefix 0x01
//   before rows of L || R, 64 bytes.
// - One level of a tree root with no copy (sha256_rows_kernel): a level of
//   m digests, viewed as floor(m / 2) rows of 64 bytes, hashed behind
//   0x01; with carry_tail (m odd) the launch's thread n copies the trailing
//   digest to the last output row. The level form stays as what the tree
//   form is held against and timed beside.
// - A whole tree root in one launch (sha256_tree_kernel). Phase one: block
//   b reduces the aligned subtree of leaves [128 b, 128 b + 128) in shared
//   memory, level by level with __syncthreads() between levels, the last,
//   partial block carrying its odd node up by the same rule, and writes
//   its root to device memory. Phase two: each block then fences its write
//   and counts itself done on a counter in device memory; the block that
//   counts last reduces the ceil(n / 128) subtree roots by the same levels
//   and writes the root. The counter lives in the launch's work buffer and
//   is zeroed by a memset on the launch's stream. One upload (the leaves),
//   one launch, one 32-byte download.
//
// Why pairing aligned subtrees gives the level order's root. The level
// order pairs nodes 2t and 2t + 1 of every level and carries an odd last
// node up unchanged; that is RFC 6962's split at the largest power of two
// below the count (crypto/merkle/tree.go, HashFromByteSlices), which
// tree_root has always relied on. Below level 7 a pair never crosses a
// multiple of 128 leaves, and the only odd node of a level is the level's
// last, which lies in the last block: so the first 7 levels of the whole
// tree are, block by block, the levels of each block's subtree (a partial
// block's subtree carrying its own odd nodes), and level 7 of the tree is
// the list of the blocks' roots, which phase two reduces as the level
// order goes on.
//
// What bounds it on an H100. A 10,000-leaf root is 9,999 inner hashes,
// two compressions each, ~2.8e7 integer instructions: ~1.7 us of the
// card's int32 issue rate, and its 320 KB of leaves ~0.1 us of HBM. Both
// are far below the chain: 14 dependent inner hashes of ~2,758 SASS
// instructions each, one thread's, which the level form paid as 14
// dependent launches. The tree form pays it in one launch: 7 levels in
// each block's shared memory, a fence and an atomic, then 7 levels in the
// last block.

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

constexpr int kTreeThreads = SHA256_TREE_LEAVES / 2;

// leaves (n, 32); work (tm_sha256_tree_work(n) bytes): the counter of
// finished blocks, zeroed before the launch, in its first 32 bytes, then
// room for the blocks' roots, two levels above them and the root.
__global__ void __launch_bounds__(kTreeThreads)
    sha256_tree_kernel(const uint8_t *leaves, uint8_t *work, int n) {
  __shared__ __align__(16) uint8_t a[kTreeThreads * 32], b[kTreeThreads * 32];
  __shared__ bool last;
  const int tid = threadIdx.x, nb = gridDim.x;
  const int first = blockIdx.x * SHA256_TREE_LEAVES;
  const int m = min(SHA256_TREE_LEAVES, n - first);
  unsigned *done = (unsigned *)work;
  uint8_t *roots = work + 32;
  const uint8_t *r = sha256_tree_reduce(leaves + (size_t)32 * first, a, b, m,
                                        tid, kTreeThreads);
  if (tid < 8)
    ((uint32_t *)(roots + (size_t)32 * blockIdx.x))[tid] =
        ((const uint32_t *)r)[tid];
  __threadfence();  // this block's root is visible before it counts
  __syncthreads();
  if (tid == 0) last = atomicAdd(done, 1u) == (unsigned)nb - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int up = (nb + 1) / 2;
  uint8_t *wa = roots + (size_t)32 * nb, *wb = wa + (size_t)32 * up;
  r = sha256_tree_reduce(roots, wa, wb, nb, tid, kTreeThreads);
  if (tid < 8)
    ((uint32_t *)(wb + (size_t)32 * up))[tid] = ((const uint32_t *)r)[tid];
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

// The RFC 6962 root of n >= 1 leaf hashes (n, 32) at leaves (4-byte
// aligned); work: tm_sha256_tree_work(n) bytes, 4-byte aligned, its last
// 32 the root; on card `device`. Zeroes the kernel's counter in work on
// the same stream (a memset, no kernel), then one launch. Returns the
// first CUDA error.
int tm_sha256_tree(const void *leaves, void *work, int n, int device,
                   void *stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(work, 0, sizeof(unsigned), (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n + SHA256_TREE_LEAVES - 1) / SHA256_TREE_LEAVES;
  sha256_tree_kernel<<<blocks, kTreeThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t *)leaves, (uint8_t *)work, n);
  return (int)cudaGetLastError();
}

// bytes of tm_sha256_tree's work buffer for n leaves: the counter's 32,
// the blocks' roots, two levels above them, and the root
int tm_sha256_tree_work(int n) {
  const int blocks = (n + SHA256_TREE_LEAVES - 1) / SHA256_TREE_LEAVES;
  return 32 * (1 + blocks + 2 * ((blocks + 1) / 2) + 1);
}

const char *tm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
