// Kernel X5: K merkle inclusion proofs against one root, one thread a
// proof (device body: sha256.cuh, merkle_proof_item).
//
// Replaces the JAX package's XLA program tendermint_tpu/ops/
// merkle_kernel.py:125 `_verify_program`: a lax.scan over the padded
// depth, every lane hashing its node with its aunt on both sides and
// keeping the side its flag names (or neither, past its depth), over
// (D, 32, K) aunts padded to a power of two in both axes.
//
// Here the input is ragged, as X1's messages are: one flat buffer of the
// proofs' aunts with K + 1 int32 offsets, the leaf hashes, one 64-bit
// word of side bits per proof, the root and the host's structural and
// leaf checks, all in one host-to-device copy. A thread keeps its node's
// eight words in registers and walks its own depth, one inner hash a
// step, the halves picked by a select on the side bit. It writes the
// computed roots (K, 32) and the (K,) bitmap: its host checks AND root ==
// want. The bitmap is the one download.
//
// What bounds it on an H100. 10,000 proofs of depth 14 are 140,000 inner
// hashes, 280,000 compressions, ~3.9e8 integer instructions: ~23 us of
// the card's int32 issue rate; the 4.5 MB of aunts take ~1.3 us of HBM.
// With one thread a proof, 10,000 threads are 79 blocks of 128, one warp
// on each of 316 of the card's 528 schedulers: the launch lasts one warp's
// stream of 28 dependent compressions a proof, every integer instruction
// of it issued by that warp alone (16 INT32 lanes a scheduler: one warp
// instruction every two cycles). So the design cuts that stream: the
// second block of an inner hash is fixed but for R's last byte, and its
// schedule plus round constants, K[t] + W[t] for t >= 16, come from a
// table of the 256 schedules (sha256_pad.cuh) in twelve 16-byte loads
// issued before the first block (48 schedule steps, ~480 instructions,
// fewer an inner hash); and the next aunt is loaded a step ahead. Chosen
// by ops/x5_variants.py over a producer/consumer split (a second warp
// expanding the schedules into shared memory), which lost at 10,000
// proofs: 626 warps for 528 schedulers put two on some.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sha256.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
    merkle_proofs_kernel(const uint8_t *leaf, const uint8_t *aunts,
                         const int32_t *off, const uint64_t *sides,
                         const uint8_t *want, const uint8_t *ok_in,
                         uint8_t *roots, uint8_t *ok, int k) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < k)
    merkle_proof_item(leaf, aunts, off, sides, want, ok_in, roots, ok, i);
}

}  // namespace

extern "C" {

// leaf (k, 32) uint8; aunts (off[k], 32) uint8; off (k + 1) int32; sides
// (k,) uint64; want (32,) uint8; ok_in (k,) uint8; roots (k, 32) uint8
// and ok (k,) uint8 out; aunts 16-byte aligned, every other pointer
// 8-byte aligned, on card `device`.
// Returns cudaGetLastError().
int tm_merkle_proofs(const void *leaf, const void *aunts, const void *off,
                     const void *sides, const void *want, const void *ok_in,
                     void *roots, void *ok, int k, int device, void *stream) {
  if (k <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  merkle_proofs_kernel<<<(k + kThreads - 1) / kThreads, kThreads, 0,
                         (cudaStream_t)stream>>>(
      (const uint8_t *)leaf, (const uint8_t *)aunts, (const int32_t *)off,
      (const uint64_t *)sides, (const uint8_t *)want, (const uint8_t *)ok_in,
      (uint8_t *)roots, (uint8_t *)ok, k);
  return (int)cudaGetLastError();
}

const char *tm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
