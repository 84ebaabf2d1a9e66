// Kernel X1 (sha512_rows): SHA-512 of n equal-length messages. The per-row
// body is sha512_row in sha512.cuh.
//
// Replaces tendermint_tpu/ops/sha512_kernel.py:sha512_fixed, an XLA program
// on the TPU (not Pallas), which split every 64-bit word into (hi, lo)
// uint32 planes because the TPU has no 64-bit integer unit. A Hopper
// thread has native 64-bit adds, shifts and logic, so here one thread
// hashes one row with the eight state words and the 16-word schedule
// window in registers, and the message length is a runtime argument with
// the Merkle-Damgard padding laid out in-kernel (one build serves every
// length).
//
// What bounds it on an H100: integer operations. One 128-byte block is
// 80 rounds of ~60 64-bit operations (each a pair of 32-bit instructions)
// against 128 bytes read, far above the card's bytes-per-operation
// balance. The layout is the JAX package's batch-minor (64 + M, n) byte
// rows, so each warp reads 32 consecutive bytes per message byte; that
// keeps the loads coalesced but byte-sized, which later work can widen.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sha512.cuh"

namespace {

constexpr int kThreads = 128;

// data (len, n) uint8 rows, batch-minor; out (64, n) uint8
__global__ void __launch_bounds__(kThreads)
    sha512_rows_kernel(const uint8_t *data, uint8_t *out, int len, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) sha512_row(data, out, len, n, i);
}

}  // namespace

extern "C" {

// data (len, n) uint8, out (64, n) uint8, on card `device`. Returns
// cudaGetLastError().
int tm_sha512_rows(const void *data, void *out, int len, int n, int device,
                   void *stream) {
  if (n <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  sha512_rows_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                       (cudaStream_t)stream>>>((const uint8_t *)data,
                                               (uint8_t *)out, len, n);
  return (int)cudaGetLastError();
}

const char *tm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
