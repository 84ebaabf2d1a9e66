// Kernel K1 (ed25519_dual_mult): [S]B - [k]A per signature, four threads
// per signature, with the JAX contract at its interface: a (4, 20, n)
// int32 extended point in 13-bit limbs, batch-minor, and (64, n) int32
// radix-16 digits in, the T-less projective (3, 20, n) out (canonical
// limbs). Each lane converts its one coordinate to and from the kernel's
// radix-2^25.5 limbs.
//
// Replaces tendermint_tpu/ops/ed25519_pallas.py:dual_mult_pallas (body
// ops/ed25519_kernel.py:dual_mult_sb_minus_ka). It serves the "hybrid"
// program: plain-torch preparation and compare around this kernel. The
// per-lane body is ed25519_dual_mult_lane in ed25519_device.cuh, the same
// four-lane ge4_dual_mult that kernel K2 runs.
//
// What bounds it on an H100: integer multiplies, per signature ~1.8k field
// multiplies of 100 32x32->64 limb products and ~1k squarings of 55,
// against 1,072 bytes moved; at 2048-signature windows, the length of one
// signature's chain of field operations. The design, and what it does
// about that, is K2's (ed25519_verify.cu): four lanes, one coordinate
// each, 16 signatures a block, tables in shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ed25519_device.cuh"

namespace {

constexpr int kSigs = ED25519_SIGS_PER_BLOCK;
constexpr int kThreads = 4 * kSigs;
constexpr int kTabStride = 4 * kSigs;  // the layout of K2's table of -A

__global__ void __launch_bounds__(kThreads, 2)
    dual_mult_kernel(const int32_t *a, const int32_t *ds, const int32_t *dk,
                     int32_t *out, int n) {
  __shared__ uint32_t btab[9 * 4 * 10];
  __shared__ uint32_t atab[9 * 10 * kTabStride];
  const uint32_t *b = &GE_BASE_TABLE[0][0][0];
  for (int k = threadIdx.x; k < 9 * 4 * 10; k += kThreads) btab[k] = b[k];
  __syncthreads();
  const int s = threadIdx.x >> 2;
  ed25519_dual_mult_lane(a, ds, dk, out, n, blockIdx.x * kSigs + s,
                         atab + 4 * s, kTabStride, btab);
}

}  // namespace

extern "C" {

// a (4, 20, n) int32 extended point, ds/dk (64, n) int32 digits in
// [0, 15], on card `device` -> out (3, 20, n) int32 canonical limbs of
// (X, Y, Z). Returns cudaGetLastError().
int tm_ed25519_dual_mult(const void *a, const void *ds, const void *dk,
                         void *out, int n, int device, void *stream) {
  if (n <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  dual_mult_kernel<<<(n + kSigs - 1) / kSigs, kThreads, 0,
                     (cudaStream_t)stream>>>(
      (const int32_t *)a, (const int32_t *)ds, (const int32_t *)dk,
      (int32_t *)out, n);
  return (int)cudaGetLastError();
}

const char *tm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
