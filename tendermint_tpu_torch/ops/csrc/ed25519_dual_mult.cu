// Kernel K1 (ed25519_dual_mult): [S]B - [k]A per signature, one signature
// per thread, with the JAX contract at its interface: a (4, 20, n) int32
// extended point in 13-bit limbs, batch-minor, and (64, n) int32 radix-16
// digits in, the T-less projective (3, 20, n) out (canonical limbs). The
// kernel converts to and from its own radix-2^51 limbs once per signature.
//
// Replaces tendermint_tpu/ops/ed25519_pallas.py:dual_mult_pallas (body
// ops/ed25519_kernel.py:dual_mult_sb_minus_ka). It serves the "hybrid"
// program: plain-torch preparation and compare around this kernel. The
// per-signature body is ed25519_dual_mult_one in ed25519_device.cuh, the
// same ge_dual_mult that kernel K2 runs.
//
// What bounds it on an H100: integer multiplies, per signature ~1.8k field
// multiplies of 25 64x64->128 limb products and ~1k squarings that need
// only 15, against 1,072 bytes moved.
// The design and its limits are those of K2 (ed25519_verify.cu).

#include <cuda_runtime.h>
#include <stdint.h>

#include "ed25519_device.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
    dual_mult_kernel(const int32_t *a, const int32_t *ds, const int32_t *dk,
                     int32_t *out, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) ed25519_dual_mult_one(a, ds, dk, out, n, i);
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
  dual_mult_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                     (cudaStream_t)stream>>>(
      (const int32_t *)a, (const int32_t *)ds, (const int32_t *)dk,
      (int32_t *)out, n);
  return (int)cudaGetLastError();
}

const char *tm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
