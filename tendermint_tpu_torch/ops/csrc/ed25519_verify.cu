// Kernel K2 (ed25519_verify_tile): the whole ZIP-215 cofactored check,
//   [8]([S]B - [k]A) == [8]R,  k = SHA512(R || A || M) mod L,  S < L,
// one signature per thread, byte rows in, validity bitmap out.
//
// Replaces tendermint_tpu/ops/ed25519_pallas.py:verify_pallas (body
// ops/ed25519_kernel.py:_verify_tile). The per-signature body is
// ed25519_verify_one in ed25519_device.cuh, shared with kernel K1.
//
// What bounds it on an H100: integer multiplies. One signature costs about
// 1.9k field multiplies of 25 64x64->128 limb products and 1.6k squarings
// that need only 15 (64 windows x (4 doublings + 2 additions), the 9-entry
// table of -A, two ~250-squaring pow_p58 chains for decompressing A and R),
// while it moves 160 bytes in and 1 out. The design is the simplest
// correct one: one thread per signature, radix-2^51 limbs, squarings taken
// as general multiplies, table entries read by index (verification
// handles public data only), the table of -A in local memory. The batch
// verifier streams a commit in windows of 2048 signatures, 16 blocks of
// 128 threads on 132 SMs, and the compiler keeps 255 registers a thread
// with spills, so the card is far from full; filling it (several threads
// per signature, or batching several signatures per thread group) is
// later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ed25519_device.cuh"

namespace {

constexpr int kThreads = 128;

// byte j of column i of (k, n) byte rows, batch-minor, whose elements are
// `es` bytes wide: 1 for uint8 rows, 4 for int32 rows (the JAX contract;
// the byte is the element's low byte on this little-endian card)
__device__ __forceinline__ void load_col(uint8_t *dst, const uint8_t *rows,
                                         int k, int n, int i, int es) {
  for (int j = 0; j < k; j++) dst[j] = rows[((size_t)j * n + i) * es];
}

__global__ void __launch_bounds__(kThreads)
    verify_tile_kernel(const uint8_t *pk, const uint8_t *sig,
                       const uint8_t *dig, bool *out, int n, int es) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint8_t a_b[32], sig_b[64], d_b[64];
  load_col(a_b, pk, 32, n, i, es);
  load_col(sig_b, sig, 64, n, i, es);
  load_col(d_b, dig, 64, n, i, es);
  out[i] = ed25519_verify_one(a_b, sig_b, d_b);
}

}  // namespace

extern "C" {

// pk (32, n), sig (64, n), dig (64, n) byte rows, all uint8 (elem_bytes =
// 1) or all int32 (elem_bytes = 4), on card `device`; out (n,) bool.
// Returns cudaGetLastError(). The device is set here because this
// library's CUDA runtime is its own, not PyTorch's.
int tm_ed25519_verify_tile(const void *pk, const void *sig, const void *dig,
                           void *out, int n, int elem_bytes, int device,
                           void *stream) {
  if (n <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  verify_tile_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                       (cudaStream_t)stream>>>(
      (const uint8_t *)pk, (const uint8_t *)sig, (const uint8_t *)dig,
      (bool *)out, n, elem_bytes);
  return (int)cudaGetLastError();
}

const char *tm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
