// Kernel K2 (ed25519_verify_tile): the whole ZIP-215 cofactored check,
//   [8]([S]B - [k]A) == [8]R,  k = SHA512(R || A || M) mod L,  S < L,
// four threads per signature, byte rows in, validity bitmap out.
//
// Replaces tendermint_tpu/ops/ed25519_pallas.py:verify_pallas (body
// ops/ed25519_kernel.py:_verify_tile). The per-lane body is
// ed25519_verify_lane in ed25519_device.cuh, whose dual scalar
// multiplication kernel K1 shares.
//
// What bounds it on an H100: integer multiplies, ~1.9k field multiplies of
// 100 32x32->64 limb products and ~1.6k squarings of 55 per signature
// against 161 bytes moved; but a batch verifier streams windows of only
// 2048 signatures, so what sets the time is how long one signature's chain
// of dependent field operations takes, not the card's multiply rate.
// The design shortens that chain and fills the card:
//   - four lanes per signature, one point coordinate each: a doubling or
//     an addition is two rounds of one field multiply per lane, lanes
//     exchanging operands by warp shuffle, and the pow_p58 chains of A and
//     R run side by side on two lane pairs (~1.1k operations on the
//     critical path instead of ~3.5k);
//   - 16 signatures (64 threads) a block, so a 2048 window is 128 blocks
//     on 132 SMs;
//   - no divergence: what differs between the lanes is data, chosen by
//     bit masks (fe_sel4), never by a branch;
//   - no local memory: the table of -A in shared memory (each lane writes
//     its coordinate of the 9 entries, the lanes of a signature read them
//     by digit), B's table copied from constant to shared memory once a
//     block (divergent digits cost bank accesses, not serialised constant
//     reads), digits packed into registers;
//   - fewer instructions per field operation: radix 2^25.5 (a multiply is
//     100 one-instruction 32x32->64 multiply-adds), dedicated squarings
//     (55 products), sums and differences left unreduced into the
//     multiplies.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ed25519_device.cuh"

namespace {

constexpr int kSigs = ED25519_SIGS_PER_BLOCK;
constexpr int kThreads = 4 * kSigs;
// -A's table: entry j, limb k, signature s, coordinate c at
// ((10 j + k) * kSigs + s) * 4 + c, so the 32 threads of a warp read 32
// different banks whatever their digits
constexpr int kTabStride = 4 * kSigs;

__global__ void __launch_bounds__(kThreads, 2)
    verify_tile_kernel(const uint8_t *pk, const uint8_t *sig,
                       const uint8_t *dig, bool *out, int n, int es) {
  __shared__ uint32_t btab[9 * 4 * 10];
  __shared__ uint32_t atab[9 * 10 * kTabStride];
  const uint32_t *b = &GE_BASE_TABLE[0][0][0];
  for (int k = threadIdx.x; k < 9 * 4 * 10; k += kThreads) btab[k] = b[k];
  __syncthreads();
  const int s = threadIdx.x >> 2;
  ed25519_verify_lane(pk, sig, dig, out, n, es, blockIdx.x * kSigs + s,
                      atab + 4 * s, kTabStride, btab);
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
  verify_tile_kernel<<<(n + kSigs - 1) / kSigs, kThreads, 0,
                       (cudaStream_t)stream>>>(
      (const uint8_t *)pk, (const uint8_t *)sig, (const uint8_t *)dig,
      (bool *)out, n, elem_bytes);
  return (int)cudaGetLastError();
}

const char *tm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
