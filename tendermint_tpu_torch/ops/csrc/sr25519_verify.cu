// Kernel X3 (sr25519_verify): the whole schnorrkel check over ristretto255,
//   [s]B - [k]A == R  as ristretto255 elements,  s < L,  marker bit set,
// with A and R decoded by RFC 9496 §4.3.1 and k the merlin challenge,
// computed and reduced mod L on the host. Four threads per signature,
// byte rows in, validity bitmap out.
//
// Replaces tendermint_tpu/ops/sr25519_kernel.py:_verify_tile_sr (an XLA
// program; its hybrid form plugs the Pallas dual mult, K1, into it). The
// per-lane body is sr25519_verify_lane in sr25519_device.cuh, on the field,
// group operations and dual multiplication of ed25519_device.cuh.
//
// What bounds it on an H100: integer multiplies, per signature two
// decodes of ~257 squarings and ~27 multiplies each (the pow_p58 chain of
// sqrt_ratio_m1) and the dual multiplication's ~1k squarings and ~1.8k
// multiplies, against 129 bytes moved. At the 2048-signature windows the
// batch verifier streams, the time of a launch is one signature's chain
// of dependent field operations, as for K2, and the design is K2's:
//   - four lanes per signature, one point coordinate each, the decodes of
//     A and R side by side on two lane pairs;
//   - 16 signatures (64 threads) a block: a 2048 window is 128 blocks;
//   - lane choices by bit masks, never by branch; the table of -A and B's
//     table in shared memory; no local memory.
// It differs from K2 in what the check needs: no SHA-512 digest and no
// reduction mod L (k arrives reduced), no cofactor doublings, and the
// equality is four products, one a lane.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sr25519_device.cuh"

namespace {

constexpr int kSigs = ED25519_SIGS_PER_BLOCK;
constexpr int kThreads = 4 * kSigs;
// -A's table laid out as in K2: 32 threads of a warp read 32 banks
constexpr int kTabStride = 4 * kSigs;

__global__ void __launch_bounds__(kThreads, 2)
    sr25519_verify_kernel(const uint8_t *pk, const uint8_t *sig,
                          const uint8_t *k, bool *out, int n, int es) {
  __shared__ uint32_t btab[9 * 4 * 10];
  __shared__ uint32_t atab[9 * 10 * kTabStride];
  const uint32_t *b = &GE_BASE_TABLE[0][0][0];
  for (int j = threadIdx.x; j < 9 * 4 * 10; j += kThreads) btab[j] = b[j];
  __syncthreads();
  const int s = threadIdx.x >> 2;
  sr25519_verify_lane(pk, sig, k, out, n, es, blockIdx.x * kSigs + s,
                      atab + 4 * s, kTabStride, btab);
}

}  // namespace

extern "C" {

// pk (32, n), sig (64, n), k (32, n) byte rows, all uint8 (elem_bytes = 1)
// or all int32 (elem_bytes = 4), on card `device`; out (n,) bool. Returns
// cudaGetLastError().
int tm_sr25519_verify(const void *pk, const void *sig, const void *k,
                      void *out, int n, int elem_bytes, int device,
                      void *stream) {
  if (n <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  sr25519_verify_kernel<<<(n + kSigs - 1) / kSigs, kThreads, 0,
                          (cudaStream_t)stream>>>(
      (const uint8_t *)pk, (const uint8_t *)sig, (const uint8_t *)k,
      (bool *)out, n, elem_bytes);
  return (int)cudaGetLastError();
}

const char *tm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
