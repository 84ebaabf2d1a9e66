// Kernel X3 (sr25519_verify): the whole schnorrkel check over ristretto255,
//   [s]B - [k]A == R  as ristretto255 elements,  s < L,  marker bit set,
// with A and R decoded by RFC 9496 §4.3.1 and k the merlin challenge,
// computed and reduced mod L on the host. Eight threads per signature,
// byte rows in, validity bitmap out.
//
// Replaces tendermint_tpu/ops/sr25519_kernel.py:_verify_tile_sr (an XLA
// program; its hybrid form plugs the Pallas dual mult, K1, into it). The
// per-lane body is sr25519_verify_lane in sr25519_device.cuh.
//
// What bounds it on an H100. Its work is integer multiplies: per signature
// two decodes of ~257 squarings and ~24 multiplies (the pow_p58 chain of
// sqrt_ratio_m1), a table of -A and 64 windows of ~1k squarings and ~1.8k
// multiplies in all, against 129 bytes moved: ~0.035 ms of the card's
// int32 issue rate for a 2048 window. A launch takes ~14 times that,
// because it lasts as long as one signature's chain of ~1,050 dependent
// rounds, each one field multiply a lane: ~280 rounds of decode, ~22 of
// table, 64 windows of 4 doublings and 2 additions of two rounds each.
//
// Why the first design (K2's four lanes a signature, 16 signatures a
// block) ran at ~870 SM cycles a round: a 2048 window was 128 blocks of two
// warps, 256 warps for the 528 schedulers of 132 SMs, so each busy
// scheduler held one warp, and that warp's round (100 32x32->64 products,
// two carry chains of depth seven in 64 bits, 40 shuffles and ~100 selects
// and sums) issued alone: nothing overlapped its multiply pipe or its
// dependent latencies, and more than half of the schedulers had no warp.
//
// What this design does about it: shorten the chain, and put the lanes
// that shorten it on the idle schedulers. X3_LANES = 8 threads a signature
// (sr25519_device.cuh), 16 signatures a block, so a 2048 window is 512
// warps, one on nearly every scheduler:
//   - [s]B is off the doubling chain: lanes 4-7 add [e_s 16^w]B from a
//     64-window fixed-base comb (sr25519_comb.cuh, 69 KB in global memory,
//     read through the read-only cache) while lanes 0-3 add -A's entry, and
//     keep their sum through lanes 0-3's doublings; a window is 4 doublings
//     and 1 addition, 10 rounds instead of 12 (640 of the walk's 768), and
//     one addition joins the two sums at the end;
//   - the decode, the table of -A in shared memory (lanes 0-3 write it) and
//     the rounds themselves are K2's; selects by lane are masks, and no lane
//     branches around a shuffle.
//
// Candidates, one launch at 128 / 2048 signatures of the sr25519 corpus
// (ops/x3_variants.py, CUDA events, mean of 2 x 200 launches, on an NVIDIA
// H100 80GB HBM3 at a 700.00 W power limit), ms:
//   four (the first design)   0.46252382278442383 / 0.4905707359313965
//   pair (candidate a)        0.40387807846069335 / 0.43969623565673827  (80 B spilled)
//   comb (candidate b)        0.39798583984375 / 0.3986075973510742  (16 B spilled)
//   pair_comb (16 lanes)      0.5015264701843262 / 0.5045787239074707
// The pair split halves a multiply's products but adds the row selects,
// the rotation of g and ten 64-bit shuffles to each, and leaves the
// squarings (half the rounds) as they were: it gains at 128, where it has
// the card to itself, less at 2048. Sixteen lanes put two warps on each
// scheduler at 2048, and a round's issue slots are what bounds it. (A
// two-pass carry of the column sums, and squarings split like the
// multiplies, were tried as well and lost at both widths.)

#include <cuda_runtime.h>
#include <stdint.h>

#include "sr25519_device.cuh"

namespace {

constexpr int kSigs = ED25519_SIGS_PER_BLOCK;
constexpr int kThreads = X3_LANES * kSigs;
// -A's table laid out as in K2: lanes 0-3 of 16 signatures write 64 banks
constexpr int kTabStride = 4 * kSigs;

__global__ void __launch_bounds__(kThreads, 1)
    sr25519_verify_kernel(const uint8_t *pk, const uint8_t *sig,
                          const uint8_t *k, bool *out, int n, int es) {
  __shared__ uint32_t atab[9 * 10 * kTabStride];
  const int s = threadIdx.x / X3_LANES;
  sr25519_verify_lane(pk, sig, k, out, n, es, blockIdx.x * kSigs + s,
                      atab + 4 * s, kTabStride);
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
