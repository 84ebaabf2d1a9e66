// Kernel X1: SHA-512 of the rows of a batch, in two entry points on one
// device body (sha512.cuh).
//
// - sha512_ram_kernel: SHA-512(R || A || M) of every lane of a verifier's
//   window, in add order, in one launch whatever the message lengths. R
//   and A are read from the (64, B) sig and (32, B) pk byte rows the
//   verifier already holds on the card; M comes from one flat buffer of
//   messages with B + 1 int32 offsets. Replaces
//   tendermint_tpu/ops/sha512_kernel.py:190 `sha512_fixed` as the JAX
//   verifier drives it (tendermint_tpu/ops/ed25519_kernel.py:660
//   `_digest_rows`): one XLA program per message length, each length
//   group padded to its own bucket, joined on the host and scattered back.
// - sha512_rows_kernel: the JAX contract of sha512_fixed itself, (L, n)
//   batch-minor rows of one length.
//
// What bounds it on an H100. Its work is integer operations: a 128-byte
// block is ~3,660 SASS instructions (80 rounds and 64 schedule steps),
// against 128 bytes read. Hopper has no 64-bit integer unit: each 64-bit
// add is an IADD3 pair and each rotate two funnel shifts (an earlier note
// here said otherwise; nvcc already made those pairs of the 64-bit C).
// At the widths a verifier launches (2048 rows) the card's throughput is
// not what limits a launch: one thread hashes one row, so a launch takes
// at least one row's compressions, issued by one warp on the integer
// pipe, whose 16 lanes a sub-partition take two cycles a warp
// instruction: 8,200-10,600 SM cycles a compression, measured
// (ops/x1_latency.py), plus the launch.
//
// What the design does about it. No row is padded to another's length:
// each lays out its own padding and block count, so a window is one
// launch and hashes only its own rows, where the grouped design hashed
// each length group padded to its own bucket in a launch of its own. One
// warp a block (32 rows), so a 2048-row window spreads over 64 SMs, one
// warp each. The block's messages are one contiguous span of the flat
// buffer, copied to shared memory in 16-byte loads, and each message word
// is two PRMTs of aligned 32-bit shared-memory words, whatever the
// message's alignment. R and A are read from the rows already on the
// card, so the host joins no R || A || M strings.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sha512.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kRows = SHA512_ROWS_PER_BLOCK;

// data (len, n) uint8 rows, batch-minor; out (64, n) uint8
__global__ void __launch_bounds__(kThreads)
    sha512_rows_kernel(const uint8_t *data, uint8_t *out, int len, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) sha512_row(data, out, len, n, i);
}

// sig (64, n), pk (32, n) uint8 rows, batch-minor; msg the messages, row
// i's at msg[off[i] .. off[i + 1]); out (64, n) uint8. cap: the bytes of
// stage a block's span may take.
__global__ void __launch_bounds__(kRows)
    sha512_ram_kernel(const uint8_t *sig, const uint8_t *pk,
                      const uint8_t *msg, const int32_t *off, uint8_t *out,
                      int n, int cap) {
  extern __shared__ sha_v16 stage[];
  const int r0 = blockIdx.x * kRows, i = r0 + threadIdx.x;
  const int r1 = min(r0 + kRows, n);
  const int a0 =
      sha512_stage(msg, off[r0], off[r1], stage, threadIdx.x, kRows, cap);
  if (a0 < 0) __trap();  // a message longer than the launch's max_len
  __syncthreads();
  if (i < n)
    sha512_ram_row(sig, pk, n, i, (const uint8_t *)stage, off[i] - a0,
                   off[i + 1] - off[i], out);
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

// sig (64, n), pk (32, n) uint8, msg uint8 (16-byte aligned, its length a
// multiple of 16), off (n + 1) int32, out (64, n) uint8, on card
// `device`; no message longer than max_len. Returns cudaGetLastError(),
// or cudaErrorInvalidValue when a block's stage would not fit in shared
// memory.
int tm_sha512_ram(const void *sig, const void *pk, const void *msg,
                  const void *off, void *out, int n, int max_len, int device,
                  void *stream) {
  if (n <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int limit = 0;
  err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return (int)err;
  const long long bytes = SHA512_STAGE_BYTES((long long)max_len);
  if (max_len < 0 || bytes > limit) return (int)cudaErrorInvalidValue;
  if (bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(sha512_ram_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  sha512_ram_kernel<<<(n + kRows - 1) / kRows, kRows, (size_t)bytes,
                      (cudaStream_t)stream>>>(
      (const uint8_t *)sig, (const uint8_t *)pk, (const uint8_t *)msg,
      (const int32_t *)off, (uint8_t *)out, n,
      (int)SHA512_STAGE_CAP((long long)max_len));
  return (int)cudaGetLastError();
}

const char *tm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
