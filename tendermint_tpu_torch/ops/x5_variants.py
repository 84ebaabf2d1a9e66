"""Kernel X5's designs, built side by side and timed in one process.

X5 (csrc/merkle_proofs.cu, body csrc/sha256.cuh `merkle_proof_item`)
walks one proof a thread: a 10,000-proof batch is 79 blocks of 128
threads, one warp on each of 316 of the card's 528 schedulers, so a
launch lasts one warp's stream of 28 dependent compressions a proof of
depth 14, every integer instruction of it issued by that warp alone. A
round cannot be split between threads; what a design can do is issue
fewer instructions a warp, or spread a proof's instructions over more
schedulers. The kernel ships one design, `shipped` (the second block of
each inner hash from the table csrc/sha256_pad.cuh, the next aunt loaded
a step ahead). Each other design is a copy of csrc/ whose text this
module replaces, as x3_variants does:

- `word`: PR 5's walk, sha256_inner_words and the aunt's eight 4-byte
  loads at the top of each step: X5 as it was first built, the
  reference;
- `fixed` (candidate 1): the second block's K[t] + W[t], t >= 16, from
  the table (the block is fixed but for R's last byte), no prefetch;
- `prefetch`: the next aunt loaded a step ahead, no table;
- `split` (candidate 2): a block of two warps for 32 proofs; warp 1
  (producer) expands W[16..63] of each compression into shared memory
  while warp 0 (consumer) runs the rounds, handing over at
  `__syncthreads()` twice a block (W[16..39], then W[40..63]) after the
  consumer's rounds 0-15;
- `fixed_split` (candidate 3): both; the producer expands the first
  block alone.

For each design it reports ptxas registers and spills and the CUDA-event
time of one launch (mean of `reps` launches, each design timed twice, in
the order given and then reversed) on the proofs of a 10,000-leaf tree
and of a 150-leaf tree, each batch's roots and bitmap checked against
the plain version's and one corrupted proof rejected. It picks the
design with the least mean time on the 10,000-proof batch (within 2%,
the least on 150), and names it as the one to ship only when it beats
`shipped` there by at least 5%. Needs nvcc and a card.

    python -m tendermint_tpu_torch.ops.x5_variants [--reps 200]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess

from .build import BUILD_DIR, CSRC, NVCC_FLAGS, nvcc_path

__all__ = [
    "SHIPPED",
    "SOURCES",
    "VARIANTS",
    "build_variant",
    "load_variant",
    "make_launcher",
    "measure",
    "variant_sources",
]

# the files of csrc/ a design changes
SOURCES = ("sha256.cuh", "merkle_proofs.cu")
# name -> (second block from the table, producer/consumer warps, the
# next aunt loaded a step ahead)
VARIANTS = {
    "shipped": (True, False, True),
    "word": (False, False, False),
    "fixed": (True, False, False),
    "prefetch": (False, False, True),
    "split": (False, True, False),
    "fixed_split": (True, True, False),
}
SHIPPED = "shipped"
BATCHES = (10_000, 150)  # leaves of the tree whose proofs make a batch
TIE = 0.02
GAIN = 0.05  # the least gain over `shipped` that makes a design ship

# appended to sha256.cuh: the candidates' device functions, under the
# design's macros (X5_FIXED, X5_SPLIT, X5_PREFETCH)
_BODY = r"""
// ---- kernel X5's candidate designs (ops/x5_variants.py) ----
#ifdef __CUDACC__
#define X5_WARP_MAX(v) __reduce_max_sync(0xffffffffu, (v))
#define X5_BAR() __syncthreads()
#else
#define X5_WARP_MAX(v) x5_host_warp_max(v)
#define X5_BAR() x5_host_bar()
#endif

// W[t] of a schedule ring w (16 words, in place), t >= 16
__device__ __forceinline__ uint32_t x5_expand(uint32_t *w, int t) {
  const uint32_t w15 = w[(t - 15) & 15], w2 = w[(t - 2) & 15];
  const uint32_t s0 = SHA256_ROTR(w15, 7) ^ SHA256_ROTR(w15, 18) ^ (w15 >> 3);
  const uint32_t s1 = SHA256_ROTR(w2, 17) ^ SHA256_ROTR(w2, 19) ^ (w2 >> 10);
  w[t & 15] += s0 + w[(t - 7) & 15] + s1;
  return w[t & 15];
}

#if X5_FIXED
#define X5_INNER sha256_inner_pad
#else
#define X5_INNER sha256_inner_words
#endif

// merkle_proof_item with the design's inner hash and aunt loads
__device__ __forceinline__ void x5_item(
    const uint8_t *leaf, const uint8_t *aunts, const int32_t *off,
    const uint64_t *sides, const uint8_t *want, const uint8_t *ok_in,
    uint8_t *roots, uint8_t *ok, int k) {
  uint32_t h[8], a[8], l[8], r[8];
  sha256_load_digest(leaf + (size_t)32 * k, h);
  const int d0 = off[k], depth = off[k + 1] - d0;
  const uint64_t s = sides[k];
#if X5_PREFETCH
  sha256_u4 n0 = {0, 0, 0, 0}, n1 = {0, 0, 0, 0};
  if (depth > 0) {
    n0 = SHA256_LD4(aunts + (size_t)32 * d0);
    n1 = SHA256_LD4(aunts + (size_t)32 * d0 + 16);
  }
#endif
#pragma unroll 1
  for (int d = 0; d < depth; d++) {
#if X5_PREFETCH
    sha256_words4(n0, n1, a);
    if (d + 1 < depth) {
      n0 = SHA256_LD4(aunts + (size_t)32 * (d0 + d + 1));
      n1 = SHA256_LD4(aunts + (size_t)32 * (d0 + d + 1) + 16);
    }
#else
    sha256_load_digest(aunts + (size_t)32 * (d0 + d), a);
#endif
    const bool left = (s >> d) & 1;
#pragma unroll
    for (int j = 0; j < 8; j++) {
      l[j] = left ? a[j] : h[j];
      r[j] = left ? h[j] : a[j];
    }
    X5_INNER(l, r, h);
  }
  sha256_store_digest(h, roots + (size_t)32 * k);
  uint32_t w[8], diff = 0;
  sha256_load_digest(want, w);
#pragma unroll
  for (int j = 0; j < 8; j++) diff |= w[j] ^ h[j];
  ok[k] = ok_in[k] != 0 && diff == 0;
}

#if X5_SPLIT
// rows of the shared schedule: the first block's W[16..63] (+ K), and
// without the table the second block's after them
#define X5_SH_ROWS (X5_FIXED ? 48 : 96)

// Proof k = 32 blockIdx + lane of a block of two warps: role 0 (the
// consumer) runs the rounds and keeps the node; role 1 (the producer)
// expands each compression's W[16..63] + K into sh_w for it. Both walk
// to the deepest proof of their 32, meeting at X5_BAR() the same number
// of times: S1 (the node is in sh_h), S2a (W[16..39]), S2b (W[40..63])
// and, without the table, S2c (the second block's schedule).
__device__ __forceinline__ void x5_split_item(
    const uint8_t *leaf, const uint8_t *aunts, const int32_t *off,
    const uint64_t *sides, const uint8_t *want, const uint8_t *ok_in,
    uint8_t *roots, uint8_t *ok, int n, int k, int lane, int role,
    uint32_t (*sh_h)[32], uint32_t (*sh_w)[32]) {
  const bool live = k < n;
  int d0 = 0, depth = 0;
  uint64_t s = 0;
  if (live) {
    d0 = off[k];
    depth = off[k + 1] - d0;
    s = sides[k];
  }
  const int dmax = X5_WARP_MAX(depth);
  uint32_t h[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  if (live && role == 0) sha256_load_digest(leaf + (size_t)32 * k, h);
#pragma unroll 1
  for (int d = 0; d < dmax; d++) {
    const bool act = d < depth;
    if (role == 0) {
#pragma unroll
      for (int j = 0; j < 8; j++) sh_h[j][lane] = h[j];
    }
    X5_BAR();  // S1
    uint32_t node[8], a[8] = {0, 0, 0, 0, 0, 0, 0, 0}, l[8], r[8], w[16];
#pragma unroll
    for (int j = 0; j < 8; j++) node[j] = role == 0 ? h[j] : sh_h[j][lane];
    if (act) sha256_load_digest(aunts + (size_t)32 * (d0 + d), a);
    const bool left = (s >> d) & 1;
#pragma unroll
    for (int j = 0; j < 8; j++) {
      l[j] = left ? a[j] : node[j];
      r[j] = left ? node[j] : a[j];
    }
    sha256_inner_block1(l, r, w);
    const uint32_t b = r[7] & 0xffu;
    if (role == 1) {
#pragma unroll
      for (int t = 16; t < 40; t++) sh_w[t - 16][lane] = K256[t] + x5_expand(w, t);
      X5_BAR();  // S2a
#pragma unroll
      for (int t = 40; t < 64; t++) sh_w[t - 16][lane] = K256[t] + x5_expand(w, t);
      X5_BAR();  // S2b
#if !X5_FIXED
      uint32_t v[16];
      v[0] = (b << 24) | 0x00800000u;
#pragma unroll
      for (int j = 1; j < 15; j++) v[j] = 0;
      v[15] = 65u * 8u;
#pragma unroll
      for (int t = 16; t < 64; t++) sh_w[32 + t][lane] = K256[t] + x5_expand(v, t);
      X5_BAR();  // S2c
#endif
    } else {
#if X5_FIXED
      uint32_t kw[48];
      sha256_pad_row(b, kw);
#endif
      uint32_t st[8] = SHA256_IV;
      uint32_t A = st[0], B = st[1], C = st[2], D = st[3], E = st[4],
               F = st[5], G = st[6], H = st[7];
#pragma unroll
      for (int t = 0; t < 16; t++) sha256_round(A, B, C, D, E, F, G, H, K256[t] + w[t]);
      X5_BAR();  // S2a
#pragma unroll
      for (int t = 16; t < 40; t++) sha256_round(A, B, C, D, E, F, G, H, sh_w[t - 16][lane]);
      X5_BAR();  // S2b
#pragma unroll
      for (int t = 40; t < 64; t++) sha256_round(A, B, C, D, E, F, G, H, sh_w[t - 16][lane]);
      st[0] += A; st[1] += B; st[2] += C; st[3] += D;
      st[4] += E; st[5] += F; st[6] += G; st[7] += H;
#if X5_FIXED
      sha256_compress_pad(st, b, kw);
#else
      A = st[0]; B = st[1]; C = st[2]; D = st[3];
      E = st[4]; F = st[5]; G = st[6]; H = st[7];
      sha256_round(A, B, C, D, E, F, G, H, K256[0] + ((b << 24) | 0x00800000u));
#pragma unroll
      for (int t = 1; t < 15; t++) sha256_round(A, B, C, D, E, F, G, H, K256[t]);
      sha256_round(A, B, C, D, E, F, G, H, K256[15] + 65u * 8u);
      X5_BAR();  // S2c
#pragma unroll
      for (int t = 16; t < 64; t++) sha256_round(A, B, C, D, E, F, G, H, sh_w[32 + t][lane]);
      st[0] += A; st[1] += B; st[2] += C; st[3] += D;
      st[4] += E; st[5] += F; st[6] += G; st[7] += H;
#endif
      if (act) {
#pragma unroll
        for (int j = 0; j < 8; j++) h[j] = st[j];
      }
    }
  }
  if (role != 0 || !live) return;
  sha256_store_digest(h, roots + (size_t)32 * k);
  uint32_t w[8], diff = 0;
  sha256_load_digest(want, w);
#pragma unroll
  for (int j = 0; j < 8; j++) diff |= w[j] ^ h[j];
  ok[k] = ok_in[k] != 0 && diff == 0;
}
#endif
"""

_ITEM_CALL = "    merkle_proof_item(leaf, aunts, off, sides, want, ok_in, roots, ok, i);"
_KERNEL_HEAD = "  const int i = blockIdx.x * blockDim.x + threadIdx.x;\n  if (i < k)\n"
_SPLIT_KERNEL = (
    "  __shared__ uint32_t sh_h[8][32];\n"
    "  __shared__ uint32_t sh_w[X5_SH_ROWS][32];\n"
    "  x5_split_item(leaf, aunts, off, sides, want, ok_in, roots, ok, k,\n"
    "                blockIdx.x * 32 + (threadIdx.x & 31), threadIdx.x & 31,\n"
    "                threadIdx.x >> 5, sh_h, sh_w);\n"
)
_THREADS = "constexpr int kThreads = 128;"
_GRID = "merkle_proofs_kernel<<<(k + kThreads - 1) / kThreads, kThreads, 0,"


def _replace(text: str, old: str, new: str, where: str) -> str:
    if text.count(old) != 1:
        raise RuntimeError(f"x5_variants: {old.strip()!r} is not once in {where}")
    return text.replace(old, new)


def variant_sources(name: str, sources: dict) -> dict:
    """SOURCES' texts for design `name` from the kernel's own; raises
    when an anchor is not in them once."""
    if name == SHIPPED:
        return dict(sources)
    fixed, split, prefetch = VARIANTS[name]
    out = dict(sources)
    flags = (
        f"\n#define X5_FIXED {int(fixed)}\n#define X5_SPLIT {int(split)}\n"
        f"#define X5_PREFETCH {int(prefetch)}\n"
    )
    out["sha256.cuh"] = sources["sha256.cuh"] + flags + _BODY
    cu = sources["merkle_proofs.cu"]
    if split:
        cu = _replace(cu, _KERNEL_HEAD + _ITEM_CALL + "\n", _SPLIT_KERNEL,
                      "merkle_proofs.cu")
        cu = _replace(cu, _THREADS, "constexpr int kThreads = 64;",
                      "merkle_proofs.cu")
        cu = _replace(cu, _GRID,
                      "merkle_proofs_kernel<<<(k + 31) / 32, kThreads, 0,",
                      "merkle_proofs.cu")
    else:
        cu = _replace(cu, _ITEM_CALL, _ITEM_CALL.replace(
            "merkle_proof_item(", "x5_item("), "merkle_proofs.cu")
    out["merkle_proofs.cu"] = cu
    return out


def build_variant(name: str):
    """Start nvcc for design `name` in build/x5_variants/<name>/: (the
    library's path, the nvcc process, whose output is the ptxas log)."""
    root = BUILD_DIR / "x5_variants" / name
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(CSRC, root / "csrc")
    texts = variant_sources(name, {f: (CSRC / f).read_text() for f in SOURCES})
    for fname, text in texts.items():
        (root / "csrc" / fname).write_text(text)
    lib = root / "libx5.so"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(lib),
           str(root / "csrc" / "merkle_proofs.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return lib, proc


def load_variant(name: str, lib, proc):
    """Wait for build_variant's nvcc: (tm_merkle_proofs of the design,
    its ptxas resources). Raises when the build failed."""
    log = proc.communicate()[0]
    if proc.returncode:
        raise RuntimeError(f"x5_variants: {name} failed to build:\n{log}")
    fn = ctypes.CDLL(str(lib)).tm_merkle_proofs
    v, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [v] * 8 + [i, i, v]
    fn.restype = i
    return fn, _ptxas(log)


def _ptxas(log: str) -> dict:
    """Registers, stack and spill bytes of merkle_proofs_kernel."""
    sec = log[log.index("merkle_proofs_kernel"):]
    regs = int(sec.split("Used ", 1)[1].split(" registers", 1)[0])
    m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                  r"(\d+) bytes spill loads", sec)
    return {"registers": regs, "stack_frame_bytes": int(m.group(1)),
            "spill_store_bytes": int(m.group(2)),
            "spill_load_bytes": int(m.group(3))}


def make_launcher(fn, views, name: str):
    """(launch, roots, ok): launch() runs a design's tm_merkle_proofs
    on the packed batch `views` (ProofBatch.to on a card) into roots and
    ok, on the current stream; it raises when the launch fails."""
    import torch

    dev = views[0].device
    k = views[0].shape[0]
    roots = torch.empty((k, 32), dtype=torch.uint8, device=dev)
    ok = torch.empty(k, dtype=torch.bool, device=dev)
    args = [ctypes.c_void_p(t.data_ptr()) for t in (*views, roots, ok)]
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)

    def launch():
        if fn(*args, k, dev.index or 0, stream) != 0:
            raise RuntimeError(f"x5_variants: {name} launch failed")

    return launch, roots, ok


def batch_of(n_leaves: int, seed: int, corrupt: bool = False):
    """(proofs, root) of a tree of n_leaves random items from `seed`;
    with `corrupt`, one aunt of proof n // 3 flipped."""
    import numpy as np

    from ..crypto import merkle

    rng = np.random.default_rng(seed + n_leaves)
    items = [rng.bytes(int(m)) for m in rng.integers(100, 301, n_leaves)]
    root, proofs = merkle.proofs_from_byte_slices(items)
    if corrupt:
        p = proofs[n_leaves // 3]
        p.aunts[0] = bytes([p.aunts[0][0] ^ 1]) + p.aunts[0][1:]
    return proofs, root


def measure(reps: int = 200, seed: int = 0) -> dict:
    """{"variants": {name: {"design", "ptxas", "ms": {batch: [ms, ms]}}},
    "chosen", "ship"}: `chosen` the fastest design, `ship` it or
    `shipped` when it gains less than GAIN on the 10,000-proof batch."""
    import torch

    from .merkle_kernel import pack_proofs, verify_program_plain

    builds = {name: build_variant(name) for name in VARIANTS}
    dev = torch.device("cuda")
    inputs = {}
    for n in BATCHES:
        for corrupt in (False, True):
            proofs, root = batch_of(n, seed, corrupt)
            views = pack_proofs(proofs, root).to(dev)
            want_roots, want_ok = verify_program_plain(*views)
            inputs[(n, corrupt)] = (views, want_roots, want_ok)
        if not inputs[(n, False)][2].all():
            raise AssertionError(f"x5_variants: a valid proof failed at {n}")
        if inputs[(n, True)][2].all():
            raise AssertionError(f"x5_variants: the corrupted proof passed at {n}")
    out, fns = {}, {}
    for name, (lib, proc) in builds.items():
        fns[name], resources = load_variant(name, lib, proc)
        fixed, split, prefetch = VARIANTS[name]
        out[name] = {"design": {"fixed": fixed, "split": split,
                                "prefetch": prefetch},
                     "ptxas": resources, "ms": {str(n): [] for n in BATCHES}}

    def launcher(name, views):
        return make_launcher(fns[name], views, name)

    for name in VARIANTS:  # every design against the plain version
        for (n, corrupt), (views, want_roots, want_ok) in inputs.items():
            launch, roots, ok = launcher(name, views)
            launch()
            torch.cuda.synchronize()
            if not (torch.equal(roots, want_roots) and torch.equal(ok, want_ok)):
                raise AssertionError(
                    f"x5_variants: {name} differs from the plain version "
                    f"({n} proofs, corrupted: {corrupt})")

    def timed(name: str, n: int) -> float:
        launch, _roots, _ok = launcher(name, inputs[(n, False)][0])
        launch()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            launch()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    order = list(VARIANTS)
    for names in (order, order[::-1]):
        for name in names:
            for n in BATCHES:
                out[name]["ms"][str(n)].append(timed(name, n))

    def mean(name, n):
        t = out[name]["ms"][str(n)]
        return sum(t) / len(t)

    big, small = BATCHES
    best = min(VARIANTS, key=lambda v: mean(v, big))
    close = [v for v in VARIANTS if mean(v, big) <= mean(best, big) * (1 + TIE)]
    chosen = min(close, key=lambda v: mean(v, small))
    gain = 1 - mean(chosen, big) / mean(SHIPPED, big)
    return {"variants": out, "chosen": chosen, "gain": gain,
            "ship": chosen if gain >= GAIN else SHIPPED,
            "reps": reps, "batches": list(BATCHES)}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=200)
    res = measure(ap.parse_args().reps)
    for name, row in res["variants"].items():
        print(json.dumps({"variant": name, **row}), flush=True)
    print(json.dumps({k: res[k] for k in ("chosen", "gain", "ship", "reps")}),
          flush=True)
