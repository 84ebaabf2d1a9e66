"""Kernel X3's designs, built side by side and timed in one process.

The kernel ships one design, `comb` (csrc/sr25519_device.cuh: eight lanes
a signature, [s]B from the fixed-base comb on the second four). Each
other design is a copy of csrc/ whose text this module replaces, as
x1_variants replaces a compression:

- `four`: four lanes a signature, [s]B added on the doubling chain from
  B's table in shared memory (ed25519_device.cuh's ge4_dual_mult, K1's
  walk): X3 as it was first built, the reference;
- `pair`: eight lanes, [s]B on the doubling chain, and every general
  field multiply split between the two sets of four lanes by the rows of
  its product (candidate a);
- `comb`: the kernel's own (candidate b);
- `pair_comb`: sixteen lanes, both.

The split multiply: the two sets hold the same values, and set h takes
the rows i = 2s + h of fe_mul's product, with g's limbs rotated by h so
that both sets run one instruction stream; the ten 64-bit column sums are
then joined with one shuffle-add before fe_reduce, so both hold fe_mul's
sums. Squarings stay whole on each thread.

For each design it reports ptxas registers and spills and the CUDA-event
time of one launch (mean of `reps`, each design timed twice, in the order
given and then reversed) at each width in WIDTHS, on the sr25519 corpus
tiled to the width, every bitmap checked against the host oracle. It then
picks the candidate (a design of eight lanes or more) with the least time
at 2048, the main path's window; within 2% of it, the least time at 128,
the light commit's bucket. Needs nvcc and a card.

    python -m tendermint_tpu_torch.ops.x3_variants [--reps 200]
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
    "CANDIDATES",
    "SHIPPED",
    "SOURCES",
    "VARIANTS",
    "build_variant",
    "load_variant",
    "measure",
    "variant_sources",
]

# the files of csrc/ a design changes
SOURCES = ("ed25519_device.cuh", "sr25519_device.cuh", "sr25519_verify.cu")
# name -> (lanes a signature, [s]B from the comb, multiplies split)
VARIANTS = {
    "four": (4, False, False),
    "pair": (8, False, True),
    "comb": (8, True, False),
    "pair_comb": (16, True, True),
}
SHIPPED = "comb"
# the redesigns the kernel may take: eight lanes a signature or more
CANDIDATES = tuple(n for n, (lanes, _c, _p) in VARIANTS.items() if lanes >= 8)
WIDTHS = (128, 2048)
TIE = 0.02

_LANES = "#define X3_LANES 8\n"
# without the comb: B's table in shared memory, K1's walk
_NO_COMB = {
    "sr25519_device.cuh": [
        ("    int n, int es, int i, uint32_t *tab, int stride) {",
         "    int n, int es, int i, uint32_t *tab, int stride,\n"
         "    const uint32_t *btab) {"),
        ("  x3_dual_mult(acc, av, esd, ekd, tab, stride);",
         "  ge4_dual_mult(acc, av, esd, ekd, tab, stride, btab);"),
    ],
    "sr25519_verify.cu": [
        ("  __shared__ uint32_t atab[9 * 10 * kTabStride];\n",
         "  __shared__ uint32_t atab[9 * 10 * kTabStride];\n"
         "  __shared__ uint32_t btab[9 * 4 * 10];\n"
         "  const uint32_t *b = &GE_BASE_TABLE[0][0][0];\n"
         "  for (int j = threadIdx.x; j < 9 * 4 * 10; j += kThreads)"
         " btab[j] = b[j];\n"
         "  __syncthreads();\n"),
        ("atab + 4 * s, kTabStride);", "atab + 4 * s, kTabStride, btab);"),
    ],
}
_MUL_START = "__device__ __forceinline__ void fe_mul("
_MUL_END = "// 2^dbl f^2"
_PAIR_MUL = """__device__ __forceinline__ void fe_mul(fe &h, const fe &f, const fe &g) {
  const int half = (threadIdx.x >> 2) & 1;
  const uint32_t m = 0u - (uint32_t)half;
  uint32_t fr[5], fd[5], gp[10], g19[10];
#pragma unroll
  for (int s = 0; s < 5; s++) {
    fr[s] = f.v[2 * s] ^ ((f.v[2 * s] ^ f.v[2 * s + 1]) & m);
    fd[s] = fr[s] << half;
  }
  gp[0] = g.v[0] ^ ((g.v[0] ^ (19 * g.v[9])) & m);
#pragma unroll
  for (int j = 1; j < 10; j++) gp[j] = g.v[j] ^ ((g.v[j] ^ g.v[j - 1]) & m);
#pragma unroll
  for (int j = 1; j < 10; j++) g19[j] = 19 * gp[j];
  uint64_t t[10] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
#pragma unroll
  for (int s = 0; s < 5; s++) {
#pragma unroll
    for (int j = 0; j < 10; j++) {
      const uint32_t a = (j & 1) ? fr[s] : fd[s];
      const uint32_t b = 2 * s + j >= 10 ? g19[j] : gp[j];
      t[(2 * s + j) % 10] += (uint64_t)a * b;
    }
  }
#pragma unroll
  for (int k = 0; k < 10; k++) {
    const uint32_t lo = __shfl_xor_sync(0xffffffffu, (uint32_t)t[k], 4);
    const uint32_t hi = __shfl_xor_sync(0xffffffffu, (uint32_t)(t[k] >> 32), 4);
    t[k] += ((uint64_t)hi << 32) | lo;
  }
  fe_reduce(h, t);
}

"""


def _replace(text: str, old: str, new: str, where: str) -> str:
    if text.count(old) != 1:
        raise RuntimeError(f"x3_variants: {old.strip()!r} is not once in {where}")
    return text.replace(old, new)


def variant_sources(name: str, sources: dict) -> dict:
    """SOURCES' texts for design `name`, from the kernel's own; raises
    when an anchor is not in them once."""
    lanes, comb, pair = VARIANTS[name]
    out = dict(sources)
    out["sr25519_device.cuh"] = _replace(
        out["sr25519_device.cuh"], _LANES, f"#define X3_LANES {lanes}\n",
        "sr25519_device.cuh")
    if not comb:
        for fname, pairs in _NO_COMB.items():
            for old, new in pairs:
                out[fname] = _replace(out[fname], old, new, fname)
    if pair:
        text = out["ed25519_device.cuh"]
        _replace(text, _MUL_START, _MUL_START, "ed25519_device.cuh")
        i = text.index(_MUL_START)
        j = text.index(_MUL_END, i)
        k = text.rindex("\n\n", 0, i) + 2  # fe_mul's note goes with it
        out["ed25519_device.cuh"] = text[:k] + _PAIR_MUL + text[j:]
    return out


def build_variant(name: str):
    """Start nvcc for design `name` in build/x3_variants/<name>/: (the
    library's path, the nvcc process, whose output is the ptxas log)."""
    root = BUILD_DIR / "x3_variants" / name
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(CSRC, root / "csrc")
    texts = variant_sources(
        name, {f: (CSRC / f).read_text() for f in SOURCES})
    for fname, text in texts.items():
        (root / "csrc" / fname).write_text(text)
    lib = root / "libx3.so"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(lib),
           str(root / "csrc" / "sr25519_verify.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return lib, proc


def load_variant(name: str, lib, proc):
    """Wait for build_variant's nvcc: (tm_sr25519_verify of the design,
    its ptxas resources). Raises when the build failed."""
    log = proc.communicate()[0]
    if proc.returncode:
        raise RuntimeError(f"x3_variants: {name} failed to build:\n{log}")
    fn = ctypes.CDLL(str(lib)).tm_sr25519_verify
    v, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [v, v, v, v, i, i, i, v]
    fn.restype = i
    return fn, _ptxas(log)


def _ptxas(log: str) -> dict:
    """Registers, stack and spill bytes of sr25519_verify_kernel."""
    sec = log[log.index("sr25519_verify_kernel"):]
    regs = int(sec.split("Used ", 1)[1].split(" registers", 1)[0])
    m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                  r"(\d+) bytes spill loads", log)
    return {"registers": regs, "stack_frame_bytes": int(m.group(1)),
            "spill_store_bytes": int(m.group(2)),
            "spill_load_bytes": int(m.group(3))}


def _inputs(torch, dev, width: int, seed: int):
    """The corpus tiled to `width` lanes, uploaded as the verifier does,
    and the oracle's bitmap."""
    import numpy as np

    from ..crypto import sr25519_corpus
    from .sr25519_kernel import Sr25519Verifier

    triples = sr25519_corpus.corpus(seed)
    want = np.array(sr25519_corpus.expected(triples))
    reps = -(-width // len(triples))
    tr = (triples * reps)[:width]
    pks, msgs, sigs = (list(x) for x in zip(*tr))
    w = Sr25519Verifier(bucket_sizes=[width], device=dev).upload(pks, msgs, sigs)
    return w, np.tile(want, reps)[:width]


def measure(reps: int = 200, seed: int = 0) -> dict:
    """{"variants": {name: {"design", "ptxas", "ms": {width: [ms, ms]}}},
    "chosen": name}."""
    import torch

    builds = {name: build_variant(name) for name in VARIANTS}
    dev = torch.device("cuda")
    inputs = {w: _inputs(torch, dev, w, seed) for w in WIDTHS}
    out, fns = {}, {}
    for name, (lib, proc) in builds.items():
        fns[name], resources = load_variant(name, lib, proc)
        lanes, comb, pair = VARIANTS[name]
        out[name] = {"design": {"lanes": lanes, "comb": comb, "pair": pair},
                     "ptxas": resources, "ms": {str(w): [] for w in WIDTHS}}
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)

    def timed(name: str, width: int) -> float:
        w, want = inputs[width]
        bits = torch.empty(width, dtype=torch.bool, device=dev)
        args = [ctypes.c_void_p(t.data_ptr())
                for t in (w.pk_b, w.sig_b, w.k_b, bits)]

        def launch():
            if fns[name](*args, width, 1, dev.index or 0, stream) != 0:
                raise RuntimeError(f"x3_variants: {name} launch failed")

        launch()
        torch.cuda.synchronize()
        got = bits.cpu().numpy() & w.size_ok
        if not (got == want).all():
            raise AssertionError(f"x3_variants: {name} differs at {width}")
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
            for width in WIDTHS:
                out[name]["ms"][str(width)].append(timed(name, width))

    def mean(name, width):
        t = out[name]["ms"][str(width)]
        return sum(t) / len(t)

    best = min(CANDIDATES, key=lambda n: mean(n, 2048))
    close = [n for n in CANDIDATES
             if mean(n, 2048) <= mean(best, 2048) * (1 + TIE)]
    chosen = min(close, key=lambda n: mean(n, 128))
    return {"variants": out, "chosen": chosen, "shipped": SHIPPED,
            "reps": reps, "widths": list(WIDTHS)}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=200)
    res = measure(ap.parse_args().reps)
    for name, row in res["variants"].items():
        print(json.dumps({"variant": name, **row}), flush=True)
    print(json.dumps({k: res[k] for k in ("chosen", "shipped", "reps")}),
          flush=True)
