"""Kernel X1's compression in other forms, timed against the kernel's own.

Each variant is a copy of csrc/sha512.cu whose sha512.cuh has
`sha512_compress` replaced by another form of the same function:

- `kernel`: the kernel's own (the rounds in the textbook order);
- `off_path_3in`: h + K[t] + W[t] and d + h + K[t] + W[t] added off the
  path of e, e and a as three-input sums;
- `off_path_2in`: the same with two-input sums;
- `fma_adds`: every 64-bit add on the FMA pipe (IMAD.WIDE.U32 and IMAD
  through a 1 the compiler cannot fold);
- `fma_schedule_adds`: only the message schedule's adds so.

For each it reports ptxas registers and spills, the SASS of one
compression (probe/sha512_compress.cu built against the variant), and
the CUDA-event time of one launch at 2048 and 12288 rows of several
message-length mixes, each digest checked against hashlib. Needs nvcc
and a card.

    python -m tendermint_tpu_torch.ops.x1_variants
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import shutil
import subprocess

from .build import BUILD_DIR, CSRC, NVCC_FLAGS, nvcc_path
from .sass_count import PROBES, count_sass

__all__ = ["VARIANTS", "measure"]

_ROUND_OFF_PATH_3IN = """
    const uint64_t hkw = hh + K512[t] + w[t & 15];
    const uint64_t dhkw = d + hkw;
    const uint64_t S1 = rotr64(e, 14) ^ rotr64(e, 18) ^ rotr64(e, 41);
    const uint64_t ch = sha_ch(e, f, g);
    const uint64_t S0 = rotr64(a, 28) ^ rotr64(a, 34) ^ rotr64(a, 39);
    const uint64_t maj = sha_maj(a, b, c);
    hh = g; g = f; f = e; e = dhkw + S1 + ch;
    d = c; c = b; b = a; a = (hkw + S1 + ch) + (S0 + maj);
"""
_ROUND_OFF_PATH_2IN = """
    const uint64_t hkw = ADD_R(hh, ADD_R(K512[t], w[t & 15]));
    const uint64_t dhkw = ADD_R(d, hkw);
    const uint64_t S1 = rotr64(e, 14) ^ rotr64(e, 18) ^ rotr64(e, 41);
    const uint64_t s1ch = ADD_R(S1, sha_ch(e, f, g));
    const uint64_t S0 = rotr64(a, 28) ^ rotr64(a, 34) ^ rotr64(a, 39);
    const uint64_t maj = sha_maj(a, b, c);
    hh = g; g = f; f = e; e = ADD_R(dhkw, s1ch);
    d = c; c = b; b = a; a = ADD_R(ADD_R(hkw, s1ch), ADD_R(S0, maj));
"""
_ROUND_TEXTBOOK = """
    const uint64_t S1 = rotr64(e, 14) ^ rotr64(e, 18) ^ rotr64(e, 41);
    const uint64_t t1 = ADD_R(ADD_R(ADD_R(hh, S1), sha_ch(e, f, g)),
                              ADD_R(K512[t], w[t & 15]));
    const uint64_t S0 = rotr64(a, 28) ^ rotr64(a, 34) ^ rotr64(a, 39);
    const uint64_t t2 = ADD_R(S0, sha_maj(a, b, c));
    hh = g; g = f; f = e; e = ADD_R(d, t1);
    d = c; c = b; b = a; a = ADD_R(t1, t2);
"""
_TEMPLATE = """__device__ __constant__ uint32_t X1V_ONE = 1;
__device__ __forceinline__ uint64_t add64_fma(uint64_t a, uint64_t b) {
  const uint32_t one = X1V_ONE;
  const uint64_t r = (uint64_t)(uint32_t)a * one + b;
  return sha_join((uint32_t)(r >> 32) + (uint32_t)(a >> 32) * one,
                  (uint32_t)r);
}
__device__ __forceinline__ uint64_t add64_alu(uint64_t a, uint64_t b) {
  return a + b;
}
#define ADD_R %(add_r)s
#define ADD_S %(add_s)s
__device__ __forceinline__ void sha512_compress(uint64_t *h, uint64_t *w) {
  uint64_t a = h[0], b = h[1], c = h[2], d = h[3], e = h[4], f = h[5],
           g = h[6], hh = h[7];
#pragma unroll
  for (int t = 0; t < 80; t++) {
    if (t >= 16) {
      const uint64_t w15 = w[(t - 15) & 15], w2 = w[(t - 2) & 15];
      const uint64_t s0 = rotr64(w15, 1) ^ rotr64(w15, 8) ^ shr64(w15, 7);
      const uint64_t s1 = rotr64(w2, 19) ^ rotr64(w2, 61) ^ shr64(w2, 6);
      w[t & 15] = ADD_S(ADD_S(w[t & 15], s0), ADD_S(w[(t - 7) & 15], s1));
    }
%(round)s  }
  h[0] += a; h[1] += b; h[2] += c; h[3] += d;
  h[4] += e; h[5] += f; h[6] += g; h[7] += hh;
}

"""


def _compress(round_body: str, add_r="add64_alu", add_s="add64_alu") -> str:
    return _TEMPLATE % {"round": round_body, "add_r": add_r, "add_s": add_s}


# name -> the text that replaces sha512_compress (None: the kernel's own)
VARIANTS = {
    "kernel": None,
    "off_path_3in": _compress(_ROUND_OFF_PATH_3IN),
    "off_path_2in": _compress(_ROUND_OFF_PATH_2IN),
    "fma_adds": _compress(_ROUND_TEXTBOOK, "add64_fma", "add64_fma"),
    "fma_schedule_adds": _compress(_ROUND_TEXTBOOK, add_s="add64_fma"),
}
_START = "__device__ __forceinline__ void sha512_compress("
_END = "// The big-endian word of bytes"
# (rows, shortest, longest message) of each timed launch
CASES = ((2048, 116, 118), (2048, 0, 47), (2048, 0, 118), (2048, 0, 300),
         (12288, 116, 118))


def variant_header(header: str, compress) -> str:
    """sha512.cuh with sha512_compress replaced by `compress`."""
    if compress is None:
        return header
    i, j = header.index(_START), header.index(_END)
    # the variant's comment-free text replaces the function and its note
    k = header.rindex("\n\n", 0, i) + 2
    return header[:k] + compress + header[j:]


def _build(name: str, compress):
    """Start nvcc for the variant's library and SASS probe."""
    root = BUILD_DIR / "x1_variants" / name
    shutil.rmtree(root, ignore_errors=True)
    (root / "csrc").mkdir(parents=True)
    (root / "probe").mkdir()
    shutil.copy(CSRC / "sha512.cu", root / "csrc" / "sha512.cu")
    hdr = (CSRC / "sha512.cuh").read_text()
    (root / "csrc" / "sha512.cuh").write_text(variant_header(hdr, compress))
    probe = PROBES[1]
    shutil.copy(probe, root / "probe" / probe.name)
    lib, cubin = root / "libx1.so", root / "probe.cubin"
    lib_cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(lib),
               str(root / "csrc" / "sha512.cu")]
    probe_cmd = [nvcc_path(), "-gencode=arch=compute_90a,code=sm_90a",
                 "-std=c++17", "-O3", "-cubin", "-o", str(cubin),
                 str(root / "probe" / probe.name)]
    procs = [
        subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
        for c in (lib_cmd, probe_cmd)
    ]
    return lib, cubin, procs


def _case(torch, dev, n: int, lo: int, hi: int, seed: int):
    import numpy as np

    rng = np.random.default_rng(seed)
    sig = rng.integers(0, 256, (64, n), np.uint8)
    pk = rng.integers(0, 256, (32, n), np.uint8)
    lens = rng.integers(lo, hi + 1, n)
    off = (np.concatenate([[0], np.cumsum(lens)]) + 3).astype(np.int32)
    flat = rng.integers(0, 256, -(-(int(off[-1]) + 1) // 16) * 16, np.uint8)
    ref = b"".join(
        hashlib.sha512(sig[:32, i].tobytes() + pk[:, i].tobytes()
                       + flat[off[i]:off[i + 1]].tobytes()).digest()
        for i in range(n)
    )
    tensors = [torch.from_numpy(a).to(dev) for a in (sig, pk, flat, off)]
    return tensors, hi, ref


def _ptxas(log: str) -> dict:
    """Registers and spill bytes of sha512_ram_kernel from ptxas -v."""
    sec = log[log.index("sha512_ram_kernel"):]
    sec = sec.split("Compiling entry function", 1)[0]
    regs = int(sec.split("Used ", 1)[1].split(" registers", 1)[0])
    spills = sec.split("bytes stack frame, ", 1)[1].split(" bytes spill", 1)[0]
    return {"registers": regs, "spill_store_bytes": int(spills)}


def measure(reps: int = 200) -> dict:
    """{variant: {"ptxas": .., "sass": .., "ms": {case: ms}}}."""
    import numpy as np
    import torch

    builds = {name: _build(name, c) for name, c in VARIANTS.items()}
    dev = torch.device("cuda")
    cases = {
        f"{n}x{lo}-{hi}": _case(torch, dev, n, lo, hi, k)
        for k, (n, lo, hi) in enumerate(CASES)
    }
    cuobjdump = os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")
    out = {}
    for name, (lib, cubin, procs) in builds.items():
        logs = [p.communicate()[0] for p in procs]
        if any(p.returncode for p in procs):
            raise RuntimeError(f"x1_variants: {name} failed to build:\n{logs}")
        sass = subprocess.run([cuobjdump, "-sass", str(cubin)], check=True,
                              capture_output=True, text=True).stdout
        fn = ctypes.CDLL(str(lib)).tm_sha512_ram
        v, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [v, v, v, v, v, i, i, i, v]
        fn.restype = i
        stream = v(torch.cuda.current_stream(dev).cuda_stream)
        row = {
            "ptxas": _ptxas(logs[0]),
            "sass": count_sass(sass)["probe_sha512_compress"],
            "ms": {},
        }
        for cname, ((sig, pk, flat, off), hi, ref) in cases.items():
            n = sig.shape[1]
            dig = torch.empty((64, n), dtype=torch.uint8, device=dev)
            args = [v(t.data_ptr()) for t in (sig, pk, flat, off, dig)]

            def launch():
                if fn(*args, n, hi, dev.index or 0, stream) != 0:
                    raise RuntimeError(f"x1_variants: {name} launch failed")

            launch()
            torch.cuda.synchronize()
            got = np.ascontiguousarray(dig.cpu().numpy().T).tobytes()
            if got != ref:
                raise AssertionError(f"x1_variants: {name} differs on {cname}")
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                launch()
            end.record()
            torch.cuda.synchronize()
            row["ms"][cname] = start.elapsed_time(end) / reps
        out[name] = row
    return out


if __name__ == "__main__":
    for name, row in measure().items():
        print(json.dumps({"variant": name, **row}), flush=True)
