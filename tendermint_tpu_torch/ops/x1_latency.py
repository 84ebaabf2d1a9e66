"""The latency floor of kernel X1: SM cycles of one row's compressions.

At the widths a verifier launches, X1 runs one warp on each of a few
dozen SMs, so a launch takes at least one row's dependent chain: its
compressions one after the other, each 80 rounds. This builds a copy of
csrc/sha512.cu whose device header records clock64() and %globaltimer
(ns) before a row's first compression and after each one (thread 0 of
block 0), launches it at the given width on seeded R || A || M rows of
the commit's sign-bytes length (two compressions a row), and prints the
cycles and nanoseconds of each compression. The kernels' own sources are
left as they are. Needs nvcc and a card.

    python -m tendermint_tpu_torch.ops.x1_latency [--width 2048]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess

from .build import BUILD_DIR, CSRC, NVCC_FLAGS, nvcc_path

__all__ = ["measure", "stamped"]

_STAMP = (
    "#define PSTAMP(k) do { if (threadIdx.x == 0 && blockIdx.x == 0 && "
    "(k) < 8) { g_clk[k] = clock64(); asm volatile(\"mov.u64 %0, "
    "%%globaltimer;\" : \"=l\"(g_ns[k])); } } while (0)\n"
    "__device__ long long g_clk[8];\n"
    "__device__ unsigned long long g_ns[8];\n"
)
# (line of sha512.cuh, stamp to put after it)
_MARKS = (
    ("  const int nblocks = (len + 17 + 127) >> 7;\n", "PSTAMP(0);\n"),
    ("    sha512_compress(h, w);\n", "    PSTAMP(1 + b);\n"),
)
_READ = (
    '\nextern "C" int tm_read_stamps(long long *clk, unsigned long long *ns)'
    " {\n  cudaError_t e = cudaMemcpyFromSymbol(clk, g_clk, sizeof(g_clk));\n"
    "  if (e != cudaSuccess) return (int)e;\n"
    "  return (int)cudaMemcpyFromSymbol(ns, g_ns, sizeof(g_ns));\n}\n"
)
# the commit's sign-bytes length (chip_smoke.py): 64 + 118 bytes hashed
MSG_LEN = 118


def stamped(header: str) -> str:
    """The device header with the stamps in; raises when a line they
    follow is gone."""
    header = header.replace("#pragma once\n", "#pragma once\n" + _STAMP, 1)
    for line, stamp in _MARKS:
        if header.count(line) != 1:
            raise RuntimeError(f"x1_latency: no stamp anchor {line.strip()!r}")
        header = header.replace(line, line + stamp, 1)
    return header


def _build() -> ctypes.CDLL:
    dst = BUILD_DIR / "x1_latency"
    shutil.rmtree(dst, ignore_errors=True)
    dst.mkdir(parents=True)
    for name in ("sha512.cu", "sha512.cuh"):
        shutil.copy(CSRC / name, dst / name)
    hdr = dst / "sha512.cuh"
    hdr.write_text(stamped(hdr.read_text()))
    src = dst / "sha512.cu"
    src.write_text(src.read_text() + _READ)
    lib = dst / "libx1_latency.so"
    subprocess.run(
        [nvcc_path(), *NVCC_FLAGS, "-o", str(lib), str(src)],
        check=True,
        capture_output=True,
    )
    return ctypes.CDLL(str(lib))


def measure(width: int = 2048, seed: int = 0) -> dict:
    """{"cycles": [per compression], "ns": [...], ...} of row 0 in one
    launch of the stamped X1 at `width` rows of MSG_LEN-byte messages."""
    import numpy as np
    import torch

    lib = _build()
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    sig = torch.from_numpy(rng.integers(0, 256, (64, width), np.uint8)).to(dev)
    pk = torch.from_numpy(rng.integers(0, 256, (32, width), np.uint8)).to(dev)
    msg = torch.from_numpy(
        rng.integers(0, 256, -(-width * MSG_LEN // 16) * 16, np.uint8)
    ).to(dev)
    off = torch.arange(0, (width + 1) * MSG_LEN, MSG_LEN, dtype=torch.int32)
    off = off.to(dev)
    out = torch.empty((64, width), dtype=torch.uint8, device=dev)
    v, i = ctypes.c_void_p, ctypes.c_int
    fn = lib.tm_sha512_ram
    fn.argtypes = [v, v, v, v, v, i, i, i, v]
    fn.restype = i
    stream = v(torch.cuda.current_stream(dev).cuda_stream)
    args = [v(t.data_ptr()) for t in (sig, pk, msg, off, out)]
    for _ in range(2):  # the second launch is the one read
        rc = fn(*args, width, MSG_LEN, dev.index or 0, stream)
        if rc != 0:
            raise RuntimeError(f"x1_latency: launch failed ({rc})")
    torch.cuda.synchronize()
    clk = (ctypes.c_longlong * 8)()
    ns = (ctypes.c_ulonglong * 8)()
    if lib.tm_read_stamps(clk, ns) != 0:
        raise RuntimeError("x1_latency: reading the stamps failed")
    blocks = (64 + MSG_LEN + 17 + 127) // 128
    cycles = [clk[b + 1] - clk[b] for b in range(blocks)]
    nanos = [ns[b + 1] - ns[b] for b in range(blocks)]
    return {
        "width": width,
        "message_bytes": 64 + MSG_LEN,
        "cycles_per_compression": cycles,
        "ns_per_compression": nanos,
        "row_cycles": clk[blocks] - clk[0],
        "row_ns": ns[blocks] - ns[0],
    }


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--width", type=int, default=2048)
    print(json.dumps(measure(ap.parse_args().width)))
