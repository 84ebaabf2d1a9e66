"""The latency floor of kernel X4's tree form: one thread's chain of
dependent inner hashes.

A tree root of n leaves is ceil(log2 n) levels, each waiting for the one
below, so no launch can take less than one thread hashing that many
inner nodes one after the other (14 for 10,000 leaves). This builds
probe/sha256_chain.cu (csrc/sha256.cuh's inner hash in a loop over aunts
staged in shared memory, clock64 and %globaltimer around it), runs it
alone on the card for `depth` <= 64 hashes, `reads` launches after a
warm-up one, checks each end digest against hashlib, and prints the SM
cycles and nanoseconds of every launch and their least, the floor (one
launch's reading varies by ~15% from call to call). Needs nvcc and a
card.

    python -m tendermint_tpu_torch.ops.x4_latency [--depth 14] [--reads 9]
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
from pathlib import Path

from .build import BUILD_DIR, NVCC_FLAGS, nvcc_path

__all__ = ["PROBE", "measure"]

PROBE = Path(__file__).resolve().parent / "probe" / "sha256_chain.cu"


def _build(pad: bool) -> ctypes.CDLL:
    dst = BUILD_DIR / "x4_latency"
    dst.mkdir(parents=True, exist_ok=True)
    lib = dst / f"libx4_latency{'_pad' if pad else ''}.so"
    flags = ["-DCHAIN_PAD"] if pad else []
    subprocess.run(
        [nvcc_path(), *NVCC_FLAGS, *flags, "-o", str(lib), str(PROBE)],
        check=True,
        capture_output=True,
    )
    return ctypes.CDLL(str(lib))


def measure(
    depth: int = 14, reads: int = 9, seed: int = 0, pad: bool = False
) -> dict:
    """{"depth", "cycles", "ns", "cycles_per_hash", "ns_per_hash"} of one
    thread's chain of `depth` dependent inner hashes, the least of
    `reads` launches, and every launch's ("cycles_read", "ns_read")."""
    import numpy as np
    import torch

    lib = _build(pad)
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    raw = rng.bytes(32 * (depth + 1))
    words = np.frombuffer(raw, dtype=">u4").astype(np.uint32)
    inp = torch.from_numpy(words.copy()).to(dev)
    out = torch.empty(8, dtype=torch.int32, device=dev)
    stamps = torch.empty(2, dtype=torch.int64, device=dev)
    v = ctypes.c_void_p
    fn = lib.tm_sha256_chain
    fn.argtypes = [v, v, v, ctypes.c_int, v]
    fn.restype = ctypes.c_int
    stream = v(torch.cuda.current_stream(dev).cuda_stream)
    args = [v(t.data_ptr()) for t in (inp, out, stamps)]
    h = raw[:32]
    for d in range(depth):
        h = hashlib.sha256(b"\x01" + h + raw[32 * (d + 1) : 32 * (d + 2)]).digest()
    cycles_read, ns_read = [], []
    for k in range(reads + 1):  # the first launch warms up, unread
        out.zero_()
        if fn(*args, depth, stream) != 0:
            raise RuntimeError("x4_latency: launch failed")
        torch.cuda.synchronize()
        got = out.cpu().numpy().astype(np.uint32).astype(">u4").tobytes()
        if got != h:
            raise AssertionError("x4_latency: the chain's digest differs from hashlib")
        if k:
            c, t = (int(x) for x in stamps.cpu().tolist())
            cycles_read.append(c)
            ns_read.append(t)
    cycles, ns = min(cycles_read), min(ns_read)
    return {
        "depth": depth,
        "cycles": cycles,
        "ns": ns,
        "cycles_per_hash": cycles / depth,
        "ns_per_hash": ns / depth,
        "cycles_read": cycles_read,
        "ns_read": ns_read,
    }


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--depth", type=int, default=14)
    ap.add_argument("--reads", type=int, default=9)
    ap.add_argument("--pad", action="store_true")
    a = ap.parse_args()
    print(json.dumps(measure(a.depth, a.reads, pad=a.pad)))
