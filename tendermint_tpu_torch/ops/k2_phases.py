"""Where one launch of kernel K2 spends its time, on a card with no
profiler that sees inside a kernel.

Builds a copy of csrc/ed25519_verify.cu whose device header records
clock64() at the phase boundaries of ed25519_verify_lane (thread 0 of
block 0: one signature's lanes), launches it at the given width on
seeded valid signatures, and prints the SM cycles of each phase:
decompression of A and R, the scalars (S < L, the digest mod L),
the table of -A, the 64 windows, the cofactor and the compare. The
stamps cost a few registers; the kernels' own sources are left as they
are. Needs nvcc and a card.

    python -m tendermint_tpu_torch.ops.k2_phases [--width 2048]
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import shutil
import subprocess

from .build import BUILD_DIR, CSRC, NVCC_FLAGS, nvcc_path

__all__ = ["PHASES", "measure", "stamped"]

PHASES = ("decompress", "scalars", "table", "windows", "cofactor_compare")
_STAMP = (
    "#define PSTAMP(k) do { if (threadIdx.x == 0 && blockIdx.x == 0) "
    "g_stamps[k] = clock64(); } while (0)\n"
    "__device__ long long g_stamps[8];\n"
)
# (line of ed25519_device.cuh, stamp to put after it), in phase order
_MARKS = (
    ("  load_words<8>(dw, dig, 0, n, i, es, in);\n", 0),
    ("  const bool ok = ge_decompress(P, y, sign);\n", 1),
    ("  sc_reduce512(kw, dw);\n", 2),
    ("  lane_sync();  // the table is read by the other lanes of the signature\n", 3),
    ("  ge4_dual_mult(acc, av, esd, ekd, tab, stride, btab);\n", 4),
    ("  if (lane == 0 && in) out[i] = same && ok_a && ok_r && s_ok;\n", 5),
)
_READ = (
    '\nextern "C" int tm_read_stamps(long long *h) {\n'
    "  return (int)cudaMemcpyFromSymbol(h, g_stamps, sizeof(g_stamps));\n}\n"
)


def stamped(header: str) -> str:
    """The device header with the phase stamps in; raises when a line
    they follow is gone."""
    header = header.replace("#pragma once\n", "#pragma once\n" + _STAMP, 1)
    for line, k in _MARKS:
        if line not in header:
            raise RuntimeError(f"k2_phases: no stamp anchor {line.strip()!r}")
        header = header.replace(line, f"{line}PSTAMP({k});\n", 1)
    return header


def _build() -> ctypes.CDLL:
    dst = BUILD_DIR / "k2_phases"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(CSRC, dst)
    dev_h = dst / "ed25519_device.cuh"
    dev_h.write_text(stamped(dev_h.read_text()))
    src = dst / "ed25519_verify.cu"
    src.write_text(src.read_text() + _READ)
    lib = dst / "libk2_phases.so"
    subprocess.run(
        [nvcc_path(), *NVCC_FLAGS, "-o", str(lib), str(src)],
        check=True,
        capture_output=True,
    )
    return ctypes.CDLL(str(lib))


def measure(width: int = 2048, seed: int = 0) -> dict:
    """{"cycles": {phase: SM cycles}, "total_cycles": n, ...} of one K2
    launch at `width` on seeded valid signatures."""
    import torch

    from ..crypto.ed25519 import PrivKeyEd25519
    from .ed25519_kernel import Ed25519Verifier

    lib = _build()
    keys = [
        PrivKeyEd25519.from_seed(hashlib.sha256(b"k2-%d-%d" % (seed, i)).digest())
        for i in range(64)
    ]
    msgs = [b"k2 phases %d" % i for i in range(width)]
    sigs = [keys[i % 64].sign(m) for i, m in enumerate(msgs)]
    pks = [keys[i % 64].pub_key().bytes() for i in range(width)]
    dev = torch.device("cuda")
    pk, sig, dig, _ok = Ed25519Verifier(device=dev).pack(pks, msgs, sigs)
    out = torch.empty(width, dtype=torch.bool, device=dev)
    v = ctypes.c_void_p
    fn = lib.tm_ed25519_verify_tile
    fn.argtypes = [v, v, v, v, ctypes.c_int, ctypes.c_int, ctypes.c_int, v]
    fn.restype = ctypes.c_int
    stream = v(torch.cuda.current_stream(dev).cuda_stream)
    for _ in range(2):  # the second launch is the one read
        rc = fn(
            v(pk.data_ptr()), v(sig.data_ptr()), v(dig.data_ptr()),
            v(out.data_ptr()), width, 1, dev.index or 0, stream,
        )
        if rc != 0:
            raise RuntimeError(f"k2_phases: launch failed ({rc})")
    torch.cuda.synchronize()
    if not bool(out.all()):
        raise AssertionError("k2_phases: a valid signature was rejected")
    stamps = (ctypes.c_longlong * 8)()
    if lib.tm_read_stamps(stamps) != 0:
        raise RuntimeError("k2_phases: reading the stamps failed")
    s = list(stamps)
    cycles = {p: s[k + 1] - s[k] for k, p in enumerate(PHASES)}
    return {"width": width, "cycles": cycles, "total_cycles": s[5] - s[0]}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--width", type=int, default=2048)
    print(json.dumps(measure(ap.parse_args().width)))
