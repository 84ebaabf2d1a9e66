"""SASS instruction counts of one field multiply and one squaring, in the
two limb radixes considered for kernels K1 and K2, and of one SHA-512
compression of kernel X1, as it is and as it was.

probe/fe_radix.cu holds one kernel per operation and radix: the
kernels' own radix 2^25.5 (ed25519_device.cuh's fe_mul and fe_sq: ten
32-bit limbs, 32x32->64 products) and radix 2^51 (five 64-bit limbs,
128-bit products, kept in the probe). This compiles it
for sm_90a with the kernels' nvcc flags, disassembles it with
cuobjdump, and counts each kernel's instructions (NOPs left out), of
which integer multiplies (IMAD*); a few of each kernel's instructions are
its loads, stores and exit, the same for the two radixes of one
operation's shape. probe/sha512_compress.cu holds one kernel with X1's
compression (csrc/sha512.cuh) and one with the compression X1 had
before, each with its 24 loads and 8 stores; for those the 64-bit
integer work is counted by opcode too (SHF funnel shifts, IADD3 adds,
LOP3 logic). Needs nvcc, not a card.

    python -m tendermint_tpu_torch.ops.sass_count
"""

from __future__ import annotations

import json
import os
import re
import subprocess
from pathlib import Path

from .build import BUILD_DIR, nvcc_path

__all__ = ["PROBES", "count", "count_sass"]

PROBES = tuple(
    Path(__file__).resolve().parent / "probe" / name
    for name in ("fe_radix.cu", "sha512_compress.cu")
)
_OPS = ("IMAD", "SHF", "IADD3", "LOP3")
_INSTR = re.compile(r"^\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")


def count() -> dict:
    """{kernel: {"instructions": n, "imad": .., "shf": .., "iadd3": ..,
    "lop3": ..}} for the probe kernels."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cuobjdump = os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")
    out: dict = {}
    for probe in PROBES:
        cubin = BUILD_DIR / f"{probe.stem}.cubin"
        subprocess.run(
            [
                nvcc_path(),
                "-gencode=arch=compute_90a,code=sm_90a",
                "-std=c++17",
                "-O3",
                "-cubin",
                "-o",
                str(cubin),
                str(probe),
            ],
            check=True,
            capture_output=True,
            text=True,
        )
        sass = subprocess.run(
            [cuobjdump, "-sass", str(cubin)],
            check=True,
            capture_output=True,
            text=True,
        ).stdout
        out.update(count_sass(sass))
    return out


def count_sass(sass: str) -> dict:
    """{kernel: counts} of cuobjdump -sass output."""
    out: dict = {}
    name = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = {"instructions": 0, **{op.lower(): 0 for op in _OPS}}
            continue
        m = _INSTR.match(line)
        if name is None or not m or m.group(1) == "NOP":
            continue
        out[name]["instructions"] += 1
        for op in _OPS:
            out[name][op.lower()] += m.group(1).startswith(op)
    return out


if __name__ == "__main__":
    print(json.dumps(count(), indent=1, sort_keys=True))
