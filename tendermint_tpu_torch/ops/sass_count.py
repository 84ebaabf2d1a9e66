"""SASS instruction counts of one field multiply and one squaring, in the
two limb radixes considered for kernels K1 and K2.

probe/fe_radix.cu holds one kernel per operation and radix: the
kernels' own radix 2^25.5 (ed25519_device.cuh's fe_mul and fe_sq: ten
32-bit limbs, 32x32->64 products) and radix 2^51 (five 64-bit limbs,
128-bit products, kept in the probe). This compiles it
for sm_90a with the kernels' nvcc flags, disassembles it with
cuobjdump, and counts each kernel's instructions (NOPs left out), of
which integer multiplies (IMAD*); a few of each kernel's instructions are
its loads, stores and exit, the same for the two radixes of one
operation's shape. Needs nvcc, not a card.

    python -m tendermint_tpu_torch.ops.sass_count
"""

from __future__ import annotations

import json
import os
import re
import subprocess
from pathlib import Path

from .build import BUILD_DIR, nvcc_path

__all__ = ["PROBE", "count"]

PROBE = Path(__file__).resolve().parent / "probe" / "fe_radix.cu"
_INSTR = re.compile(r"^\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")


def count() -> dict:
    """{kernel: {"instructions": n, "imad": m}} for the probe kernels."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cubin = BUILD_DIR / "fe_radix.cubin"
    subprocess.run(
        [
            nvcc_path(),
            "-gencode=arch=compute_90a,code=sm_90a",
            "-std=c++17",
            "-O3",
            "-cubin",
            "-o",
            str(cubin),
            str(PROBE),
        ],
        check=True,
        capture_output=True,
        text=True,
    )
    cuobjdump = os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")
    sass = subprocess.run(
        [cuobjdump, "-sass", str(cubin)],
        check=True,
        capture_output=True,
        text=True,
    ).stdout
    out: dict = {}
    name = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = {"instructions": 0, "imad": 0}
            continue
        m = _INSTR.match(line)
        if name is None or not m or m.group(1) == "NOP":
            continue
        out[name]["instructions"] += 1
        out[name]["imad"] += m.group(1).startswith("IMAD")
    return out


if __name__ == "__main__":
    print(json.dumps(count(), indent=1, sort_keys=True))
