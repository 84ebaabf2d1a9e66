"""Compile one unit of the kernels alone for sm_90a and report ptxas -v.

Counterpart: scripts/aot_bisect.py (:44 `pallas_wrap`, a single-tile
pallas_call around one segment of K2's tile body, compiled alone to find
which segment a Mosaic lowering failure comes from) and
tendermint_tpu/ops/toolchain.py:114 `mosaic_probe`. A unit here is
either

- a whole source, `ops/csrc/<stem>.cu`, named by its stem; or
- a segment: a one-thread `__global__` wrapper generated around one
  `__device__` function of csrc/ed25519_device.cuh, under the names
  aot_bisect gives its cases (SEGMENTS): `mod_l+nibbles` (sc_reduce512,
  then sc_recode_words), `s_lt_l` (sc_lt_l), `fe_from_bytes`
  (fe_from_words of y with bit 255 cleared), `decompress` (ge_decompress,
  its x) and `decompress_ok` (its ok); and `ristretto_decode`, the
  decode of csrc/sr25519_device.cuh (X3), ok and x. A wrapper reads
  64-bit words at `in` and writes 64-bit words at `out`.

Every unit asked for is compiled at once, one nvcc each, with
ops/build.py's NVCC_FLAGS (`-Xptxas -v` among them) into a scratch
directory of its own under build/torch_kernels/probe/. For each unit the
probe reports OK or FAILED, the seconds its nvcc took, and from ptxas -v
the registers of its entry kernels and the largest stack frame and
spill bytes of its functions (ptxas_resources); for a failure, the first
lines of nvcc's errors. It computes nothing, and it does not report on
the libraries the kernels' install built (ops/build.build_report holds
their ptxas output). Needs nvcc, not a card. Like ops/probe/ and
ops/sass_count.py, it is tooling beside the kernels, no part of them.

    python -m tendermint_tpu_torch.ops.compile_probe [name ...]
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterable, List, Optional

from .build import BUILD_DIR, CSRC, NVCC_FLAGS, nvcc_path

__all__ = [
    "SEGMENTS",
    "entry_name",
    "format_row",
    "probe",
    "ptxas_resources",
    "segment_source",
    "units",
]

_CLEAR_255 = "in[3] & 0x7fffffffffffffffULL"
_Y = (
    f"  uint64_t w[4] = {{in[0], in[1], in[2], {_CLEAR_255}}};\n"
    "  fe y;\n"
    "  fe_from_words(y, w);\n"
    "  ge_p3 p;\n"
    "  const bool ok = ge_decompress(p, y, (int)(in[3] >> 63));\n"
)
# name -> (the header it needs, the wrapper's body)
SEGMENTS: Dict[str, tuple] = {
    "mod_l+nibbles": (
        "ed25519_device.cuh",
        "  uint64_t k[4];\n"
        "  uint32_t e[8];\n"
        "  sc_reduce512(k, in);\n"
        "  sc_recode_words(e, k);\n"
        "  for (int m = 0; m < 4; m++)\n"
        "    out[m] = (uint64_t)e[2 * m] | ((uint64_t)e[2 * m + 1] << 32);\n",
    ),
    "s_lt_l": ("ed25519_device.cuh", "  out[0] = sc_lt_l(in);\n"),
    "fe_from_bytes": (
        "ed25519_device.cuh",
        f"  uint64_t w[4] = {{in[0], in[1], in[2], {_CLEAR_255}}};\n"
        "  fe h;\n"
        "  fe_from_words(h, w);\n"
        "  for (int i = 0; i < 10; i++) out[i] = h.v[i];\n",
    ),
    "decompress": (
        "ed25519_device.cuh",
        _Y + "  (void)ok;\n  for (int i = 0; i < 10; i++) out[i] = p.X.v[i];\n",
    ),
    "decompress_ok": ("ed25519_device.cuh", _Y + "  out[0] = ok;\n"),
    "ristretto_decode": (
        "sr25519_device.cuh",
        "  ge_p3 p;\n"
        "  out[0] = ristretto_decode(p, in);\n"
        "  for (int i = 0; i < 10; i++) out[1 + i] = p.X.v[i];\n",
    ),
}


def entry_name(segment: str) -> str:
    """The wrapper kernel's name: probe_ and the segment's name in C."""
    return "probe_" + re.sub(r"[^0-9A-Za-z]+", "_", segment)


def segment_source(name: str) -> str:
    """The .cu text of one segment's wrapper."""
    header, body = SEGMENTS[name]
    return (
        f"// segment {name} of ops/compile_probe.py, compiled alone\n"
        "#include <stdint.h>\n"
        f'#include "{header}"\n\n'
        f'extern "C" __global__ void {entry_name(name)}(const uint64_t *in,\n'
        f"    uint64_t *out) {{\n{body}}}\n"
    )


def units() -> List[str]:
    """Every unit's name: the whole sources, then the segments."""
    return [src.stem for src in sorted(CSRC.glob("*.cu"))] + list(SEGMENTS)


def ptxas_resources(log: str, entry: str = "") -> dict:
    """Registers of the entry kernels, and the largest stack frame and
    spill bytes over all functions, from `ptxas -v` output; only those of
    the entry kernels whose name holds `entry`."""
    regs, stack, st, ld = [], [0], [0], [0]
    sections = re.split(r"(?=ptxas info\s+: Compiling entry function)", log)
    picked = [sec for sec in sections if entry in sec.split("\n", 1)[0]]
    if entry and not picked:
        raise AssertionError(f"ptxas -v reports no entry kernel {entry}")
    for line in "\n".join(picked).splitlines():
        m = re.search(r"Used (\d+) registers", line)
        if m:
            regs.append(int(m.group(1)))
        m = re.search(
            r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
            r"(\d+) bytes spill loads",
            line,
        )
        if m:
            stack.append(int(m.group(1)))
            st.append(int(m.group(2)))
            ld.append(int(m.group(3)))
    return {
        "registers": max(regs) if regs else None,
        "stack_frame_bytes": max(stack),
        "spill_store_bytes": max(st),
        "spill_load_bytes": max(ld),
    }


def _error_lines(log: str, keep: int = 8) -> List[str]:
    lines = [ln for ln in log.splitlines() if ln.strip()]
    errors = [ln for ln in lines if "error" in ln.lower()]
    return (errors or lines)[:keep]


def _compile(name: str, nvcc: str, root: Path) -> dict:
    work = root / re.sub(r"[^0-9A-Za-z_]+", "_", name)
    work.mkdir(parents=True, exist_ok=True)
    if name in SEGMENTS:
        src = work / f"{work.name}.cu"
        src.write_text(segment_source(name))
        kind = "segment"
    else:
        src = CSRC / f"{name}.cu"
        kind = "source"
    cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(work / f"lib{work.name}.so"), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    seconds = time.perf_counter() - t0
    (work / "nvcc.txt").write_text(proc.stdout)
    row = {"unit": name, "kind": kind, "ok": proc.returncode == 0, "seconds": seconds}
    if row["ok"]:
        row.update(ptxas_resources(proc.stdout, entry_name(name) if kind == "segment" else ""))
    else:
        row["errors"] = _error_lines(proc.stdout)
    return row


def probe(names: Optional[Iterable[str]] = None, out_dir=None) -> List[dict]:
    """Compile the named units (all of them by default), one nvcc each,
    all at once; one report a unit, in the order asked. Raises on an
    unknown name, never on a failed compile (that is the report)."""
    names = list(names) if names else units()
    known = set(units())
    unknown = [n for n in names if n not in known]
    if unknown:
        raise ValueError(f"unknown units {unknown}; the units are {sorted(known)}")
    root = Path(out_dir) if out_dir is not None else BUILD_DIR / "probe"
    nvcc = nvcc_path()
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        return list(pool.map(lambda n: _compile(n, nvcc, root), names))


def format_row(row: dict) -> str:
    """One report line: the unit, OK or FAILED, seconds, and ptxas -v's
    numbers or the first error lines."""
    head = f"{row['unit']}: {'OK' if row['ok'] else 'FAILED'} in {row['seconds']:.1f}s"
    if row["ok"]:
        return (
            f"{head}: {row['registers']} registers, {row['stack_frame_bytes']} bytes "
            f"stack, {row['spill_store_bytes']}/{row['spill_load_bytes']} bytes spilled "
            "(stores/loads)"
        )
    return head + "\n" + "\n".join("    " + ln for ln in row["errors"])


def main(argv: List[str]) -> int:
    rows = probe(argv or None)
    for row in rows:
        print(format_row(row), flush=True)
    print(json.dumps(rows))
    return 0 if all(r["ok"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
