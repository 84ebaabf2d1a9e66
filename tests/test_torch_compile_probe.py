"""The compile probe (tendermint_tpu_torch/ops/compile_probe.py), the
counterpart of scripts/aot_bisect.py, without nvcc or a card.

- Its segments are aot_bisect's cases, read from that script's source
  text (the script imports JAX's TPU topologies, so it is not imported),
  and the sr25519 decode beside them.
- The generated one-thread wrappers compile with the host C++ compiler,
  with the CUDA qualifiers defined away as tests/test_torch_csrc.py
  builds the device code, and run there: each holds against the host
  oracles (the scalar compare and reduction with its signed recode, the
  limbs of a field element, ZIP-215 decompression, the ristretto decode).
- A stub nvcc on PATH that fails one unit makes the probe report that
  unit FAILED with its error lines and the others OK, with the registers,
  stack and spills ptxas -v reported.
Tolerance: zero.
"""

import ctypes
import os
import pathlib
import re
import shutil
import stat
import subprocess

import numpy as np
import pytest

from tendermint_tpu_torch.crypto import ed25519_math as em
from tendermint_tpu_torch.crypto import ristretto as rst
from tendermint_tpu_torch.ops import compile_probe as cp
from tendermint_tpu_torch.ops.build import CSRC

ROOT = pathlib.Path(__file__).resolve().parents[1]

HOST_PRELUDE = r"""
#include <stdint.h>
#define __device__
#define __constant__
#define __forceinline__ inline
#define __global__
#define ED25519_HOST_LANES
static inline int lane_id() { return 0; }
static inline uint32_t lane_shfl(uint32_t v, int) { return v; }
static inline void lane_sync() {}
static inline int x3_lane() { return 0; }
static inline uint32_t x3_shfl(uint32_t v, int) { return v; }
"""


def test_segments_are_aot_bisects_cases():
    text = (ROOT / "scripts" / "aot_bisect.py").read_text()
    body = text[text.index("cases = {"):text.index("which = ")]
    names = re.findall(r'^        "([^"]+)": \(', body, re.M)
    assert names == ["mod_l+nibbles", "s_lt_l", "fe_from_bytes", "decompress", "decompress_ok"]
    assert list(cp.SEGMENTS) == names + ["ristretto_decode"]
    assert cp.units() == [p.stem for p in sorted(CSRC.glob("*.cu"))] + list(cp.SEGMENTS)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++") or shutil.which("clang++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the segment wrappers with")
    d = tmp_path_factory.mktemp("probe_host")
    src = d / "segments.cpp"
    src.write_text(HOST_PRELUDE + "\n".join(cp.segment_source(n) for n in cp.SEGMENTS))
    so = d / "libsegments.so"
    subprocess.run([cxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-I", str(CSRC), "-o", str(so), str(src)],
                   check=True, capture_output=True, timeout=300)
    return ctypes.CDLL(str(so))


def _run(lib, name: str, value: int, words_in: int, words_out: int) -> list:
    inp = np.frombuffer(value.to_bytes(8 * words_in, "little"), dtype=np.uint64).copy()
    out = np.zeros(words_out, dtype=np.uint64)
    getattr(lib, cp.entry_name(name))(inp.ctypes.data_as(ctypes.c_void_p), out.ctypes.data_as(ctypes.c_void_p))
    return [int(w) for w in out]


def _limbs_value(limbs) -> int:
    return sum(int(v) << ((i * 51 + 1) // 2) for i, v in enumerate(limbs))


def test_segment_wrappers_compile_and_run_on_the_host(host_lib):
    rng = np.random.default_rng(21)
    L, P = em.L, em.P
    assert _run(host_lib, "s_lt_l", L - 1, 4, 1) == [1]
    assert _run(host_lib, "s_lt_l", L, 4, 1) == [0]
    for _ in range(8):
        x = int.from_bytes(rng.bytes(64), "little")
        got = _run(host_lib, "mod_l+nibbles", x, 8, 4)
        k, want, carry = x % L, 0, 0
        for i in range(64):
            t = ((k >> (4 * i)) & 15) + carry
            carry = int(t >= 8)
            want |= ((t - 16 * carry) & 15) << (4 * i)
        assert sum(w << (64 * m) for m, w in enumerate(got)) == want
        y = int.from_bytes(rng.bytes(32), "little")
        limbs = _run(host_lib, "fe_from_bytes", y, 4, 10)
        assert _limbs_value(limbs) == y & ((1 << 255) - 1)
    encodings = [em.compress(em.mul_base(int(rng.integers(1, 1 << 62)))) for _ in range(6)]
    encodings += [rng.bytes(32) for _ in range(10)]
    for enc in encodings:
        v = int.from_bytes(enc, "little")
        pt = em.decompress(enc)
        assert _run(host_lib, "decompress_ok", v, 4, 1) == [int(pt is not None)]
        if pt is not None:
            assert _limbs_value(_run(host_lib, "decompress", v, 4, 10)) % P == pt[0]
    for enc in [rst.encode(rst.mul_base(int(rng.integers(1, 1 << 62)))) for _ in range(4)] + [
            rng.bytes(32) for _ in range(6)]:
        got = _run(host_lib, "ristretto_decode", int.from_bytes(enc, "little"), 4, 11)
        pt = rst.decode(enc)
        assert got[0] == int(pt is not None)
        if pt is not None:
            assert _limbs_value(got[1:]) % P == pt[0]


STUB_NVCC = r"""#!/bin/sh
out=""; src=""
while [ $# -gt 0 ]; do
  case "$1" in
    -o) out="$2"; shift 2 ;;
    *.cu) src="$1"; shift ;;
    *) shift ;;
  esac
done
case "$src" in
  *s_lt_l*)
    echo "$src(7): error: identifier \"sc_lt_l\" is undefined"
    echo "1 error detected in the compilation of \"$src\"."
    exit 2 ;;
esac
name=$(basename "$src" .cu)
echo "ptxas info    : 0 bytes gmem"
echo "ptxas info    : Compiling entry function 'probe_$name' for 'sm_90a'"
echo "ptxas info    : Function properties for probe_$name"
echo "    16 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads"
echo "ptxas info    : Used 40 registers, 368 bytes cmem[0]"
: > "$out"
"""


def test_a_failing_unit_is_reported_failed_with_its_errors(tmp_path, monkeypatch):
    bindir = tmp_path / "cuda" / "bin"
    bindir.mkdir(parents=True)
    nvcc = bindir / "nvcc"
    nvcc.write_text(STUB_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setenv("PATH", str(bindir) + os.pathsep + os.environ["PATH"])
    names = ["ed25519_verify", "s_lt_l", "decompress", "ristretto_decode"]
    rows = cp.probe(names, out_dir=tmp_path / "probe")
    assert [r["unit"] for r in rows] == names
    assert [r["ok"] for r in rows] == [True, False, True, True]
    failed = rows[1]
    assert failed["errors"][0].endswith('error: identifier "sc_lt_l" is undefined')
    assert "FAILED" in cp.format_row(failed) and "sc_lt_l" in cp.format_row(failed)
    for r in (rows[2], rows[3]):
        assert (r["registers"], r["stack_frame_bytes"], r["spill_store_bytes"], r["spill_load_bytes"]) == (
            40, 16, 4, 8)
        assert (tmp_path / "probe" / r["unit"] / f"{r['unit']}.cu").read_text() == cp.segment_source(r["unit"])
    assert rows[0]["kind"] == "source" and rows[0]["registers"] == 40
    assert cp.main(["s_lt_l"]) == 1
    with pytest.raises(ValueError, match="unknown units"):
        cp.probe(["nope"])
