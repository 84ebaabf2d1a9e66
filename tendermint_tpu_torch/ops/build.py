"""Builds the CUDA kernels under ops/csrc/ at first use.

Every `*.cu` in csrc/ becomes one shared library with a plain C
interface, compiled by `nvcc` for `sm_90a` and loaded with ctypes. All
sources are compiled in one call, one `nvcc` process per source, all
started together. A source that includes PyTorch's headers takes minutes
to compile (torch.utils.cpp_extension.load), a plain C interface
seconds, so the wrappers pass pointers and the current stream as
integers instead (`tensor.data_ptr()`,
`torch.cuda.current_stream().cuda_stream`), each launch under
`torch.cuda.device` of the card its tensors are on (`launch`).

Libraries go to `build/torch_kernels/` at the repository root (listed in
.gitignore), named by a hash of the sources and flags, so an edited
source is rebuilt and an unchanged one is loaded as it is; the nvcc and
ptxas output of each build is kept beside its library. Importing
this module builds nothing. A failed build raises: nothing falls back.

    python -m tendermint_tpu_torch.ops.build   # build now, print ptxas -v
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional

__all__ = [
    "BUILD_DIR",
    "CSRC",
    "NVCC_FLAGS",
    "build_report",
    "check_launch",
    "kernels",
    "launch",
    "nvcc_path",
    "ptr",
    "stream_of",
]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = [
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
]

_V = ctypes.c_void_p
_I = ctypes.c_int
# exported C functions: name -> (argtypes, restype)
_SIGNATURES = {
    "ed25519_verify": {
        "tm_ed25519_verify_tile": ([_V, _V, _V, _V, _I, _I, _I, _V], _I),
    },
    "ed25519_dual_mult": {
        "tm_ed25519_dual_mult": ([_V, _V, _V, _V, _I, _I, _V], _I),
    },
    "sr25519_verify": {
        "tm_sr25519_verify": ([_V, _V, _V, _V, _I, _I, _I, _V], _I),
    },
    "sha512": {
        "tm_sha512_rows": ([_V, _V, _I, _I, _I, _V], _I),
        "tm_sha512_ram": ([_V, _V, _V, _V, _V, _I, _I, _I, _V], _I),
    },
    "sha256": {
        "tm_sha256_rows": ([_V, _V, _I, _I, _I, _I, _I, _V], _I),
        "tm_sha256_tree": ([_V, _V, _I, _I, _V], _I),
        "tm_sha256_tree_work": ([_I], _I),
    },
    "merkle_proofs": {
        "tm_merkle_proofs": ([_V] * 8 + [_I, _I, _V], _I),
    },
}
# every library also exports tm_error_string(code) -> cudaGetErrorString

_lock = threading.Lock()
_LIBS: Optional[Dict[str, ctypes.CDLL]] = None
_REPORT: dict = {}


def nvcc_path() -> str:
    """The nvcc to build with: $CUDA_HOME/bin/nvcc, /usr/local/cuda's, or
    the one on PATH."""
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels cannot be "
            "built on this machine"
        )
    return found


def _digest(src: Path) -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cuh")) + [src]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _build_all() -> Dict[str, ctypes.CDLL]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    jobs = {}
    for src in sorted(CSRC.glob("*.cu")):
        lib = BUILD_DIR / f"lib{src.stem}-{_digest(src)}.so"
        if lib.exists():
            jobs[src.stem] = (lib, None)
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        jobs[src.stem] = (lib, (proc, tmp))
    logs = {}
    failed = []
    for stem, (lib, job) in jobs.items():
        log = lib.with_suffix(".ptxas.txt")  # kept beside the library
        if job is None:
            logs[stem] = log.read_text() if log.exists() else "(cached)"
            continue
        proc, tmp = job
        out, _ = proc.communicate()
        logs[stem] = out
        if proc.returncode != 0:
            failed.append(f"{stem}.cu (exit {proc.returncode}):\n{out}")
            continue
        log.write_text(out)
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    libs = {}
    for stem, (lib, _job) in jobs.items():
        dll = ctypes.CDLL(str(lib))
        sigs = dict(_SIGNATURES.get(stem, {}))
        sigs["tm_error_string"] = ([_I], ctypes.c_char_p)
        for name, (argtypes, restype) in sigs.items():
            fn = getattr(dll, name)
            fn.argtypes = argtypes
            fn.restype = restype
        libs[stem] = dll
    _REPORT.update(
        seconds=time.perf_counter() - t0,
        libraries={stem: str(lib) for stem, (lib, _j) in jobs.items()},
        ptxas=logs,
    )
    return libs


def kernels() -> Dict[str, ctypes.CDLL]:
    """The loaded kernel libraries by source stem, built on first call."""
    global _LIBS
    with _lock:
        if _LIBS is None:
            _LIBS = _build_all()
        return _LIBS


def build_report() -> dict:
    """Build seconds, library paths and nvcc/ptxas output of the build
    this process ran (empty before the first kernels() call)."""
    return dict(_REPORT)


def ptr(t) -> ctypes.c_void_p:
    """A tensor's data pointer as a kernel argument."""
    return ctypes.c_void_p(t.data_ptr())


def stream_of(device) -> ctypes.c_void_p:
    """PyTorch's current stream on `device`, as a kernel argument."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def launch(fn, device, *args) -> int:
    """fn(*args, stream) with `device` made the current CUDA device and
    `stream` its current stream (stream_of): the return code of a kernel
    library's launch function. The library sets the card itself; this
    keeps PyTorch's current device and the stream on the card the
    tensors are on, as a launch on each card of a mesh needs
    (parallel/sharding.py), and gives the caller's device back after."""
    import torch

    with torch.cuda.device(device):
        return fn(*args, stream_of(device))


def check_launch(rc: int, lib, name: str) -> None:
    """Raise when a launch function returned a CUDA error."""
    if rc != 0:
        msg = lib.tm_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: {msg}")


if __name__ == "__main__":
    kernels()
    rep = build_report()
    print(f"built in {rep['seconds']:.1f} s")
    for stem, log in rep["ptxas"].items():
        print(f"== {stem}\n{log}")
