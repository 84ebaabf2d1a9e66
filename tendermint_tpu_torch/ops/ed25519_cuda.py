"""Wrappers of the ed25519 CUDA kernels K1 and K2 (csrc/).

K2 `verify_tile` (csrc/ed25519_verify.cu) replaces
tendermint_tpu/ops/ed25519_pallas.py:140 `verify_pallas` (body
ops/ed25519_kernel.py:_verify_tile): the whole ZIP-215 cofactored check,
byte rows in, (N,) bool bitmap out. Its plain version is
ed25519_kernel._verify_tile.

K1 `dual_mult` (csrc/ed25519_dual_mult.cu) replaces
ed25519_pallas.py:171 `dual_mult_pallas` (body
ed25519_kernel.dual_mult_sb_minus_ka): [S]B - [k]A with the JAX contract
at its interface, (4, 20, N) 13-bit-limb int32 in, (3, 20, N) out; the
kernel converts to and from its own radix-2^25.5 limbs, one coordinate per
thread. Its plain version is ed25519_kernel.dual_mult_sb_minus_ka.

Both run four threads per signature, one point coordinate each
(csrc/ed25519_device.cuh): a group operation is two rounds of one field
multiply per thread, with operands exchanged by warp shuffle, 16
signatures a block, the tables in shared memory and nothing in local
memory. What bounds both on an H100 is integer multiplies (per
signature, ~1.9k field multiplies of 100 32x32->64 products and ~1.6k
squarings of 55 for K2, against 161 bytes moved), but at the 2048-wide
windows a batch verifier streams, the time of a launch is that of one
signature's chain of dependent field operations, which the four lanes
shorten; the design notes are in the two sources.

Each wrapper takes the plain version only for a CPU tensor. For a CUDA
tensor it checks device, dtype, shape and contiguity, allocates the
output with torch.empty, launches on the current stream, raises on a
launch error, and counts the launch in LAUNCHES.
"""

from __future__ import annotations

import ctypes

import torch

from . import ed25519_kernel as K
from . import field25519 as F

__all__ = ["LAUNCHES", "dual_mult", "reset_launches", "verify_tile"]

# launches of each kernel, counted by its wrapper only
LAUNCHES = {"ed25519_verify_tile": 0, "ed25519_dual_mult": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check(name: str, t: torch.Tensor, shape, dtypes, device) -> None:
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, want {device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name}: dtype {t.dtype}, want one of {dtypes}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, want {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _raise_on(rc: int, lib, name: str) -> None:
    if rc != 0:
        msg = lib.tm_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: {msg}")


def verify_tile(pk_b, sig_b, dig_b) -> torch.Tensor:
    """pk_b (32, N), sig_b (64, N) byte rows (uint8, or int32 like
    verify_pallas), dig_b (64, N) SHA-512(R||A||M) rows of the same
    dtype -> (N,) bool. Kernel K2 on CUDA, the plain version on CPU."""
    if pk_b.device.type == "cpu":
        return K._verify_tile(pk_b, sig_b, dig_b)
    if pk_b.device.type != "cuda":
        raise ValueError(f"verify_tile: unsupported device {pk_b.device}")
    n = pk_b.shape[-1]
    _check("pk_b", pk_b, (32, n), (torch.uint8, torch.int32), pk_b.device)
    _check("sig_b", sig_b, (64, n), (pk_b.dtype,), pk_b.device)
    _check("dig_b", dig_b, (64, n), (pk_b.dtype,), pk_b.device)
    from .build import kernels

    out = torch.empty(n, dtype=torch.bool, device=pk_b.device)
    lib = kernels()["ed25519_verify"]
    rc = lib.tm_ed25519_verify_tile(
        _ptr(pk_b),
        _ptr(sig_b),
        _ptr(dig_b),
        _ptr(out),
        n,
        pk_b.element_size(),
        pk_b.device.index,
        _stream(pk_b.device),
    )
    _raise_on(rc, lib, "ed25519_verify_tile")
    LAUNCHES["ed25519_verify_tile"] += 1
    return out


def dual_mult(A, dS, dk) -> torch.Tensor:
    """A (4, 20, N) int32 extended point in 13-bit limbs, dS/dk (64, N)
    int32 radix-16 digits in [0, 15] -> (3, 20, N) int32 T-less
    projective [S]B - [k]A. Kernel K1 on CUDA (canonical output limbs),
    the plain version on CPU."""
    if A.device.type == "cpu":
        return K.dual_mult_sb_minus_ka(A, dS, dk)
    if A.device.type != "cuda":
        raise ValueError(f"dual_mult: unsupported device {A.device}")
    n = A.shape[-1]
    _check("A", A, (4, F.NLIMBS, n), (torch.int32,), A.device)
    _check("dS", dS, (64, n), (torch.int32,), A.device)
    _check("dk", dk, (64, n), (torch.int32,), A.device)
    from .build import kernels

    out = torch.empty((3, F.NLIMBS, n), dtype=torch.int32, device=A.device)
    lib = kernels()["ed25519_dual_mult"]
    rc = lib.tm_ed25519_dual_mult(
        _ptr(A),
        _ptr(dS),
        _ptr(dk),
        _ptr(out),
        n,
        A.device.index,
        _stream(A.device),
    )
    _raise_on(rc, lib, "ed25519_dual_mult")
    LAUNCHES["ed25519_dual_mult"] += 1
    return out
