"""Wrapper of the sr25519 CUDA kernel X3 (csrc/sr25519_verify.cu).

X3 `verify_sr` replaces tendermint_tpu/ops/sr25519_kernel.py:150
`_verify_tile_sr` (an XLA program, not a Pallas kernel): the whole
schnorrkel check, ristretto decode of A and R, s < L and the marker bit,
[s]B - [k]A and ristretto equality, byte rows in, (N,) bool bitmap out.
Its plain version is ops/sr25519_kernel._verify_tile_sr.

The kernel runs eight threads per signature on K1's and K2's field and
group formulas (csrc/ed25519_device.cuh): the two decodes side by side
on two lane pairs, then four lanes walk [k](-A) over 64 windows while the
other four sum [s]B from a fixed-base comb (csrc/sr25519_comb.cuh), one
addition joining them (no cofactor: ristretto255 has prime order), then
the equality as one product a lane. What bounds it on an H100, and what
the design does about it, is in csrc/sr25519_verify.cu.

The wrapper takes the plain version only for a CPU tensor. For a CUDA
tensor it checks device, dtype, shape and contiguity, allocates the
output with torch.empty, launches on the current stream, raises on a
launch error, and counts the launch in LAUNCHES.
"""

from __future__ import annotations

import torch

from . import sr25519_kernel as SK
from .build import check_launch, kernels, ptr, stream_of
from .ed25519_cuda import _check

__all__ = ["LAUNCHES", "reset_launches", "verify_sr"]

# launches of X3, counted by its wrapper only
LAUNCHES = {"sr25519_verify": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def verify_sr(pk_b, sig_b, k_b) -> torch.Tensor:
    """pk_b (32, N), sig_b (64, N), k_b (32, N) byte rows, all uint8 or
    all int32 (the JAX contract) -> (N,) bool. Kernel X3 on CUDA, the
    plain version on CPU."""
    if pk_b.device.type == "cpu":
        return SK._verify_tile_sr(pk_b, sig_b, k_b)
    if pk_b.device.type != "cuda":
        raise ValueError(f"verify_sr: unsupported device {pk_b.device}")
    n = pk_b.shape[-1]
    _check("pk_b", pk_b, (32, n), (torch.uint8, torch.int32), pk_b.device)
    _check("sig_b", sig_b, (64, n), (pk_b.dtype,), pk_b.device)
    _check("k_b", k_b, (32, n), (pk_b.dtype,), pk_b.device)
    out = torch.empty(n, dtype=torch.bool, device=pk_b.device)
    lib = kernels()["sr25519_verify"]
    rc = lib.tm_sr25519_verify(
        ptr(pk_b),
        ptr(sig_b),
        ptr(k_b),
        ptr(out),
        n,
        pk_b.element_size(),
        pk_b.device.index,
        stream_of(pk_b.device),
    )
    check_launch(rc, lib, "sr25519_verify")
    LAUNCHES["sr25519_verify"] += 1
    return out
