"""Batched SHA-256: kernel X4 and its plain versions.

Counterpart: tendermint_tpu/ops/sha256_kernel.py:125 `sha256_fixed`,
:173 `inner_hash_batch`, :182 `leaf_hash_batch` (XLA programs, no Pallas
body). The port's layout is rows: (N, L) uint8, one message a row, where
the JAX package takes (L, N) columns (interop.py converts).

- `sha256_rows(rows, prefix)`: SHA-256 of prefix || row for each of N rows
  of L bytes, prefix one byte or None -> (N, 32).
- `sha256_level(level)`: one level of a merkle tree root, (m, 32) digests
  -> (ceil(m / 2), 32): the adjacent pairs' inner hashes, and an odd
  trailing digest carried up unchanged. On the card the level is viewed as
  floor(m / 2) rows of 64 bytes, with no copy.
- `sha256_tree(leaves)`: the whole root of n leaf hashes, (n, 32) ->
  (32,): on the card one launch of X4's tree kernel, the levels of
  `sha256_level` in shared memory.
- `sha256_fixed`, `leaf_hash_batch`, `inner_hash_batch`: the JAX package's
  three functions on rows.

The plain versions are plain PyTorch on int64-held 32-bit words (torch's
`>>` is arithmetic on signed types; held below 2^32 in int64 and masked
after each add and left shift, every shift is logical): one torch op a
step, the yardstick the kernel is held against, never a speed path. Each
wrapper takes the plain version only for a CPU tensor; a CUDA tensor
launches X4 on the current stream or raises. What bounds X4 on an H100,
and what its design does about it, is in csrc/sha256.cu.
"""

from __future__ import annotations

from typing import Optional

import torch

from .build import check_launch, kernels, ptr, stream_of

__all__ = [
    "LAUNCHES",
    "inner_hash_batch",
    "leaf_hash_batch",
    "reset_launches",
    "sha256_fixed",
    "sha256_level",
    "sha256_level_plain",
    "sha256_rows",
    "sha256_rows_plain",
    "sha256_tree",
    "sha256_tree_plain",
]

# launches of kernel X4, by this module's wrappers only: the row form and
# the tree form
LAUNCHES = {"sha256_rows": 0, "sha256_tree": 0}

LEAF_PREFIX = 0x00
INNER_PREFIX = 0x01


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


_K = [
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
    0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
    0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
    0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
    0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
    0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
    0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
]
_H0 = [
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
]
_M32 = 0xFFFFFFFF


def _rotr(w: torch.Tensor, n: int) -> torch.Tensor:
    return (w >> n) | ((w << (32 - n)) & _M32)


def _compress(state: list, block: list) -> list:
    """One compression: state 8 (N,) int64 words, block 16 words, each
    below 2^32."""
    w = list(block)
    for t in range(16, 64):
        w15 = w[t - 15]
        w2 = w[t - 2]
        s0 = _rotr(w15, 7) ^ _rotr(w15, 18) ^ (w15 >> 3)
        s1 = _rotr(w2, 17) ^ _rotr(w2, 19) ^ (w2 >> 10)
        w.append((w[t - 16] + s0 + w[t - 7] + s1) & _M32)
    a, b, c, d, e, f, g, h = state
    for t in range(64):
        s1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = g ^ (e & (f ^ g))
        t1 = h + s1 + ch + _K[t] + w[t]
        s0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) | (c & (a | b))
        h, g, f, e = g, f, e, (d + t1) & _M32
        d, c, b, a = c, b, a, (t1 + s0 + maj) & _M32
    return [(s + o) & _M32 for s, o in zip(state, (a, b, c, d, e, f, g, h))]


def sha256_rows_plain(rows: torch.Tensor, prefix: Optional[int] = None):
    """SHA-256 of prefix || row for each row, as plain torch ops:
    (N, L) uint8 -> (N, 32) uint8, on rows' device."""
    n, length = rows.shape
    dev = rows.device
    head = [] if prefix is None else [prefix]
    mlen = len(head) + length
    nblocks = (mlen + 9 + 63) // 64
    tail = [0x80] + [0] * (64 * nblocks - mlen - 9)
    tail += [((8 * mlen) >> (8 * (7 - i))) & 0xFF for i in range(8)]
    full = torch.cat(
        [
            torch.tensor(head, dtype=torch.int64, device=dev).expand(n, -1),
            rows.to(torch.int64),
            torch.tensor(tail, dtype=torch.int64, device=dev).expand(n, -1),
        ],
        dim=1,
    )
    quads = full.reshape(n, nblocks, 16, 4)
    words = (
        (quads[..., 0] << 24)
        | (quads[..., 1] << 16)
        | (quads[..., 2] << 8)
        | quads[..., 3]
    )
    state = [torch.full((n,), h, dtype=torch.int64, device=dev) for h in _H0]
    for b in range(nblocks):
        state = _compress(state, [words[:, b, j] for j in range(16)])
    st = torch.stack(state, dim=1)  # (N, 8)
    shifts = torch.tensor([24, 16, 8, 0], device=dev)
    out = (st[:, :, None] >> shifts) & 0xFF
    return out.reshape(n, 32).to(torch.uint8)


def sha256_level_plain(level: torch.Tensor) -> torch.Tensor:
    """One tree level as plain torch ops: (m, 32) -> (ceil(m / 2), 32)."""
    m = level.shape[0]
    pairs = sha256_rows_plain(level[: m - m % 2].reshape(m // 2, 64), 1)
    return torch.cat([pairs, level[m - m % 2 :]], dim=0)


def sha256_tree_plain(leaves: torch.Tensor) -> torch.Tensor:
    """The root of (n, 32) leaf hashes, n >= 1, level by level as plain
    torch ops -> (32,)."""
    level = leaves
    while level.shape[0] > 1:
        level = sha256_level_plain(level)
    return level[0]


def _launch(data, out, length: int, n: int, prefix, carry: bool) -> None:
    lib = kernels()["sha256"]
    rc = lib.tm_sha256_rows(
        ptr(data), ptr(out), length, n, -1 if prefix is None else prefix,
        int(carry), data.device.index, stream_of(data.device),
    )
    check_launch(rc, lib, "sha256_rows")
    LAUNCHES["sha256_rows"] += 1


def _check(name: str, t: torch.Tensor, ndim: int) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    if t.dtype != torch.uint8 or t.dim() != ndim:
        raise ValueError(
            f"{name}: want a {ndim}-d uint8 tensor, got "
            f"{tuple(t.shape)} {t.dtype}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name}: input must be contiguous")


def sha256_rows(rows: torch.Tensor, prefix: Optional[int] = None):
    """(N, L) uint8 rows -> (N, 32) uint8 SHA-256 of prefix || row, prefix
    a byte or None. A CPU tensor runs the plain version; a CUDA tensor
    launches kernel X4 on the current stream or raises."""
    if rows.device.type == "cpu":
        return sha256_rows_plain(rows, prefix)
    _check("sha256_rows", rows, 2)
    if prefix is not None and not 0 <= prefix <= 255:
        raise ValueError(f"sha256_rows: prefix {prefix} is not a byte")
    n, length = rows.shape
    out = torch.empty((n, 32), dtype=torch.uint8, device=rows.device)
    _launch(rows, out, length, n, prefix, False)
    return out


def sha256_level(level: torch.Tensor) -> torch.Tensor:
    """One level of a tree root: (m, 32) uint8 digests -> (ceil(m / 2),
    32), the inner hashes of the adjacent pairs and an odd trailing digest
    carried up unchanged. A CPU tensor runs the plain version; a CUDA
    tensor is one launch of kernel X4 or raises."""
    if level.device.type == "cpu":
        return sha256_level_plain(level)
    _check("sha256_level", level, 2)
    m = level.shape[0]
    if level.shape[1] != 32:
        raise ValueError(f"sha256_level: want (m, 32), got {tuple(level.shape)}")
    out = torch.empty(((m + 1) // 2, 32), dtype=torch.uint8, device=level.device)
    _launch(level, out, 64, m // 2, INNER_PREFIX, bool(m % 2))
    return out


def sha256_tree(leaves: torch.Tensor) -> torch.Tensor:
    """The RFC 6962 root of n >= 1 leaf hashes: leaves (n, 32) uint8 ->
    (32,) uint8. A CPU tensor runs the plain version; a CUDA tensor is one
    launch of X4's tree kernel (behind a memset of its counter) or
    raises."""
    if leaves.device.type == "cpu":
        return sha256_tree_plain(leaves)
    _check("sha256_tree", leaves, 2)
    n = leaves.shape[0]
    if n < 1 or leaves.shape[1] != 32:
        raise ValueError(
            f"sha256_tree: want (n, 32) with n >= 1, got {tuple(leaves.shape)}"
        )
    lib = kernels()["sha256"]
    work = torch.empty(
        lib.tm_sha256_tree_work(n), dtype=torch.uint8, device=leaves.device
    )
    rc = lib.tm_sha256_tree(
        ptr(leaves), ptr(work), n, leaves.device.index, stream_of(leaves.device)
    )
    check_launch(rc, lib, "sha256_tree")
    LAUNCHES["sha256_tree"] += 1
    return work[-32:]


def sha256_fixed(rows: torch.Tensor) -> torch.Tensor:
    """SHA-256 of N equal-length rows: (N, L) uint8 -> (N, 32)."""
    return sha256_rows(rows, None)


def leaf_hash_batch(leaves: torch.Tensor) -> torch.Tensor:
    """RFC 6962 leaf nodes sha256(0x00 || leaf): (N, L) -> (N, 32)."""
    return sha256_rows(leaves, LEAF_PREFIX)


def inner_hash_batch(left: torch.Tensor, right: torch.Tensor):
    """RFC 6962 inner nodes sha256(0x01 || left || right): two (N, 32)
    -> (N, 32)."""
    return sha256_rows(torch.cat([left, right], dim=1), INNER_PREFIX)
