"""Batched SHA-512: kernel X1 and its plain versions.

Two functions, one device body (csrc/sha512.cuh):

- `sha512_ragged(sig_b, pk_b, msg, offsets, max_len)`: SHA-512(R || A ||
  M) of every lane of a verifier window, R and A from the (64, B) sig and
  (32, B) pk byte rows, M from one flat message buffer with B + 1 int32
  offsets -> (64, B) digests in lane order, one launch whatever the
  lengths. Counterpart: what tendermint_tpu/ops/ed25519_kernel.py:660
  `_digest_rows` computes, which groups the lanes by message length, runs
  one `sha512_fixed` program per group and scatters the digests back.
- `sha512_fixed(data)`: tendermint_tpu/ops/sha512_kernel.py:190's
  contract, (L, N) uint8 rows, batch axis minor -> (64, N) digests.

Their plain versions are plain PyTorch on int64 words (torch's `>>` on
int64 is arithmetic, so logical shifts are masked; additions wrap): one
torch op per step, ~80 rounds x ~40 ops per 128-byte block, the
yardstick the kernel is held against, never a speed path.
`sha512_ragged_plain` groups the lanes by length through
`sha512_fixed_plain`, as the JAX package does. Each wrapper takes the
plain version only for a CPU tensor; a CUDA tensor launches X1 on the
current stream or raises.

X1 replaces an XLA program, not a Pallas kernel: as torch ops it would be
thousands of tiny launches per batch. What bounds it on an H100, and
what its design does about it, is in csrc/sha512.cu.
"""

from __future__ import annotations

import torch

from .build import check_launch, kernels, ptr, stream_of

__all__ = [
    "LAUNCHES",
    "reset_launches",
    "sha512_fixed",
    "sha512_fixed_plain",
    "sha512_ragged",
    "sha512_ragged_plain",
]

# launches of kernel X1's two entry points, by this module's wrappers only
LAUNCHES = {"sha512_ram": 0, "sha512_rows": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


_K64 = [
    0x428A2F98D728AE22, 0x7137449123EF65CD, 0xB5C0FBCFEC4D3B2F,
    0xE9B5DBA58189DBBC, 0x3956C25BF348B538, 0x59F111F1B605D019,
    0x923F82A4AF194F9B, 0xAB1C5ED5DA6D8118, 0xD807AA98A3030242,
    0x12835B0145706FBE, 0x243185BE4EE4B28C, 0x550C7DC3D5FFB4E2,
    0x72BE5D74F27B896F, 0x80DEB1FE3B1696B1, 0x9BDC06A725C71235,
    0xC19BF174CF692694, 0xE49B69C19EF14AD2, 0xEFBE4786384F25E3,
    0x0FC19DC68B8CD5B5, 0x240CA1CC77AC9C65, 0x2DE92C6F592B0275,
    0x4A7484AA6EA6E483, 0x5CB0A9DCBD41FBD4, 0x76F988DA831153B5,
    0x983E5152EE66DFAB, 0xA831C66D2DB43210, 0xB00327C898FB213F,
    0xBF597FC7BEEF0EE4, 0xC6E00BF33DA88FC2, 0xD5A79147930AA725,
    0x06CA6351E003826F, 0x142929670A0E6E70, 0x27B70A8546D22FFC,
    0x2E1B21385C26C926, 0x4D2C6DFC5AC42AED, 0x53380D139D95B3DF,
    0x650A73548BAF63DE, 0x766A0ABB3C77B2A8, 0x81C2C92E47EDAEE6,
    0x92722C851482353B, 0xA2BFE8A14CF10364, 0xA81A664BBC423001,
    0xC24B8B70D0F89791, 0xC76C51A30654BE30, 0xD192E819D6EF5218,
    0xD69906245565A910, 0xF40E35855771202A, 0x106AA07032BBD1B8,
    0x19A4C116B8D2D0C8, 0x1E376C085141AB53, 0x2748774CDF8EEB99,
    0x34B0BCB5E19B48A8, 0x391C0CB3C5C95A63, 0x4ED8AA4AE3418ACB,
    0x5B9CCA4F7763E373, 0x682E6FF3D6B2B8A3, 0x748F82EE5DEFB2FC,
    0x78A5636F43172F60, 0x84C87814A1F0AB72, 0x8CC702081A6439EC,
    0x90BEFFFA23631E28, 0xA4506CEBDE82BDE9, 0xBEF9A3F7B2C67915,
    0xC67178F2E372532B, 0xCA273ECEEA26619C, 0xD186B8C721C0C207,
    0xEADA7DD6CDE0EB1E, 0xF57D4F7FEE6ED178, 0x06F067AA72176FBA,
    0x0A637DC5A2C898A6, 0x113F9804BEF90DAE, 0x1B710B35131C471B,
    0x28DB77F523047D84, 0x32CAAB7B40C72493, 0x3C9EBE0A15C9BEBC,
    0x431D67C49C100D4C, 0x4CC5D4BECB3E42B6, 0x597F299CFC657E2A,
    0x5FCB6FAB3AD6FAEC, 0x6C44198C4A475817,
]
_H0 = [
    0x6A09E667F3BCC908, 0xBB67AE8584CAA73B, 0x3C6EF372FE94F82B,
    0xA54FF53A5F1D36F1, 0x510E527FADE682D1, 0x9B05688C2B3E6C1F,
    0x1F83D9ABFB41BD6B, 0x5BE0CD19137E2179,
]


def _signed64(x: int) -> int:
    """A 64-bit word as the int64 with the same bits."""
    return x - (1 << 64) if x >= 1 << 63 else x


def _shr(w: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift of int64 words."""
    return (w >> n) & ((1 << (64 - n)) - 1)


def _rotr(w: torch.Tensor, n: int) -> torch.Tensor:
    return _shr(w, n) | (w << (64 - n))


def _compress(state: list, block: list) -> list:
    """One compression: state 8 (N,) int64 words, block 16 words."""
    w = list(block)
    for t in range(16, 80):
        w15 = w[t - 15]
        w2 = w[t - 2]
        s0 = _rotr(w15, 1) ^ _rotr(w15, 8) ^ _shr(w15, 7)
        s1 = _rotr(w2, 19) ^ _rotr(w2, 61) ^ _shr(w2, 6)
        w.append(w[t - 16] + s0 + w[t - 7] + s1)
    a, b, c, d, e, f, g, h = state
    for t in range(80):
        s1 = _rotr(e, 14) ^ _rotr(e, 18) ^ _rotr(e, 41)
        ch = (e & f) ^ (~e & g)
        t1 = h + s1 + ch + _signed64(_K64[t]) + w[t]
        s0 = _rotr(a, 28) ^ _rotr(a, 34) ^ _rotr(a, 39)
        maj = (a & b) ^ (a & c) ^ (b & c)
        h, g, f, e, d, c, b, a = g, f, e, d + t1, c, b, a, t1 + s0 + maj
    return [s + o for s, o in zip(state, (a, b, c, d, e, f, g, h))]


def sha512_fixed_plain(data: torch.Tensor) -> torch.Tensor:
    """SHA-512 of N equal-length messages as plain torch ops:
    (L, N) uint8 -> (64, N) uint8, on data's device."""
    length, n = data.shape
    dev = data.device
    bitlen = length * 8
    nblocks = (length + 17 + 127) // 128
    padded_len = nblocks * 128
    tail = [0x80] + [0] * (padded_len - length - 1 - 8)
    tail += [(bitlen >> (8 * (7 - i))) & 0xFF for i in range(8)]
    pad = torch.tensor(tail, dtype=torch.int64, device=dev)[:, None]
    full = torch.cat([data.to(torch.int64), pad.expand(len(tail), n)], dim=0)
    octets = full.reshape(nblocks, 16, 8, n)
    words = octets[:, :, 0, :] << 56
    for k in range(1, 8):
        words = words | (octets[:, :, k, :] << (56 - 8 * k))
    state = [
        torch.full((n,), _signed64(h), dtype=torch.int64, device=dev)
        for h in _H0
    ]
    for b in range(nblocks):
        state = _compress(state, [words[b, j] for j in range(16)])
    st = torch.stack(state, dim=0)  # (8, N)
    shifts = torch.arange(56, -8, -8, device=dev)[None, :, None]
    out = (st[:, None, :] >> shifts) & 0xFF
    return out.reshape(64, n).to(torch.uint8)


def sha512_fixed(data: torch.Tensor) -> torch.Tensor:
    """(64 + M, N) uint8 rows -> (64, N) uint8 SHA-512 digests.

    A CPU tensor runs the plain version; a CUDA tensor launches kernel
    X1 on the current stream or raises."""
    if data.device.type == "cpu":
        return sha512_fixed_plain(data)
    if data.device.type != "cuda":
        raise ValueError(f"sha512_fixed: unsupported device {data.device}")
    if data.dtype != torch.uint8 or data.dim() != 2:
        raise ValueError(
            f"sha512_fixed: want (L, N) uint8, got {tuple(data.shape)} "
            f"{data.dtype}"
        )
    if not data.is_contiguous():
        raise ValueError("sha512_fixed: input must be contiguous")
    length, n = data.shape
    out = torch.empty((64, n), dtype=torch.uint8, device=data.device)
    lib = kernels()["sha512"]
    rc = lib.tm_sha512_rows(
        ptr(data), ptr(out), length, n, data.device.index,
        stream_of(data.device),
    )
    check_launch(rc, lib, "sha512_rows")
    LAUNCHES["sha512_rows"] += 1
    return out


def sha512_ragged_plain(sig_b, pk_b, msg, offsets) -> torch.Tensor:
    """SHA-512(R || A || M) of every lane as plain torch ops, the lanes
    grouped by message length through sha512_fixed_plain and the digests
    put back in lane order. Arguments as sha512_ragged's."""
    n = sig_b.shape[1]
    dev = sig_b.device
    off = offsets.to(device=dev, dtype=torch.int64)
    lens = off[1:] - off[:-1]
    out = torch.empty((64, n), dtype=torch.uint8, device=dev)
    for length in sorted(set(lens.tolist())):
        idx = torch.nonzero(lens == length).flatten()
        at = off[:-1][idx][None, :] + torch.arange(length, device=dev)[:, None]
        rows = torch.cat([sig_b[:32, idx], pk_b[:, idx], msg[at]], dim=0)
        out[:, idx] = sha512_fixed_plain(rows)
    return out


def sha512_ragged(sig_b, pk_b, msg, offsets, max_len: int) -> torch.Tensor:
    """(64, B) uint8 SHA-512(R || A || M) of every lane, in lane order.

    sig_b (64, B) and pk_b (32, B) uint8 byte rows, batch axis minor (R is
    sig rows 0..31, A all of pk); msg a flat uint8 buffer, lane i's message
    msg[offsets[i]:offsets[i + 1]]; offsets (B + 1,) int32; max_len at least
    the longest message (it sizes the kernel's shared memory). On CUDA msg
    must start 16-byte aligned and be a multiple of 16 bytes long (the
    kernel reads it in 16-byte loads): pad it. A CPU tensor runs the plain
    version; a CUDA tensor launches kernel X1 on the current stream or
    raises."""
    if sig_b.device.type == "cpu":
        return sha512_ragged_plain(sig_b, pk_b, msg, offsets)
    if sig_b.device.type != "cuda":
        raise ValueError(f"sha512_ragged: unsupported device {sig_b.device}")
    n = sig_b.shape[-1]
    for name, t, shape, dtype in (
        ("sig_b", sig_b, (64, n), torch.uint8),
        ("pk_b", pk_b, (32, n), torch.uint8),
        ("offsets", offsets, (n + 1,), torch.int32),
        ("msg", msg, (msg.numel(),), torch.uint8),
    ):
        if t.device != sig_b.device or t.dtype != dtype:
            raise ValueError(
                f"sha512_ragged: {name} must be {dtype} on {sig_b.device}"
            )
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"sha512_ragged: {name} must be contiguous {shape}"
            )
    if msg.data_ptr() % 16 or msg.numel() % 16:
        raise ValueError(
            "sha512_ragged: msg must start 16-byte aligned and be a "
            "multiple of 16 bytes long"
        )
    out = torch.empty((64, n), dtype=torch.uint8, device=sig_b.device)
    lib = kernels()["sha512"]
    rc = lib.tm_sha512_ram(
        ptr(sig_b),
        ptr(pk_b),
        ptr(msg),
        ptr(offsets),
        ptr(out),
        n,
        max_len,
        sig_b.device.index,
        stream_of(sig_b.device),
    )
    check_launch(rc, lib, "sha512_ram")
    LAUNCHES["sha512_ram"] += 1
    return out
