"""The second-block schedules of kernel X5: csrc/sha256_pad.cuh.

An RFC 6962 inner hash sha256(0x01 || L || R) is 65 bytes, two blocks;
the second block holds R's last byte b, the 0x80 marker, zeros and the
bit length 520, so its message schedule depends on b alone. X5
(csrc/sha256.cuh, `sha256_compress_pad`) reads K[t] + W[t] for t = 16..63
of that schedule from row b of this table instead of expanding it: 256
rows of 48 words, 49,152 bytes, computed here with Python integers by
the FIPS 180-4 recurrence.

    python -m tendermint_tpu_torch.ops.sha256_pad   # rewrite the header
"""

from __future__ import annotations

from pathlib import Path

__all__ = ["HEADER", "K256", "header_text", "table"]

HEADER = Path(__file__).resolve().parent / "csrc" / "sha256_pad.cuh"

K256 = (
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
)
_M32 = 0xFFFFFFFF


def _rotr(x: int, n: int) -> int:
    return ((x >> n) | (x << (32 - n))) & _M32


def table() -> list:
    """[b][t - 16] = K[t] + W[t] mod 2^32, t = 16..63, of the second
    block of 0x01 || L || R whose R ends in byte b."""
    rows = []
    for b in range(256):
        w = [(b << 24) | 0x00800000] + [0] * 14 + [65 * 8]
        for t in range(16, 64):
            s0 = _rotr(w[t - 15], 7) ^ _rotr(w[t - 15], 18) ^ (w[t - 15] >> 3)
            s1 = _rotr(w[t - 2], 17) ^ _rotr(w[t - 2], 19) ^ (w[t - 2] >> 10)
            w.append((w[t - 16] + s0 + w[t - 7] + s1) & _M32)
        rows.append([(K256[t] + w[t]) & _M32 for t in range(16, 64)])
    return rows


def header_text() -> str:
    lines = [
        "// K[t] + W[t], t = 16..63, of the second block of the RFC 6962 inner",
        "// hash 0x01 || L || R whose R ends in byte b (row b): W[0] = b << 24 |",
        "// 0x800000, W[1..14] = 0, W[15] = 520. Kernel X5 reads a row in twelve",
        "// 16-byte loads (sha256.cuh, sha256_pad_row). Generated by",
        "// `python -m tendermint_tpu_torch.ops.sha256_pad`;",
        "// tests/test_torch_csrc.py holds it against the generator.",
        "",
        "#pragma once",
        "#include <stdint.h>",
        "",
        "#if !defined(__CUDACC__) && !defined(__align__)",
        "#define __align__(n) __attribute__((aligned(n)))",
        "#endif",
        "",
        "__device__ __align__(16) uint32_t SHA256_PAD_KW[256 * 48] = {",
    ]
    for row in table():
        for i in range(0, 48, 6):
            lines.append(
                "    " + ", ".join(f"0x{v:08X}u" for v in row[i : i + 6]) + ","
            )
    lines.append("};")
    return "\n".join(lines) + "\n"


if __name__ == "__main__":
    HEADER.write_text(header_text())
    print(f"wrote {HEADER}")
