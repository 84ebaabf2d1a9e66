"""The fixed-base comb of kernel X3: csrc/sr25519_comb.cuh.

X3 (csrc/sr25519_device.cuh) sums [s]B on a lane group of its own from
[j 16^w]B for every window w < 64 and j <= 8, so its additions need no
doublings. Each entry is the point cached with Z = 1:
(y - x, y + x, 2 d x y) mod p, in the kernels' radix-2^25.5 limbs
(canonical), computed here from the port's own base point
(crypto.ed25519_math.B_POINT) with Python integers; entry 0 is the
identity (1, 1, 0). 64 x 9 x 3 x 10 words, 69,120 bytes.

    python -m tendermint_tpu_torch.ops.x3_comb   # rewrite the header
"""

from __future__ import annotations

from pathlib import Path

from ..crypto import ed25519_math as em

__all__ = ["HEADER", "entries", "header_text", "limbs"]

HEADER = Path(__file__).resolve().parent / "csrc" / "sr25519_comb.cuh"
WINDOWS, MULTIPLES = 64, 9


def limbs(x: int) -> list:
    """x mod p in radix 2^25.5: ten limbs of 26 and 25 bits."""
    x %= em.P
    out = []
    for k in range(10):
        w = 26 - (k & 1)
        out.append(x & ((1 << w) - 1))
        x >>= w
    return out


def entries() -> list:
    """[w][j] = (y - x, y + x, 2 d x y) of [j 16^w]B, affine."""
    p = em.P
    d2 = 2 * em.D % p
    rows = []
    base = em.B_POINT
    for _w in range(WINDOWS):
        row, pt = [], em.IDENTITY
        for _j in range(MULTIPLES):
            X, Y, Z, _T = pt
            zi = pow(Z, p - 2, p)
            x, y = X * zi % p, Y * zi % p
            row.append(((y - x) % p, (y + x) % p, d2 * x * y % p))
            pt = em.point_add(pt, base)
        rows.append(row)
        for _ in range(4):
            base = em.point_double(base)
    return rows


def header_text() -> str:
    lines = [
        "// [j 16^w]B cached with Z = 1, (Y - X, Y + X, 2dT) in radix-2^25.5",
        "// limbs, for w < 64 and j <= 8: the fixed-base comb of kernel X3",
        "// (sr25519_device.cuh). Generated by",
        "// `python -m tendermint_tpu_torch.ops.x3_comb` from the port's base",
        "// point; tests/test_torch_csrc.py holds it against the generator.",
        "",
        "#pragma once",
        "#include <stdint.h>",
        "",
        "__device__ const uint32_t X3_COMB_TABLE[64][9][3][10] = {",
    ]
    for row in entries():
        lines.append("  {")
        for coords in row:
            cells = ", ".join(
                "{" + ", ".join(f"0x{v:07x}" for v in limbs(c)) + "}"
                for c in coords
            )
            lines.append(f"    {{{cells}}},")
        lines.append("  },")
    lines.append("};")
    return "\n".join(lines) + "\n"


if __name__ == "__main__":
    HEADER.write_text(header_text())
    print(f"wrote {HEADER}")
