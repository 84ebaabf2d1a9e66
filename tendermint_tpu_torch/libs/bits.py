"""Bit array (the subset Commit.bit_array needs).

Counterpart: tendermint_tpu/libs/bits.py BitArray, backed by a Python
int; get/set with the same out-of-range semantics.
"""

from __future__ import annotations

__all__ = ["BitArray"]


class BitArray:
    __slots__ = ("size", "_bits")

    def __init__(self, size: int) -> None:
        if size < 0:
            raise ValueError("negative size")
        self.size = size
        self._bits = 0

    def get(self, i: int) -> bool:
        if i < 0 or i >= self.size:
            return False
        return bool(self._bits >> i & 1)

    def set(self, i: int, value: bool = True) -> bool:
        if i < 0 or i >= self.size:
            return False
        if value:
            self._bits |= 1 << i
        else:
            self._bits &= ~(1 << i)
        return True
