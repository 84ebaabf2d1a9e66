"""Bit array for VoteSet and Commit bookkeeping.

Counterpart: tendermint_tpu/libs/bits.py:25-156 BitArray, backed by a
Python int, with the same out-of-range semantics, set algebra, sizing
and proto words (the bits count and little-endian uint64 words), and the
wire clamp MAX_BIT_ARRAY_SIZE (:22). pick_random draws from the
random.Random the caller passes, where the JAX package draws from its
process-wide gossip RNG (tendermint_tpu/libs/rng.py randbelow, which is
`randrange` on a random.Random): the same seed gives the same pick.
"""

from __future__ import annotations

import random
from typing import Iterator, List, Optional

__all__ = ["BitArray", "MAX_BIT_ARRAY_SIZE"]

# The bound on a wire-decoded size: every op masks with (1 << size) - 1,
# so an unclamped varint would be a bigint-allocation lever. The
# protocol's real maxima are 10,000 votes and 1,601 block parts.
MAX_BIT_ARRAY_SIZE = 1 << 20


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

    # set algebra: or_ takes the larger size, and_ the smaller, the rest
    # self's

    def or_(self, other: "BitArray") -> "BitArray":
        out = BitArray(max(self.size, other.size))
        out._bits = self._bits | other._bits
        return out

    def and_(self, other: "BitArray") -> "BitArray":
        out = BitArray(min(self.size, other.size))
        out._bits = self._bits & other._bits & ((1 << out.size) - 1)
        return out

    def not_(self) -> "BitArray":
        out = BitArray(self.size)
        out._bits = ~self._bits & ((1 << self.size) - 1)
        return out

    def sub(self, other: "BitArray") -> "BitArray":
        out = BitArray(self.size)
        out._bits = self._bits & ~other._bits & ((1 << self.size) - 1)
        return out

    def update(self, other: "BitArray") -> None:
        """Copy other's bits into self, cut to self's size."""
        self._bits = other._bits & ((1 << self.size) - 1)

    def is_empty(self) -> bool:
        return self._bits == 0

    def is_full(self) -> bool:
        return self.size > 0 and self._bits == (1 << self.size) - 1

    def count(self) -> int:
        return self._bits.bit_count()

    def indices(self) -> Iterator[int]:
        bits = self._bits
        i = 0
        while bits:
            if bits & 1:
                yield i
            bits >>= 1
            i += 1

    def pick_random(self, rnd: random.Random) -> Optional[int]:
        """A uniformly random set index drawn from `rnd`, or None when
        empty (reference: libs/bits/bit_array.go PickRandom)."""
        idxs = list(self.indices())
        if not idxs:
            return None
        return idxs[rnd.randrange(len(idxs))]

    def copy(self) -> "BitArray":
        out = BitArray(self.size)
        out._bits = self._bits
        return out

    def to_words(self) -> List[int]:
        n_words = (self.size + 63) // 64
        return [(self._bits >> (64 * w)) & ((1 << 64) - 1) for w in range(n_words)]

    @classmethod
    def from_words(cls, size: int, words: List[int]) -> "BitArray":
        """The wire form back: `size` and `words` come from a peer, so
        both are bounded (at most MAX_BIT_ARRAY_SIZE bits and
        ceil(size / 64) words, each a uint64) before any bigint is built."""
        if size > MAX_BIT_ARRAY_SIZE:
            raise ValueError(
                f"BitArray size {size} exceeds MAX_BIT_ARRAY_SIZE "
                f"{MAX_BIT_ARRAY_SIZE}"
            )
        if len(words) > (size + 63) // 64:
            raise ValueError(f"BitArray: {len(words)} words exceed size {size}")
        out = cls(size)
        try:
            buf = b"".join(w.to_bytes(8, "little") for w in words)
        except (OverflowError, AttributeError):
            raise ValueError("BitArray word out of uint64 range") from None
        bits = int.from_bytes(buf, "little")
        out._bits = bits & ((1 << size) - 1) if size else 0
        return out

    def __eq__(self, other: object) -> bool:
        return (
            isinstance(other, BitArray)
            and self.size == other.size
            and self._bits == other._bits
        )

    def __repr__(self) -> str:
        s = "".join("x" if self.get(i) else "_" for i in range(min(self.size, 64)))
        return f"BA{{{self.size}:{s}}}"
