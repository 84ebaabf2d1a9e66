"""The injectable, seedable RNG of the gossip routines' picks.

Counterpart: tendermint_tpu/libs/rng.py:1-80 (reference: PickSendVote /
BitArray.PickRandom). Which part or vote a gossip routine sends a peer
is load balancing, not security: it needs no OS entropy, but it must be
seedable, so that a run replays its picks from one seed. The module RNG
seeds itself from OS entropy at import, like the `random` module;
`reseed(seed)` pins it. Keys, cookies and nonces never come from here.

`randbelow(n)` and `choice(seq)` draw alike: both are one
`random.Random._randbelow(n)` call (CPython's `randrange(n)` and
`choice`), so the port's PeerState, which draws an index with
randbelow, picks what the JAX package's `choice` over the same
candidates picks.
"""

from __future__ import annotations

import random
import zlib
from typing import Optional, Sequence, TypeVar

__all__ = [
    "derive", "gossip", "reseed", "subseed",
    "choice", "shuffle", "randbelow",
]

T = TypeVar("T")

_GOSSIP = random.Random()  # self-seeds from OS entropy, like `random`


def derive(seed: int, label: str) -> random.Random:
    """An independent seeded stream for (seed, label), one per concern,
    so that a new consumer never shifts another's draws. Leaves the
    gossip RNG alone."""
    return random.Random(f"{seed}/{label}")


def subseed(seed: int, label: str) -> int:
    """A deterministic child seed for (seed, label), for a consumer that
    takes an integer seed (a fault rule, a Byzantine rule)."""
    return (int(seed) << 16) ^ zlib.crc32(label.encode())


def gossip() -> random.Random:
    """The shared gossip RNG (reseed it, or swap a Random-compatible
    stand-in in a test)."""
    return _GOSSIP


def reseed(seed: Optional[int]) -> None:
    """Reseed the gossip RNG; None goes back to OS entropy."""
    _GOSSIP.seed(seed)


def choice(seq: Sequence[T]) -> T:
    return _GOSSIP.choice(seq)


def shuffle(seq: list) -> None:
    _GOSSIP.shuffle(seq)


def randbelow(n: int) -> int:
    return _GOSSIP.randrange(n)
