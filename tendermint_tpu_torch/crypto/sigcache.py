"""The process-wide verified-signature cache: triples proven once.

Counterpart: the triple half of tendermint_tpu/crypto/sigcache.py:
`DEFAULT_CAPACITY` (:104), `enabled` and `disabled` (:137-155),
`key_for` (:156), `seen_key` (:164), `seen_keys_bulk` (:185),
`add_keys_bulk` (:218-233), the two-generation rotation
(:236-253), `seen` and `add` (:306-323), `stats`, `set_capacity`,
`reset` and `entries` (:334-365).

The consensus vote path is built on it: the vote-burst pre-verify
(consensus/state.py `_preverify_votes`) verifies a burst's signatures in
one batch a key type and records every valid (pubkey, sign-bytes,
signature) triple here through crypto.batch.drain_and_cache; VoteSet
.add_vote's Vote.verify then finds its triple and skips the curve math.

Safety: the key is the exact triple, a tuple in a set, so a hit needs
byte equality of all three (a forged signature, other sign-bytes or an
equivocating vote's other block is a miss by construction); only
successful verifications are inserted; and the cache carries no
acceptance of its own: every address, index, height and double-sign
check runs either way, only the signature equation is skipped. A batch
the device faulted under caches nothing (crypto/batch.py).

Memory: inserts land in the young generation; when it holds `capacity`
keys the old one is dropped (counted as evictions) and the young one
takes its place. A hit in the old generation is promoted, so a stable
validator set's triples survive rotation. 20,000 a generation is about
two heights of precommits at MAX_VOTES_COUNT (types/vote_set.py).

Left out: the commit-level keys (`seen_commit`/`add_commit`, :280-305)
and their memo switch. No port path keeps a commit memo, and the port's
commit paths (types/validation.py) consult no cache, so a commit's
signatures always reach the kernels there. The JAX package's metrics
registry is replaced by integer counters (`stats()`), and its
TM_TPU_NO_SIGCACHE environment switch by the `disabled()` scope alone.
"""

from __future__ import annotations

import contextlib
import threading

__all__ = [
    "DEFAULT_CAPACITY",
    "add",
    "add_keys_bulk",
    "disabled",
    "enabled",
    "entries",
    "key_for",
    "reset",
    "seen",
    "seen_key",
    "seen_keys_bulk",
    "set_capacity",
    "stats",
]

DEFAULT_CAPACITY = 20_000

_capacity = DEFAULT_CAPACITY
_gen0: set = set()  # young generation: inserts and promotions land here
_gen1: set = set()  # old generation: dropped whole at rotation
_lock = threading.Lock()  # guards rotation and the counters
_force_off = False
_counts = {"hits": 0, "misses": 0, "evictions": 0}


def enabled() -> bool:
    """False inside a disabled() scope: every lookup misses and every
    insert is dropped, as if the cache did not exist."""
    return not _force_off


@contextlib.contextmanager
def disabled():
    """A scope with the cache off (the cold ingest, A/B tests)."""
    global _force_off
    prev = _force_off
    _force_off = True
    try:
        yield
    finally:
        _force_off = prev


def key_for(pk_bytes: bytes, sign_bytes: bytes, signature: bytes) -> tuple:
    """The exact triple is the key: distinct triples never alias."""
    return (pk_bytes, sign_bytes, signature)


def seen_key(key: tuple) -> bool:
    """Membership of a prebuilt key, promoting an old-generation hit,
    with no counting and no enabled() gate (seen() has both)."""
    if key in _gen0:
        return True
    if key in _gen1:
        _gen1.discard(key)
        _insert(key)
        return True
    return False


def seen_keys_bulk(keys) -> set:
    """The subset of `keys` already proven, by one set intersection a
    generation; old-generation hits are promoted as in seen_key. Batch
    callers check enabled() once; no counting."""
    if not keys:
        return set()
    ks = keys if isinstance(keys, set) else set(keys)
    hits = ks & _gen0
    old = (ks - hits) & _gen1
    if old:
        _gen1.difference_update(old)
        _gen0.update(old)
        hits |= old
        if len(_gen0) >= _capacity:
            _rotate()
    return hits


def add_keys_bulk(keys) -> None:
    """Record prebuilt keys; the caller gates on enabled() and calls
    only after a successful verification. Inserted in chunks of the
    young generation's remaining room, so that at most 2 x capacity keys
    are resident even when one drain holds more than a generation."""
    keys = list(keys)
    pos = 0
    while pos < len(keys):
        room = max(_capacity - len(_gen0), 1)
        _gen0.update(keys[pos : pos + room])
        pos += room
        if len(_gen0) >= _capacity:
            _rotate()


def _insert(key: tuple) -> None:
    _gen0.add(key)
    if len(_gen0) >= _capacity:
        _rotate()


def _rotate() -> None:
    global _gen0, _gen1
    with _lock:
        if len(_gen0) < _capacity:  # another thread rotated first
            return
        _counts["evictions"] += len(_gen1)
        _gen1 = _gen0
        _gen0 = set()


def seen(pk_bytes: bytes, sign_bytes: bytes, signature: bytes) -> bool:
    """One triple (Vote.verify): False when disabled; counts one hit or
    one miss."""
    if not enabled():
        return False
    hit = seen_key(key_for(pk_bytes, sign_bytes, signature))
    with _lock:
        _counts["hits" if hit else "misses"] += 1
    return hit


def add(pk_bytes: bytes, sign_bytes: bytes, signature: bytes) -> None:
    """One triple, after a successful verification; dropped when
    disabled."""
    if not enabled():
        return
    _insert(key_for(pk_bytes, sign_bytes, signature))


def stats() -> dict:
    """Hits, misses and evictions since the process started, the keys
    resident and the capacity of a generation."""
    with _lock:
        out = dict(_counts)
    out["entries"] = entries()
    out["capacity"] = _capacity
    return out


def set_capacity(n: int) -> None:
    """Resize a generation; resident keys stay until rotation."""
    global _capacity
    if n < 1:
        raise ValueError(f"sigcache capacity must be >= 1: {n}")
    _capacity = int(n)


def reset() -> None:
    """Drop every key (tests, cold runs); the counters keep counting."""
    global _gen0, _gen1
    with _lock:
        _gen0 = set()
        _gen1 = set()


def entries() -> int:
    """Keys resident in both generations."""
    return len(_gen0) + len(_gen1)
