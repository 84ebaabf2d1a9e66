"""Database key migration: legacy string-prefixed keys to the
binary-prefix layout.

Counterpart: tendermint_tpu/store/keymigrate.py:1-131 (reference:
scripts/keymigrate/migrate.go and `tendermint key-migrate`). The legacy
v0.34 ASCII keys (``H:1``, ``P:1:0``, ``C:0``, ``SC:1``, ``BH:<hex>``,
``validatorsKey:…``, ``stateKey``, ``consensusParamsKey:…``,
``abciResponsesKey:…``) move to the binary layout of
store/block_store.py and state/store.py (a prefix byte and a big-endian
height). Values are carried over unchanged, except ``BH:``'s ASCII
decimal height, which becomes the 8-byte big-endian one the hash index
reads; of several ``SC:`` keys only the highest height's survives, under
the single seen-commit key.

Migration is resumable and idempotent: legacy keys are found by prefix,
so a re-run (or a crash partway) skips everything already translated.
"""

from __future__ import annotations

import struct
from typing import Callable, Dict, List, Optional, Tuple

from ..state import store as state_store
from ..store import block_store
from .kv import KVStore

__all__ = ["migrate_db", "CONTEXTS"]


def _int(b: bytes) -> int:
    return int(b.decode())


def _h(height: int) -> bytes:
    return struct.pack(">q", height)


def _migrate_blockstore(key: bytes) -> Optional[Tuple[bytes, Callable]]:
    """legacy key -> (new key, value translator) or None if not legacy.
    reference formats: migrate.go:116-160."""
    ident = lambda v: v  # noqa: E731
    if key.startswith(b"H:"):
        return block_store._meta_key(_int(key[2:])), ident
    if key.startswith(b"P:"):
        height, _, part = key[2:].partition(b":")
        return (
            block_store._part_key(_int(height), _int(part)),
            ident,
        )
    if key.startswith(b"C:"):
        return block_store._commit_key(_int(key[2:])), ident
    if key.startswith(b"SC:"):
        # the current layout keeps only the LATEST seen commit under a
        # single key; migrate_db resolves the max-height winner
        return block_store._seen_commit_key(), ident
    if key.startswith(b"BH:"):
        # legacy: hex hash key, ASCII-decimal height value
        return (
            block_store._hash_key(bytes.fromhex(key[3:].decode())),
            lambda v: _h(_int(v)),
        )
    return None


def _migrate_state(key: bytes) -> Optional[Tuple[bytes, Callable]]:
    ident = lambda v: v  # noqa: E731
    if key == b"stateKey":
        return state_store._STATE, ident
    if key.startswith(b"validatorsKey:"):
        return state_store._vals_key(_int(key[14:])), ident
    if key.startswith(b"consensusParamsKey:"):
        return state_store._params_key(_int(key[19:])), ident
    if key.startswith(b"abciResponsesKey:"):
        return state_store._abci_key(_int(key[17:])), ident
    return None


CONTEXTS: Dict[str, Callable] = {
    "blockstore": _migrate_blockstore,
    "state": _migrate_state,
}


def migrate_db(db: KVStore, context: str) -> int:
    """Translate every legacy-format key in `db`; returns the count.
    Unknown contexts (tx_index, evidence, light, peerstore — born in
    the current layout here) are no-ops, mirroring the reference's
    per-context dispatch."""
    fn = CONTEXTS.get(context)
    if fn is None:
        return 0
    moves: List[Tuple[bytes, bytes, bytes]] = []  # old, new, value
    seen_commit_best = None  # (height, old_key, value)
    for key, value in list(db.iterate(None, None)):
        try:
            res = fn(bytes(key))
        except (ValueError, UnicodeDecodeError):
            continue  # not a well-formed legacy key: leave it alone
        if res is None:
            continue
        new_key, xform = res
        if context == "blockstore" and bytes(key).startswith(b"SC:"):
            height = _int(bytes(key)[3:])
            if (
                seen_commit_best is None
                or height > seen_commit_best[0]
            ):
                if seen_commit_best is not None:
                    # the previous best is superseded: delete only
                    moves.append((seen_commit_best[1], b"", b""))
                seen_commit_best = (height, bytes(key), value)
            else:
                moves.append((bytes(key), b"", b""))  # delete only
            continue
        moves.append((bytes(key), new_key, xform(value)))
    if seen_commit_best is not None:
        _, old_key, value = seen_commit_best
        moves.append(
            (old_key, block_store._seen_commit_key(), value)
        )
    migrated = 0
    for old_key, new_key, value in moves:
        if new_key:
            db.set(new_key, value)
            migrated += 1
        db.delete(old_key)  # delete-only: superseded SC: tombstones
    return migrated
