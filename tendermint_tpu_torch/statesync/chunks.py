"""The on-disk chunk queue of a snapshot restore.

Counterpart: tendermint_tpu/statesync/chunks.py:1-122, whole (reference:
internal/statesync/chunks.go:33-54 NewChunkQueue spooling to a temporary
directory, :88 Add writing a file an index, Discard and Retry :178-214).
Fetched chunks spool to one file an index in a private temporary
directory, so a restore holds one chunk in memory, not the snapshot.
close() removes the directory: the reactor calls it in a finally.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Optional, Set

__all__ = ["ChunkQueue"]


class ChunkQueue:
    """Per-index chunk spool for one snapshot restore.

    put() writes the chunk to disk and remembers which peer sent it;
    get() reads it back; discard() deletes the file (after a successful
    apply, or when the app asks for a re-fetch). close() removes the
    whole directory — always call it, success or failure.
    """

    def __init__(self, total: int, dir: Optional[str] = None) -> None:
        if total < 0:
            raise ValueError("negative chunk count")
        self.total = total
        self._dir = tempfile.mkdtemp(prefix="tm-statesync-chunks-", dir=dir)
        self._have: Set[int] = set()
        self._returned: Set[int] = set()  # applied (ACCEPTed) indexes
        self._senders: dict = {}
        self._closed = False

    def _path(self, index: int) -> str:
        return os.path.join(self._dir, f"{index:06d}")

    def _check(self, index: int) -> None:
        if self._closed:
            raise RuntimeError("chunk queue is closed")
        if not 0 <= index < self.total:
            raise IndexError(f"chunk index {index} out of range")

    def put(self, index: int, chunk: bytes, sender: str = "") -> bool:
        """Spool one chunk; returns False if the index is already
        present (first responder wins, reference chunks.go Add)."""
        self._check(index)
        if index in self._have:
            return False
        tmp = self._path(index) + ".tmp"
        with open(tmp, "wb") as f:
            f.write(chunk)
        os.replace(tmp, self._path(index))
        self._have.add(index)
        self._senders[index] = sender
        return True

    def has(self, index: int) -> bool:
        self._check(index)
        return index in self._have

    def get(self, index: int) -> bytes:
        self._check(index)
        if index not in self._have:
            raise KeyError(f"chunk {index} not in queue")
        with open(self._path(index), "rb") as f:
            return f.read()

    def sender(self, index: int) -> str:
        return self._senders.get(index, "")

    def discard(self, index: int) -> None:
        """Drop a chunk so it can be re-fetched (reference chunks.go
        Discard :160-185): deletes the backing file and clears the
        returned flag, so the apply cursor naturally rewinds to it once
        the re-fetch lands."""
        self._check(index)
        if index in self._have:
            os.remove(self._path(index))
            self._have.discard(index)
            self._senders.pop(index, None)
        self._returned.discard(index)

    # -- apply-cursor bookkeeping (reference chunks.go Next/Retry) --

    def next_up(self) -> Optional[int]:
        """Lowest index not yet applied, or None when every chunk has
        been returned (reference chunks.go nextUp :288-300)."""
        for i in range(self.total):
            if i not in self._returned:
                return i
        return None

    def mark_returned(self, index: int) -> None:
        self._check(index)
        self._returned.add(index)

    def is_returned(self, index: int) -> bool:
        """True once the chunk has been handed to the app and not since
        discarded/retried (the apply cursor skips returned chunks)."""
        return index in self._returned

    def retry(self, index: int) -> None:
        """Schedule a re-apply WITHOUT refetching (reference chunks.go
        Retry :303-308)."""
        self._check(index)
        self._returned.discard(index)

    def missing(self) -> Set[int]:
        return set(range(self.total)) - self._have

    def __len__(self) -> int:
        return len(self._have)

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            shutil.rmtree(self._dir, ignore_errors=True)
