"""The write-ahead log of consensus inputs.

Counterpart: tendermint_tpu/consensus/wal.py:1-442 (reference:
internal/consensus/wal.go; write-before-process in state.go:855-870).
Every input is written before it is handled, so a node that crashed
replays exactly what it had seen and lands in the same round state.

A record: crc32 (4 bytes, big-endian) | length (4, big-endian) | a
TimedWALMessage proto (wal.go's encoder :268-292). The CRC is zlib's
(IEEE), as in the JAX package, not the reference's Castagnoli: a WAL is
read only by the node that wrote it. Own votes and proposals go through
write_sync (fsync), so a signature never outlives its record across a
crash (state.go:861). The head file rotates to `{path}.NNN` past
head_size_limit and the oldest chunks are pruned past total_size_limit
(the autofile group, internal/libs/autofile/group.go:66-100). Fault
points: `wal.write` (short_write clips the frame) and `wal.fsync`
(io_error) of crypto/faults.py.
"""

from __future__ import annotations

import asyncio
import io
import logging
import os
import struct
import time
import zlib
from typing import Iterator, Optional, Tuple

from ..crypto import faults
from ..libs.service import Service
from .msgs import (
    EndHeightMessage,
    decode_timed_wal_message,
    encode_timed_wal_message,
)

__all__ = [
    "WAL",
    "NopWAL",
    "WALDecodeError",
    "iter_wal_records",
    "iter_wal_group",
]

MAX_MSG_SIZE = 1 << 20  # 1 MB (reference: wal.go maxMsgSizeBytes)
FLUSH_INTERVAL_S = 2.0  # reference: wal.go walDefaultFlushInterval
# autofile-group analog (reference: internal/libs/autofile/group.go:66-100):
# the head rotates once it crosses HEAD_SIZE_LIMIT, and the oldest rotated
# files are pruned when the whole group exceeds TOTAL_SIZE_LIMIT
HEAD_SIZE_LIMIT = 10 << 20  # group.go defaultHeadSizeLimit (10 MB)
TOTAL_SIZE_LIMIT = 1 << 30  # group.go defaultTotalSizeLimit (1 GB)


class WALDecodeError(Exception):
    """Corrupt record (bad CRC / overlong / truncated mid-record)."""


def _frame(payload: bytes) -> bytes:
    crc = zlib.crc32(payload) & 0xFFFFFFFF
    return struct.pack(">II", crc, len(payload)) + payload


def _read_record(f: io.BufferedReader) -> Optional[bytes]:
    """One framed record, None at clean EOF, WALDecodeError if torn."""
    hdr = f.read(8)
    if len(hdr) == 0:
        return None
    if len(hdr) < 8:
        raise WALDecodeError("truncated record header")
    crc, length = struct.unpack(">II", hdr)
    if length > MAX_MSG_SIZE:
        raise WALDecodeError(f"record too big: {length}")
    payload = f.read(length)
    if len(payload) < length:
        raise WALDecodeError("truncated record body")
    if zlib.crc32(payload) & 0xFFFFFFFF != crc:
        raise WALDecodeError("CRC mismatch")
    return payload


def _decode_record(payload: bytes):
    """decode_timed_wal_message, with decode failures (e.g. an unknown
    message type from a WAL written by a newer binary) re-raised as
    WALDecodeError so a CRC-valid-but-undecodable record degrades like
    a torn/corrupt one instead of crashing boot/crash-recovery."""
    try:
        return decode_timed_wal_message(payload)
    except (ValueError, TypeError, KeyError, IndexError, struct.error) as e:
        # any shape of malformed-but-CRC-valid payload (wrong wire
        # type, truncated field, unknown message tag) is corruption
        raise WALDecodeError(f"undecodable record: {e}") from e


def iter_wal_records(path: str) -> Iterator[Tuple[int, object]]:
    """Yield (time_ns, msg) from a WAL file, stopping at the first torn
    record (a crash mid-write leaves a torn tail; everything before it is
    intact — reference: wal.go:97-103 repair semantics)."""
    with open(path, "rb") as f:
        while True:
            try:
                payload = _read_record(f)
                if payload is None:
                    return
                msg = _decode_record(payload)
            except WALDecodeError:
                return
            yield msg


def wal_group_files(path: str) -> list:
    """The WAL group for head file `path`, oldest first: rotated files
    `path.NNN` in index order, then the head (reference: autofile
    group.go — Head plus {Head.Path}.NNN chunks)."""
    d = os.path.dirname(path) or "."
    base = os.path.basename(path)
    rotated = []
    try:
        names = os.listdir(d)
    except FileNotFoundError:
        return []
    for name in names:
        if name.startswith(base + "."):
            suffix = name[len(base) + 1:]
            if suffix.isdigit():
                rotated.append((int(suffix), os.path.join(d, name)))
    out = [p for _, p in sorted(rotated)]
    if os.path.exists(path):
        out.append(path)
    return out


def _read_chunk(path: str) -> Tuple[list, bool]:
    """All messages of one chunk in order plus a clean-EOF flag (False
    when decoding stopped at a torn/corrupt record)."""
    msgs: list = []
    with open(path, "rb") as f:
        while True:
            try:
                payload = _read_record(f)
                if payload is None:
                    return msgs, True
                msg = _decode_record(payload)[1]
            except WALDecodeError:
                return msgs, False
            msgs.append(msg)


def iter_wal_group(path: str) -> Iterator[Tuple[int, object]]:
    """iter_wal_records across the whole rotated group, oldest record
    first. Rotated files are closed at record boundaries, so only the
    head can have a torn tail; a decode error anywhere (external
    corruption) ends the WHOLE iteration — records after a corrupt one
    are not trustworthy input history, same as the single-file
    semantics."""
    for p in wal_group_files(path):
        with open(p, "rb") as f:
            while True:
                try:
                    payload = _read_record(f)
                    if payload is None:
                        break
                    msg = _decode_record(payload)
                except WALDecodeError:
                    return
                yield msg


class WAL(Service):
    """reference: internal/consensus/wal.go BaseWAL, writing through an
    autofile-group analog (internal/libs/autofile/group.go): the head
    file rotates to `{path}.NNN` once it crosses head_size_limit, and
    the oldest rotated files are pruned when the group's total size
    exceeds total_size_limit — a long-running validator's WAL is
    size-bounded instead of growing forever."""

    def __init__(
        self,
        path: str,
        head_size_limit: int = HEAD_SIZE_LIMIT,
        total_size_limit: int = TOTAL_SIZE_LIMIT,
    ) -> None:
        super().__init__(name="wal", logger=logging.getLogger(__name__))
        self.path = path
        self.head_size_limit = head_size_limit
        self.total_size_limit = total_size_limit
        self._f: Optional[io.BufferedWriter] = None
        self._dirty = False
        self._head_size = 0
        self._prune_pending = False

    async def on_start(self) -> None:
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        self._truncate_torn_tail()
        self._f = open(self.path, "ab")
        self._head_size = os.path.getsize(self.path)
        # next rotation index, computed once so _rotate never listdirs
        rotated = wal_group_files(self.path)[:-1]
        self._next_chunk_idx = 0
        if rotated:
            last = os.path.basename(rotated[-1])
            self._next_chunk_idx = (
                int(last[len(os.path.basename(self.path)) + 1:]) + 1
            )
        self.spawn(self._flush_routine(), "wal-flush")

    async def on_stop(self) -> None:
        if self._f is not None:
            self._f.flush()
            # the last signed messages reach the disk before the file
            # closes (reference: wal.go Stop -> FlushAndSync)
            os.fsync(self._f.fileno())
            self._f.close()
            self._f = None
        if self._prune_pending:
            # settle deferred pruning so a clean shutdown leaves the
            # group within its size bound
            self._prune_pending = False
            self._enforce_total_size()

    def _truncate_torn_tail(self) -> None:
        """Drop a torn OR undecodable final record left by a crash (or
        by a newer binary) so appends start after the last good record
        — otherwise everything written after the bad record would be
        invisible to recovery, which stops at the first corruption
        (reference: wal.go:97-103 repair semantics)."""
        if not os.path.exists(self.path):
            return
        good_end = 0
        with open(self.path, "rb") as f:
            while True:
                try:
                    payload = _read_record(f)
                    if payload is None:
                        break
                    _decode_record(payload)
                    good_end = f.tell()
                except WALDecodeError:
                    self.logger.error(
                        "WAL has a torn/undecodable tail; truncating to %d bytes",
                        good_end,
                    )
                    break
        if good_end < os.path.getsize(self.path):
            with open(self.path, "r+b") as f:
                f.truncate(good_end)

    # -- writes --

    def write(self, msg) -> None:
        """Buffered append (peer messages, timeouts — reference:
        wal.go:173). Crossing the head-size limit rotates at the record
        boundary just written (reference: group.go checkHeadSizeLimit —
        there on a ticker; synchronous here keeps the bound exact)."""
        if self._f is None:
            return
        payload = encode_timed_wal_message(time.time_ns(), msg)
        if len(payload) > MAX_MSG_SIZE:
            raise ValueError(f"WAL message too big: {len(payload)}")
        frame = _frame(payload)
        if faults.armed():
            # "wal.write" short_write: only a prefix of the frame, the
            # shape a crash mid-write leaves; recovery treats it as a
            # torn tail
            frame = faults.clip("wal.write", frame)
        self._f.write(frame)
        self._dirty = True
        self._head_size += len(frame)
        if self._head_size >= self.head_size_limit:
            self._rotate()

    def write_sync(self, msg) -> None:
        """Append + flush + fsync. Used for own messages: the signature
        this record describes must hit disk before it leaves the process
        (reference: wal.go:183-196, state.go:861)."""
        self.write(msg)
        self.flush_and_sync()

    def flush_and_sync(self) -> None:
        if self._f is None or not self._dirty:
            return
        self._f.flush()
        if faults.armed():
            faults.fire("wal.fsync")  # io_error rule -> OSError
        # an own vote or proposal is on disk before it leaves the
        # process, or a crash double-signs (reference: state.go:861);
        # peer messages ride the 2 s flush ticker
        os.fsync(self._f.fileno())
        self._dirty = False

    async def _flush_routine(self) -> None:
        """Periodic group flush (reference: wal.go:116 processFlushTicks)
        plus deferred group pruning — the directory scan lives here, off
        the write path (the reference prunes on a background ticker,
        group.go processTicks)."""
        while True:
            await asyncio.sleep(FLUSH_INTERVAL_S)
            self.flush_and_sync()
            if self._prune_pending:
                self._prune_pending = False
                self._enforce_total_size()

    # -- rotation (autofile-group analog) --

    def _rotate(self) -> None:
        """fsync + close the head, rename it to the next `.NNN` chunk,
        and open a fresh head (reference: group.go rotateFile). The
        fsync must stay on this path: write_sync's durability promise
        has to hold for a record that just landed in the rotated-out
        chunk (its flush_and_sync afterwards only reaches the new
        head). Pruning — the directory scan — is deferred to the flush
        routine so the consensus loop doesn't pay it at every 10 MB
        boundary (reference prunes on a ticker, checkTotalSizeLimit
        group.go:100-160)."""
        assert self._f is not None
        self._f.flush()
        if faults.armed():
            # the rotation fsync is the durability hinge: write_sync's
            # promise for a record that just landed in the rotating
            # chunk holds ONLY if this fsync really reached disk, so an
            # injected failure here must propagate (never be swallowed)
            faults.fire("wal.fsync")
        # write_sync's promise for a record that just landed in the
        # rotating-out chunk holds only if this fsync reached the disk
        # before the rename (reference: group.go rotateFile)
        os.fsync(self._f.fileno())
        self._f.close()
        target = f"{self.path}.{self._next_chunk_idx:03d}"
        self._next_chunk_idx += 1
        os.replace(self.path, target)
        self._f = open(self.path, "ab")
        self._head_size = 0
        self._dirty = False
        self.logger.info("rotated WAL head to %s", os.path.basename(target))
        self._prune_pending = True

    def _enforce_total_size(self) -> None:
        """Delete oldest rotated chunks while the group exceeds
        total_size_limit. The head is never deleted (reference:
        group.go:129 checkTotalSizeLimit, which skips index maxIndex)."""
        files = wal_group_files(self.path)
        sizes = {p: os.path.getsize(p) for p in files}
        total = sum(sizes.values())
        for p in files[:-1]:  # oldest first; never the head
            if total <= self.total_size_limit:
                break
            os.remove(p)
            total -= sizes[p]
            self.logger.info(
                "pruned oldest WAL chunk over total-size limit: %s",
                os.path.basename(p),
            )

    # -- replay support --

    def write_end_height(self, height: int) -> None:
        """Height fully committed; the replay cut point
        (reference: state.go:867 updateToState → wal.WriteSync(EndHeight))."""
        self.write_sync(EndHeightMessage(height=height))

    def search_for_end_height(
        self, height: int
    ) -> Optional[list]:
        """All messages recorded AFTER EndHeight(height), i.e. the inputs
        of height+1 onward, or None if that marker isn't in the log
        (reference: wal.go:202-254 — a backwards group scan). Chunks are
        read newest-first so crash recovery touches only the tail of the
        group (the marker is almost always in the head) and corruption
        in an OLD chunk can never mask an intact recent tail. height 0
        means 'from the start' when no EndHeight(0) exists but the log
        is non-empty. Later EndHeight markers ARE returned so catchup
        replay can detect an inconsistent store/WAL (crash between
        EndHeight fsync and state save) instead of silently merging
        heights."""
        files = wal_group_files(self.path)
        if not files:
            return None
        # chunks newer than the marker, newest first (concatenated once
        # at return — no quadratic re-copying while scanning)
        newer: list = []
        for p in reversed(files):
            msgs, clean = _read_chunk(p)
            if not clean and p != self.path:
                # Only the head may legitimately end short (torn tail).
                # A short decode of a ROTATED chunk is real corruption,
                # and the records lost after the corruption point would
                # leave a silent hole in the replayed input history —
                # fail the search loudly instead of replaying a gapped
                # history into consensus.
                self.logger.error(
                    "corrupt record inside rotated WAL chunk %s; refusing "
                    "to assemble a replay history with a gap",
                    os.path.basename(p),
                )
                return None
            marker = None
            for j, m in enumerate(msgs):
                if isinstance(m, EndHeightMessage) and m.height == height:
                    marker = j
            if marker is not None:
                out = msgs[marker + 1:]
                for chunk_msgs in reversed(newer):
                    out.extend(chunk_msgs)
                return out
            newer.append(msgs)
        # Special case: a fresh WAL that never completed `height` but has
        # records (reference treats missing EndHeight(0) as start-of-file).
        if height == 0 and any(newer):
            out = []
            for chunk_msgs in reversed(newer):
                out.extend(chunk_msgs)
            return out
        return None


class NopWAL:
    """For tests and non-validator replay paths
    (reference: wal.go nilWAL)."""

    def write(self, msg) -> None: ...

    def write_sync(self, msg) -> None: ...

    def flush_and_sync(self) -> None: ...

    def write_end_height(self, height: int) -> None: ...

    def search_for_end_height(self, height: int):
        return None

    async def start(self) -> None: ...

    async def stop(self) -> None: ...
