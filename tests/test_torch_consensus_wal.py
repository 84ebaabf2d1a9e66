"""The port's WAL, timeout ticker and consensus codecs held against the
JAX package's.

Every arm of the consensus Message oneof and every WAL record type,
built from a seed, encodes to the same bytes in both packages, decodes
both ways, and gives the same validate_basic outcome. The same seeded
sequence of records written through both packages' WAL (the clock
pinned) makes the same files, byte for byte, and reads back the same:
iter_wal_records, iter_wal_group, search_for_end_height. Then the WAL's
recovery cases of tests/test_consensus_wal.py, on both: a torn tail cut
at seeded points and truncated on restart, a flipped CRC byte, an
undecodable record, an oversize message, rotation across chunks with
the total-size cap, the short-write fault at `wal.write` and the fsync
fault at `wal.fsync` (crypto/faults.py), each with the same files and
outcomes. The ticker fires the same timeouts in the same order.
Tolerance: zero.
"""

import asyncio
import os
import pathlib
import time

import numpy as np
import pytest

from tendermint_tpu.consensus import msgs as jax_msgs
from tendermint_tpu.consensus import wal as jax_wal
from tendermint_tpu.consensus.ticker import TimeoutTicker as JaxTicker
from tendermint_tpu.crypto import faults as jax_faults
from tendermint_tpu_torch.consensus import msgs as port_msgs
from tendermint_tpu_torch.consensus import wal as port_wal
from tendermint_tpu_torch.consensus.ticker import TimeoutTicker
from tendermint_tpu_torch.crypto import faults as port_faults
from tendermint_tpu_torch.crypto.merkle import Proof
from tendermint_tpu_torch.libs.bits import BitArray
from tendermint_tpu_torch.types.block_id import BlockID, PartSetHeader
from tendermint_tpu_torch.types.part_set import Part
from tendermint_tpu_torch.types.proposal import Proposal
from tendermint_tpu_torch.types.vote import Vote

from .test_torch_isolation import jax_device_plane_paused  # noqa: F401 (autouse)

SEED = 17
PKGS = {"port": (port_msgs, port_wal, port_faults), "jax": (jax_msgs, jax_wal, jax_faults)}


def run(coro):
    return asyncio.run(coro)


def _outcome(fn):
    try:
        fn()
    except Exception as e:  # the outcome compared IS the exception
        return type(e).__name__, str(e)
    return "ok", ""


def _bid(rng, zero_ok=True) -> BlockID:
    if zero_ok and rng.integers(4) == 0:
        return BlockID()
    return BlockID(rng.bytes(32), PartSetHeader(int(rng.integers(1, 9)), rng.bytes(32)))


def _bits(rng) -> BitArray:
    n = int(rng.integers(1, 200))
    words = [int(w) for w in rng.integers(0, 1 << 62, (n + 63) // 64, dtype=np.int64)]
    ba = BitArray.from_words(n, words)
    return ba


def _messages(seed: int) -> list:
    """Every Message arm and WAL record, fields from the seed (some out
    of range, for validate_basic)."""
    rng = np.random.default_rng(seed)
    h = lambda: int(rng.integers(-1, 1 << 20))  # noqa: E731
    r = lambda: int(rng.integers(-1, 20))  # noqa: E731
    vote = Vote(type=int(rng.choice([1, 2, 3])), height=h(), round=r(), block_id=_bid(rng),
                timestamp_ns=int(rng.integers(0, 1 << 62)), validator_address=rng.bytes(20),
                validator_index=int(rng.integers(-1, 100)), signature=rng.bytes(int(rng.choice([0, 63, 64]))))
    proposal = Proposal(height=h(), round=r(), pol_round=int(rng.integers(-2, 5)), block_id=_bid(rng),
                        timestamp_ns=int(rng.integers(0, 1 << 62)),
                        signature=rng.bytes(int(rng.choice([0, 64, 65]))))
    part = Part(index=int(rng.integers(0, 5)), bytes=rng.bytes(int(rng.integers(0, 300))),
                proof=Proof(total=int(rng.integers(1, 9)), index=int(rng.integers(0, 8)),
                            leaf_hash=rng.bytes(32), aunts=[rng.bytes(32) for _ in range(int(rng.integers(0, 4)))]))
    arms = [
        port_msgs.NewRoundStepMessage(height=h(), round=r(), step=int(rng.integers(0, 9)),
                                      seconds_since_start_time=int(rng.integers(0, 99)),
                                      last_commit_round=r()),
        port_msgs.NewValidBlockMessage(height=h(), round=r(),
                                       block_part_set_header=PartSetHeader(int(rng.integers(0, 9)), rng.bytes(32)),
                                       block_parts=_bits(rng), is_commit=bool(rng.integers(2))),
        port_msgs.ProposalMessage(proposal),
        port_msgs.ProposalPOLMessage(height=h(), proposal_pol_round=r(), proposal_pol=_bits(rng)),
        port_msgs.BlockPartMessage(height=h(), round=r(), part=part),
        port_msgs.VoteMessage(vote),
        port_msgs.HasVoteMessage(height=h(), round=r(), type=int(rng.choice([1, 2, 5])), index=r()),
        port_msgs.VoteSetMaj23Message(height=h(), round=r(), type=int(rng.choice([1, 2])), block_id=_bid(rng)),
        port_msgs.VoteSetBitsMessage(height=h(), round=r(), type=int(rng.choice([1, 2])),
                                     block_id=_bid(rng), votes=_bits(rng)),
    ]
    return arms


def _records(seed: int) -> list:
    """A WAL's worth of records: every arm as a MsgInfo, timeouts, round
    steps and EndHeight markers."""
    rng = np.random.default_rng([seed, 1])
    out = []
    for height in range(1, 6):
        for msg in _messages(seed + height):
            out.append(port_msgs.MsgInfo(msg=msg, peer_id="" if rng.integers(3) == 0 else "peer-%d" % height))
        out.append(port_msgs.TimeoutInfo(duration_s=float(rng.integers(0, 3000)) / 1000, height=height,
                                         round=int(rng.integers(0, 3)), step=int(rng.integers(1, 9))))
        out.append(port_msgs.EventDataRoundStateWAL(height=height, round=0, step="RoundStepPropose"))
        out.append(port_msgs.EndHeightMessage(height=height))
    return out


@pytest.mark.parametrize("seed", range(6))
def test_every_message_arm_equal_jax_both_ways(seed):
    for msg in _messages(seed):
        wire = port_msgs.encode_msg(msg)
        jmsg = jax_msgs.decode_msg(wire)
        assert type(jmsg).__name__ == type(msg).__name__
        assert jax_msgs.encode_msg(jmsg) == wire
        back = port_msgs.decode_msg(jax_msgs.encode_msg(jmsg))
        assert back == msg and port_msgs.encode_msg(back) == wire
        assert _outcome(msg.validate_basic) == _outcome(jmsg.validate_basic)


@pytest.mark.parametrize("seed", range(3))
def test_timed_wal_records_equal_jax_both_ways(seed):
    rng = np.random.default_rng([seed, 2])
    for rec in _records(seed):
        t = int(rng.integers(0, 1 << 62))
        data = port_msgs.encode_timed_wal_message(t, rec)
        jt, jrec = jax_msgs.decode_timed_wal_message(data)
        pt, prec = port_msgs.decode_timed_wal_message(data)
        again = port_msgs.encode_timed_wal_message(pt, prec)
        assert pt == jt == t and again == jax_msgs.encode_timed_wal_message(jt, jrec)
        # a timeout's float seconds may lose a nanosecond going round,
        # in both packages alike; every other record comes back whole
        assert again == data or isinstance(rec, port_msgs.TimeoutInfo)
    with pytest.raises(TypeError, match="unknown WAL message"):
        port_msgs.encode_timed_wal_message(0, object())
    for bad in (b"", b"\x0a\x00"):
        assert _outcome(lambda: port_msgs.decode_timed_wal_message(bad)) == _outcome(
            lambda: jax_msgs.decode_timed_wal_message(bad))


# -- the WAL on disk, both packages --


class _Clock:
    """time.time_ns() a nanosecond a read from a fixed start, the same in
    both packages' runs."""

    def __init__(self, monkeypatch):
        self.t = 1_700_000_000_000_000_000
        monkeypatch.setattr(time, "time_ns", self.now)

    def now(self) -> int:
        self.t += 1
        return self.t

    def reset(self) -> None:
        self.t = 1_700_000_000_000_000_000


def _jax_record(rec):
    """The JAX package's record of a port record (by its bytes)."""
    return jax_msgs.decode_timed_wal_message(port_msgs.encode_timed_wal_message(0, rec))[1]


def _write(pkg: str, path: str, records, sync_every: int = 5, **kw) -> None:
    msgs, wal, _faults = PKGS[pkg]

    async def go():
        w = wal.WAL(path, **kw)
        await w.start()
        for i, rec in enumerate(records):
            rec = rec if pkg == "port" else _jax_record(rec)
            if isinstance(rec, msgs.EndHeightMessage):
                w.write_end_height(rec.height)
            elif i % sync_every == 0:
                w.write_sync(rec)
            else:
                w.write(rec)
        await w.stop()

    run(go())


def _files(path: str) -> dict:
    return {os.path.basename(p): pathlib.Path(p).read_bytes() for p in port_wal.wal_group_files(path)}


def _read(pkg: str, path: str) -> dict:
    msgs, wal, _ = PKGS[pkg]
    enc = lambda ms: [msgs.encode_timed_wal_message(0, m) for m in ms]  # noqa: E731
    out = {
        "records": [msgs.encode_timed_wal_message(t, m) for t, m in wal.iter_wal_records(path)],
        "group": [msgs.encode_timed_wal_message(t, m) for t, m in wal.iter_wal_group(path)],
    }
    w = wal.WAL(path)
    for h in (0, 1, 3, 5, 9):
        found = w.search_for_end_height(h)
        out[f"end{h}"] = None if found is None else enc(found)
    return out


def _both(tmp_path, clock, name, records, **kw) -> dict:
    out = {}
    for pkg in PKGS:
        clock.reset()
        path = str(tmp_path / pkg / name / "wal")
        _write(pkg, path, records, **kw)
        out[pkg] = path
    return out


def test_wal_files_and_reads_equal_jax(tmp_path, monkeypatch):
    clock = _Clock(monkeypatch)
    paths = _both(tmp_path, clock, "plain", _records(SEED))
    assert _files(paths["port"]) == _files(paths["jax"])
    got, want = _read("port", paths["port"]), _read("jax", paths["jax"])
    assert got == want and len(got["records"]) == len(_records(SEED))
    # no EndHeight(0): height 0 replays from the start
    assert len(got["end0"]) == len(got["records"]) and got["end9"] is None and got["end5"] == []


@pytest.mark.parametrize("cut", range(5))
def test_torn_tail_truncated_on_restart_as_jax(tmp_path, monkeypatch, cut):
    """The file cut at a seeded byte (a crash mid-write): a restart of
    each package's WAL truncates it to the same last whole record, and
    both read the same records and replay cuts."""
    clock = _Clock(monkeypatch)
    paths = _both(tmp_path, clock, "torn", _records(SEED + cut))
    size = os.path.getsize(paths["port"])
    at = int(np.random.default_rng([SEED, cut]).integers(size // 2, size))
    for pkg, path in paths.items():
        with open(path, "r+b") as f:
            f.truncate(at)
        _msgs, wal, _ = PKGS[pkg]

        async def restart():
            w = wal.WAL(path)
            await w.start()
            await w.stop()

        run(restart())
    assert _files(paths["port"]) == _files(paths["jax"])
    assert os.path.getsize(paths["port"]) <= at
    assert _read("port", paths["port"]) == _read("jax", paths["jax"])


@pytest.mark.parametrize("where", ["crc", "length", "payload"])
def test_corrupt_record_stops_reading_as_jax(tmp_path, monkeypatch, where):
    """A flipped byte in a record's CRC, its length (past the 1 MB cap)
    or its payload (CRC-valid but undecodable: the payload rewritten
    with a good CRC): both packages stop at the same record."""
    import struct
    import zlib

    clock = _Clock(monkeypatch)
    paths = _both(tmp_path, clock, where, _records(SEED))
    for path in paths.values():
        data = bytearray(pathlib.Path(path).read_bytes())
        # the fifth record's frame
        off = 0
        for _ in range(4):
            off += 8 + struct.unpack(">I", data[off + 4 : off + 8])[0]
        n = struct.unpack(">I", data[off + 4 : off + 8])[0]
        if where == "crc":
            data[off] ^= 0xFF
        elif where == "length":
            data[off + 4 : off + 8] = struct.pack(">I", (1 << 20) + 1)
        else:
            payload = b"\x0a\x01\x00" + b"\xff" * (n - 3)
            data[off + 8 : off + 8 + n] = payload
            data[off : off + 4] = struct.pack(">I", zlib.crc32(payload) & 0xFFFFFFFF)
        pathlib.Path(path).write_bytes(bytes(data))
    got, want = _read("port", paths["port"]), _read("jax", paths["jax"])
    assert got == want and len(got["records"]) == 4


def test_oversize_message_refused_as_jax(tmp_path, monkeypatch):
    # one clock for both writes: the record's size counts the varints of
    # its time, which two readings of the host clock can make differ
    monkeypatch.setattr(time, "time_ns", lambda: 1_760_000_000_123_456_789)
    big = port_msgs.MsgInfo(msg=port_msgs.BlockPartMessage(
        height=1, round=0, part=Part(index=0, bytes=b"\x07" * (1 << 20),
                                     proof=Proof(total=1, index=0, leaf_hash=b"\x01" * 32))))
    out = {}
    for pkg in PKGS:
        _msgs, wal, _ = PKGS[pkg]
        rec = big if pkg == "port" else _jax_record(big)

        async def go():
            w = wal.WAL(str(tmp_path / pkg / "wal"))
            await w.start()
            try:
                return _outcome(lambda: w.write(rec))
            finally:
                await w.stop()

        out[pkg] = run(go())
    assert out["port"] == out["jax"] and out["port"][0] == "ValueError"


@pytest.mark.parametrize("limits", [(512, 1 << 30), (512, 3000)], ids=["rotate", "rotate_and_prune"])
def test_rotation_and_size_cap_equal_jax(tmp_path, monkeypatch, limits):
    """A 512-byte head rotates into `wal.NNN` chunks (and, under a
    3,000-byte total cap, the oldest chunks go at the next stop): the
    same chunk names and bytes in both packages, and the same reads
    across the chunks."""
    head, total = limits
    clock = _Clock(monkeypatch)
    paths = _both(tmp_path, clock, "rot", _records(SEED), head_size_limit=head, total_size_limit=total)
    files = _files(paths["port"])
    assert files == _files(paths["jax"]) and len(files) > 3
    assert _read("port", paths["port"]) == _read("jax", paths["jax"])


def test_short_write_fault_recovers_as_jax(tmp_path, monkeypatch):
    """The `wal.write` short_write rule (seed 9) on the last append: the
    same torn prefix on disk, the same truncation on restart, the same
    replay cut (tests/test_consensus_wal.py's case)."""
    clock = _Clock(monkeypatch)
    out = {}
    for pkg in PKGS:
        msgs, wal, faults = PKGS[pkg]
        clock.reset()
        path = str(tmp_path / pkg / "wal")

        async def go():
            w = wal.WAL(path)
            await w.start()
            for h in (1, 2, 3):
                w.write(msgs.MsgInfo(msg=msgs.HasVoteMessage(height=h, round=0, type=1, index=h)))
                w.write_end_height(h)
            with faults.inject("wal.write", mode="short_write", seed=9) as rule:
                w.write(msgs.MsgInfo(msg=msgs.HasVoteMessage(height=4, round=0, type=1, index=0)))
            w._f.flush()
            w._f.close()
            w._f = None
            await w.stop()
            torn = pathlib.Path(path).read_bytes()
            w = wal.WAL(path)
            await w.start()
            await w.stop()
            return rule.fired, torn

        fired, torn = run(go())
        assert fired == 1
        out[pkg] = (torn, _files(path), _read(pkg, path))
    assert out["port"] == out["jax"]
    assert len(out["port"][0]) > len(out["port"][1]["wal"])


def test_fsync_fault_at_rotation_propagates_as_jax(tmp_path, monkeypatch):
    """The `wal.fsync` io_error rule on the rotation's fsync: the write
    that rotates raises the same OSError after the same count of
    records, and a restart reads the same prefix."""
    clock = _Clock(monkeypatch)
    out = {}
    for pkg in PKGS:
        msgs, wal, faults = PKGS[pkg]
        clock.reset()
        path = str(tmp_path / pkg / "wal")

        async def go():
            w = wal.WAL(path, head_size_limit=512)
            await w.start()
            w.write_end_height(1)
            written, err = 0, None
            with faults.inject("wal.fsync", mode="io_error", times=1) as rule:
                try:
                    for i in range(200):
                        w.write(msgs.MsgInfo(msg=msgs.HasVoteMessage(height=2, round=0, type=1, index=i % 4)))
                        written += 1
                except OSError as e:
                    err = str(e)
            if w._f is not None:
                w._f.close()
                w._f = None
            w = wal.WAL(path, head_size_limit=512)
            await w.start()
            await w.stop()
            return rule.fired, written, err

        fired, written, err = run(go())
        assert fired == 1 and "injected I/O fault" in err
        out[pkg] = (written, err, _files(path), _read(pkg, path))
    assert out["port"] == out["jax"]


def test_nop_wal_as_jax():
    for w in (port_wal.NopWAL(), jax_wal.NopWAL()):
        w.write(None)
        w.write_sync(None)
        w.flush_and_sync()
        w.write_end_height(3)
        assert w.search_for_end_height(0) is None
        run(w.start())
        run(w.stop())


# -- the ticker --


def _ticker_run(pkg: str, schedule) -> list:
    """Schedule each (delay before scheduling, duration, height, round,
    step) in order; the timeouts fired, in order."""
    msgs = port_msgs if pkg == "port" else jax_msgs
    cls = TimeoutTicker if pkg == "port" else JaxTicker

    async def go():
        t = cls()
        await t.start()
        fired = []
        for wait, dur, h, r, s in schedule:
            await asyncio.sleep(wait)
            t.schedule(msgs.TimeoutInfo(duration_s=dur, height=h, round=r, step=s))
        await asyncio.sleep(0.3)
        while not t.timeout_queue.empty():
            ti = t.timeout_queue.get_nowait()
            fired.append((ti.height, ti.round, ti.step))
        await t.stop()
        return fired

    return run(go())


@pytest.mark.parametrize(
    "schedule, want",
    [
        # fires, and a stale (older) schedule is ignored
        ([(0, 0.02, 5, 0, 3), (0, 0.01, 4, 0, 3)], [(5, 0, 3)]),
        # a newer step replaces the pending one
        ([(0, 0.2, 5, 0, 3), (0, 0.02, 5, 0, 4)], [(5, 0, 4)]),
        # the same step again is ignored while pending; after firing, it schedules
        ([(0, 0.02, 5, 1, 3), (0, 0.01, 5, 1, 3), (0.08, 0.01, 5, 1, 3)], [(5, 1, 3), (5, 1, 3)]),
        # a newer round and height replace
        ([(0, 0.2, 5, 0, 6), (0, 0.05, 5, 1, 1), (0, 0.02, 6, 0, 1)], [(6, 0, 1)]),
    ],
)
def test_ticker_fires_as_jax(schedule, want):
    assert _ticker_run("port", schedule) == _ticker_run("jax", schedule) == want
