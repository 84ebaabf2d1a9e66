"""Injectable device faults: seeded, scoped chaos at the device seam.

Counterpart: tendermint_tpu/crypto/faults.py, trimmed to what the port's
device verifier, WAL, signer, p2p router and transports, RPC dispatch
and their tests use: `DeviceFault` and `DeviceTimeout` (:120-130), `Rule` (:139-215,
the point, mode, probability, seed, budget, hang length and key filter,
and the network filters src, dst and ch), the label match and `NetPlan`
(:221-270), `armed` (:273) and `net_armed` (:288), `inject` and
`reset` (:397-440), `set_partition`, `partition_blocked` and `net_plan`
(:443-548), `rules` (:551), `fire`, `mangle` and `clip` (:556-614), the
TM_TPU_FAULT environment spec (`load_env` :297, `_parse_rule` :346) and
the partition file's poll (`_poll_partition_file_locked` :465).

Rules are armed in-process through inject() and set_partition(), or for
a whole process (an e2e child, an operator's command) from the
environment, with the JAX package's variable names and grammar, so that
one e2e manifest arms the children of either package:

    TM_TPU_FAULT="gpu.dispatch:raise:p=0.3:seed=7;gpu.gather:hang:hang_s=0.5"
    TM_TPU_FAULT="p2p.send:drop:p=0.4:seed=7:src=load0:dst=load1:ch=34"
    TM_TPU_PARTITION="load0,load1|load2,load3"
    TM_TPU_PARTITION_FILE=/path/to/spec   (re-read when it changes)

A rule is `point:mode[:p=..][:seed=..][:times=..][:hang_s=..][:key=..]
[:src=..][:dst=..][:ch=..][:delay_s=..][:dup=..]`. The spec is parsed on
the first armed() or net_armed() call; a malformed spec raises there once
and leaves the plane disarmed (all or none of its rules arm). The point
names are the port's: a JAX `tpu.dispatch` or `tpu.gather` rule parses
and arms, but no point of the port consults it, so it never fires.

Fault points are named strings consulted where a device or a disk would
fail:

    gpu.dispatch   crypto/gpu_verifier.py, before every window's launch
    gpu.gather     crypto/gpu_verifier.py, inside the gather (under its
                   deadline) and on the bitmap it returns
    wal.write      consensus/wal.py, the framed append (short writes)
    wal.fsync      consensus/wal.py, every fsync (rotation included)
    privval.save   privval/file.py, the last-sign-state checkpoint,
                   keyed by the node home's basename
    p2p.send       p2p/router.py _send_peer, (src, dst, ch): outbound
                   link faults a direction and channel
    p2p.recv       p2p/router.py _recv_peer, (src, dst, ch): inbound
                   link faults (src is the remote peer)
    p2p.dial       p2p/transport.py dial(), (src, dst)
    rpc.route      rpc/jsonrpc.py, before every route's handler, keyed
                   by the method

Modes:

    raise       the point raises DeviceFault (a launch error's stand-in)
    hang        the point sleeps `hang_s`; under the gather deadline
                this surfaces as DeviceTimeout
    misshape    mangle() drops the last lane (a wrong-shaped bitmap)
    bitflip     mangle() inverts one seeded lane (silent corruption)
    io_error    the point raises OSError (an fsync failure)
    short_write clip() keeps a seeded strict prefix of the buffer (the
                torn record a crash mid-write leaves)

Network modes, consulted through net_plan() and carried out by the
router and the transports (the plane never sleeps the event loop):

    drop        the message or dial is discarded
    delay       the caller sleeps `delay_s` before going on
    duplicate   the message is delivered `dup` extra times
    reorder     the message is held and swapped behind its successor

`src` and `dst` match a node's net labels (moniker, node ID, listen
host) exactly, or as a prefix when the member is 8 or more hex digits
(a node-ID prefix). A partition (set_partition("a,b|c,d"), TM_TPU_PARTITION, or the file named by
TM_TPU_PARTITION_FILE, stat()ed at most every 0.2 s) cuts every send,
receive and dial between members of different groups. A missing or
unreadable file is no partition, so deleting it heals the net.

Every rule owns a `random.Random(seed)`, so whether a consult fires is a
function of (seed, consult index) alone. `inject()` arms a rule for the
duration of its scope. With no rule armed, the hot path pays one
module-level boolean (`armed()`).
"""

from __future__ import annotations

import contextlib
import os
import random
import threading
import time
from typing import List, Optional

__all__ = [
    "DeviceFault",
    "DeviceTimeout",
    "NetPlan",
    "Rule",
    "armed",
    "clip",
    "fire",
    "inject",
    "load_env",
    "mangle",
    "net_armed",
    "net_plan",
    "partition_blocked",
    "partition_spec",
    "reset",
    "rules",
    "set_partition",
]


class DeviceFault(RuntimeError):
    """A device dispatch or gather failed: what the plane raises, and
    what crypto/gpu_verifier.py raises for faults it detects itself (a
    mis-shaped bitmap, a disproven lane)."""


class DeviceTimeout(DeviceFault):
    """A gather exceeded its deadline (a hung device)."""


_CONTROL_MODES = ("raise", "hang", "io_error")
_DATA_MODES = ("misshape", "bitflip")
_CLIP_MODES = ("short_write",)
_NET_MODES = ("drop", "delay", "duplicate", "reorder")


class Rule:
    """One armed fault: a point, a mode, and a seeded generator that
    decides which consults fire."""

    def __init__(
        self,
        point: str,
        mode: str,
        p: float = 1.0,
        seed: int = 0,
        times: Optional[int] = None,
        hang_s: float = 30.0,
        key: Optional[str] = None,
        src: Optional[str] = None,
        dst: Optional[str] = None,
        ch: Optional[int] = None,
        delay_s: float = 0.05,
        dup: int = 1,
    ) -> None:
        if mode not in _CONTROL_MODES + _DATA_MODES + _CLIP_MODES + _NET_MODES:
            raise ValueError(f"unknown fault mode {mode!r}")
        self.point = point
        self.mode = mode
        self.p = float(p)
        self.seed = int(seed)
        self.times = times  # None: unlimited
        self.hang_s = float(hang_s)
        self.key = key  # key-type filter (None: any)
        # the network filters and knobs (p2p.* points; None: any)
        self.src = src
        self.dst = dst
        self.ch = int(ch) if ch is not None else None
        self.delay_s = float(delay_s)
        self.dup = int(dup)
        self.rng = random.Random(self.seed)
        self.fired = 0  # consults that faulted
        self.from_env = False  # armed by load_env()

    def _matches(self, point: str, key: Optional[str]) -> bool:
        if self.point != point:
            return False
        return self.key is None or key is None or self.key == key

    def _matches_net(self, point: str, src_labels: tuple, dst_labels: tuple,
                     ch: Optional[int]) -> bool:
        if self.point != point:
            return False
        if self.ch is not None and ch is not None and self.ch != ch:
            return False
        if self.src is not None and not _label_match(self.src, src_labels):
            return False
        if self.dst is not None and not _label_match(self.dst, dst_labels):
            return False
        return True

    def _roll(self) -> bool:
        """One seeded decision; the generator advances on every matching
        consult, fired or not."""
        if self.times is not None and self.fired >= self.times:
            return False
        if self.p < 1.0 and self.rng.random() >= self.p:
            return False
        self.fired += 1
        return True

    def __repr__(self) -> str:
        return (
            f"Rule({self.point}:{self.mode} p={self.p} seed={self.seed} "
            f"fired={self.fired})"
        )


_HEX_DIGITS = frozenset("0123456789abcdef")


def _label_match(member: str, labels: tuple) -> bool:
    """A member names a node if it equals one of its labels, or, only
    when it looks like a node-ID prefix (8 or more lowercase hex digits),
    prefixes one: "validator1" never matches "validator10"."""
    id_prefix = len(member) >= 8 and all(c in _HEX_DIGITS for c in member)
    for label in labels:
        if member == label:
            return True
        if id_prefix and label.startswith(member):
            return True
    return False


class NetPlan:
    """What every network rule that fired at one consult asks of the
    router or transport for this message or dial."""

    __slots__ = ("drop", "delay_s", "dup", "reorder")

    def __init__(self) -> None:
        self.drop = False
        self.delay_s = 0.0
        self.dup = 0  # extra copies to deliver
        self.reorder = False

    def __repr__(self) -> str:
        return (
            f"NetPlan(drop={self.drop} delay_s={self.delay_s} "
            f"dup={self.dup} reorder={self.reorder})"
        )


_RULES: List[Rule] = []
_LOCK = threading.Lock()
_ARMED = False  # mirrors bool(_RULES); read without the lock
_NET_ARMED = False  # a p2p rule or a partition is live; ditto
# the partition's groups of net-label members: links between members of
# different groups are cut; replaced whole by set_partition
_PARTITION: List[List[str]] = []
_PARTITION_SPEC = ""
_ENV_LOADED = False
_PARTITION_FILE: Optional[str] = None
_PARTITION_FILE_SIG: Optional[tuple] = None  # (mtime_ns, size)
_PARTITION_NEXT_POLL = 0.0
_PARTITION_POLL_S = 0.2  # the file form's stat() throttle


def armed() -> bool:
    """False when no rule is armed: then no fault code runs at all. The
    environment is parsed on the first call."""
    if not _ENV_LOADED:
        load_env()
    return _ARMED


def net_armed() -> bool:
    """False when no network rule and no partition is live: then the
    router and transports run no fault code."""
    if not _ENV_LOADED:
        load_env()
    return _NET_ARMED


def _refresh() -> None:
    global _ARMED, _NET_ARMED
    _ARMED = bool(_RULES)
    _NET_ARMED = (
        bool(_PARTITION)
        or _PARTITION_FILE is not None
        or any(r.point.startswith("p2p.") for r in _RULES)
    )


def load_env() -> None:
    """(Re-)parse TM_TPU_FAULT into armed rules, and TM_TPU_PARTITION and
    TM_TPU_PARTITION_FILE into the partition. Rules from an earlier load
    are dropped first; inject() rules stay. A malformed spec raises, arms
    none of its rules, and still latches, so that the next armed() runs
    disarmed instead of parsing and raising again."""
    global _ENV_LOADED, _PARTITION_SPEC, _PARTITION_FILE
    global _PARTITION_FILE_SIG, _PARTITION_NEXT_POLL
    spec = os.environ.get("TM_TPU_FAULT", "")
    with _LOCK:
        _RULES[:] = [r for r in _RULES if not r.from_env]
        try:
            # the partition first: a malformed TM_TPU_FAULT leaves it armed
            _PARTITION_SPEC = os.environ.get("TM_TPU_PARTITION", "")
            _PARTITION[:] = _parse_partition(_PARTITION_SPEC)
            _PARTITION_FILE = os.environ.get("TM_TPU_PARTITION_FILE") or None
            _PARTITION_FILE_SIG = None
            _PARTITION_NEXT_POLL = 0.0
            parsed = []
            for part in spec.split(";"):
                part = part.strip()
                if part:
                    rule = _parse_rule(part)
                    rule.from_env = True
                    parsed.append(rule)
            _RULES.extend(parsed)
        finally:
            _refresh()
            _ENV_LOADED = True


_FLOAT_OPTS = ("p", "hang_s", "delay_s")
_INT_OPTS = ("seed", "times", "ch", "dup")
_STR_OPTS = ("key", "src", "dst")


def _parse_rule(spec: str) -> Rule:
    """`point:mode[:name=value]...`, the options of Rule."""
    fields = spec.split(":")
    if len(fields) < 2:
        raise ValueError(f"bad TM_TPU_FAULT rule {spec!r} (want point:mode)")
    kwargs = {}
    for opt in fields[2:]:
        if "=" not in opt:
            raise ValueError(f"bad fault option {opt!r} in {spec!r}")
        k, v = opt.split("=", 1)
        if k in _FLOAT_OPTS:
            kwargs[k] = float(v)
        elif k in _INT_OPTS:
            kwargs[k] = int(v)
        elif k in _STR_OPTS:
            kwargs[k] = v
        else:
            raise ValueError(f"unknown fault option {k!r} in {spec!r}")
    return Rule(fields[0], fields[1], **kwargs)


@contextlib.contextmanager
def inject(
    point: str,
    mode: str,
    p: float = 1.0,
    seed: int = 0,
    times: Optional[int] = None,
    hang_s: float = 30.0,
    key: Optional[str] = None,
    src: Optional[str] = None,
    dst: Optional[str] = None,
    ch: Optional[int] = None,
    delay_s: float = 0.05,
    dup: int = 1,
):
    """Arm one rule for the scope; yields it, so the caller can read how
    often it fired."""
    rule = Rule(point, mode, p=p, seed=seed, times=times, hang_s=hang_s, key=key,
                src=src, dst=dst, ch=ch, delay_s=delay_s, dup=dup)
    with _LOCK:
        _RULES.append(rule)
        _refresh()
    try:
        yield rule
    finally:
        with _LOCK:
            if rule in _RULES:
                _RULES.remove(rule)
            _refresh()


def reset() -> None:
    """Disarm every rule and heal the partition, the file form too."""
    global _PARTITION_SPEC, _PARTITION_FILE, _PARTITION_FILE_SIG
    with _LOCK:
        _RULES.clear()
        _PARTITION.clear()
        _PARTITION_SPEC = ""
        _PARTITION_FILE = None
        _PARTITION_FILE_SIG = None
        _refresh()


def _parse_partition(spec: str) -> List[List[str]]:
    """"a,b|c,d" -> [[a, b], [c, d]]; "" is no partition."""
    groups: List[List[str]] = []
    for part in spec.split("|"):
        members = [m.strip() for m in part.split(",") if m.strip()]
        if members:
            groups.append(members)
    return groups


def set_partition(spec: str) -> None:
    """Install the partition's groups (or heal it with "")."""
    global _PARTITION_SPEC
    if not _ENV_LOADED:
        load_env()  # else a later first load would overwrite this spec
    groups = _parse_partition(spec)
    with _LOCK:
        _PARTITION[:] = groups
        _PARTITION_SPEC = spec
        _refresh()


def partition_spec() -> str:
    with _LOCK:
        return _PARTITION_SPEC


def _poll_partition_file_locked() -> None:
    """Re-read TM_TPU_PARTITION_FILE when its (mtime, size) changed,
    stat()ing it at most every _PARTITION_POLL_S. Callers hold _LOCK."""
    global _PARTITION_FILE_SIG, _PARTITION_NEXT_POLL, _PARTITION_SPEC
    now = time.monotonic()
    if now < _PARTITION_NEXT_POLL:
        return
    _PARTITION_NEXT_POLL = now + _PARTITION_POLL_S
    try:
        st = os.stat(_PARTITION_FILE)
        sig = (st.st_mtime_ns, st.st_size)
        if sig == _PARTITION_FILE_SIG:
            return
        with open(_PARTITION_FILE, "r") as f:
            spec = f.read().strip()
        _PARTITION_FILE_SIG = sig
    except OSError:
        _PARTITION_FILE_SIG = None
        spec = ""
    _PARTITION[:] = _parse_partition(spec)
    _PARTITION_SPEC = spec


def _group_of(labels: tuple) -> Optional[int]:
    for i, group in enumerate(_PARTITION):
        for member in group:
            if _label_match(member, labels):
                return i
    return None


def partition_blocked(src_labels: tuple, dst_labels: tuple) -> bool:
    """True when the partition cuts the src -> dst link: both ends are
    named, in different groups. Callers gate on net_armed()."""
    with _LOCK:
        if _PARTITION_FILE is not None:
            _poll_partition_file_locked()
        if not _PARTITION:
            return False
        a = _group_of(src_labels)
        if a is None:
            return False
        b = _group_of(dst_labels)
        return b is not None and a != b


def net_plan(point: str, src: tuple = (), dst: tuple = (),
             ch: Optional[int] = None) -> Optional[NetPlan]:
    """Consult the network rules at a p2p point: None when nothing
    fired, else the combined plan. Each matching rule's generator
    advances once a consult, fired or not. Callers gate on
    net_armed()."""
    plan: Optional[NetPlan] = None
    with _LOCK:
        for r in _RULES:
            if r.mode not in _NET_MODES:
                continue
            if not r._matches_net(point, src, dst, ch):
                continue
            if not r._roll():
                continue
            if plan is None:
                plan = NetPlan()
            if r.mode == "drop":
                plan.drop = True
            elif r.mode == "delay":
                plan.delay_s = max(plan.delay_s, r.delay_s)
            elif r.mode == "duplicate":
                plan.dup += max(r.dup, 0)
            elif r.mode == "reorder":
                plan.reorder = True
    return plan


def rules() -> List[Rule]:
    """The armed rules, a copy."""
    with _LOCK:
        return list(_RULES)


def fire(point: str, key: Optional[str] = None) -> None:
    """Consult the control modes at a point: may raise DeviceFault
    (`raise`) or OSError (`io_error`), or sleep (`hang`). Callers gate on
    armed()."""
    with _LOCK:
        actions = [
            r for r in _RULES
            if r.mode in _CONTROL_MODES and r._matches(point, key) and r._roll()
        ]
    for r in actions:
        if r.mode == "raise":
            raise DeviceFault(f"injected device fault at {point} (seed={r.seed})")
        if r.mode == "io_error":
            raise OSError(f"injected I/O fault at {point} (seed={r.seed})")
        time.sleep(r.hang_s)  # "hang": the wedged device under test


def mangle(point: str, bits: list, key: Optional[str] = None) -> list:
    """Apply the data modes to a gathered bitmap: `misshape` drops the
    last lane, `bitflip` inverts one seeded lane. Callers gate on
    armed()."""
    with _LOCK:
        actions = [
            r for r in _RULES
            if r.mode in _DATA_MODES and r._matches(point, key) and r._roll()
        ]
    for r in actions:
        if r.mode == "misshape" and bits:
            bits = bits[:-1]
        elif r.mode == "bitflip" and bits:
            i = r.rng.randrange(len(bits))
            bits = list(bits)
            bits[i] = not bits[i]
    return bits


def clip(point: str, data: bytes) -> bytes:
    """Apply `short_write` at a point: a seeded strict prefix of data,
    the shape a crash mid-write leaves on disk. Callers gate on
    armed()."""
    with _LOCK:
        actions = [
            r for r in _RULES
            if r.mode in _CLIP_MODES and r._matches(point, None) and r._roll()
        ]
    for r in actions:
        data = data[: r.rng.randrange(len(data))] if data else data
    return data
