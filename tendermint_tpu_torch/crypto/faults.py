"""Injectable device faults: seeded, scoped chaos at the device seam.

Counterpart: tendermint_tpu/crypto/faults.py, trimmed to what the port's
device verifier, WAL, signer and their tests use: `DeviceFault` and
`DeviceTimeout` (:120-130), `Rule` (:139-215, the point, mode,
probability, seed, budget, hang length and key filter), `armed` (:273),
`inject` and `reset` (:397-440), `fire`, `mangle` and `clip`
(:556-614). The network plan, partitions and the TM_TPU_FAULT
environment spec stay out: the port has no network or process boundary
to arm across yet.

Fault points are named strings consulted where a device or a disk would
fail:

    gpu.dispatch   crypto/gpu_verifier.py, before every window's launch
    gpu.gather     crypto/gpu_verifier.py, inside the gather (under its
                   deadline) and on the bitmap it returns
    wal.write      consensus/wal.py, the framed append (short writes)
    wal.fsync      consensus/wal.py, every fsync (rotation included)
    privval.save   privval/file.py, the last-sign-state checkpoint,
                   keyed by the node home's basename

Modes:

    raise       the point raises DeviceFault (a launch error's stand-in)
    hang        the point sleeps `hang_s`; under the gather deadline
                this surfaces as DeviceTimeout
    misshape    mangle() drops the last lane (a wrong-shaped bitmap)
    bitflip     mangle() inverts one seeded lane (silent corruption)
    io_error    the point raises OSError (an fsync failure)
    short_write clip() keeps a seeded strict prefix of the buffer (the
                torn record a crash mid-write leaves)

Every rule owns a `random.Random(seed)`, so whether a consult fires is a
function of (seed, consult index) alone. `inject()` arms a rule for the
duration of its scope. With no rule armed, the hot path pays one
module-level boolean (`armed()`).
"""

from __future__ import annotations

import contextlib
import random
import threading
import time
from typing import List, Optional

__all__ = [
    "DeviceFault",
    "DeviceTimeout",
    "Rule",
    "armed",
    "clip",
    "fire",
    "inject",
    "mangle",
    "reset",
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
    ) -> None:
        if mode not in _CONTROL_MODES + _DATA_MODES + _CLIP_MODES:
            raise ValueError(f"unknown fault mode {mode!r}")
        self.point = point
        self.mode = mode
        self.p = float(p)
        self.seed = int(seed)
        self.times = times  # None: unlimited
        self.hang_s = float(hang_s)
        self.key = key  # key-type filter (None: any)
        self.rng = random.Random(self.seed)
        self.fired = 0  # consults that faulted

    def _matches(self, point: str, key: Optional[str]) -> bool:
        if self.point != point:
            return False
        return self.key is None or key is None or self.key == key

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


_RULES: List[Rule] = []
_LOCK = threading.Lock()
_ARMED = False  # mirrors bool(_RULES); read without the lock


def armed() -> bool:
    """False when no rule is armed: then no fault code runs at all."""
    return _ARMED


def _refresh() -> None:
    global _ARMED
    _ARMED = bool(_RULES)


@contextlib.contextmanager
def inject(
    point: str,
    mode: str,
    p: float = 1.0,
    seed: int = 0,
    times: Optional[int] = None,
    hang_s: float = 30.0,
    key: Optional[str] = None,
):
    """Arm one rule for the scope; yields it, so the caller can read how
    often it fired."""
    rule = Rule(point, mode, p=p, seed=seed, times=times, hang_s=hang_s, key=key)
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
    """Disarm every rule."""
    with _LOCK:
        _RULES.clear()
        _refresh()


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
