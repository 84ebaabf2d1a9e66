"""Per-route circuit breakers for the device offload paths.

Counterpart: tendermint_tpu/crypto/breaker.py:78-378 (`CircuitBreaker`,
`breaker_for`, `fresh`, `discard`, `reset_all`). Every device entry
point of crypto/gpu_verifier.py (the ed25519 and sr25519 batch
factories, the sr25519 single-verify route, the streaming dispatch)
consults a named breaker, and a tripped breaker sends new work to the
CPU factories with no device touch and no per-call warning.

    CLOSED --failure--> OPEN --backoff elapsed--> HALF_OPEN
      ^                  ^                            |
      |                  +--------probe failed--------+
      +-------------------probe succeeded-------------+

- OPEN serves every caller the CPU at once; nobody waits.
- Re-arming is probed by one background thread, never by the callers:
  with a probe function set, `allow()` answers False through HALF_OPEN
  and the single-flight probe decides. Without one, HALF_OPEN hands one
  caller a ticket per backoff interval.
- The backoff is exponential (base x 2^(trips - 1), capped), so a dead
  device converges to one cheap probe per cap interval.

`stats()` carries the state as an integer (`code`: 0 closed, 1 open, 2
half-open) beside the trip and probe counts, and the JAX family on
libs/metrics.DEFAULT_REGISTRY publishes the same (:61-75): the gauge
`breaker_state` and the counters `breaker_trips_total` and
`breaker_probes_total`, labelled by the breaker's `name`. The JAX
package reads the base backoff from TM_TPU_BREAKER_BACKOFF_S; here it is
an argument (10 s).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional

from ..libs import metrics as M

__all__ = [
    "CLOSED",
    "HALF_OPEN",
    "OPEN",
    "STATE_CODE",
    "CircuitBreaker",
    "breaker_for",
    "discard",
    "fresh",
    "reset_all",
]

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"

STATE_CODE = {CLOSED: 0, OPEN: 1, HALF_OPEN: 2}

_m_state = M.new_gauge(
    "breaker", "state",
    "Circuit-breaker state (0 closed, 1 open, 2 half-open).",
    label_names=("name",),
)
_m_trips = M.new_counter(
    "breaker", "trips_total",
    "Circuit-breaker transitions into OPEN.",
    label_names=("name",),
)
_m_probes = M.new_counter(
    "breaker", "probes_total",
    "Circuit-breaker re-arm probes launched.",
    label_names=("name",),
)


class CircuitBreaker:
    """One route's breaker. Thread-safe; cheap when CLOSED (one lock +
    one compare per allow())."""

    def __init__(
        self,
        name: str,
        backoff_base_s: Optional[float] = None,
        backoff_max_s: float = 300.0,
        probe: Optional[Callable[[], bool]] = None,
        start_open: bool = False,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.name = name
        self.backoff_base_s = 10.0 if backoff_base_s is None else backoff_base_s
        self.backoff_max_s = backoff_max_s
        self._probe_fn = probe
        self._clock = clock
        self._lock = threading.Lock()
        self._state = OPEN if start_open else CLOSED
        self._trips = 0  # consecutive OPEN entries (backoff exponent)
        # a cold (start_open) breaker waits a full base backoff before
        # admitting any caller-probe: only probe_now() — install()'s
        # deliberate warm-up — may touch the device sooner
        self._retry_at = self._clock() + (
            self.backoff_base_s if start_open else 0.0
        )
        self._probe_thread: Optional[threading.Thread] = None
        self._probe_timer: Optional[threading.Timer] = None
        self._half_open_ticket = False  # probe-less mode: one admission
        self._ticket_at = float("-inf")  # when the last ticket went out
        # bumped by operator overrides (open_now/close_now): a probe
        # launched before the override must not publish over it
        self._probe_gen = 0
        self._probes = 0
        _m_state.set(STATE_CODE[self._state], name=self.name)

    # -- introspection --

    def state(self) -> str:
        with self._lock:
            return self._state

    def stats(self) -> dict:
        with self._lock:
            return {
                "state": self._state,
                "code": STATE_CODE[self._state],
                "trips": self._trips,
                "probes": self._probes,
                "retry_in_s": max(0.0, self._retry_at - self._clock()),
            }

    def probe_in_flight(self) -> bool:
        with self._lock:
            t = self._probe_thread
        return t is not None and t.is_alive()

    # -- configuration --

    def set_probe(self, fn: Optional[Callable[[], bool]]) -> None:
        """Install the background re-arm probe (device-touching; must
        return truthy on success and never block forever — wrap device
        calls in the same gather deadline the hot path uses)."""
        with self._lock:
            self._probe_fn = fn

    def configure(self, backoff_base_s=None, backoff_max_s=None) -> None:
        with self._lock:
            if backoff_base_s is not None:
                self.backoff_base_s = backoff_base_s
            if backoff_max_s is not None:
                self.backoff_max_s = backoff_max_s

    # -- the gate --

    def allow(self) -> bool:
        """True when callers may route to the device. OPEN/HALF_OPEN
        answer False when a probe fn is configured (traffic never
        pilots a possibly-wedged device — the probe does); without one,
        HALF_OPEN admits one caller per backoff interval, who SHOULD
        report back via record_success()/record_failure(). A ticket
        whose holder never reports (its work got rerouted, its process
        path died) expires after the current backoff and a fresh one
        is issued — the half-open state can stall the route, never
        wedge it."""
        kick = False
        with self._lock:
            if self._state == CLOSED:
                return True
            now = self._clock()
            if self._state == OPEN and now >= self._retry_at:
                self._set_state(HALF_OPEN)
                if self._probe_fn is not None:
                    kick = True
                else:
                    self._half_open_ticket = True
            if self._state == HALF_OPEN and self._probe_fn is None:
                if self._half_open_ticket or (
                    now - self._ticket_at >= self._backoff_s()
                ):
                    self._half_open_ticket = False
                    self._ticket_at = now
                    return True
                return False
            if kick:
                self._kick_probe_locked()
        return False

    def _backoff_s(self) -> float:
        """Current backoff window (call with the lock held)."""
        return min(
            self.backoff_base_s * (2 ** max(self._trips - 1, 0)),
            self.backoff_max_s,
        )

    def record_success(self) -> None:
        """A device interaction completed correctly: HALF_OPEN (ticket
        holder or probe) closes the breaker; CLOSED stays closed and
        resets the backoff exponent."""
        with self._lock:
            self._record_success_locked()

    def _record_success_locked(self) -> None:
        self._trips = 0
        if self._state != CLOSED:
            self._set_state(CLOSED)
        self._cancel_timer_locked()

    def record_failure(self) -> None:
        """A device interaction faulted: open (or re-open) with
        exponential backoff. When a probe fn is configured, the next
        probe is timer-scheduled at backoff expiry so the route re-arms
        even with no traffic poking allow()."""
        with self._lock:
            self._record_failure_locked()

    def _record_failure_locked(self) -> None:
        self._trips += 1
        backoff = self._backoff_s()
        self._retry_at = self._clock() + backoff
        self._half_open_ticket = False
        self._set_state(OPEN)
        _m_trips.inc(name=self.name)
        if self._probe_fn is not None:
            self._schedule_probe_locked(backoff)

    def probe_now(self) -> None:
        """Launch the single-flight probe immediately (install-time
        warm-up of a start_open breaker)."""
        with self._lock:
            if self._state == OPEN:
                self._set_state(HALF_OPEN)
            self._kick_probe_locked()

    def close_now(self) -> None:
        """Force CLOSED (tests; operator override). Retires any probe
        already in flight: its verdict must not land on top of an
        explicit operator decision."""
        with self._lock:
            self._probe_gen += 1
            self._record_success_locked()

    def open_now(self, backoff_s: Optional[float] = None) -> None:
        """Force OPEN without scheduling a probe timer (bench's
        degraded-mode row; operator kill switch). `backoff_s` defaults
        to the max backoff so the route stays down until re-armed.
        Retires any in-flight probe — a probe that launched before the
        override succeeded against the device must NOT silently close
        the breaker the operator just ordered open."""
        with self._lock:
            self._probe_gen += 1
            self._retry_at = self._clock() + (
                self.backoff_max_s if backoff_s is None else backoff_s
            )
            self._half_open_ticket = False
            self._cancel_timer_locked()
            if self._state != OPEN:
                self._trips += 1
                self._set_state(OPEN)
                _m_trips.inc(name=self.name)

    # -- internals (call with self._lock held) --

    def _set_state(self, state: str) -> None:
        self._state = state
        _m_state.set(STATE_CODE[state], name=self.name)

    def _cancel_timer_locked(self) -> None:
        if self._probe_timer is not None:
            self._probe_timer.cancel()
            self._probe_timer = None

    def _schedule_probe_locked(self, delay_s: float) -> None:
        """One timer per OPEN window; a newer failure replaces it (the
        old 10-second probe-delay policy: a wedge is never re-touched
        instantly, and never by more than one thread)."""
        self._cancel_timer_locked()
        t = threading.Timer(delay_s, self._timer_fired)
        t.daemon = True
        t.name = f"breaker-retry-{self.name}"
        self._probe_timer = t
        t.start()

    def _timer_fired(self) -> None:
        with self._lock:
            self._probe_timer = None
            if self._state != OPEN or self._clock() < self._retry_at:
                return
            self._set_state(HALF_OPEN)
            self._kick_probe_locked()

    def _kick_probe_locked(self) -> None:
        if self._probe_fn is None:
            return
        if self._probe_thread is not None and self._probe_thread.is_alive():
            return  # single-flight: alive-check and publish share the lock
        self._probes += 1
        _m_probes.inc(name=self.name)
        gen = self._probe_gen
        t = threading.Thread(
            target=self._run_probe,
            args=(gen,),
            daemon=True,
            name=f"breaker-probe-{self.name}",
        )
        self._probe_thread = t
        t.start()

    def _run_probe(self, gen: int) -> None:
        try:
            ok = bool(self._probe_fn())
        except Exception:  # a probe failure is data, never fatal
            ok = False
        # generation check and state mutation under ONE lock hold: an
        # operator override (open_now/close_now) landing between them
        # would otherwise be silently overwritten by this verdict
        with self._lock:
            if gen != self._probe_gen:
                return  # superseded by an operator override
            if ok:
                self._record_success_locked()
            else:
                self._record_failure_locked()


# -- registry ---------------------------------------------------------

_REGISTRY: Dict[str, CircuitBreaker] = {}
_REG_LOCK = threading.Lock()


def breaker_for(name: str, **kwargs) -> CircuitBreaker:
    """The process-wide breaker for a route, created on first use with
    `kwargs` (later calls return the live instance unchanged)."""
    with _REG_LOCK:
        b = _REGISTRY.get(name)
        if b is None:
            b = _REGISTRY[name] = CircuitBreaker(name, **kwargs)
        return b


def fresh(name: str, **kwargs) -> CircuitBreaker:
    """Replace the registered breaker with a new instance: a new
    install() generation. A stale in-flight probe finishes against the
    orphaned object, which nobody consults any more."""
    with _REG_LOCK:
        old = _REGISTRY.pop(name, None)
        if old is not None:
            with old._lock:
                old._cancel_timer_locked()
        b = _REGISTRY[name] = CircuitBreaker(name, **kwargs)
        return b


def discard(name: str) -> None:
    with _REG_LOCK:
        old = _REGISTRY.pop(name, None)
    if old is not None:
        with old._lock:
            old._cancel_timer_locked()


def reset_all() -> None:
    """Drop every breaker (tests)."""
    with _REG_LOCK:
        names = list(_REGISTRY)
    for n in names:
        discard(n)
