"""TimeoutTicker: schedules the step machine's timeouts.

Counterpart: tendermint_tpu/consensus/ticker.py:1-63 (reference:
internal/consensus/ticker.go). One pending timeout at a time: a newer
(height, round, step) replaces it, an older one is ignored. A fired
timeout lands on an asyncio queue the receive loop consumes.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Optional

from ..libs.service import Service
from .msgs import TimeoutInfo

__all__ = ["TimeoutTicker"]


class TimeoutTicker(Service):
    def __init__(self) -> None:
        super().__init__(name="ticker", logger=logging.getLogger(__name__))
        self._out: "asyncio.Queue[TimeoutInfo]" = asyncio.Queue()
        self._pending: Optional[TimeoutInfo] = None
        self._timer: Optional[asyncio.Task] = None

    @property
    def timeout_queue(self) -> "asyncio.Queue[TimeoutInfo]":
        return self._out

    async def on_stop(self) -> None:
        self._stop_timer()

    def schedule(self, ti: TimeoutInfo) -> None:
        """Schedule ti unless something newer is pending (reference:
        ticker.go:92-126 timeoutRoutine)."""
        cur = self._pending
        if cur is not None:
            if ti.height < cur.height:
                return
            if ti.height == cur.height:
                if ti.round < cur.round:
                    return
                if ti.round == cur.round and cur.step > 0 and ti.step <= cur.step:
                    return
        self._stop_timer()
        self._pending = ti
        self._timer = self.spawn(self._fire_after(ti), "timeout-timer")

    def _stop_timer(self) -> None:
        if self._timer is not None and not self._timer.done():
            self._timer.cancel()
        self._timer = None
        # drop finished timers, so _tasks does not grow a round
        self._tasks = [t for t in self._tasks if not t.done()]

    async def _fire_after(self, ti: TimeoutInfo) -> None:
        await asyncio.sleep(ti.duration_s)
        self.logger.debug("timed out %r", ti)
        if self._pending is ti:
            self._pending = None
        self._out.put_nowait(ti)
