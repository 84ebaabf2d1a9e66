"""The Service lifecycle: start once, stop once, wait for the end.

Counterpart: tendermint_tpu/libs/service.py:24-152 (reference:
libs/service/service.go:24-49), asyncio-native: a Service owns tasks,
cancelled on stop. Left out: the profiler's task labels (the port has no
host profiler).
"""

from __future__ import annotations

import asyncio
import logging
from typing import Coroutine, Optional

__all__ = ["Service", "ServiceError"]


class ServiceError(Exception):
    pass


class Service:
    """Base class for long-running components.

    Subclasses override `on_start` (spawn tasks via `self.spawn`) and
    optionally `on_stop` (cleanup before task cancellation).
    """

    def __init__(self, name: str = "", logger: Optional[logging.Logger] = None) -> None:
        self.name = name or type(self).__name__
        self.logger = logger or logging.getLogger(f"tendermint_tpu_torch.{self.name}")
        self._started = False
        self._stopped = False
        self._tasks: list[asyncio.Task] = []
        self._pending_stop: Optional[asyncio.Task] = None
        self._done = asyncio.Event()

    # -- lifecycle --

    @property
    def is_running(self) -> bool:
        return self._started and not self._stopped

    async def start(self) -> None:
        if self._started:
            raise ServiceError(f"{self.name}: already started")
        if self._stopped:
            raise ServiceError(f"{self.name}: already stopped; cannot restart")
        self._started = True
        self.logger.info("starting service")
        try:
            await self.on_start()
        except Exception:
            self._stopped = True
            await self._cancel_tasks()
            self._done.set()
            raise

    async def stop(self) -> None:
        if not self._started or self._stopped:
            if self._stopped:
                # A concurrent stop() is (or was) draining tasks; don't
                # return until teardown actually finished.
                await self._done.wait()
            return
        self._stopped = True
        self.logger.info("stopping service")
        try:
            await self.on_stop()
        finally:
            await self._cancel_tasks()
            self._done.set()

    async def _cancel_tasks(self) -> None:
        pending = [t for t in self._tasks if not t.done()]
        while pending:
            for task in pending:
                task.cancel()
            # Python 3.10's asyncio.wait_for can swallow a cancellation
            # that races its inner future completing (bpo-42130 family,
            # rewritten in 3.11) — a task parked in such a wait_for
            # survives one cancel and its retry loop runs forever, so a
            # single cancel+gather would hang stop(). Re-cancel until
            # every task actually finishes.
            await asyncio.wait(pending, timeout=1.0)
            # re-derive from _tasks, not the wait() leftovers: a task
            # that slipped through an await completing during this
            # sweep can spawn NEW tasks (e.g. an accept finishing its
            # handshake mid-stop) — the final gather below must never
            # wait on a task nothing cancelled
            pending = [t for t in self._tasks if not t.done()]
        # return_exceptions keeps a cancellation of stop() itself
        # propagating while swallowing the tasks' own CancelledErrors
        # (and retrieving real exceptions so none log as unretrieved).
        await asyncio.gather(*self._tasks, return_exceptions=True)
        self._tasks.clear()

    async def wait(self) -> None:
        """Block until the service has fully stopped."""
        await self._done.wait()

    def spawn(self, coro: Coroutine, name: str = "") -> asyncio.Task:
        """Spawn a task owned by this service; cancelled on stop. Uncaught
        exceptions stop the service (fail-fast, like the reference's
        consensus panic-on-error policy, internal/consensus/state.go:820)."""
        task = asyncio.get_event_loop().create_task(
            self._run_guarded(coro, name or self.name)
        )
        # If the task is cancelled before its first tick, the inner coroutine
        # never starts; close it then to avoid "never awaited" warnings.
        task.add_done_callback(lambda _t: coro.close())
        self._tasks.append(task)
        # drop finished tasks so services spawning per-event work
        # (dials, accepts) don't grow the list without bound
        task.add_done_callback(self._discard_task)
        return task

    def _discard_task(self, task: asyncio.Task) -> None:
        try:
            self._tasks.remove(task)
        except ValueError:
            pass  # already cleared by stop()

    async def _run_guarded(self, coro: Coroutine, name: str) -> None:
        try:
            await coro
        except asyncio.CancelledError:
            raise
        except Exception:
            self.logger.exception(f"task {name} failed")
            # Detach to avoid self-await deadlock during stop(); hold a
            # strong reference so the stop task can't be GC'd before it runs.
            stop_task = asyncio.get_event_loop().create_task(self.stop())
            self._pending_stop = stop_task
            stop_task.add_done_callback(
                lambda _t: setattr(self, "_pending_stop", None)
            )

    # -- overridables --

    async def on_start(self) -> None:  # pragma: no cover - trivial default
        pass

    async def on_stop(self) -> None:  # pragma: no cover - trivial default
        pass
