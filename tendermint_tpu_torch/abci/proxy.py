"""Proxy mux: four logical ABCI connections to one application.

Counterpart: tendermint_tpu/abci/proxy.py:16-37 (reference:
internal/proxy/multi_app_conn.go:24-60). The consensus, mempool, query
and snapshot connections are each serialized on their own, so the
mempool can CheckTx while consensus delivers a block.
"""

from __future__ import annotations

from ..libs.service import Service
from .client import ABCIClient, ClientCreator

__all__ = ["AppConns"]


class AppConns(Service):
    """Owns the four clients; starts and stops them as a unit
    (reference: internal/proxy/multi_app_conn.go:52-55, OnStart :86)."""

    def __init__(self, creator: ClientCreator) -> None:
        super().__init__(name="proxy")
        self.consensus: ABCIClient = creator()
        self.mempool: ABCIClient = creator()
        self.query: ABCIClient = creator()
        self.snapshot: ABCIClient = creator()

    async def on_start(self) -> None:
        for conn in (self.query, self.snapshot, self.mempool, self.consensus):
            await conn.start()
        # liveness check, as the reference's Echo on start
        await self.query.echo("ping")

    async def on_stop(self) -> None:
        for conn in (self.consensus, self.mempool, self.snapshot, self.query):
            if conn.is_running:
                await conn.stop()
