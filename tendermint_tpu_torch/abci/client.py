"""ABCI clients: the async interface and the in-process local client.

Counterpart: tendermint_tpu/abci/client.py: ABCIClient (:31-93, with
check_tx_batch :50 and the state-sync methods :75-90), LocalClient
(:157-216, its batch in one lock hold :185, its state-sync methods
:207-217), ClientCreator and local_creator (:349-354);
reference: abci/client/client.go, local_client.go, creators.go:12-36.
Every method is a coroutine; the local client runs the synchronous
application inline under one lock, as the reference's mutex-serialized
local client does. The socket and gRPC clients wait for the servers
(a later item).
"""

from __future__ import annotations

import asyncio
from typing import Callable

from ..libs.service import Service
from . import types as T

__all__ = ["ABCIClient", "ClientCreator", "LocalClient", "local_creator"]


class ABCIClient(Service):
    """Async mirror of the Application interface plus echo and flush
    (reference: abci/client/client.go:24-54)."""

    async def echo(self, message: str) -> T.ResponseEcho:
        raise NotImplementedError

    async def flush(self) -> None:
        raise NotImplementedError

    async def info(self, req: T.RequestInfo) -> T.ResponseInfo:
        raise NotImplementedError

    async def query(self, req: T.RequestQuery) -> T.ResponseQuery:
        raise NotImplementedError

    async def check_tx(self, req: T.RequestCheckTx) -> T.ResponseCheckTx:
        raise NotImplementedError

    async def check_tx_batch(self, reqs: "list[T.RequestCheckTx]") -> "list[T.ResponseCheckTx]":
        """Validate a batch with one client round. Default: one await a
        request; LocalClient folds the batch into one lock hold."""
        return [await self.check_tx(r) for r in reqs]

    async def init_chain(self, req: T.RequestInitChain) -> T.ResponseInitChain:
        raise NotImplementedError

    async def begin_block(self, req: T.RequestBeginBlock) -> T.ResponseBeginBlock:
        raise NotImplementedError

    async def deliver_tx(self, req: T.RequestDeliverTx) -> T.ResponseDeliverTx:
        raise NotImplementedError

    async def end_block(self, req: T.RequestEndBlock) -> T.ResponseEndBlock:
        raise NotImplementedError

    async def commit(self) -> T.ResponseCommit:
        raise NotImplementedError

    async def list_snapshots(
        self, req: T.RequestListSnapshots
    ) -> T.ResponseListSnapshots:
        raise NotImplementedError

    async def offer_snapshot(
        self, req: T.RequestOfferSnapshot
    ) -> T.ResponseOfferSnapshot:
        raise NotImplementedError

    async def load_snapshot_chunk(
        self, req: T.RequestLoadSnapshotChunk
    ) -> T.ResponseLoadSnapshotChunk:
        raise NotImplementedError

    async def apply_snapshot_chunk(
        self, req: T.RequestApplySnapshotChunk
    ) -> T.ResponseApplySnapshotChunk:
        raise NotImplementedError


class LocalClient(ABCIClient):
    """In-process client: direct calls serialized by one lock
    (reference: abci/client/local_client.go)."""

    def __init__(self, app: T.Application) -> None:
        super().__init__(name="abci.local")
        self.app = app
        self._lock = asyncio.Lock()

    async def _call(self, fn, *args):
        async with self._lock:
            return fn(*args)

    async def echo(self, message: str) -> T.ResponseEcho:
        return T.ResponseEcho(message=message)

    async def flush(self) -> None:
        return None

    async def info(self, req):
        return await self._call(self.app.info, req)

    async def query(self, req):
        return await self._call(self.app.query, req)

    async def check_tx(self, req):
        return await self._call(self.app.check_tx, req)

    async def check_tx_batch(self, reqs):
        # one lock hold for the whole batch, as the JAX client does
        async with self._lock:
            return [self.app.check_tx(r) for r in reqs]

    async def init_chain(self, req):
        return await self._call(self.app.init_chain, req)

    async def begin_block(self, req):
        return await self._call(self.app.begin_block, req)

    async def deliver_tx(self, req):
        return await self._call(self.app.deliver_tx, req)

    async def end_block(self, req):
        return await self._call(self.app.end_block, req)

    async def commit(self):
        return await self._call(self.app.commit)

    async def list_snapshots(self, req):
        return await self._call(self.app.list_snapshots, req)

    async def offer_snapshot(self, req):
        return await self._call(self.app.offer_snapshot, req)

    async def load_snapshot_chunk(self, req):
        return await self._call(self.app.load_snapshot_chunk, req)

    async def apply_snapshot_chunk(self, req):
        return await self._call(self.app.apply_snapshot_chunk, req)


# reference: abci/client/creators.go:12-36
ClientCreator = Callable[[], ABCIClient]


def local_creator(app: T.Application) -> ClientCreator:
    return lambda: LocalClient(app)
