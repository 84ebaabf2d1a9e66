"""ABCI clients: the async interface, the in-process local client and
the socket client.

Counterpart: tendermint_tpu/abci/client.py: ABCIClientError (:27),
ABCIClient (:31-93, with check_tx_batch :50 and the state-sync methods
:75-90), _RequestForwardingClient (:96-154), LocalClient (:157-216, its
batch in one lock hold :185), SocketClient (:220-318), the framing
helpers (:321-345), ClientCreator, local_creator and socket_creator
(:349-358); reference: abci/client/client.go, local_client.go,
socket_client.go, creators.go:12-36. Every method is a coroutine; the
local client runs the synchronous application inline under one lock, as
the reference's mutex-serialized local client does. The socket client
pipelines varint-framed requests (abci/codec.py) and matches the answers
FIFO. The gRPC client is abci/grpc_transport.py.
"""

from __future__ import annotations

import asyncio
from typing import Callable, Optional

from ..encoding.proto import encode_varint
from ..libs.service import Service
from . import types as T
from .codec import decode_response, encode_request

__all__ = [
    "ABCIClient",
    "ABCIClientError",
    "ClientCreator",
    "LocalClient",
    "SocketClient",
    "local_creator",
    "socket_creator",
]


class ABCIClientError(Exception):
    pass


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


class _RequestForwardingClient(ABCIClient):
    """The methods of a client that sends every call through one
    `_request(req)` (the socket transport)."""

    async def _request(self, req):
        raise NotImplementedError

    async def echo(self, message: str) -> T.ResponseEcho:
        return await self._request(T.RequestEcho(message=message))

    async def flush(self) -> None:
        await self._request(T.RequestFlush())

    async def info(self, req):
        return await self._request(req)

    async def query(self, req):
        return await self._request(req)

    async def check_tx(self, req):
        return await self._request(req)

    async def check_tx_batch(self, reqs):
        return await self._request_batch(reqs)

    async def _request_batch(self, reqs):
        """Every request issued before any answer is awaited; a FIFO
        transport overrides it to write them in one go."""
        return list(await asyncio.gather(*(self._request(r) for r in reqs)))

    async def init_chain(self, req):
        return await self._request(req)

    async def begin_block(self, req):
        return await self._request(req)

    async def deliver_tx(self, req):
        return await self._request(req)

    async def end_block(self, req):
        return await self._request(req)

    async def commit(self):
        return await self._request(T.RequestCommit())

    async def list_snapshots(self, req):
        return await self._request(req)

    async def offer_snapshot(self, req):
        return await self._request(req)

    async def load_snapshot_chunk(self, req):
        return await self._request(req)

    async def apply_snapshot_chunk(self, req):
        return await self._request(req)


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


class SocketClient(_RequestForwardingClient):
    """An out-of-process app over a varint-framed byte stream. Requests
    are written in order and the server answers in order, so answers
    are matched FIFO (reference: abci/client/socket_client.go:118-180)."""

    def __init__(self, address: str, must_connect: bool = True) -> None:
        super().__init__(name="abci.socket")
        self.address = address
        self.must_connect = must_connect
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        self._pending: asyncio.Queue = asyncio.Queue()
        self._write_lock = asyncio.Lock()
        self._err: Optional[Exception] = None

    async def on_start(self) -> None:
        delay = 0.2
        while True:
            try:
                self._reader, self._writer = await _open(self.address)
                break
            except OSError as e:
                if self.must_connect:
                    raise
                self.logger.info("abci.socket dial failed; retrying: %s", e)
                await asyncio.sleep(delay)
                delay = min(delay * 2, 3.0)
        self.spawn(self._recv_loop())

    async def on_stop(self) -> None:
        if self._writer is not None:
            self._writer.close()

    async def _recv_loop(self) -> None:
        assert self._reader is not None
        try:
            while True:
                msg = await _read_delimited(self._reader)
                resp = decode_response(msg)
                if isinstance(resp, T.ResponseException):
                    raise ABCIClientError(f"abci app exception: {resp.error}")
                fut: asyncio.Future = await self._pending.get()
                if not fut.done():
                    fut.set_result(resp)
        except asyncio.CancelledError:
            self._err = ABCIClientError("client stopped")
            self._drain_pending(self._err)
            raise
        except Exception as e:  # a stream or codec failure ends the connection
            self._err = e
            # _request enqueues under _write_lock and checks _err there,
            # so draining under it leaves no future behind
            async with self._write_lock:
                self._drain_pending(e)

    def _drain_pending(self, err: Exception) -> None:
        while not self._pending.empty():
            fut = self._pending.get_nowait()
            if not fut.done():
                fut.set_exception(ABCIClientError(str(err)))

    async def _request(self, req):
        if self._writer is None:
            raise ABCIClientError("socket client not started")
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        async with self._write_lock:
            if self._err is not None:
                raise ABCIClientError(str(self._err))
            await self._pending.put(fut)
            body = encode_request(req)
            self._writer.write(encode_varint(len(body)) + body)
            await self._writer.drain()
        return await fut

    async def _request_batch(self, reqs):
        """The whole batch written under one _write_lock hold and one
        drain, so the server reads one contiguous pipeline."""
        if not reqs:
            return []
        if self._writer is None:
            raise ABCIClientError("socket client not started")
        loop = asyncio.get_running_loop()
        futs: list = []
        async with self._write_lock:
            if self._err is not None:
                raise ABCIClientError(str(self._err))
            buf = bytearray()
            for req in reqs:
                fut = loop.create_future()
                await self._pending.put(fut)
                futs.append(fut)
                body = encode_request(req)
                buf += encode_varint(len(body)) + body
            self._writer.write(bytes(buf))
            await self._writer.drain()
        return list(await asyncio.gather(*futs))


async def _open(address: str):
    """Dial `tcp://host:port` or `unix://path`."""
    if address.startswith("unix://"):
        return await asyncio.open_unix_connection(address[len("unix://"):])
    hostport = address[len("tcp://"):] if address.startswith("tcp://") else address
    host, _, port = hostport.rpartition(":")
    return await asyncio.open_connection(host or "127.0.0.1", int(port))


async def _read_delimited(reader: asyncio.StreamReader) -> bytes:
    """Read one varint-length-delimited message."""
    shift = 0
    n = 0
    while True:
        b = (await reader.readexactly(1))[0]
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            break
        shift += 7
        if shift > 63:
            raise ABCIClientError("varint overflow")
    if n > 64 * 1024 * 1024:
        raise ABCIClientError(f"message too large: {n}")
    return await reader.readexactly(n)


# reference: abci/client/creators.go:12-36
ClientCreator = Callable[[], ABCIClient]


def local_creator(app: T.Application) -> ClientCreator:
    return lambda: LocalClient(app)


def socket_creator(address: str, must_connect: bool = False) -> ClientCreator:
    return lambda: SocketClient(address, must_connect=must_connect)
