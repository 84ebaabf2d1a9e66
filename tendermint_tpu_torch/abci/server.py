"""ABCI socket server: an Application served to out-of-process nodes.

Counterpart: tendermint_tpu/abci/server.py:21-113 (reference:
abci/server/socket_server.go, a varint-framed request loop a connection,
and abci/server/server.go). SocketServer answers echo and flush itself
and dispatches the rest to the app under one lock (dispatch_to_app); an
app that raises answers ResponseException, which the client raises as
ABCIClientError. The app runs on the host: no device call runs under the
catch. The gRPC server is abci/grpc_transport.py.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Optional

from ..encoding.proto import encode_varint
from ..libs.service import Service
from . import types as T
from .client import _read_delimited
from .codec import decode_request, encode_response

__all__ = ["SocketServer", "dispatch_to_app"]


class SocketServer(Service):
    def __init__(self, address: str, app: T.Application) -> None:
        super().__init__(name="abci.server", logger=logging.getLogger(__name__))
        self.address = address
        self.app = app
        self._server: Optional[asyncio.base_events.Server] = None
        # one lock for the app over every connection: the server is the
        # app's guard
        self._app_lock = asyncio.Lock()

    async def on_start(self) -> None:
        if self.address.startswith("unix://"):
            self._server = await asyncio.start_unix_server(
                self._handle, self.address[len("unix://"):]
            )
        else:
            hostport = (
                self.address[len("tcp://"):]
                if self.address.startswith("tcp://")
                else self.address
            )
            host, _, port = hostport.rpartition(":")
            self._server = await asyncio.start_server(
                self._handle, host or "127.0.0.1", int(port)
            )

    @property
    def listen_port(self) -> int:
        assert self._server is not None
        return self._server.sockets[0].getsockname()[1]

    async def on_stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()

    async def _handle(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        try:
            while True:
                msg = await _read_delimited(reader)
                req = decode_request(msg)
                try:
                    resp = await self._dispatch(req)
                except Exception as e:  # the app's error: an exception response
                    self.logger.exception("abci app raised")
                    resp = T.ResponseException(error=str(e))
                body = encode_response(resp)
                writer.write(encode_varint(len(body)) + body)
                await writer.drain()
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        finally:
            writer.close()

    async def _dispatch(self, req):
        if isinstance(req, T.RequestEcho):
            return T.ResponseEcho(message=req.message)
        if isinstance(req, T.RequestFlush):
            return T.ResponseFlush()
        async with self._app_lock:
            return dispatch_to_app(self.app, req)


def dispatch_to_app(app: T.Application, req):
    """The app method a request names (echo and flush are the
    transport's)."""
    if isinstance(req, T.RequestInfo):
        return app.info(req)
    if isinstance(req, T.RequestQuery):
        return app.query(req)
    if isinstance(req, T.RequestCheckTx):
        return app.check_tx(req)
    if isinstance(req, T.RequestInitChain):
        return app.init_chain(req)
    if isinstance(req, T.RequestBeginBlock):
        return app.begin_block(req)
    if isinstance(req, T.RequestDeliverTx):
        return app.deliver_tx(req)
    if isinstance(req, T.RequestEndBlock):
        return app.end_block(req)
    if isinstance(req, T.RequestCommit):
        return app.commit()
    if isinstance(req, T.RequestListSnapshots):
        return app.list_snapshots(req)
    if isinstance(req, T.RequestOfferSnapshot):
        return app.offer_snapshot(req)
    if isinstance(req, T.RequestLoadSnapshotChunk):
        return app.load_snapshot_chunk(req)
    if isinstance(req, T.RequestApplySnapshotChunk):
        return app.apply_snapshot_chunk(req)
    raise ValueError(f"unknown ABCI request {type(req).__name__}")
