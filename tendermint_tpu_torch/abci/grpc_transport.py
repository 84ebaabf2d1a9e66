"""The gRPC ABCI transport: the reference's third client and server.

Counterpart: tendermint_tpu/abci/grpc_transport.py:1-166 (reference:
abci/client/grpc_client.go, abci/server/grpc_server.go). One unary
method, `/tendermint_tpu.abci.ABCI/Process`, carries the request and
response envelopes the socket transport frames (abci/codec.py), as raw
bytes through identity (de)serializers, so no generated stubs are
needed and a port node talks to a JAX app server and back. The service
name is the JAX one for that reason.

The server answers echo and flush itself and runs the rest on the app
under one lock (server.py dispatch_to_app); an app that raises answers
ResponseException, which the client raises as ABCIClientError, as the
socket pair does. The app runs on the host: no device call runs under
that catch. The client serializes its calls, because unary gRPC calls
have no order across calls and ABCI's connection contract is FIFO (a
mempool recheck must reach the app before a later CheckTx).
"""

from __future__ import annotations

import asyncio
from typing import Optional

import grpc
from grpc import aio as grpc_aio

from ..libs.log import get_logger
from ..libs.service import Service
from . import codec
from . import types as T
from .client import ABCIClientError, ClientCreator, _RequestForwardingClient
from .server import dispatch_to_app

__all__ = ["GRPCClient", "GRPCServer", "grpc_creator"]

_SERVICE = "tendermint_tpu.abci.ABCI"
_METHOD = "Process"


def strip_scheme(address: str) -> str:
    """`grpc://h:p` or `tcp://h:p` -> `h:p`."""
    for scheme in ("grpc://", "tcp://"):
        if address.startswith(scheme):
            return address[len(scheme):]
    return address


class GRPCServer(Service):
    """An Application served over gRPC (reference:
    abci/server/grpc_server.go). `bound_port` is the port taken, for an
    address that asks for port 0."""

    def __init__(self, address: str, app: T.Application) -> None:
        super().__init__(name="abci.grpc.server", logger=get_logger("tendermint_tpu_torch.abci.grpc"))
        self.address = strip_scheme(address)
        self.app = app
        self._app_lock = asyncio.Lock()
        self._server: Optional[grpc_aio.Server] = None
        self.bound_port = 0

    async def on_start(self) -> None:
        self._server = grpc_aio.server()
        rpc = grpc.unary_unary_rpc_method_handler(self._process)
        self._server.add_generic_rpc_handlers(
            (grpc.method_handlers_generic_handler(_SERVICE, {_METHOD: rpc}),)
        )
        self.bound_port = self._server.add_insecure_port(self.address)
        if self.bound_port == 0:
            raise OSError(f"failed to bind gRPC server to {self.address}")
        await self._server.start()
        self.logger.info("abci grpc server listening", addr=self.address, port=self.bound_port)

    async def on_stop(self) -> None:
        if self._server is not None:
            await self._server.stop(grace=1.0)
            self._server = None

    async def _process(self, request: bytes, context) -> bytes:
        req = codec.decode_request(request)
        if isinstance(req, T.RequestEcho):
            resp = T.ResponseEcho(message=req.message)
        elif isinstance(req, T.RequestFlush):
            resp = T.ResponseFlush()
        else:
            try:
                async with self._app_lock:
                    resp = dispatch_to_app(self.app, req)
            except Exception as e:  # the socket server's contract
                self.logger.error("abci app raised", err=repr(e))
                resp = T.ResponseException(error=repr(e))
        return codec.encode_response(resp)


class GRPCClient(_RequestForwardingClient):
    """An out-of-process app over gRPC (reference:
    abci/client/grpc_client.go). With must_connect, start() fails unless
    an echo is answered."""

    def __init__(self, address: str, must_connect: bool = True) -> None:
        super().__init__(name="abci.grpc.client")
        self.address = strip_scheme(address)
        self.must_connect = must_connect
        self._channel: Optional[grpc_aio.Channel] = None
        self._call = None
        self._order_lock = asyncio.Lock()

    async def on_start(self) -> None:
        self._channel = grpc_aio.insecure_channel(self.address)
        self._call = self._channel.unary_unary(f"/{_SERVICE}/{_METHOD}")
        if self.must_connect:
            try:
                await self.echo("connected")
            except BaseException:
                # a failed start reaches no on_stop: close the channel here
                await self._channel.close()
                self._channel = None
                self._call = None
                raise

    async def on_stop(self) -> None:
        if self._channel is not None:
            await self._channel.close()
            self._channel = None
            self._call = None

    async def _request(self, req):
        if self._call is None:
            raise ABCIClientError("grpc client not started")
        payload = codec.encode_request(req)
        try:
            async with self._order_lock:
                data = await self._call(payload)
        except grpc_aio.AioRpcError as e:
            raise ABCIClientError(f"grpc: {e.code().name}: {e.details()}") from e
        resp = codec.decode_response(data)
        if isinstance(resp, T.ResponseException):
            raise ABCIClientError(f"abci app exception: {resp.error}")
        return resp


def grpc_creator(address: str, must_connect: bool = True) -> ClientCreator:
    return lambda: GRPCClient(address, must_connect=must_connect)
