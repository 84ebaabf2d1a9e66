"""Async JSON-RPC clients: HTTP and websocket, and an in-process one.

Counterpart: tendermint_tpu/rpc/client.py:1-352 (reference: rpc/jsonrpc/client/{http_json_client,ws_client}.go,
rpc/client/http, rpc/client/local). Raw asyncio streams, as the server.
The light client's HTTPProvider (light/provider.py) calls HTTPClient.
"""

from __future__ import annotations

import asyncio
import base64
import hashlib
import itertools
import json
import os
import struct
from typing import Any, Dict, Optional

__all__ = ["RPCClientError", "HTTPClient", "LocalClient", "WSClient"]

_WS_MAGIC = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"


class RPCClientError(Exception):
    """JSON-RPC error response, or transport failure."""

    def __init__(self, message: str, code: Optional[int] = None):
        super().__init__(message)
        self.code = code


def _parse_addr(addr: str) -> tuple[str, int]:
    addr = addr.replace("tcp://", "").replace("http://", "")
    host, _, port = addr.rpartition(":")
    return host or "127.0.0.1", int(port)


class HTTPClient:
    """One JSON-RPC call per HTTP/1.1 request (keep-alive reuse)."""

    def __init__(self, addr: str, timeout: float = 10.0) -> None:
        self.host, self.port = _parse_addr(addr)
        self.timeout = timeout
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        self._ids = itertools.count(1)
        self._lock = asyncio.Lock()

    async def _connect(self) -> None:
        self._reader, self._writer = await asyncio.open_connection(
            self.host, self.port
        )

    async def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
            self._writer = None
            self._reader = None

    async def call(self, method: str, **params: Any) -> Any:
        """Returns the JSON-RPC result or raises RPCClientError."""
        async with self._lock:
            try:
                return await asyncio.wait_for(
                    self._call_locked(method, params), self.timeout
                )
            except asyncio.TimeoutError:
                # the request may still be in flight server-side; a
                # reused connection would hand its late response to the
                # NEXT call, so drop the connection
                await self.close()
                raise

    async def _call_locked(self, method: str, params: Dict[str, Any]):
        rid = next(self._ids)
        body = json.dumps(
            {
                "jsonrpc": "2.0",
                "id": rid,
                "method": method,
                "params": params,
            }
        ).encode()
        for attempt in (0, 1):
            if self._writer is None:
                await self._connect()
            try:
                self._writer.write(
                    (
                        f"POST / HTTP/1.1\r\n"
                        f"Host: {self.host}\r\n"
                        "Content-Type: application/json\r\n"
                        f"Content-Length: {len(body)}\r\n\r\n"
                    ).encode()
                    + body
                )
                await self._writer.drain()
                resp = await self._read_response()
                break
            except (ConnectionError, asyncio.IncompleteReadError):
                # server closed the keep-alive conn; retry once fresh
                await self.close()
                if attempt:
                    raise
        if resp.get("id") != rid:
            # desynchronized keep-alive stream (e.g. a stale response
            # from an aborted call): poison the connection
            await self.close()
            raise RPCClientError(
                f"response id {resp.get('id')} != request id {rid}"
            )
        return _unwrap(resp)

    async def _read_response(self) -> Any:
        status_line = await self._reader.readline()
        if not status_line:
            raise ConnectionError("connection closed")
        parts = status_line.decode("latin-1").split(" ", 2)
        status = int(parts[1])
        headers: Dict[str, str] = {}
        while True:
            line = await self._reader.readline()
            if line in (b"\r\n", b"\n", b""):
                break
            k, _, v = line.decode("latin-1").partition(":")
            headers[k.strip().lower()] = v.strip()
        n = int(headers.get("content-length", "0") or "0")
        body = await self._reader.readexactly(n) if n else b""
        if status != 200:
            raise RPCClientError(
                f"http status {status}: {body[:200]!r}", code=status
            )
        return json.loads(body)


def _unwrap(resp: Any) -> Any:
    if "error" in resp:
        err = resp["error"]
        raise RPCClientError(
            f"{err.get('message')} ({err.get('data', '')})",
            code=err.get("code"),
        )
    return resp.get("result")


class WSClient:
    """Websocket JSON-RPC client with server-push support.

    `call` matches responses by id; pushed notifications (subscription
    events, which reuse the subscribe request's id) are delivered via
    `next_event`.
    """

    def __init__(
        self,
        addr: str,
        timeout: float = 10.0,
        max_frame: int = 10 << 20,
    ) -> None:
        """max_frame bounds a hostile server's declared frame length;
        raise it only for a trusted (e.g. local) endpoint whose block
        dumps legitimately exceed 10 MB."""
        self.host, self.port = _parse_addr(addr)
        self.timeout = timeout
        self.max_frame = max_frame
        self._reader = None
        self._writer = None
        self._ids = itertools.count(1)
        self._pending: Dict[int, asyncio.Future] = {}
        self._events: asyncio.Queue = asyncio.Queue(maxsize=1024)
        self._recv_task: Optional[asyncio.Task] = None
        self._sub_ids: set = set()

    async def connect(self) -> None:
        self._reader, self._writer = await asyncio.open_connection(
            self.host, self.port
        )
        key = base64.b64encode(os.urandom(16)).decode()
        self._writer.write(
            (
                "GET /websocket HTTP/1.1\r\n"
                f"Host: {self.host}\r\n"
                "Upgrade: websocket\r\n"
                "Connection: Upgrade\r\n"
                f"Sec-WebSocket-Key: {key}\r\n"
                "Sec-WebSocket-Version: 13\r\n\r\n"
            ).encode()
        )
        await self._writer.drain()
        status = await self._reader.readline()
        if b"101" not in status:
            raise RPCClientError(f"websocket handshake failed: {status!r}")
        expect = base64.b64encode(
            hashlib.sha1((key + _WS_MAGIC).encode()).digest()
        ).decode()
        ok = False
        while True:
            line = await self._reader.readline()
            if line in (b"\r\n", b"\n", b""):
                break
            k, _, v = line.decode("latin-1").partition(":")
            if k.strip().lower() == "sec-websocket-accept":
                ok = v.strip() == expect
        if not ok:
            raise RPCClientError("websocket accept mismatch")
        self._recv_task = asyncio.ensure_future(self._recv_loop())

    async def close(self) -> None:
        if self._recv_task is not None:
            self._recv_task.cancel()
            self._recv_task = None
        if self._writer is not None:
            try:
                self._writer.write(self._frame(0x8, b""))
                await self._writer.drain()
            except ConnectionError:
                pass
            self._writer.close()
            self._writer = None

    def _frame(self, opcode: int, payload: bytes) -> bytes:
        """Client->server frames must be masked (RFC 6455 §5.3)."""
        head = bytes([0x80 | opcode])
        n = len(payload)
        if n < 126:
            head += bytes([0x80 | n])
        elif n < (1 << 16):
            head += bytes([0x80 | 126]) + struct.pack(">H", n)
        else:
            head += bytes([0x80 | 127]) + struct.pack(">Q", n)
        mask = os.urandom(4)
        body = bytes(b ^ mask[i % 4] for i, b in enumerate(payload))
        return head + mask + body

    async def _recv_loop(self) -> None:
        from .jsonrpc import _read_frame  # shared parser

        try:
            while True:
                opcode, payload = await _read_frame(
                    self._reader, max_frame=self.max_frame
                )
                if opcode == 0x8:
                    break
                if opcode == 0x9:  # ping -> pong
                    self._writer.write(self._frame(0xA, payload))
                    await self._writer.drain()
                    continue
                if opcode not in (0x1, 0x2):
                    continue
                obj = json.loads(payload)
                rid = obj.get("id")
                fut = self._pending.pop(rid, None)
                if fut is not None and not fut.done():
                    fut.set_result(obj)
                elif rid in self._sub_ids:
                    try:
                        self._events.put_nowait(obj)
                    except asyncio.QueueFull:
                        pass
        except (
            ConnectionError,
            asyncio.IncompleteReadError,
            asyncio.CancelledError,
            ValueError,
        ):
            pass
        finally:
            for fut in self._pending.values():
                if not fut.done():
                    fut.set_exception(RPCClientError("connection closed"))
            self._pending.clear()

    async def call(self, method: str, **params: Any) -> Any:
        rid = next(self._ids)
        fut: asyncio.Future = asyncio.get_event_loop().create_future()
        self._pending[rid] = fut
        if method == "subscribe":
            self._sub_ids.add(rid)
        self._writer.write(
            self._frame(
                0x1,
                json.dumps(
                    {
                        "jsonrpc": "2.0",
                        "id": rid,
                        "method": method,
                        "params": params,
                    }
                ).encode(),
            )
        )
        await self._writer.drain()
        resp = await asyncio.wait_for(fut, self.timeout)
        return _unwrap(resp)

    async def next_event(self, timeout: float = 10.0) -> Any:
        """Next pushed subscription event's `result` object."""
        obj = await asyncio.wait_for(self._events.get(), timeout)
        return obj.get("result")


class LocalClient:
    """In-process client: calls the node's RPC handlers directly
    against its Environment — same surface as HTTPClient.call but no
    network hop (reference: rpc/client/local/local.go). Websocket-only
    methods (subscribe/unsubscribe) are not supported here; in-process
    consumers subscribe on the event bus directly."""

    def __init__(self, env) -> None:
        self._routes = env.routes()
        self._ids = itertools.count(1)

    @classmethod
    def from_node(cls, node) -> "LocalClient":
        if node.rpc_env is None:
            raise RPCClientError(
                "node has no RPC environment (rpc.laddr disabled "
                "or node not started)"
            )
        return cls(node.rpc_env)

    async def call(self, method: str, **params: Any) -> Any:
        from .jsonrpc import INVALID_PARAMS, RPCError, RPCRequest

        handler = self._routes.get(method)
        if handler is None:
            raise RPCClientError(f"unknown method {method!r}")
        if method in ("subscribe", "unsubscribe", "unsubscribe_all"):
            raise RPCClientError(
                f"{method} requires a websocket; use the event bus "
                "for in-process subscriptions"
            )
        req = RPCRequest(
            method=method, params=dict(params), req_id=next(self._ids)
        )
        # the server's error mapping (jsonrpc._dispatch) for a route's
        # answers and params errors; any other error (a failed launch)
        # raises to the caller unchanged, where the JAX client wraps it
        # as INTERNAL_ERROR: in process there is no server to keep it
        try:
            return await handler(req)
        except RPCError as e:
            raise RPCClientError(e.message, code=e.code) from e
        except (TypeError, ValueError, KeyError) as e:
            raise RPCClientError(str(e), code=INVALID_PARAMS) from e
