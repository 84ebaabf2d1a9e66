"""Minimal JSON-RPC 2.0 server over HTTP POST, URI GET, and websocket.

Counterpart: tendermint_tpu/rpc/jsonrpc.py:1-657 (reference:
rpc/jsonrpc/server/{http_json_handler,http_uri_handler,ws_handler}.go):
one handler task per TCP connection on asyncio streams, no HTTP
framework, pipelined HTTP/1.1 with in-order replies, and the RFC 6455
subset the reference's websocket clients use (text frames, ping/pong,
close), because `subscribe` needs a duplex connection.

ERRORS. A route's RPCError is its answer; TypeError, ValueError and
KeyError answer INVALID_PARAMS, as in the JAX package. Any other error
answers INTERNAL_ERROR, as there, and the server also keeps the first
such error (`failure()`): a failed kernel launch or a CUDA error under a
route is never only a reply to one client. A request whose params are
a JSON string, number or boolean makes a route that reads them raise
AttributeError: that is the client's error, answered INTERNAL_ERROR with
the JAX server's text and not kept. The `rpc.route` fault point
(crypto/faults.py) fires inside the dispatch, keyed by the method.

METRICS. With an RPCMetrics struct (rpc/metrics.py) the dispatch records
each route's requests, errors, latency and in-flight count, a method
with no route in the unlabeled unknown_methods_total, and a request past
its route's SLO in slow_requests_total; the websocket side records live
connections, each subscriber's send-queue depth at every enqueue and the
slow subscribers dropped (:104-135, :256-260, :499-592). The trace
spans, the slow-request exemplars and the profiler task labels of the
JAX server wait for the port's tracing (ROADMAP item 11b).
"""

from __future__ import annotations

import asyncio
import base64
import hashlib
import json
import struct
import logging
import time
from dataclasses import dataclass
from typing import Any, Awaitable, Callable, Dict, Optional
from urllib.parse import parse_qsl, urlsplit

from ..crypto import faults

__all__ = [
    "RPCError",
    "RPCRequest",
    "JSONRPCServer",
    "WSConn",
    "PARSE_ERROR",
    "INVALID_REQUEST",
    "METHOD_NOT_FOUND",
    "INVALID_PARAMS",
    "INTERNAL_ERROR",
]

PARSE_ERROR = -32700
INVALID_REQUEST = -32600
METHOD_NOT_FOUND = -32601
INVALID_PARAMS = -32602
INTERNAL_ERROR = -32603

_WS_MAGIC = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

# Per-connection pipelining depth: how many requests may be in flight
# at once before the read loop stalls (backpressure). Bounds the
# memory a single pipelining client can pin server-side.
HTTP_PIPELINE_DEPTH = 64
WS_PIPELINE_DEPTH = 64


class RPCError(Exception):
    """Carries a JSON-RPC error code + message to the client."""

    def __init__(self, code: int, message: str, data: Optional[str] = None):
        super().__init__(message)
        self.code = code
        self.message = message
        self.data = data

    def to_obj(self) -> dict:
        err: Dict[str, Any] = {"code": self.code, "message": self.message}
        if self.data is not None:
            err["data"] = self.data
        return err


@dataclass
class RPCRequest:
    """One decoded request, transport-independent."""

    method: str
    params: Dict[str, Any]
    req_id: Any
    # set only for websocket requests: lets handlers (subscribe) push
    # frames outside the request/response cycle
    ws: Optional["WSConn"] = None


# handler(request) -> result object (JSON-encodable)
Handler = Callable[[RPCRequest], Awaitable[Any]]


def _response(req_id: Any, result: Any = None, error: Optional[dict] = None):
    obj: Dict[str, Any] = {"jsonrpc": "2.0", "id": req_id}
    if error is not None:
        obj["error"] = error
    else:
        obj["result"] = result
    return obj


def _client_params_error(req: RPCRequest, e: BaseException) -> bool:
    """e is a route's AttributeError on params that are not an object
    (a string, number or boolean in the request): the client's error,
    which the server does not keep (module docstring)."""
    return isinstance(e, AttributeError) and not isinstance(req.params, dict)


class WSConn:
    """Server side of one websocket connection.

    Owns the write half (single writer task -> no interleaved frames)
    and tracks the client id used for eventbus subscriptions so the
    server can unsubscribe on disconnect (reference:
    rpc/jsonrpc/server/ws_handler.go OnDisconnect).
    """

    def __init__(self, reader, writer, remote: str, metrics=None) -> None:
        self.reader = reader
        self.writer = writer
        self.remote = remote
        self.client_id = f"ws-{remote}"
        self._sendq: asyncio.Queue = asyncio.Queue(maxsize=512)
        self.closed = asyncio.Event()
        self.on_close: Optional[Callable[["WSConn"], None]] = None
        self._metrics = metrics  # RPCMetrics or None

    async def send_json(self, obj: Any) -> None:
        await self.send_text(json.dumps(obj))

    async def send_text(self, text: str) -> None:
        """Enqueue one already-serialized text frame — the fan-out path
        (rpc.core._pump_events) serializes once per event group and
        hands every subscriber the shared string."""
        if self.closed.is_set():
            return
        try:
            self._sendq.put_nowait(("text", text))
        except asyncio.QueueFull:
            # slow client: drop the connection rather than buffer
            # unboundedly (reference pubsub terminates slow subscribers)
            if self._metrics is not None:
                self._metrics.ws_slow_clients_dropped.inc()
            self._close()
            return
        if self._metrics is not None:
            # the depth after the enqueue: this subscriber's lag now
            self._metrics.ws_send_queue_depth.observe(self._sendq.qsize())

    def _close(self) -> None:
        if not self.closed.is_set():
            self.closed.set()
            try:
                # abort the transport so the read loop and the peer see
                # the disconnect immediately (a slow subscriber must be
                # dropped, not silently muted)
                self.writer.close()
            except Exception:
                pass
            if self.on_close is not None:
                self.on_close(self)

    async def _writer_loop(self) -> None:
        closed = asyncio.ensure_future(self.closed.wait())
        get: Optional[asyncio.Future] = None
        try:
            while not self.closed.is_set():
                get = asyncio.ensure_future(self._sendq.get())
                done, _ = await asyncio.wait(
                    [get, closed], return_when=asyncio.FIRST_COMPLETED
                )
                if get not in done:
                    get.cancel()
                    get = None
                    break
                items = [get.result()]
                get = None
                # cork: drain everything already queued into ONE write
                # + drain per wakeup — under fan-out load the queue
                # holds a burst per published event, and per-frame
                # write/drain round-trips dominated the writer
                while True:
                    try:
                        items.append(self._sendq.get_nowait())
                    except asyncio.QueueEmpty:
                        break
                buf = bytearray()
                closing = False
                for kind, payload in items:
                    if kind == "text":
                        buf += _encode_frame(0x1, payload.encode())
                    elif kind == "pong":
                        buf += _encode_frame(0xA, payload)
                    else:  # close
                        buf += _encode_frame(0x8, payload)
                        closing = True
                        break
                self.writer.write(bytes(buf))
                await self.writer.drain()
                if closing:
                    break
        except (ConnectionError, asyncio.CancelledError):
            pass
        finally:
            closed.cancel()
            if get is not None and not get.done():
                # cancelled mid-wait (server stop with a live
                # subscriber): asyncio.wait does NOT cancel its
                # awaitables, so without this the pending Queue.get
                # task survives to interpreter exit as a
                # "Task was destroyed but it is pending!" leak
                get.cancel()
            self._close()


def _encode_frame(opcode: int, payload: bytes) -> bytes:
    """Server->client frame (unmasked, FIN set)."""
    head = bytes([0x80 | opcode])
    n = len(payload)
    if n < 126:
        head += bytes([n])
    elif n < (1 << 16):
        head += bytes([126]) + struct.pack(">H", n)
    else:
        head += bytes([127]) + struct.pack(">Q", n)
    return head + payload


async def _read_frame(
    reader, max_frame: int = 10 << 20
) -> tuple[int, bytes]:
    """Returns (opcode, payload) of one frame (handles masking and
    fragmentation-free messages; continuation frames are concatenated
    by the caller loop). max_frame bounds a hostile/corrupt declared
    length — callers with trusted peers pass a larger cap."""
    h = await reader.readexactly(2)
    opcode = h[0] & 0x0F
    masked = h[1] & 0x80
    n = h[1] & 0x7F
    if n == 126:
        n = struct.unpack(">H", await reader.readexactly(2))[0]
    elif n == 127:
        n = struct.unpack(">Q", await reader.readexactly(8))[0]
    if n > max_frame:
        raise ConnectionError("websocket frame too large")
    mask = await reader.readexactly(4) if masked else b"\x00" * 4
    data = bytearray(await reader.readexactly(n))
    if masked:
        for i in range(n):
            data[i] ^= mask[i % 4]
    return opcode, bytes(data)


class JSONRPCServer:
    """Routes JSON-RPC methods; speaks HTTP/1.1 + websocket upgrade.

    URI GET form: /method?param=value with JSON-encoded values (strings
    may be bare). POST form: JSON-RPC 2.0 single or batch. Websocket
    endpoint at /websocket (reference: rpc/jsonrpc/server).
    """

    def __init__(
        self,
        routes: Dict[str, Handler],
        max_body_bytes: int = 1_000_000,
        metrics=None,
    ) -> None:
        self.routes = routes
        self.max_body_bytes = max_body_bytes
        self.metrics = metrics  # rpc.metrics.RPCMetrics or None
        self.logger = logging.getLogger(__name__)
        self._server: Optional[asyncio.AbstractServer] = None
        self._conns: set = set()
        self._ws_conns: set[WSConn] = set()
        self._failure: Optional[BaseException] = None

    def failure(self) -> Optional[BaseException]:
        """The first error a route raised that was neither its RPCError
        nor a params error (module docstring), or None."""
        return self._failure

    async def start(self, host: str, port: int) -> None:
        self._server = await asyncio.start_server(
            self._handle_conn, host, port
        )

    @property
    def bound_port(self) -> int:
        assert self._server is not None
        return self._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        # cancel live connection handlers BEFORE wait_closed():
        # wait_closed waits for handlers to finish, and a keep-alive
        # client parked on readline() would never finish on its own
        if self._server is not None:
            self._server.close()
        for ws in list(self._ws_conns):
            ws._close()
        tasks = list(self._conns)
        for task in tasks:
            task.cancel()
        if tasks:
            await asyncio.gather(*tasks, return_exceptions=True)
        self._conns.clear()
        if self._server is not None:
            await self._server.wait_closed()

    # -- connection handling --

    async def _handle_conn(self, reader, writer) -> None:
        task = asyncio.current_task()
        self._conns.add(task)
        try:
            await self._serve_http(reader, writer)
        except (
            ConnectionError,
            asyncio.IncompleteReadError,
            asyncio.TimeoutError,
        ):
            pass
        except Exception as e:  # pragma: no cover - defensive
            self.logger.error("rpc conn error err=%r", e)
        finally:
            self._conns.discard(task)
            try:
                writer.close()
            except Exception:
                pass

    async def _serve_http(self, reader, writer) -> None:
        """HTTP/1.1 loop, pipelined: each request is dispatched as its
        own task the moment it is parsed, and a per-connection writer
        queue preserves HTTP/1.1 response order — so one slow handler
        (broadcast_tx_commit waiting a block) no longer head-of-line-
        blocks the requests a pipelining client queued behind it.
        Inflight per connection is bounded by the queue capacity: when
        it fills, the read loop stalls (backpressure) instead of
        buffering unboundedly."""
        resp_q: asyncio.Queue = asyncio.Queue(maxsize=HTTP_PIPELINE_DEPTH)
        wtask = asyncio.ensure_future(self._http_writer_loop(writer, resp_q))
        pending: set = set()
        try:
            while True:
                req_line = await reader.readline()
                if not req_line:
                    break
                try:
                    method, target, _version = (
                        req_line.decode("latin-1").strip().split(" ", 2)
                    )
                except ValueError:
                    break
                headers: Dict[str, str] = {}
                while True:
                    line = await reader.readline()
                    if line in (b"\r\n", b"\n", b""):
                        break
                    k, _, v = line.decode("latin-1").partition(":")
                    headers[k.strip().lower()] = v.strip()

                if headers.get("upgrade", "").lower() == "websocket":
                    # flush the pipeline, retire the writer, then hand
                    # the raw stream over to the websocket server
                    await resp_q.join()
                    resp_q.put_nowait(None)
                    await wtask
                    await self._serve_websocket(reader, writer, headers)
                    return

                body = b""
                n = int(headers.get("content-length", "0") or "0")
                if n > self.max_body_bytes:
                    await resp_q.put((413, b"body too large", "text/plain"))
                    break
                if n:
                    body = await reader.readexactly(n)

                if method == "POST":
                    task = asyncio.ensure_future(
                        self._handle_post_body(body)
                    )
                elif method == "GET":
                    task = asyncio.ensure_future(self._handle_uri(target))
                else:
                    await resp_q.put(
                        (405, b"method not allowed", "text/plain")
                    )
                    break
                pending.add(task)
                task.add_done_callback(pending.discard)
                await resp_q.put(task)  # bounded inflight
                if headers.get("connection", "").lower() == "close":
                    break
            # client finished (EOF / close / protocol error): drain the
            # responses already admitted, then retire the writer
            await resp_q.join()
            resp_q.put_nowait(None)
            await wtask
        finally:
            wtask.cancel()
            for t in list(pending):
                t.cancel()

    async def _http_writer_loop(self, writer, q: asyncio.Queue) -> None:
        """FIFO response writer for one pipelined HTTP connection.
        Consumes (status, body, ctype) tuples or in-flight dispatch
        tasks in request order; a None sentinel retires it. Never stops
        consuming on a broken transport — it keeps draining (discarding)
        so the read loop's bounded put/join can't deadlock."""
        broken = False
        while True:
            item = await q.get()
            try:
                if item is None:
                    return
                if broken:
                    continue
                try:
                    if isinstance(item, tuple):
                        status, body, ctype = item
                    else:
                        resp = await item
                        status = 200
                        # default=str: a handler returning an exotic
                        # object must not kill the connection
                        body = json.dumps(resp, default=str).encode()
                        ctype = "application/json"
                    await self._http_reply(writer, status, body, ctype=ctype)
                except asyncio.CancelledError:
                    raise
                except (ConnectionError, asyncio.IncompleteReadError):
                    broken = True
                except Exception as e:  # pragma: no cover - defensive
                    self.logger.error("rpc http response error err=%r", e)
                    broken = True
            finally:
                q.task_done()

    async def _http_reply(
        self, writer, status: int, body: bytes, ctype: str = "text/plain"
    ) -> None:
        reason = {200: "OK", 405: "Method Not Allowed", 413: "Too Large"}.get(
            status, "Error"
        )
        writer.write(
            (
                f"HTTP/1.1 {status} {reason}\r\n"
                f"Content-Type: {ctype}\r\n"
                f"Content-Length: {len(body)}\r\n"
                "\r\n"
            ).encode()
            + body
        )
        await writer.drain()

    # -- POST / GET dispatch --

    async def _handle_post_body(self, body: bytes):
        try:
            obj = json.loads(body)
        except (ValueError, UnicodeDecodeError):
            return _response(
                None, error=RPCError(PARSE_ERROR, "parse error").to_obj()
            )
        if isinstance(obj, list):
            return [await self._dispatch_obj(o) for o in obj]
        return await self._dispatch_obj(obj)

    async def _dispatch_obj(self, obj: Any, ws: Optional[WSConn] = None):
        if not isinstance(obj, dict) or "method" not in obj:
            return _response(
                None,
                error=RPCError(INVALID_REQUEST, "invalid request").to_obj(),
            )
        req_id = obj.get("id")
        params = obj.get("params") or {}
        if isinstance(params, list):
            return _response(
                req_id,
                error=RPCError(
                    INVALID_PARAMS, "positional params not supported"
                ).to_obj(),
            )
        req = RPCRequest(
            method=obj["method"], params=params, req_id=req_id, ws=ws
        )
        return await self._dispatch(req)

    async def _handle_uri(self, target: str):
        parts = urlsplit(target)
        method = parts.path.strip("/")
        if method == "":
            # route listing, like the reference's index page
            return _response(None, result=sorted(self.routes))
        params: Dict[str, Any] = {}
        for k, v in parse_qsl(parts.query):
            try:
                params[k] = json.loads(v)
            except ValueError:
                params[k] = v  # bare string
        return await self._dispatch(
            RPCRequest(method=method, params=params, req_id=-1)
        )

    async def _dispatch(self, req: RPCRequest):
        handler = self.routes.get(req.method)
        m = self.metrics
        if handler is None:
            if m is not None:
                # not labeled by method: route labels stay a server-known
                # set, or a client mints unbounded series
                m.unknown_methods.inc()
            return _response(
                req.req_id,
                error=RPCError(
                    METHOD_NOT_FOUND, f"unknown method {req.method!r}"
                ).to_obj(),
            )
        if m is not None:
            m.requests_total.inc(route=req.method)
            m.inflight.add(1, route=req.method)
        failed = False
        t0 = time.perf_counter()
        try:
            try:
                if faults.armed():
                    # chaos seam: `rpc.route` keyed by method; an injected
                    # raise maps to the INTERNAL_ERROR a crashing handler's
                    # would
                    faults.fire("rpc.route", req.method)
                result = await handler(req)
            except RPCError as e:
                failed = True
                return _response(req.req_id, error=e.to_obj())
            except (TypeError, ValueError, KeyError) as e:
                # int()/decode failures on client-supplied params; logged
                # so a genuine server bug surfacing here stays visible
                failed = True
                self.logger.info(
                    "rpc invalid params method=%s err=%r", req.method, e
                )
                return _response(
                    req.req_id,
                    error=RPCError(INVALID_PARAMS, str(e)).to_obj(),
                )
            except Exception as e:
                # the client gets INTERNAL_ERROR, as from the JAX server;
                # the server keeps the error too (module docstring)
                failed = True
                self.logger.error(
                    "rpc handler error method=%s err=%r", req.method, e
                )
                if self._failure is None and not _client_params_error(req, e):
                    self._failure = e
                return _response(
                    req.req_id,
                    error=RPCError(INTERNAL_ERROR, repr(e)).to_obj(),
                )
            return _response(req.req_id, result=result)
        finally:
            if m is not None:
                dur = time.perf_counter() - t0
                m.inflight.add(-1, route=req.method)
                m.request_latency.observe(dur, route=req.method)
                if failed:
                    m.request_errors.inc(route=req.method)
                if dur > m.slo_for(req.method):
                    m.slow_requests.inc(route=req.method)

    # -- websocket --

    async def _serve_websocket(self, reader, writer, headers) -> None:
        key = headers.get("sec-websocket-key")
        if not key:
            await self._http_reply(writer, 405, b"bad websocket handshake")
            return
        accept = base64.b64encode(
            hashlib.sha1((key + _WS_MAGIC).encode()).digest()
        ).decode()
        writer.write(
            (
                "HTTP/1.1 101 Switching Protocols\r\n"
                "Upgrade: websocket\r\n"
                "Connection: Upgrade\r\n"
                f"Sec-WebSocket-Accept: {accept}\r\n\r\n"
            ).encode()
        )
        await writer.drain()

        peer = writer.get_extra_info("peername")
        remote = f"{peer[0]}:{peer[1]}" if peer else "unknown"
        ws = WSConn(reader, writer, remote, metrics=self.metrics)
        self._ws_conns.add(ws)
        if self.metrics is not None:
            self.metrics.ws_connections.add(1)
        wtask = asyncio.ensure_future(ws._writer_loop())
        msg = bytearray()
        sem = asyncio.Semaphore(WS_PIPELINE_DEPTH)
        inflight: set = set()
        try:
            while True:
                opcode, payload = await _read_frame(reader)
                if opcode == 0x8:  # close
                    ws._sendq.put_nowait(("close", payload[:2]))
                    break
                if opcode == 0x9:  # ping
                    ws._sendq.put_nowait(("pong", payload))
                    continue
                if opcode in (0x1, 0x2, 0x0):
                    msg.extend(payload)
                    # FIN bit already folded into _read_frame? no —
                    # reference clients don't fragment; treat each
                    # data frame as a complete message.
                    try:
                        obj = json.loads(bytes(msg))
                    except ValueError:
                        await ws.send_json(
                            _response(
                                None,
                                error=RPCError(
                                    PARSE_ERROR, "parse error"
                                ).to_obj(),
                            )
                        )
                        msg.clear()
                        continue
                    msg.clear()
                    # dispatch off the read loop: a slow handler
                    # (broadcast_tx_commit waits a whole block) must
                    # not head-of-line-block the frames behind it;
                    # clients match responses by id. The semaphore
                    # bounds per-connection inflight (backpressure).
                    await sem.acquire()
                    task = asyncio.ensure_future(
                        self._ws_dispatch(obj, ws, sem)
                    )
                    inflight.add(task)
                    task.add_done_callback(inflight.discard)
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            ws._close()
            self._ws_conns.discard(ws)
            if self.metrics is not None:
                self.metrics.ws_connections.add(-1)
            wtask.cancel()
            for task in list(inflight):
                task.cancel()

    async def _ws_dispatch(self, obj: Any, ws: WSConn, sem) -> None:
        try:
            resp = await self._dispatch_obj(obj, ws=ws)
            await ws.send_json(resp)
        finally:
            sem.release()
