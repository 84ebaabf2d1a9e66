"""Transports: how raw (channel_id, bytes) messages move between nodes.

Counterpart: tendermint_tpu/p2p/transport.py: the Connection and
Transport interfaces, consult_dial_plane (:58), MemoryNetwork and
MemoryTransport (:104-218) and TCPTransport with its SecretConnection
handshake (:220-318); reference: internal/p2p/transport.go,
transport_memory.go, transport_mconn.go.

A Connection carries framed (channel_id, payload) messages after a
handshake that exchanges NodeInfo and proves the node key's ownership.
"""

from __future__ import annotations

import asyncio
import logging
from abc import ABC, abstractmethod
from typing import Dict, Optional, Tuple

from ..crypto import faults
from ..crypto.keys import PrivKey, PubKey
from ..encoding.proto import decode_varint, encode_varint
from .conn import SecretConnection
from .types import NodeInfo, node_id_from_pubkey, parse_node_address

__all__ = [
    "Connection",
    "Transport",
    "MemoryNetwork",
    "MemoryTransport",
    "TCPTransport",
]

MAX_MSG_SIZE = 1 << 22  # 4 MiB


class Connection(ABC):
    """An established peer link (reference: transport.go Connection)."""

    @abstractmethod
    async def handshake(
        self, node_info: NodeInfo, priv_key: PrivKey
    ) -> Tuple[NodeInfo, PubKey]:
        """Exchange NodeInfo; returns (peer_info, peer_pubkey)."""

    @abstractmethod
    async def send(self, channel_id: int, payload: bytes) -> None: ...

    @abstractmethod
    async def receive(self) -> Tuple[int, bytes]: ...

    @abstractmethod
    def close(self) -> None: ...

    @property
    @abstractmethod
    def remote_addr(self) -> str: ...


async def consult_dial_plane(src_labels: tuple, host: str, port: int):
    """The `p2p.dial` fault point, shared by every transport: a `drop`
    rule or a live partition turns the dial into ConnectionError (the
    same failure a dead peer produces, so the dial-backoff machinery
    is exercised, not bypassed), a `delay` rule slows it. Callers gate
    on faults.net_armed() — unarmed dials never reach here."""
    dst = (host, f"{host}:{port}")
    if faults.partition_blocked(src_labels, dst):
        raise ConnectionError(
            f"injected partition: dial to {host}:{port} blocked"
        )
    plan = faults.net_plan("p2p.dial", src=src_labels, dst=dst)
    if plan is not None:
        if plan.delay_s > 0:
            await asyncio.sleep(plan.delay_s)
        if plan.drop:
            raise ConnectionError(
                f"injected dial drop: {host}:{port}"
            )


class Transport(ABC):
    """reference: transport.go Transport."""

    # net-fault-plane identity of the dialing node (moniker, node ID,
    # listen host) — the router stamps this so `p2p.dial` rules and
    # partitions can match the SOURCE side
    local_labels: tuple = ()

    @abstractmethod
    async def listen(self, addr: str) -> None: ...

    @abstractmethod
    async def accept(self) -> Connection: ...

    @abstractmethod
    async def dial(self, host: str, port: int) -> Connection: ...

    @abstractmethod
    async def close(self) -> None: ...


# ---------------------------------------------------------------------------
# Memory transport (tests; reference: transport_memory.go)


class _MemoryConnection(Connection):
    def __init__(self, local_addr: str, remote_addr_: str) -> None:
        self._send_q: asyncio.Queue = asyncio.Queue(maxsize=1024)
        self._recv_q: asyncio.Queue = asyncio.Queue(maxsize=1024)
        self._local_addr = local_addr
        self._remote_addr = remote_addr_
        self._closed = asyncio.Event()
        self.peer: Optional[_MemoryConnection] = None

    @staticmethod
    def pair(a_addr: str, b_addr: str):
        a = _MemoryConnection(a_addr, b_addr)
        b = _MemoryConnection(b_addr, a_addr)
        a.peer, b.peer = b, a
        b._recv_q, a._recv_q = a._send_q, b._send_q
        return a, b

    async def handshake(self, node_info, priv_key):
        await self._send_q.put(("_handshake", (node_info, priv_key.pub_key())))
        kind, (peer_info, peer_pub) = await self._recv_q.get()
        if kind != "_handshake":
            raise RuntimeError("expected handshake message")
        return peer_info, peer_pub

    async def send(self, channel_id: int, payload: bytes) -> None:
        if self._closed.is_set():
            raise ConnectionError("connection closed")
        await self._send_q.put((channel_id, payload))

    async def receive(self) -> Tuple[int, bytes]:
        get = asyncio.ensure_future(self._recv_q.get())
        closed = asyncio.ensure_future(self._closed.wait())
        try:
            done, _pending = await asyncio.wait(
                {get, closed}, return_when=asyncio.FIRST_COMPLETED
            )
        finally:
            # also runs when THIS task is cancelled mid-wait: the two
            # inner futures must not outlive the call (they used to
            # leak as destroyed-but-pending Queue.get tasks at loop
            # close)
            for p in (get, closed):
                if not p.done():
                    p.cancel()
        if get in done:
            item = get.result()
            if item == ("_close", None):
                self._closed.set()
                raise ConnectionError("connection closed by peer")
            return item
        raise ConnectionError("connection closed")

    def close(self) -> None:
        if not self._closed.is_set():
            self._closed.set()
            try:
                self._send_q.put_nowait(("_close", None))
            except asyncio.QueueFull:
                pass
            if self.peer is not None:
                self.peer._closed.set()

    @property
    def remote_addr(self) -> str:
        return self._remote_addr


class MemoryNetwork:
    """Shared fabric connecting MemoryTransports by address
    (reference: transport_memory.go MemoryNetwork)."""

    def __init__(self) -> None:
        self.transports: Dict[str, "MemoryTransport"] = {}

    def register(self, addr: str, transport: "MemoryTransport") -> None:
        self.transports[addr] = transport


class MemoryTransport(Transport):
    def __init__(self, network: MemoryNetwork, addr: str) -> None:
        self.network = network
        self.addr = addr
        self._accept_q: asyncio.Queue = asyncio.Queue()
        network.register(addr, self)

    async def listen(self, addr: str) -> None:
        pass  # registered at construction

    async def accept(self) -> Connection:
        return await self._accept_q.get()

    async def dial(self, host: str, port: int) -> Connection:
        if faults.net_armed():
            await consult_dial_plane(
                self.local_labels
                or (self.addr, self.addr.rsplit(":", 1)[0]),
                host,
                port,
            )
        target = self.network.transports.get(f"{host}:{port}")
        if target is None:
            raise ConnectionError(f"no memory transport at {host}:{port}")
        local, remote = _MemoryConnection.pair(
            self.addr, f"{host}:{port}"
        )
        await target._accept_q.put(remote)
        return local

    async def close(self) -> None:
        self.network.transports.pop(self.addr, None)


# ---------------------------------------------------------------------------
# TCP transport with SecretConnection (reference: transport_mconn.go)


class _TCPConnection(Connection):
    def __init__(
        self,
        reader: asyncio.StreamReader,
        writer: asyncio.StreamWriter,
    ) -> None:
        self._reader = reader
        self._writer = writer
        self._secret: Optional[SecretConnection] = None
        peer = writer.get_extra_info("peername") or ("?", 0)
        self._remote = f"{peer[0]}:{peer[1]}"

    async def handshake(self, node_info: NodeInfo, priv_key: PrivKey):
        self._secret = await SecretConnection.handshake(
            self._reader, self._writer, priv_key
        )
        await self._secret.write_frame(node_info.to_proto())
        peer_info = NodeInfo.from_proto(await self._secret.read_frame())
        peer_pub = self._secret.remote_pubkey
        # the node ID must be derived from the authenticated key
        if peer_info.node_id != node_id_from_pubkey(peer_pub):
            raise ConnectionError(
                "peer's node ID does not match its authenticated key"
            )
        return peer_info, peer_pub

    async def send(self, channel_id: int, payload: bytes) -> None:
        if len(payload) > MAX_MSG_SIZE:
            raise ValueError(f"message too large: {len(payload)}")
        self._check_open()
        frame = encode_varint(channel_id) + payload
        await self._secret.write_frame(frame)

    async def receive(self) -> Tuple[int, bytes]:
        self._check_open()
        try:
            frame = await self._secret.read_frame()
        except (asyncio.IncompleteReadError, ConnectionResetError) as e:
            raise ConnectionError(f"connection lost: {e}") from e
        channel_id, off = decode_varint(frame)
        return channel_id, frame[off:]

    def _check_open(self) -> None:
        if self._secret is None:
            raise ConnectionError("handshake not complete")

    def close(self) -> None:
        try:
            self._writer.close()
        except (OSError, RuntimeError):  # already closed, or its loop is gone
            pass

    @property
    def remote_addr(self) -> str:
        return self._remote


class TCPTransport(Transport):
    def __init__(self) -> None:
        self.logger = logging.getLogger(__name__)
        self._server: Optional[asyncio.AbstractServer] = None
        self._accept_q: asyncio.Queue = asyncio.Queue(maxsize=64)
        self.listen_port: int = 0

    async def listen(self, addr: str) -> None:
        _nid, host, port = parse_node_address(addr)  # defaults port 26656

        async def on_client(reader, writer):
            try:
                self._accept_q.put_nowait(_TCPConnection(reader, writer))
            except asyncio.QueueFull:
                writer.close()

        self._server = await asyncio.start_server(
            on_client, host, int(port)
        )
        self.listen_port = self._server.sockets[0].getsockname()[1]
        self.logger.info("p2p listening on %s:%d", host, self.listen_port)

    async def accept(self) -> Connection:
        return await self._accept_q.get()

    async def dial(self, host: str, port: int) -> Connection:
        if faults.net_armed():
            await consult_dial_plane(self.local_labels, host, port)
        reader, writer = await asyncio.open_connection(host, port)
        return _TCPConnection(reader, writer)

    async def close(self) -> None:
        if self._server is not None:
            self._server.close()
            try:
                # 3.12: wait_closed blocks until every handler connection
                # closes; stragglers shouldn't wedge shutdown
                await asyncio.wait_for(self._server.wait_closed(), timeout=1.0)
            except asyncio.TimeoutError:
                pass
