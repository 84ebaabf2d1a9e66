"""The remote signer: socket endpoints between a node and an external
process that holds the validator key.

Counterpart: tendermint_tpu/privval/signer.py:1-466 (reference:
privval/signer_listener_endpoint.go, signer_dialer_endpoint.go,
signer_client.go, signer_requestHandler.go, retry_signer_client.go).
The roles are the reference's: the node listens and the signer dials
in, so the machine holding the key never listens. Frames ride the
SecretConnection of p2p/conn.py (X25519, ChaCha20-Poly1305), and the
signer may require the node to prove an expected node key. The
double-sign protection lives with the key, in the signer's FilePV
last-sign state; the node side forwards.

Its broad catches are the JAX ones, and none covers a device call: a
failed handshake (:198 there) and a dial or serve that ended (:412) are
a connection's bytes; a request's send or receive (:241) poisons the
connection; the signer's handler (:459) answers FilePV's refusal or a
malformed request as an error reply, and FilePV signs on the host
(ROADMAP §3).
"""

from __future__ import annotations

import asyncio
import logging
from typing import Optional

from ..crypto.ed25519 import PrivKeyEd25519
from ..crypto.keys import PrivKey, PubKey, pubkey_from_proto, pubkey_to_proto
from ..encoding.proto import FieldReader, ProtoWriter
from ..libs.service import Service
from ..p2p.conn import SecretConnection
from ..types.proposal import Proposal
from ..types.vote import Vote
from .types import PrivValidator

__all__ = [
    "RemoteSignerError",
    "RemoteSignerConnectionError",
    "SignerListenerEndpoint",
    "SignerServer",
    "RetrySignerClient",
]


class RemoteSignerError(Exception):
    """Signer replied with an error (e.g. double-sign refusal)."""


class RemoteSignerConnectionError(RemoteSignerError):
    """Transport-shaped failure: safe to retry. Signer-side refusals
    (RemoteSignerError) must NOT be retried — a double-sign refusal
    retried into a different connection would defeat the protection."""


# -- wire messages (oneof; reference: proto/tendermint/privval) -------------

_F_PUBKEY_REQ = 1
_F_PUBKEY_RESP = 2
_F_SIGN_VOTE_REQ = 3
_F_SIGNED_VOTE_RESP = 4
_F_SIGN_PROP_REQ = 5
_F_SIGNED_PROP_RESP = 6
_F_PING_REQ = 7
_F_PING_RESP = 8


def _msg(field: int, body: bytes = b"") -> bytes:
    w = ProtoWriter()
    w.message(field, body)
    return w.finish()


def _req_body(chain_id: str, payload: bytes = b"") -> bytes:
    w = ProtoWriter()
    w.string(1, chain_id)
    if payload:
        w.bytes(2, payload)
    return w.finish()


def _resp_body(payload: bytes = b"", error: str = "") -> bytes:
    w = ProtoWriter()
    if payload:
        w.bytes(1, payload)
    w.string(2, error)
    return w.finish()


def _parse(data: bytes):
    r = FieldReader(data)
    for field in range(_F_PUBKEY_REQ, _F_PING_RESP + 1):
        body = r.get(field)
        if body is not None:
            return field, body
    raise ValueError("unknown remote signer message")


# -- shared frame plumbing --------------------------------------------------


class _Conn:
    """One authenticated signer connection."""

    def __init__(self, secret: SecretConnection) -> None:
        self.secret = secret

    async def send(self, data: bytes) -> None:
        await self.secret.write_frame(data)

    async def recv(self) -> bytes:
        return await self.secret.read_frame()

    def close(self) -> None:
        self.secret.close()


# -- node side --------------------------------------------------------------


class SignerListenerEndpoint(Service, PrivValidator):
    """The node's PrivValidator backed by a remote signer that dials in
    (reference: signer_listener_endpoint.go + signer_client.go).

    Requests are serialized over the single live connection; a broken
    connection fails in-flight requests and waits for the signer to
    re-dial."""

    def __init__(
        self,
        listen_addr: str,
        node_priv_key: PrivKey,
        timeout_read: float = 5.0,
        accept_timeout: float = 30.0,
        ping_interval: float = 10.0,
        authorized_keys: Optional[list] = None,
    ) -> None:
        """authorized_keys: allowed signer transport pubkeys (raw 32-byte
        values). Empty means any dialer that completes the handshake is
        accepted — fine on a private interface, NOT on a public one."""
        Service.__init__(
            self, name="privval-listener", logger=logging.getLogger(__name__)
        )
        addr = listen_addr.replace("tcp://", "")
        host, _, port = addr.rpartition(":")
        self.host = host or "127.0.0.1"
        self.port = int(port)
        self.node_priv_key = node_priv_key
        self.timeout_read = timeout_read
        self.accept_timeout = accept_timeout
        self.ping_interval = ping_interval
        self.authorized_keys = set(authorized_keys or [])
        self._server: Optional[asyncio.AbstractServer] = None
        self._conn: Optional[_Conn] = None
        self._conn_ready = asyncio.Event()
        self._lock = asyncio.Lock()

    @property
    def bound_port(self) -> int:
        assert self._server is not None
        return self._server.sockets[0].getsockname()[1]

    async def on_start(self) -> None:
        self._server = await asyncio.start_server(
            self._on_signer, self.host, self.port
        )
        self.spawn(self._ping_loop(), "ping")
        self.logger.info("privval listening for signer at %s:%d", self.host, self.bound_port)

    async def _ping_loop(self) -> None:
        """Detect silently-dropped connections (NAT/firewall idle
        drops): without this, the signer parks in recv() forever and
        never re-dials (reference: signer_listener_endpoint.go
        pingLoop)."""
        while True:
            await asyncio.sleep(self.ping_interval)
            if not self._conn_ready.is_set():
                continue
            try:
                await self.ping()
            except RemoteSignerError:
                # _request already tore the connection down
                self.logger.info("signer ping failed; awaiting re-dial")

    async def on_stop(self) -> None:
        if self._conn is not None:
            self._conn.close()
            self._conn = None
        self._conn_ready.clear()
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()

    async def _on_signer(self, reader, writer) -> None:
        try:
            secret = await SecretConnection.handshake(
                reader, writer, self.node_priv_key
            )
        except Exception as e:
            self.logger.info("signer handshake failed: %s", e)
            writer.close()
            return
        if (
            self.authorized_keys
            and secret.remote_pubkey.bytes() not in self.authorized_keys
        ):
            # authenticated but NOT authorized: an arbitrary dialer must
            # not be able to evict the real signer's connection
            self.logger.info(
                "rejecting unauthorized signer %s", secret.remote_pubkey.bytes().hex()[:16]
            )
            secret.close()
            return
        if self._conn is not None:
            # a newer signer connection replaces the old (reference:
            # the listener accepts the latest dial-in)
            self._conn.close()
        self._conn = _Conn(secret)
        self._conn_ready.set()
        self.logger.info("remote signer connected")

    async def _request(self, data: bytes) -> tuple:
        async with self._lock:
            try:
                await asyncio.wait_for(
                    self._conn_ready.wait(), self.accept_timeout
                )
            except asyncio.TimeoutError:
                raise RemoteSignerConnectionError("no signer connected")
            conn = self._conn
            if conn is None:  # shutdown/teardown race
                self._conn_ready.clear()
                raise RemoteSignerConnectionError("signer connection gone")
            try:
                await conn.send(data)
                resp = await asyncio.wait_for(
                    conn.recv(), self.timeout_read
                )
            except asyncio.CancelledError:
                raise
            except Exception as e:
                # ANY failure here (reset, timeout, AEAD InvalidTag on a
                # garbled frame, oversized frame) leaves the secret
                # connection's nonces desynced — the connection is toast
                # either way: drop it and wait for a re-dial
                self._poison(conn)
                raise RemoteSignerConnectionError(
                    f"signer connection failed: {e!r}"
                )
            try:
                return _parse(resp)
            except ValueError as e:
                # decryptable but malformed message: a broken or hostile
                # signer — same treatment as a transport failure, and
                # crucially it must NOT escape as ValueError (the ping
                # loop only absorbs RemoteSignerError; anything else
                # would fail-fast the whole listener service)
                self._poison(conn)
                raise RemoteSignerConnectionError(
                    f"malformed signer message: {e}"
                )

    def _poison(self, conn: Optional[_Conn]) -> None:
        if conn is not None and self._conn is conn:
            self._conn = None
            self._conn_ready.clear()
        if conn is not None:
            conn.close()

    @staticmethod
    def _unwrap(body: bytes, expect_field: int, got_field: int) -> bytes:
        if got_field != expect_field:
            raise RemoteSignerError(
                f"unexpected response type {got_field}"
            )
        r = FieldReader(body)
        err = r.string(2)
        if err:
            raise RemoteSignerError(err)
        return r.bytes(1)

    # -- PrivValidator --

    async def get_pub_key(self) -> PubKey:
        field, body = await self._request(
            _msg(_F_PUBKEY_REQ, _req_body(""))
        )
        payload = self._unwrap(body, _F_PUBKEY_RESP, field)
        return pubkey_from_proto(payload)

    async def sign_vote(self, chain_id: str, vote: Vote) -> None:
        field, body = await self._request(
            _msg(_F_SIGN_VOTE_REQ, _req_body(chain_id, vote.to_proto()))
        )
        payload = self._unwrap(body, _F_SIGNED_VOTE_RESP, field)
        signed = Vote.from_proto(payload)
        vote.signature = signed.signature
        vote.timestamp_ns = signed.timestamp_ns

    async def sign_proposal(self, chain_id: str, proposal: Proposal) -> None:
        field, body = await self._request(
            _msg(
                _F_SIGN_PROP_REQ, _req_body(chain_id, proposal.to_proto())
            )
        )
        payload = self._unwrap(body, _F_SIGNED_PROP_RESP, field)
        signed = Proposal.from_proto(payload)
        proposal.signature = signed.signature
        proposal.timestamp_ns = signed.timestamp_ns

    async def ping(self) -> None:
        field, _body = await self._request(_msg(_F_PING_REQ))
        if field != _F_PING_RESP:
            raise RemoteSignerError("bad ping response")


class RetrySignerClient(PrivValidator):
    """Retry wrapper around SignerListenerEndpoint
    (reference: retry_signer_client.go). Retries only transport-shaped
    failures; signer-side refusals (double sign!) propagate
    immediately."""

    def __init__(
        self,
        inner: SignerListenerEndpoint,
        retries: int = 5,
        delay: float = 1.0,
    ) -> None:
        self.inner = inner
        self.retries = retries
        self.delay = delay

    async def _retry(self, fn, *args):
        last: Optional[Exception] = None
        for _ in range(self.retries):
            try:
                return await fn(*args)
            except RemoteSignerConnectionError as e:
                last = e
                await asyncio.sleep(self.delay)
        raise last  # type: ignore[misc]

    async def get_pub_key(self) -> PubKey:
        return await self._retry(self.inner.get_pub_key)

    async def sign_vote(self, chain_id: str, vote: Vote) -> None:
        await self._retry(self.inner.sign_vote, chain_id, vote)

    async def sign_proposal(self, chain_id: str, proposal: Proposal) -> None:
        await self._retry(self.inner.sign_proposal, chain_id, proposal)


# -- signer side ------------------------------------------------------------


class SignerServer(Service):
    """The external signing process: dials the node and serves signing
    requests from a local FilePV (reference: signer_dialer_endpoint.go
    + signer_server.go + signer_requestHandler.go)."""

    def __init__(
        self,
        node_addr: str,
        pv,  # FilePV (holds the key + last-sign state)
        signer_priv_key: Optional[PrivKey] = None,
        expected_node_id: str = "",
        redial_delay: float = 1.0,
        chain_id: str = "",
    ) -> None:
        super().__init__(name="signer-server", logger=logging.getLogger(__name__))
        addr = node_addr.replace("tcp://", "")
        host, _, port = addr.rpartition(":")
        self.host = host or "127.0.0.1"
        self.port = int(port)
        self.pv = pv
        # non-empty => sign requests for any OTHER chain are refused
        # (reference: signer_requestHandler.go DefaultValidationRequest
        # Handler rejects a chainID mismatch) — a misconfigured or
        # hostile node must not be able to pull signatures for another
        # chain or burn the last-sign HRS state with foreign votes
        self.chain_id = chain_id
        # transport identity for the secret connection (not the
        # validator key)
        self.signer_priv_key = signer_priv_key or PrivKeyEd25519.generate()
        self.expected_node_id = expected_node_id
        self.redial_delay = redial_delay

    async def on_start(self) -> None:
        self.spawn(self._dial_loop(), "dial")

    async def _dial_loop(self) -> None:
        while True:
            try:
                reader, writer = await asyncio.open_connection(
                    self.host, self.port
                )
                secret = await SecretConnection.handshake(
                    reader, writer, self.signer_priv_key
                )
                if self.expected_node_id:
                    from ..p2p.types import node_id_from_pubkey

                    got = node_id_from_pubkey(secret.remote_pubkey)
                    if got != self.expected_node_id:
                        raise ConnectionError(
                            f"node identity mismatch: {got}"
                        )
                self.logger.info("connected to node")
                await self._serve(_Conn(secret))
            except asyncio.CancelledError:
                raise
            except Exception as e:
                self.logger.info("signer connection ended: %s", e)
            await asyncio.sleep(self.redial_delay)

    async def _serve(self, conn: _Conn) -> None:
        try:
            while True:
                field, body = _parse(await conn.recv())
                await conn.send(await self._handle(field, body))
        finally:
            conn.close()

    async def _handle(self, field: int, body: bytes) -> bytes:
        """reference: signer_requestHandler.go DefaultValidationRequest
        Handler."""
        r = FieldReader(body)
        chain_id = r.string(1)
        payload = r.bytes(2)
        try:
            if field == _F_PING_REQ:
                return _msg(_F_PING_RESP)
            if (
                self.chain_id
                and field in (_F_SIGN_VOTE_REQ, _F_SIGN_PROP_REQ)
                and chain_id != self.chain_id
            ):
                raise ValueError(
                    f"sign request for chain {chain_id!r}; this signer "
                    f"serves {self.chain_id!r}"
                )
            if field == _F_PUBKEY_REQ:
                pk = await self.pv.get_pub_key()
                return _msg(
                    _F_PUBKEY_RESP, _resp_body(pubkey_to_proto(pk))
                )
            if field == _F_SIGN_VOTE_REQ:
                vote = Vote.from_proto(payload)
                await self.pv.sign_vote(chain_id, vote)
                return _msg(
                    _F_SIGNED_VOTE_RESP, _resp_body(vote.to_proto())
                )
            if field == _F_SIGN_PROP_REQ:
                proposal = Proposal.from_proto(payload)
                await self.pv.sign_proposal(chain_id, proposal)
                return _msg(
                    _F_SIGNED_PROP_RESP, _resp_body(proposal.to_proto())
                )
        except Exception as e:
            resp_field = {
                _F_PUBKEY_REQ: _F_PUBKEY_RESP,
                _F_SIGN_VOTE_REQ: _F_SIGNED_VOTE_RESP,
                _F_SIGN_PROP_REQ: _F_SIGNED_PROP_RESP,
            }.get(field, _F_PUBKEY_RESP)
            return _msg(resp_field, _resp_body(error=str(e)))
        return _msg(_F_PUBKEY_RESP, _resp_body(error="unknown request"))
