"""The gRPC remote signer: the reference's second privval transport.

Counterpart: tendermint_tpu/privval/grpc.py:1-226 (reference:
privval/grpc/client.go, server.go, util.go). The roles are the inverse
of the socket signer's (privval/signer.py): the signer runs a gRPC
server and the node dials it (reference: node/setup.go:548
DialRemoteSigner, chosen by a `grpc://` priv_validator.laddr,
node/setup.go:586). The double-sign protection stays with the key, in
the signer process's FilePV.

The three methods, GetPubKey, SignVote and SignProposal (the
reference's PrivValidatorAPI), carry hand-written proto bodies through
identity (de)serializers under the JAX package's service name, so a port
node and a JAX signer talk either way: a request is {1: chain_id,
2: vote or proposal bytes}, an answer {1: pubkey, vote or proposal
bytes}.

Errors: a signer's refusal (a double sign) aborts with INVALID_ARGUMENT
(NOT_FOUND for the key) and reaches the node as RemoteSignerError, never
retried; UNAVAILABLE, DEADLINE_EXCEEDED, CANCELLED and UNKNOWN are the
connection's and raise RemoteSignerConnectionError, which
RetrySignerClient retries. The handlers' catches are the JAX ones:
FilePV signs on the host, and no device call runs under them.
"""

from __future__ import annotations

from typing import Optional

import grpc
from grpc import aio as grpc_aio

from ..abci.grpc_transport import strip_scheme
from ..crypto.keys import PubKey, pubkey_from_proto, pubkey_to_proto
from ..encoding.proto import FieldReader, ProtoWriter
from ..libs.log import get_logger
from ..libs.service import Service
from ..types.proposal import Proposal
from ..types.vote import Vote
from .signer import RemoteSignerConnectionError, RemoteSignerError
from .types import PrivValidator

__all__ = ["GRPCSignerClient", "GRPCSignerServer"]

_SERVICE = "tendermint_tpu.privval.PrivValidatorAPI"
_GET_PUB_KEY = "GetPubKey"
_SIGN_VOTE = "SignVote"
_SIGN_PROPOSAL = "SignProposal"

_TRANSPORT_CODES = frozenset(
    {
        grpc.StatusCode.UNAVAILABLE,
        grpc.StatusCode.DEADLINE_EXCEEDED,
        grpc.StatusCode.CANCELLED,
        grpc.StatusCode.UNKNOWN,
    }
)


def request_bytes(chain_id: str, payload: bytes = b"") -> bytes:
    w = ProtoWriter()
    w.string(1, chain_id)
    if payload:
        w.bytes(2, payload)
    return w.finish()


def response_bytes(payload: bytes) -> bytes:
    w = ProtoWriter()
    w.bytes(1, payload)
    return w.finish()


class GRPCSignerServer(Service):
    """The signer process: a FilePV served over gRPC (reference:
    privval/grpc/server.go SignerServer)."""

    def __init__(self, listen_addr: str, chain_id: str, pv) -> None:
        super().__init__(name="privval-grpc-server", logger=get_logger("tendermint_tpu_torch.privval.grpc"))
        self.listen_addr = strip_scheme(listen_addr)
        self.chain_id = chain_id
        self.pv = pv
        self._server: Optional[grpc_aio.Server] = None
        self.bound_port: Optional[int] = None

    async def on_start(self) -> None:
        self._server = grpc_aio.server()
        handlers = {
            _GET_PUB_KEY: grpc.unary_unary_rpc_method_handler(self._get_pub_key),
            _SIGN_VOTE: grpc.unary_unary_rpc_method_handler(self._sign_vote),
            _SIGN_PROPOSAL: grpc.unary_unary_rpc_method_handler(self._sign_proposal),
        }
        self._server.add_generic_rpc_handlers(
            (grpc.method_handlers_generic_handler(_SERVICE, handlers),)
        )
        self.bound_port = self._server.add_insecure_port(self.listen_addr)
        await self._server.start()
        self.logger.info("privval grpc signer listening", port=self.bound_port)

    async def on_stop(self) -> None:
        if self._server is not None:
            await self._server.stop(grace=0.5)
            self._server = None

    async def _get_pub_key(self, request: bytes, context) -> bytes:
        try:
            pk = await self.pv.get_pub_key()
            return response_bytes(pubkey_to_proto(pk))
        except Exception as e:
            await context.abort(grpc.StatusCode.NOT_FOUND, f"error getting pubkey: {e}")

    async def _sign_vote(self, request: bytes, context) -> bytes:
        r = FieldReader(request)
        chain_id = r.string(1)
        try:
            vote = Vote.from_proto(r.bytes(2))
            await self.pv.sign_vote(chain_id, vote)
            return response_bytes(vote.to_proto())
        except Exception as e:  # a refusal: never retried
            await context.abort(grpc.StatusCode.INVALID_ARGUMENT, f"error signing vote: {e}")

    async def _sign_proposal(self, request: bytes, context) -> bytes:
        r = FieldReader(request)
        chain_id = r.string(1)
        try:
            proposal = Proposal.from_proto(r.bytes(2))
            await self.pv.sign_proposal(chain_id, proposal)
            return response_bytes(proposal.to_proto())
        except Exception as e:
            await context.abort(grpc.StatusCode.INVALID_ARGUMENT, f"error signing proposal: {e}")


class GRPCSignerClient(Service, PrivValidator):
    """The node's PrivValidator, dialing a gRPC signer (reference:
    privval/grpc/client.go SignerClient, util.go DialRemoteSigner)."""

    def __init__(self, addr: str, timeout: float = 5.0) -> None:
        Service.__init__(self, name="privval-grpc-client", logger=get_logger("tendermint_tpu_torch.privval.grpc"))
        self.addr = strip_scheme(addr)
        self.timeout = timeout
        self._channel: Optional[grpc_aio.Channel] = None
        self._calls = {}

    async def on_start(self) -> None:
        self._channel = grpc_aio.insecure_channel(self.addr)
        for method in (_GET_PUB_KEY, _SIGN_VOTE, _SIGN_PROPOSAL):
            self._calls[method] = self._channel.unary_unary(f"/{_SERVICE}/{method}")

    async def on_stop(self) -> None:
        if self._channel is not None:
            await self._channel.close()
            self._channel = None
            self._calls = {}

    async def _call(self, method: str, payload: bytes) -> bytes:
        call = self._calls.get(method)
        if call is None:
            raise RemoteSignerConnectionError("grpc signer client not started")
        try:
            return await call(payload, timeout=self.timeout)
        except grpc_aio.AioRpcError as e:
            msg = f"grpc signer: {e.code().name}: {e.details()}"
            if e.code() in _TRANSPORT_CODES:
                raise RemoteSignerConnectionError(msg) from e
            raise RemoteSignerError(msg) from e

    async def get_pub_key(self) -> PubKey:
        data = await self._call(_GET_PUB_KEY, request_bytes(""))
        return pubkey_from_proto(FieldReader(data).bytes(1))

    async def sign_vote(self, chain_id: str, vote: Vote) -> None:
        data = await self._call(_SIGN_VOTE, request_bytes(chain_id, vote.to_proto()))
        signed = Vote.from_proto(FieldReader(data).bytes(1))
        vote.signature = signed.signature
        vote.timestamp_ns = signed.timestamp_ns

    async def sign_proposal(self, chain_id: str, proposal: Proposal) -> None:
        data = await self._call(_SIGN_PROPOSAL, request_bytes(chain_id, proposal.to_proto()))
        signed = Proposal.from_proto(FieldReader(data).bytes(1))
        proposal.signature = signed.signature
        proposal.timestamp_ns = signed.timestamp_ns
