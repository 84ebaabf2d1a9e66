"""The port's ABCI codec and socket transport held against the JAX
package's.

- every Request and Response envelope, its fields filled (seeded
  events, validator updates, params, snapshots, misbehavior), encodes to
  the JAX codec's bytes for the same message built from the JAX types,
  and each package decodes the other's bytes back to its message;
- a port SocketClient drives a JAX SocketServer and a JAX SocketClient
  the port's SocketServer, both serving a kvstore app on 127.0.0.1:0,
  through the same sequence (echo, info, InitChain, two blocks of
  DeliverTx, queries, a CheckTx batch, snapshots): the answers are equal
  to each other and to an in-process app's. An app that raises answers
  ResponseException, which both clients raise as ABCIClientError.

Tolerance: zero (bytes).
"""

import asyncio
import dataclasses

import numpy as np
import pytest

from tendermint_tpu.abci import client as jax_client
from tendermint_tpu.abci import codec as jax_codec
from tendermint_tpu.abci import kvstore as jax_kvstore
from tendermint_tpu.abci import server as jax_server
from tendermint_tpu.abci import types as JT
from tendermint_tpu.types.params import ConsensusParams as JaxParams
from tendermint_tpu_torch.abci import client as port_client
from tendermint_tpu_torch.abci import codec as port_codec
from tendermint_tpu_torch.abci import server as port_server
from tendermint_tpu_torch.abci import types as T
from tendermint_tpu_torch.abci.kvstore import KVStoreApplication
from tendermint_tpu_torch.types.params import ConsensusParams

SEED = 19
DEADLINE_S = 20.0


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, DEADLINE_S))


def to_jax(obj):
    """The JAX package's object for a port ABCI object: the class of the
    same name, field by field."""
    if isinstance(obj, ConsensusParams):
        return JaxParams.from_proto(obj.to_proto())
    if dataclasses.is_dataclass(obj):
        cls = getattr(JT, type(obj).__name__)
        return cls(**{f.name: to_jax(getattr(obj, f.name)) for f in dataclasses.fields(obj)})
    if isinstance(obj, tuple):
        return tuple(to_jax(x) for x in obj)
    return obj


def _samples():
    rng = np.random.default_rng(SEED)

    def b(n):
        return rng.bytes(n)

    events = (
        T.Event(type="transfer", attributes=(
            T.EventAttribute(key=b"sender", value=b(8), index=True),
            T.EventAttribute(key=b"amount", value=b"12", index=False),
        )),
        T.Event(type="app", attributes=()),
    )
    vus = tuple(
        T.ValidatorUpdate(pub_key=T.PubKey(key_type=kt, data=b(32)), power=p)
        for kt, p in (("ed25519", 10), ("sr25519", 0), ("ed25519", 7))
    )
    params = ConsensusParams()
    params.block.max_bytes = 1 << 20
    params.validator.pub_key_types = ["ed25519", "sr25519"]
    snap = T.Snapshot(height=8, format=1, chunks=3, hash=b(32), metadata=b"m")
    val = T.Validator(address=b(20), power=10)
    lci = T.LastCommitInfo(round=1, votes=(T.VoteInfo(validator=val, signed_last_block=True),
                                          T.VoteInfo(validator=T.Validator(address=b(20), power=3),
                                                     signed_last_block=False)))
    mis = T.Misbehavior(kind=1, validator=val, height=5, time_ns=1_700_000_000_123_456_789,
                        total_voting_power=13)
    return [
        T.RequestEcho(message="ping"),
        T.RequestFlush(),
        T.RequestInfo(version="0.34", block_version=11, p2p_version=8, abci_version="0.17"),
        T.RequestInitChain(time_ns=1_700_000_000_000_000_001, chain_id="chain-x", consensus_params=params,
                           validators=vus, app_state_bytes=b'{"a":1}', initial_height=3),
        T.RequestInitChain(),
        T.RequestQuery(data=b"key", path="/store", height=4, prove=True),
        T.RequestBeginBlock(hash=b(32), header_bytes=b(60), last_commit_info=lci, byzantine_validators=(mis,)),
        T.RequestCheckTx(tx=b(40), type=1),
        T.RequestDeliverTx(tx=b(77)),
        T.RequestEndBlock(height=9),
        T.RequestCommit(),
        T.RequestListSnapshots(),
        T.RequestOfferSnapshot(snapshot=snap, app_hash=b(32)),
        T.RequestOfferSnapshot(snapshot=None, app_hash=b""),
        T.RequestLoadSnapshotChunk(height=8, format=1, chunk=2),
        T.RequestApplySnapshotChunk(index=2, chunk=b(100), sender="peer-a"),
        T.ResponseException(error="boom"),
        T.ResponseEcho(message="pong"),
        T.ResponseFlush(),
        T.ResponseInfo(data='{"size":3}', version="kvstore/1", app_version=1, last_block_height=9,
                       last_block_app_hash=b(32)),
        T.ResponseInitChain(consensus_params=params, validators=vus, app_hash=b(32)),
        T.ResponseQuery(code=0, log="exists", info="i", index=-1, key=b"k", value=b(9), height=9,
                        codespace="cs"),
        T.ResponseBeginBlock(events=events),
        T.ResponseCheckTx(code=3, data=b(5), log="l", info="i", gas_wanted=10, gas_used=-2, events=events,
                          codespace="x", sender="s", priority=-7, mempool_error="full"),
        T.ResponseDeliverTx(code=0, data=b(6), log="ok", info="", gas_wanted=1, gas_used=1, events=events,
                            codespace=""),
        T.ResponseEndBlock(validator_updates=vus, consensus_param_updates=params, events=events),
        T.ResponseEndBlock(),
        T.ResponseCommit(data=b(32), retain_height=4),
        T.ResponseListSnapshots(snapshots=(snap, T.Snapshot(height=4, format=1, chunks=1, hash=b(32)))),
        T.ResponseOfferSnapshot(result=3),
        T.ResponseLoadSnapshotChunk(chunk=b(50)),
        T.ResponseApplySnapshotChunk(result=1, refetch_chunks=(0, 3, 300), reject_senders=("p1", "p2")),
    ]


SAMPLES = _samples()


@pytest.mark.parametrize("msg", SAMPLES, ids=[f"{i}-{type(m).__name__}" for i, m in enumerate(SAMPLES)])
def test_envelope_bytes_equal_jax(msg):
    request = type(msg).__name__.startswith("Request")
    p_enc, p_dec = ((port_codec.encode_request, port_codec.decode_request) if request
                    else (port_codec.encode_response, port_codec.decode_response))
    j_enc, j_dec = ((jax_codec.encode_request, jax_codec.decode_request) if request
                    else (jax_codec.encode_response, jax_codec.decode_response))
    wire = p_enc(msg)
    assert wire == j_enc(to_jax(msg))
    assert j_enc(j_dec(wire)) == wire
    back = p_dec(j_enc(to_jax(msg)))
    # proof_ops travel in neither codec
    assert p_enc(back) == wire and type(back) is type(msg)


def test_unknown_payload_and_empty_envelope_refused_alike():
    for enc in (port_codec.encode_request, jax_codec.encode_request):
        with pytest.raises(TypeError, match="not an ABCI oneof payload: int"):
            enc(3)
    for dec in (port_codec.decode_response, jax_codec.decode_response):
        with pytest.raises(ValueError, match="empty/unknown ABCI envelope"):
            dec(b"")


# -- the socket transport --


def _script(types):
    """The sequence both transports are driven through, in `types`' ABCI
    classes (port or JAX)."""
    pk = bytes(range(32))
    return [
        ("echo", "hello"),
        ("info", types.RequestInfo(version="torch")),
        ("init_chain", types.RequestInitChain(
            chain_id="sock", validators=(types.ValidatorUpdate(pub_key=types.PubKey("ed25519", pk), power=5),))),
        ("begin_block", types.RequestBeginBlock(hash=b"\x01" * 32)),
        ("deliver_tx", types.RequestDeliverTx(tx=b"name=satoshi")),
        ("deliver_tx", types.RequestDeliverTx(tx=b"k2=v2")),
        ("end_block", types.RequestEndBlock(height=1)),
        ("commit", None),
        ("query", types.RequestQuery(data=b"name", path="/store")),
        ("check_tx_batch", [types.RequestCheckTx(tx=b"a=1"), types.RequestCheckTx(tx=b"b=2")]),
        ("begin_block", types.RequestBeginBlock(hash=b"\x02" * 32)),
        ("deliver_tx", types.RequestDeliverTx(tx=b"name=nakamoto")),
        ("end_block", types.RequestEndBlock(height=2)),
        ("commit", None),
        ("query", types.RequestQuery(data=b"name", path="/store")),
        ("info", types.RequestInfo()),
        ("list_snapshots", types.RequestListSnapshots()),
        ("flush", None),
    ]


def _wire(res) -> bytes:
    """A port or JAX answer as the JAX codec's bytes."""
    if type(res).__module__.startswith("tendermint_tpu_torch"):
        return jax_codec.encode_response(to_jax(res))
    return jax_codec.encode_response(res)


async def _local() -> list:
    return await _drive(port_client.LocalClient(KVStoreApplication(snapshot_interval=1)), T)


async def _port_client_jax_server() -> list:
    srv = jax_server.SocketServer("tcp://127.0.0.1:0", jax_kvstore.KVStoreApplication(snapshot_interval=1))
    await srv.start()
    client = port_client.SocketClient(f"tcp://127.0.0.1:{srv.listen_port}")
    await client.start()
    try:
        return await _drive(client, T)
    finally:
        await client.stop()
        await srv.stop()


async def _jax_client_port_server() -> list:
    srv = port_server.SocketServer("tcp://127.0.0.1:0", KVStoreApplication(snapshot_interval=1))
    await srv.start()
    client = jax_client.SocketClient(f"tcp://127.0.0.1:{srv.listen_port}")
    await client.start()
    try:
        return await _drive(client, JT)
    finally:
        await client.stop()
        await srv.stop()


async def _drive(client, types) -> list:
    """Each answer of the script as JAX-codec bytes (a list of them for
    the batch; flush answers None)."""
    out = []
    for method, arg in _script(types):
        fn = getattr(client, method)
        res = await (fn() if arg is None else fn(arg))
        if res is None:
            out.append(None)
        elif isinstance(res, list):
            out.append([_wire(r) for r in res])
        else:
            out.append(_wire(res))
    return out


def test_socket_transports_answer_as_the_local_app():
    want = run(_local())
    assert run(_port_client_jax_server()) == want
    assert run(_jax_client_port_server()) == want
    # the second block's query reads what the first wrote
    assert b"satoshi" not in want[14] and b"nakamoto" in want[14]


class _Raising(KVStoreApplication):
    def deliver_tx(self, req):
        raise RuntimeError("app refused the tx")


class _JaxRaising(jax_kvstore.KVStoreApplication):
    def deliver_tx(self, req):
        raise RuntimeError("app refused the tx")


@pytest.mark.parametrize("side", ["port_server", "jax_server"])
def test_an_app_exception_reaches_the_client_as_abci_client_error(side):
    async def go():
        if side == "port_server":
            srv = port_server.SocketServer("tcp://127.0.0.1:0", _Raising())
            client_mod, types = jax_client, JT
        else:
            srv = jax_server.SocketServer("tcp://127.0.0.1:0", _JaxRaising())
            client_mod, types = port_client, T
        await srv.start()
        client = client_mod.SocketClient(f"tcp://127.0.0.1:{srv.listen_port}")
        await client.start()
        try:
            with pytest.raises(client_mod.ABCIClientError, match="abci app exception: app refused the tx"):
                await client.deliver_tx(types.RequestDeliverTx(tx=b"x=1"))
            # the connection is gone: a later call raises too
            with pytest.raises(client_mod.ABCIClientError):
                await client.echo("again")
        finally:
            await client.stop()
            await srv.stop()

    run(go())


def test_socket_client_must_connect_raises_without_a_server():
    async def go():
        import socket

        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        client = port_client.SocketClient(f"tcp://127.0.0.1:{port}", must_connect=True)
        with pytest.raises(OSError):
            await client.start()

    run(go())
