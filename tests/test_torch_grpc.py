"""The port's gRPC transports, held against the JAX package's
(after tests/test_abci_grpc.py and tests/test_privval_grpc.py).

- ABCI: every method round-trips against the kvstore app; the answer
  bytes of the port's server equal the JAX server's for the same request
  envelopes (each over a fresh kvstore app), an app that raises answers
  the same ResponseException, and the clients of either package talk to
  the server of the other; a stopped server is UNAVAILABLE to both;
- a port node with abci = "grpc" produces blocks against a gRPC app;
- privval: the request and answer bodies equal the JAX helpers'; the
  port's signer answers the JAX client with the JAX signer's bytes;
  a double sign is a RemoteSignerError, never the retried connection
  error; a stopped signer is a connection error; a node with a grpc://
  signer produces blocks;
- privval.release: a `signer --grpc` process armed with
  TM_TPU_FAULT="privval.release:hang" is SIGKILLed between its
  checkpoint and the release; the restarted signer re-releases the same
  signature, refuses a conflicting vote, and its state file holds the
  bytes of the JAX FilePV that signed the same vote.

Servers bind 127.0.0.1:0; every loop runs under a deadline.
"""

import asyncio
import os
import signal
import subprocess
import sys
import time

import pytest

from tendermint_tpu.abci import codec as jax_codec
from tendermint_tpu.abci import types as JT
from tendermint_tpu.abci.client import ABCIClientError as JaxABCIClientError
from tendermint_tpu.abci.grpc_transport import GRPCClient as JaxGRPCClient
from tendermint_tpu.abci.grpc_transport import GRPCServer as JaxGRPCServer
from tendermint_tpu.abci.kvstore import KVStoreApplication as JaxKVStore
from tendermint_tpu.crypto.ed25519 import PrivKeyEd25519 as JaxPriv
from tendermint_tpu.privval import grpc as jax_pv_grpc
from tendermint_tpu.privval.file import FilePV as JaxFilePV
from tendermint_tpu.types.proposal import Proposal as JaxProposal
from tendermint_tpu.types.vote import Vote as JaxVote
from tendermint_tpu_torch import workloads
from tendermint_tpu_torch.abci import codec
from tendermint_tpu_torch.abci import types as T
from tendermint_tpu_torch.abci.client import ABCIClientError
from tendermint_tpu_torch.abci.grpc_transport import GRPCClient, GRPCServer
from tendermint_tpu_torch.abci.kvstore import KVStoreApplication
from tendermint_tpu_torch.crypto.ed25519 import PrivKeyEd25519
from tendermint_tpu_torch.node import device as device_plane
from tendermint_tpu_torch.node import make_node
from tendermint_tpu_torch.privval import grpc as pv_grpc
from tendermint_tpu_torch.privval.file import FilePV
from tendermint_tpu_torch.privval.signer import RemoteSignerConnectionError, RemoteSignerError, RetrySignerClient
from tendermint_tpu_torch.types.block_id import BlockID, PartSetHeader
from tendermint_tpu_torch.types.canonical import PRECOMMIT_TYPE, PREVOTE_TYPE
from tendermint_tpu_torch.types.genesis import GenesisDoc, GenesisValidator
from tendermint_tpu_torch.types.proposal import Proposal
from tendermint_tpu_torch.types.vote import Vote

from .test_torch_isolation import jax_device_plane_paused  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHAIN = "grpc-signer-chain"
DEADLINE_S = 60.0


def run(coro, deadline_s: float = DEADLINE_S):
    return asyncio.run(asyncio.wait_for(coro, deadline_s))


@pytest.fixture(autouse=True)
def _uninstall():
    yield
    device_plane.uninstall_device_plane()


def _requests():
    """The same request envelopes in both packages' types: one of each
    method the kvstore app answers, and a malformed tx."""
    pairs = []
    for mod in (T, JT):
        pairs.append([
            mod.RequestEcho(message="ping"),
            mod.RequestFlush(),
            mod.RequestInfo(),
            mod.RequestCheckTx(tx=b"k=v"),
            mod.RequestCheckTx(tx=b"no-equals-sign"),
            mod.RequestBeginBlock(),
            mod.RequestDeliverTx(tx=b"k=v"),
            mod.RequestDeliverTx(tx=b"name=satoshi"),
            mod.RequestEndBlock(height=1),
            mod.RequestCommit(),
            mod.RequestQuery(path="/store", data=b"k"),
            mod.RequestQuery(path="/store", data=b"absent"),
            mod.RequestListSnapshots(),
        ])
    return pairs


async def _raw_answers(server_cls, app, payloads):
    """The answer bytes of one server to raw request envelopes, over a
    bare unary channel (the transport's one method)."""
    from grpc import aio as grpc_aio

    srv = server_cls("127.0.0.1:0", app)
    await srv.start()
    channel = grpc_aio.insecure_channel(f"127.0.0.1:{srv.bound_port}")
    call = channel.unary_unary("/tendermint_tpu.abci.ABCI/Process")
    try:
        return [await call(p) for p in payloads]
    finally:
        await channel.close()
        await srv.stop()


def test_abci_envelopes_and_answers_equal_jax():
    port_reqs, jax_reqs = _requests()
    payloads = [codec.encode_request(r) for r in port_reqs]
    assert payloads == [jax_codec.encode_request(r) for r in jax_reqs]

    async def go():
        got = await _raw_answers(GRPCServer, KVStoreApplication(), payloads)
        want = await _raw_answers(JaxGRPCServer, JaxKVStore(), payloads)
        return got, want

    got, want = run(go())
    assert got == want
    answers = [codec.decode_response(b) for b in got]
    assert answers[0].message == "ping" and answers[10].value == b"v"


def test_abci_roundtrip_all_methods_and_cross_package_clients():
    async def go():
        app = KVStoreApplication()
        port_srv, jax_srv = GRPCServer("127.0.0.1:0", app), JaxGRPCServer("127.0.0.1:0", JaxKVStore())
        await port_srv.start()
        await jax_srv.start()
        clients = [GRPCClient(f"grpc://127.0.0.1:{port_srv.bound_port}"),
                   JaxGRPCClient(f"127.0.0.1:{port_srv.bound_port}"),
                   GRPCClient(f"tcp://127.0.0.1:{jax_srv.bound_port}")]
        for c in clients:
            await c.start()
        try:
            port_client, jax_client, cross = clients
            assert (await port_client.echo("ping")).message == "ping"
            await port_client.flush()
            assert (await port_client.info(T.RequestInfo())).last_block_height == 0
            assert (await port_client.check_tx(T.RequestCheckTx(tx=b"k=v"))).is_ok
            await port_client.begin_block(T.RequestBeginBlock())
            assert (await port_client.deliver_tx(T.RequestDeliverTx(tx=b"k=v"))).is_ok
            await port_client.end_block(T.RequestEndBlock(height=1))
            assert (await port_client.commit()).data
            q = await port_client.query(T.RequestQuery(path="/store", data=b"k"))
            assert q.value == b"v"
            snap = app.take_snapshot()
            snaps = await port_client.list_snapshots(T.RequestListSnapshots())
            assert any(s.height == snap.height for s in snaps.snapshots)
            # the JAX client reads the port's app; the port client the JAX server
            jq = await jax_client.query(JT.RequestQuery(path="/store", data=b"k"))
            assert (jq.value, jq.log) == (q.value, q.log)
            await cross.deliver_tx(T.RequestDeliverTx(tx=b"a=b"))
            assert (await cross.commit()).data
        finally:
            for c in clients:
                await c.stop()
            await port_srv.stop()
            await jax_srv.stop()

    run(go())


def test_an_app_exception_and_a_stopped_server_are_client_errors():
    class Exploding(KVStoreApplication):
        def deliver_tx(self, req):
            raise RuntimeError("boom")

    class JaxExploding(JaxKVStore):
        def deliver_tx(self, req):
            raise RuntimeError("boom")

    async def go():
        errors = []
        for srv_cls, app, cli_cls, req, err_cls in (
            (GRPCServer, Exploding(), GRPCClient, T.RequestDeliverTx(tx=b"x"), ABCIClientError),
            (JaxGRPCServer, JaxExploding(), JaxGRPCClient, JT.RequestDeliverTx(tx=b"x"), JaxABCIClientError),
        ):
            srv = srv_cls("127.0.0.1:0", app)
            await srv.start()
            client = cli_cls(f"127.0.0.1:{srv.bound_port}")
            await client.start()
            try:
                with pytest.raises(err_cls) as err:
                    await client.deliver_tx(req)
                errors.append(str(err.value))
                # the transport outlives the app's exception
                assert (await client.echo("still-up")).message == "still-up"
            finally:
                await srv.stop()
            with pytest.raises(err_cls) as err:
                await client.echo("gone")
            errors.append(str(err.value).split(":")[:2])
            await client.stop()
        return errors

    port_boom, port_gone, jax_boom, jax_gone = run(go())
    assert port_boom == jax_boom == "abci app exception: RuntimeError('boom')"
    assert port_gone == jax_gone == ["grpc", " UNAVAILABLE"]


def _genesis(privs, chain_id="grpc-chain"):
    return GenesisDoc(chain_id=chain_id, genesis_time_ns=time.time_ns(),
                      validators=[GenesisValidator(pub_key=p.pub_key(), power=10) for p in privs])


def _validator_home(tmp_path, priv, genesis, **settings):
    home = str(tmp_path / "node")
    base = {"gpu": {"enable": False}, "rpc": {"laddr": "tcp://127.0.0.1:0"}, "p2p": {"laddr": "tcp://127.0.0.1:0"},
            "consensus": {"timeout_commit": 0.2}, "base": {"db_backend": "memdb"}}
    for section, values in settings.items():
        base.setdefault(section, {}).update(values)
    workloads.init_home(home, genesis.to_json(), base)
    FilePV.from_priv_key(priv, os.path.join(home, "config", "priv_validator_key.json"),
                         os.path.join(home, "data", "priv_validator_state.json")).save()
    from tendermint_tpu_torch.config import load_config

    cfg = load_config(os.path.join(home, "config", "config.toml"))
    cfg.base.home = home
    return cfg


def test_node_runs_against_a_grpc_app(tmp_path):
    priv = PrivKeyEd25519.from_seed(b"\x61" * 32)

    async def go():
        app_srv = GRPCServer("127.0.0.1:0", KVStoreApplication())
        await app_srv.start()
        cfg = _validator_home(tmp_path, priv, _genesis([priv]),
                              base={"abci": "grpc", "proxy_app": f"grpc://127.0.0.1:{app_srv.bound_port}"})
        node = make_node(cfg, device="cpu")
        assert node._app is None
        await node.start()
        try:
            await node.consensus.wait_for_height(3, timeout=DEADLINE_S)
            assert node.block_store.height() >= 2
        finally:
            await node.stop()
            await app_srv.stop()

    run(go())


def _block_id(tag: bytes = b"\xaa") -> BlockID:
    return BlockID(hash=tag * 32, part_set_header=PartSetHeader(total=1, hash=b"\xbb" * 32))


def _vote(pk, height=7, tag=b"\xaa", ts=1_000, vtype=PRECOMMIT_TYPE):
    return Vote(type=vtype, height=height, round=0, block_id=_block_id(tag), timestamp_ns=ts,
                validator_address=pk.address(), validator_index=0)


def test_signer_bodies_and_answers_equal_jax(tmp_path):
    priv = PrivKeyEd25519.from_seed(b"\x41" * 32)
    vote = _vote(priv.pub_key())
    assert pv_grpc.request_bytes(CHAIN, vote.to_proto()) == jax_pv_grpc._req(CHAIN, vote.to_proto())
    assert pv_grpc.request_bytes("") == jax_pv_grpc._req("")
    assert pv_grpc.response_bytes(b"\x01\x02") == jax_pv_grpc._resp(b"\x01\x02")

    async def go():
        (tmp_path / "p").mkdir()
        (tmp_path / "j").mkdir()
        port_pv = FilePV.from_priv_key(priv, str(tmp_path / "p" / "k.json"), str(tmp_path / "p" / "s.json"))
        jax_pv = JaxFilePV.from_priv_key(JaxPriv.from_seed(b"\x41" * 32), str(tmp_path / "j" / "k.json"),
                                         str(tmp_path / "j" / "s.json"))
        servers = [pv_grpc.GRPCSignerServer("127.0.0.1:0", CHAIN, port_pv),
                   jax_pv_grpc.GRPCSignerServer("127.0.0.1:0", CHAIN, jax_pv)]
        for s in servers:
            await s.start()
        # the JAX client asks the port's signer; the port client the JAX one
        clients = [jax_pv_grpc.GRPCSignerClient(f"grpc://127.0.0.1:{servers[0].bound_port}"),
                   pv_grpc.GRPCSignerClient(f"grpc://127.0.0.1:{servers[1].bound_port}")]
        for c in clients:
            await c.start()
        try:
            signed = []
            for c, make in ((clients[0], lambda: JaxVote.from_proto(vote.to_proto())),
                            (clients[1], lambda: Vote.from_proto(vote.to_proto()))):
                v = make()
                await c.sign_vote(CHAIN, v)
                signed.append(v.to_proto())
                assert (await c.get_pub_key()).bytes() == priv.pub_key().bytes()
            prop = Proposal(height=8, round=0, pol_round=-1, block_id=_block_id(b"\xcc"), timestamp_ns=5)
            jax_prop = JaxProposal.from_proto(prop.to_proto())
            await clients[0].sign_proposal(CHAIN, jax_prop)
            await clients[1].sign_proposal(CHAIN, prop)
            assert prop.to_proto() == jax_prop.to_proto()
            assert priv.pub_key().verify_signature(prop.sign_bytes(CHAIN), prop.signature)
            return signed
        finally:
            for c in clients:
                await c.stop()
            for s in servers:
                await s.stop()

    port_signed, jax_signed = run(go())
    assert port_signed == jax_signed
    assert (tmp_path / "p" / "s.json").read_bytes() == (tmp_path / "j" / "s.json").read_bytes()


def test_double_sign_refused_and_a_stopped_signer_is_a_connection_error(tmp_path):
    async def go():
        pv = FilePV.from_priv_key(PrivKeyEd25519.from_seed(b"\x41" * 32), str(tmp_path / "k.json"),
                                  str(tmp_path / "s.json"))
        server = pv_grpc.GRPCSignerServer("127.0.0.1:0", CHAIN, pv)
        await server.start()
        client = pv_grpc.GRPCSignerClient(f"grpc://127.0.0.1:{server.bound_port}")
        await client.start()
        try:
            pk = await client.get_pub_key()
            await client.sign_vote(CHAIN, _vote(pk, tag=b"\xaa"))
            with pytest.raises(RemoteSignerError) as err:
                await client.sign_vote(CHAIN, _vote(pk, tag=b"\xdd"))
            assert not isinstance(err.value, RemoteSignerConnectionError)
            assert "INVALID_ARGUMENT" in str(err.value) and "conflicting data" in str(err.value)
            await server.stop()
            client.timeout = 0.5
            with pytest.raises(RemoteSignerConnectionError):
                await client.get_pub_key()
        finally:
            await client.stop()
            await server.stop()

    run(go())


def test_node_with_a_grpc_signer_produces_blocks(tmp_path):
    priv = PrivKeyEd25519.from_seed(b"\x61" * 32)

    async def go():
        genesis = _genesis([priv], "grpc-signer-node")
        pv = FilePV.from_priv_key(priv, str(tmp_path / "signer_key.json"), str(tmp_path / "signer_state.json"))
        server = pv_grpc.GRPCSignerServer("127.0.0.1:0", genesis.chain_id, pv)
        await server.start()
        cfg = _validator_home(tmp_path, PrivKeyEd25519.from_seed(b"\x62" * 32), genesis,
                              priv_validator={"listen_addr": f"grpc://127.0.0.1:{server.bound_port}"})
        node = make_node(cfg, device="cpu")
        assert isinstance(node.privval, RetrySignerClient)
        assert isinstance(node.privval.inner, pv_grpc.GRPCSignerClient)
        await node.start()
        try:
            await node.consensus.wait_for_height(3, timeout=DEADLINE_S)
            assert node.block_store.height() >= 2
        finally:
            await node.stop()
            await server.stop()

    run(go())


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn_signer(home: str, port: int, fault: str = ""):
    env = dict(os.environ, PYTHONPATH=REPO, TM_TPU_FAULT=fault)
    return subprocess.Popen(
        [sys.executable, "-m", "tendermint_tpu_torch.cmd", "--home", home, "signer", "--grpc",
         "--addr", f"127.0.0.1:{port}"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, cwd=REPO,
    )


def test_a_signer_killed_at_privval_release_re_releases_the_same_signature(tmp_path):
    priv = PrivKeyEd25519.from_seed(b"\x47" * 32)
    home = str(tmp_path / "signer")
    workloads.init_home(home, _genesis([priv], CHAIN).to_json(), {"gpu": {"enable": False}})
    state_path = os.path.join(home, "data", "priv_validator_state.json")
    FilePV.from_priv_key(priv, os.path.join(home, "config", "priv_validator_key.json"), state_path).save()
    # the JAX FilePV signs the same vote, with no fault
    (tmp_path / "jax").mkdir()
    jax_pv = JaxFilePV.from_priv_key(JaxPriv.from_seed(b"\x47" * 32), str(tmp_path / "jax" / "k.json"),
                                     str(tmp_path / "jax" / "s.json"))
    jax_pv.save()
    pk = priv.pub_key()
    first = _vote(pk, height=5, ts=1_000, vtype=PREVOTE_TYPE)
    jv = JaxVote.from_proto(first.to_proto())
    asyncio.run(jax_pv.sign_vote(CHAIN, jv))

    async def connect(port):
        client = pv_grpc.GRPCSignerClient(f"grpc://127.0.0.1:{port}", timeout=2.0)
        await client.start()
        while True:
            try:
                await client.get_pub_key()
                return client
            except RemoteSignerConnectionError:
                await asyncio.sleep(0.1)

    port = _free_port()
    proc = _spawn_signer(home, port, fault="privval.release:hang:hang_s=120")
    try:
        async def hung():
            client = await connect(port)
            try:
                with pytest.raises(RemoteSignerConnectionError, match="DEADLINE_EXCEEDED"):
                    await client.sign_vote(CHAIN, Vote.from_proto(first.to_proto()))
            finally:
                await client.stop()

        run(hung())
        # the checkpoint is on disk; the signature never left
        assert FilePV.load(os.path.join(home, "config", "priv_validator_key.json"),
                           state_path).last_sign_state.height == 5
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=10)
        checkpoint = open(state_path, "rb").read()
        assert checkpoint == open(tmp_path / "jax" / "s.json", "rb").read()

        proc = _spawn_signer(home, port)

        async def restarted():
            client = await connect(port)
            try:
                again = _vote(pk, height=5, ts=9_000, vtype=PREVOTE_TYPE)
                await client.sign_vote(CHAIN, again)
                with pytest.raises(RemoteSignerError) as err:
                    await client.sign_vote(CHAIN, _vote(pk, height=5, tag=b"\xdd", ts=9_000, vtype=PREVOTE_TYPE))
                assert not isinstance(err.value, RemoteSignerConnectionError)
                return again
            finally:
                await client.stop()

        again = run(restarted())
        assert (again.signature, again.timestamp_ns) == (jv.signature, 1_000)
        assert pk.verify_signature(first.sign_bytes(CHAIN), again.signature)
        assert open(state_path, "rb").read() == checkpoint
    finally:
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
            try:
                proc.wait(timeout=15)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
    assert proc.returncode == 0
