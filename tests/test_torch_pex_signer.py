"""The port's PEX, remote signer and evidence gossip messages held
against the JAX package's.

- EvidenceListMessage (duplicate votes and a light-client attack),
  PexRequest and PexResponse, and every remote-signer message (requests,
  replies, error replies) have equal wire bytes and decode alike; the
  channel descriptors match;
- two port nodes exchange addresses through their PEX reactors on a
  MemoryNetwork (the poller learns the responder's other peer) and an
  unsolicited response is reported as the peer's error, as the JAX
  reactor does;
- the port's SignerServer serves the JAX SignerListenerEndpoint (behind
  RetrySignerClient), and the JAX SignerServer serves the port's, over
  SecretConnection on 127.0.0.1:0: the same public key, the signatures
  and timestamps FilePV makes of the same key and requests, a
  double-sign refused with the same message, a ping answered.
Tolerance: zero.
"""

import asyncio

import numpy as np
import pytest

from tendermint_tpu.crypto.ed25519 import PrivKeyEd25519 as JaxPrivKey
from tendermint_tpu.evidence import reactor as jax_ev_reactor
from tendermint_tpu.p2p import pex as jax_pex
from tendermint_tpu.privval import signer as jax_signer
from tendermint_tpu.privval.file import FilePV as JaxFilePV
from tendermint_tpu.types.proposal import Proposal as JaxProposal
from tendermint_tpu.types.vote import Vote as JaxVote
from tendermint_tpu_torch import workloads
from tendermint_tpu_torch.evidence import reactor as port_ev_reactor
from tendermint_tpu_torch.p2p import pex as port_pex
from tendermint_tpu_torch.p2p.p2ptest import TestNetwork
from tendermint_tpu_torch.p2p.types import Envelope, PeerError
from tendermint_tpu_torch.privval import signer as port_signer
from tendermint_tpu_torch.privval.file import FilePV
from tendermint_tpu_torch.types.block_id import BlockID, PartSetHeader
from tendermint_tpu_torch.types.canonical import PRECOMMIT_TYPE, PREVOTE_TYPE
from tendermint_tpu_torch.types.evidence import DuplicateVoteEvidence
from tendermint_tpu_torch.types.proposal import Proposal
from tendermint_tpu_torch.types.validator import Validator, ValidatorSet
from tendermint_tpu_torch.types.vote import Vote

from .test_torch_isolation import jax_device_plane_paused  # noqa: F401 (autouse)

CHAIN_ID = "torch-signer-chain"
SEED = 71


def run(coro):
    return asyncio.run(coro)


def _duplicates(n: int) -> list:
    privs = workloads.seeded_keys(6, SEED, 2)
    vals = ValidatorSet([Validator(pub_key=p.pub_key(), voting_power=10) for p in privs])
    out = []
    for k in range(n):
        i = k % len(privs)
        idx, val = vals.get_by_address(privs[i].pub_key().address())
        votes = []
        for tag in (b"\xaa", b"\xbb"):
            v = Vote(type=PREVOTE_TYPE if k % 2 else PRECOMMIT_TYPE, height=3 + k, round=k % 2,
                     block_id=BlockID(tag * 32, PartSetHeader(1, tag * 32)), timestamp_ns=5 + k,
                     validator_address=val.address, validator_index=idx)
            v.signature = privs[i].sign(v.sign_bytes(CHAIN_ID), rng=np.random.default_rng(k).bytes) \
                if privs[i].type() == "sr25519" else privs[i].sign(v.sign_bytes(CHAIN_ID))
            votes.append(v)
        out.append(DuplicateVoteEvidence.from_votes(votes[0], votes[1], 1_000 + k, vals))
    return out


@pytest.mark.parametrize("n", [0, 1, 3, 70])
def test_evidence_list_message_bytes_equal_jax(n):
    evs = _duplicates(n)
    data = port_ev_reactor.EvidenceListMessage(evidence=tuple(evs)).to_proto()
    jmsg = jax_ev_reactor.EvidenceListMessage.from_proto(data)
    assert jmsg.to_proto() == data
    back = port_ev_reactor.EvidenceListMessage.from_proto(data)
    assert [e.hash() for e in back.evidence] == [e.hash() for e in evs] == [e.hash() for e in jmsg.evidence]
    p, j = port_ev_reactor.evidence_channel_descriptor(), jax_ev_reactor.evidence_channel_descriptor()
    fields = ("channel_id", "priority", "send_queue_capacity", "recv_buffer_capacity", "name")
    assert [getattr(p, f) for f in fields] == [getattr(j, f) for f in fields]
    assert port_ev_reactor.MAX_MSG_EVIDENCE == jax_ev_reactor.MAX_MSG_EVIDENCE


def test_evidence_list_message_carries_a_light_client_attack():
    from .test_torch_consensus_reactor import _attack_node

    node, ev = _attack_node()
    node.close()
    data = port_ev_reactor.EvidenceListMessage(evidence=(ev,) + tuple(_duplicates(2))).to_proto()
    assert jax_ev_reactor.EvidenceListMessage.from_proto(data).to_proto() == data


@pytest.mark.parametrize("seed", range(3))
def test_pex_messages_bytes_equal_jax(seed):
    rng = np.random.default_rng(seed)
    msgs = [port_pex.PexRequest()]
    for _ in range(5):
        msgs.append(port_pex.PexResponse(addresses=[
            f"{rng.bytes(20).hex()}@10.0.{int(rng.integers(0, 255))}.1:{int(rng.integers(1, 65535))}"
            for _ in range(int(rng.integers(0, 101)))
        ]))
    pc = port_pex.pex_channel_descriptor().message_type
    jc = jax_pex.pex_channel_descriptor().message_type
    for m in msgs:
        jm = jax_pex.PexRequest() if isinstance(m, port_pex.PexRequest) else jax_pex.PexResponse(list(m.addresses))
        data = pc.encode(m)
        assert data == jc.encode(jm)
        assert type(pc.decode(data)).__name__ == type(jc.decode(data)).__name__
        assert getattr(pc.decode(data), "addresses", None) == getattr(jc.decode(data), "addresses", None)
    for bad in (b"", b"\x1a\x00"):
        with pytest.raises(ValueError) as a:
            pc.decode(bad)
        with pytest.raises(ValueError) as b:
            jc.decode(bad)
        assert str(a.value) == str(b.value)
    p, j = port_pex.pex_channel_descriptor(), jax_pex.pex_channel_descriptor()
    fields = ("channel_id", "priority", "send_queue_capacity", "recv_message_capacity", "name")
    assert [getattr(p, f) for f in fields] == [getattr(j, f) for f in fields]


def test_pex_reactors_exchange_addresses_and_police_unsolicited_responses():
    async def go():
        net = TestNetwork(3, chain_id=CHAIN_ID)
        a, b, c = net.nodes
        reactors = []
        for node in (a, b):
            ch = node.open_channel(port_pex.pex_channel_descriptor())
            reactors.append((port_pex.PexReactor(node.peer_manager, ch, node.peer_manager.subscribe()), ch))
        for node in net.nodes:
            await node.router.start()
        # a knows b; b knows c: a's poll of b teaches it c
        a.peer_manager.add(f"{b.node_id}@{b.addr}")
        b.peer_manager.add(f"{c.node_id}@{c.addr}")
        for r, _ch in reactors:
            await r.start()
        try:
            deadline = asyncio.get_running_loop().time() + 10
            while c.node_id not in [p for p in a.peer_manager.peers()] and reactors[0][0].total_added == 0:
                assert asyncio.get_running_loop().time() < deadline, "a never learned c"
                await asyncio.sleep(0.01)
            # an unsolicited response is the sender's error
            errors = reactors[1][1].error_queue
            before = errors.qsize()
            await reactors[1][0]._handle_response(a.node_id, port_pex.PexResponse(addresses=[]))
            got = errors.get_nowait() if errors.qsize() > before else None
        finally:
            for r, _ch in reactors:
                await r.stop()
            await net.stop()
        return reactors[0][0].total_added, got

    added, err = run(go())
    assert added >= 1
    assert isinstance(err, PeerError) and err.err == "unsolicited pex response"


def test_signer_messages_bytes_equal_jax():
    privs = workloads.seeded_keys(1, SEED)
    vote = Vote(type=PREVOTE_TYPE, height=5, round=1,
                block_id=BlockID(b"\x12" * 32, PartSetHeader(2, b"\x34" * 32)), timestamp_ns=77,
                validator_address=privs[0].pub_key().address(), validator_index=3)
    proposal = Proposal(height=5, round=1, pol_round=0, block_id=vote.block_id, timestamp_ns=78)
    for payload in (b"", vote.to_proto(), proposal.to_proto()):
        for cid in ("", CHAIN_ID):
            assert port_signer._req_body(cid, payload) == jax_signer._req_body(cid, payload)
        for err in ("", "double sign"):
            assert port_signer._resp_body(payload, err) == jax_signer._resp_body(payload, err)
    for field in range(1, 9):
        body = port_signer._req_body(CHAIN_ID, vote.to_proto())
        data = port_signer._msg(field, body)
        assert data == jax_signer._msg(field, body)
        assert port_signer._parse(data) == jax_signer._parse(data)
    for bad in (b"", b"\x52\x00"):
        with pytest.raises(ValueError) as a:
            port_signer._parse(bad)
        with pytest.raises(ValueError) as b:
            jax_signer._parse(bad)
        assert str(a.value) == str(b.value)


def _filepvs(tmp_path, pkg: str):
    key = workloads.seeded_keys(1, SEED)[0]
    home = tmp_path / pkg
    (home / "config").mkdir(parents=True)
    (home / "data").mkdir(parents=True)
    paths = (str(home / "config" / "k.json"), str(home / "data" / "s.json"))
    pv = (FilePV.from_priv_key(key, *paths) if pkg == "port"
          else JaxFilePV.from_priv_key(JaxPrivKey.from_seed(key.bytes()[:32]), *paths))
    pv.save()
    return pv


def _requests():
    addr = workloads.seeded_keys(1, SEED)[0].pub_key().address()
    bid = BlockID(b"\x12" * 32, PartSetHeader(2, b"\x34" * 32))
    other = BlockID(b"\x56" * 32, PartSetHeader(2, b"\x34" * 32))
    out = []
    for h, r, t, b in ((4, 0, PREVOTE_TYPE, bid), (4, 0, PRECOMMIT_TYPE, bid), (5, 0, PREVOTE_TYPE, bid),
                       (5, 0, PREVOTE_TYPE, other)):
        out.append(("vote", Vote(type=t, height=h, round=r, block_id=b, timestamp_ns=1_000 + h,
                                 validator_address=addr, validator_index=0)))
    out.insert(2, ("proposal", Proposal(height=5, round=0, pol_round=-1, block_id=bid, timestamp_ns=999)))
    return out


async def _serve(listener_pkg: str, tmp_path) -> list:
    """One package's node-side endpoint on 127.0.0.1:0 and the other's
    SignerServer dialing it; the requests through the endpoint."""
    node_key = workloads.node_key(SEED, 1)
    if listener_pkg == "jax":
        endpoint = jax_signer.SignerListenerEndpoint("tcp://127.0.0.1:0", JaxPrivKey.from_seed(node_key.bytes()[:32]))
        client = jax_signer.RetrySignerClient(endpoint, retries=2, delay=0.05)
        server_cls, pv, sign_key = port_signer.SignerServer, _filepvs(tmp_path, "port"), workloads.node_key(SEED, 2)
        vote_cls, prop_cls = JaxVote, JaxProposal
    else:
        endpoint = port_signer.SignerListenerEndpoint("tcp://127.0.0.1:0", node_key)
        client = port_signer.RetrySignerClient(endpoint, retries=2, delay=0.05)
        server_cls, pv = jax_signer.SignerServer, _filepvs(tmp_path, "jax")
        sign_key = JaxPrivKey.from_seed(workloads.node_key(SEED, 2).bytes()[:32])
        vote_cls, prop_cls = Vote, Proposal
    await endpoint.start()
    server = server_cls(f"tcp://127.0.0.1:{endpoint.bound_port}", pv, signer_priv_key=sign_key,
                        redial_delay=0.05, chain_id=CHAIN_ID)
    await server.start()
    out = []
    try:
        out.append(("pubkey", (await client.get_pub_key()).bytes()))
        for kind, req in _requests():
            obj = (vote_cls if kind == "vote" else prop_cls).from_proto(req.to_proto())
            try:
                if kind == "vote":
                    await client.sign_vote(CHAIN_ID, obj)
                else:
                    await client.sign_proposal(CHAIN_ID, obj)
                out.append((kind, obj.signature, obj.timestamp_ns))
            except Exception as e:  # the refusal compared IS the exception
                out.append((kind, type(e).__name__, str(e)))
        await endpoint.ping()
        out.append(("ping", "ok"))
    finally:
        await server.stop()
        await endpoint.stop()
    return out


def test_signers_serve_each_other_over_secret_connection(tmp_path):
    port_serves = run(_serve("jax", tmp_path / "a"))
    jax_serves = run(_serve("port", tmp_path / "b"))
    assert port_serves == jax_serves
    assert port_serves[0][1] == workloads.seeded_keys(1, SEED)[0].pub_key().bytes()
    kinds = [r[1] for r in port_serves[1:-1]]
    assert kinds[-1] == "RemoteSignerError" and "conflicting data" in port_serves[-2][2]
    assert all(isinstance(k, bytes) and len(k) == 64 for k in kinds[:-1])
