"""The port's p2p core and symmetric crypto held against the JAX package's.

- crypto/symmetric.py: the ChaCha20 block, HChaCha20, the RFC 8439 AEAD
  and XChaCha20-Poly1305 against the JAX module, which here runs the
  `cryptography` package's OpenSSL AEAD; the RFC 8439 §2.8.2 and
  HChaCha20 vectors (tests/test_symmetric.py, tests/test_crypto.py);
- p2p/conn.py: X25519 against the RFC 7748 vectors and OpenSSL, the key
  derivation and the auth signature bytes, and SecretConnection's wire
  bytes, byte for byte, against the JAX conn.py with fixed ephemeral
  keys (tests/test_conn_vectors.py), then a port-to-JAX handshake and
  traffic over a 127.0.0.1:0 socket pair;
- p2p/types.py: NodeInfo's proto bytes, its checks, and node addresses;
- p2p/peermanager.py: seeded add/dial/score/disconnect sequences, every
  return, error and peer's state compared after each action;
- p2p/router.py on MemoryNetwork under partition, drop, duplicate and
  delay plans of each package's fault plane: what each router delivers.

Tolerance: zero. One divergence is a decision (ROADMAP §3): a tampered
frame raises ValueError("authentication failed") in the port, as in the
JAX module's pure route, where its OpenSSL route raises InvalidTag; the
router drops the peer either way. No socket but 127.0.0.1:0 is opened.
"""

import asyncio
import random

import numpy as np
import pytest
from cryptography.exceptions import InvalidTag
from cryptography.hazmat.primitives.asymmetric.x25519 import X25519PrivateKey as OsslX25519

from tendermint_tpu.crypto import faults as jax_faults
from tendermint_tpu.crypto import symmetric as jax_sym
from tendermint_tpu.crypto.ed25519 import PrivKeyEd25519 as JaxPrivKey
from tendermint_tpu.libs.metrics import Registry
from tendermint_tpu.mempool import reactor as jax_reactor
from tendermint_tpu.p2p import conn as jax_conn
from tendermint_tpu.p2p import peermanager as jax_pm
from tendermint_tpu.p2p import router as jax_router
from tendermint_tpu.p2p import transport as jax_transport
from tendermint_tpu.p2p import types as jax_types
from tendermint_tpu.p2p.metrics import P2PMetrics
from tendermint_tpu_torch.crypto import faults as port_faults
from tendermint_tpu_torch.crypto import symmetric as port_sym
from tendermint_tpu_torch.crypto.ed25519 import PrivKeyEd25519 as PortPrivKey
from tendermint_tpu_torch.mempool import reactor as port_reactor
from tendermint_tpu_torch.p2p import conn as port_conn
from tendermint_tpu_torch.p2p import peermanager as port_pm
from tendermint_tpu_torch.p2p import router as port_router
from tendermint_tpu_torch.p2p import transport as port_transport
from tendermint_tpu_torch.p2p import types as port_types


def run(coro):
    return asyncio.run(coro)


@pytest.fixture(autouse=True)
def _planes():
    jax_faults.reset()
    port_faults.reset()
    yield
    jax_faults.reset()
    port_faults.reset()


# -- crypto/symmetric.py --


@pytest.mark.parametrize("seed", range(4))
def test_symmetric_equal_jax_openssl(seed):
    """Seeded keys, nonces, plaintexts (0-300 bytes) and AADs: the
    block, HChaCha20, the AEAD and XChaCha20-Poly1305 give the JAX
    module's bytes (its AEAD is OpenSSL's here), and each opens the
    other's boxes."""
    assert jax_sym.ChaCha20Poly1305 is not None  # the OpenSSL route
    rng = np.random.default_rng(seed)
    for _ in range(12):
        key, n12, n24 = rng.bytes(32), rng.bytes(12), rng.bytes(24)
        pt = rng.bytes(int(rng.integers(0, 300)))
        aad = rng.bytes(int(rng.integers(0, 40))) if rng.random() < 0.7 else None
        counter = int(rng.integers(0, 1 << 32))
        assert port_sym.chacha20_block(key, counter, n12) == jax_sym.chacha20_block(key, counter, n12)
        assert port_sym.hchacha20(key, n24[:16]) == jax_sym.hchacha20(key, n24[:16])
        ossl = jax_sym.ChaCha20Poly1305(key)
        box = port_sym.PureChaCha20Poly1305(key).encrypt(n12, pt, aad)
        assert box == ossl.encrypt(n12, pt, aad)
        assert port_sym.PureChaCha20Poly1305(key).decrypt(n12, box, aad) == pt
        xbox = port_sym.XChaCha20Poly1305(key).encrypt(n24, pt, aad)
        assert xbox == jax_sym.XChaCha20Poly1305(key).encrypt(n24, pt, aad)
        assert jax_sym.XChaCha20Poly1305(key).decrypt(n24, xbox, aad) == pt
        sealed = jax_sym.encrypt_symmetric(pt, key)
        assert port_sym.decrypt_symmetric(sealed, key) == pt
        assert jax_sym.decrypt_symmetric(port_sym.encrypt_symmetric(pt, key), key) == pt


def test_symmetric_rfc_vectors_and_refusals():
    key = bytes(range(0x80, 0xA0))
    nonce = bytes.fromhex("070000004041424344454647")
    aad = bytes.fromhex("50515253c0c1c2c3c4c5c6c7")
    pt = (b"Ladies and Gentlemen of the class of '99: If I could offer you "
          b"only one tip for the future, sunscreen would be it.")
    out = port_sym.PureChaCha20Poly1305(key).encrypt(nonce, pt, aad)
    assert out[:16] == bytes.fromhex("d31a8d34648e60db7b86afbc53ef7ec2")
    assert out[-16:] == bytes.fromhex("1ae10b594f09e26a7e902ecbd0600691")
    assert out == jax_sym.PureChaCha20Poly1305(key).encrypt(nonce, pt, aad)
    assert port_sym.hchacha20(
        bytes(range(32)), bytes.fromhex("000000090000004a0000000031415927")
    ) == bytes.fromhex("82413b4227b27bfed30e42508a877d73a0f9e4d58a74a853c12ec41326d3ecdc")
    # the refusals: the port's messages are the JAX module's
    for fn, args in (
        (lambda m, *a: m.decrypt_symmetric(*a), (b"short", b"\x0c" * 32)),
        (lambda m, *a: m.encrypt_symmetric(*a), (b"x", b"bad-size-key")),
        (lambda m, *a: m.PureChaCha20Poly1305(*a), (b"k",)),
        (lambda m, *a: m.hchacha20(*a), (b"\x00" * 32, b"\x00" * 15)),
        (lambda m, *a: m.XChaCha20Poly1305(b"\x00" * 32).encrypt(*a), (b"\x00" * 23, b"pt")),
    ):
        got = []
        for mod in (jax_sym, port_sym):
            with pytest.raises(ValueError) as e:
                fn(mod, *args)
            got.append(str(e.value))
        assert got[0] == got[1]


def test_tampered_box_raises_value_error_where_openssl_raises_invalid_tag():
    """The decision of ROADMAP §3: the port has only the pure AEAD, whose
    tampered-box error is the JAX pure route's ValueError; the JAX
    module's OpenSSL route raises InvalidTag for the same box."""
    key, nonce = b"\x42" * 32, b"\x01" * 12
    box = bytearray(port_sym.PureChaCha20Poly1305(key).encrypt(nonce, b"payload", None))
    box[0] ^= 1
    with pytest.raises(ValueError, match="authentication failed"):
        port_sym.PureChaCha20Poly1305(key).decrypt(nonce, bytes(box), None)
    with pytest.raises(ValueError, match="authentication failed"):
        jax_sym.PureChaCha20Poly1305(key).decrypt(nonce, bytes(box), None)
    with pytest.raises(InvalidTag):
        jax_sym.ChaCha20Poly1305(key).decrypt(nonce, bytes(box), None)


# -- p2p/conn.py --


def test_x25519_rfc7748_and_openssl():
    k = bytes.fromhex("a546e36bf0527c9d3b16154b82465edd62144c0ac1fc5a18506a2244ba449ac4")
    u = bytes.fromhex("e6db6867583030db3594c1a424b15f7c726624ec26b3353b10a903a6d0ab1c4c")
    assert port_conn._x25519_scalarmult(k, u).hex() == (
        "c3da55379de9c6908e94ea4df28d084f32eccf03491c71f754b4075577a28552"
    )
    rng = np.random.default_rng(7)
    for _ in range(8):
        a, b = rng.bytes(32), rng.bytes(32)
        pa, pb = port_conn.X25519PrivateKey(a), port_conn.X25519PrivateKey(b)
        oa, ob = OsslX25519.from_private_bytes(a), OsslX25519.from_private_bytes(b)
        assert pa.public_key().public_bytes() == oa.public_key().public_bytes_raw()
        shared = pa.exchange(pb.public_key())
        assert shared == oa.exchange(ob.public_key()) == pb.exchange(pa.public_key())
    with pytest.raises(ValueError, match="low-order"):
        port_conn.X25519PrivateKey(b"\x01" * 32).exchange(port_conn.X25519PublicKey(b"\x00" * 32))


def test_derive_and_auth_sig_equal_jax():
    rng = np.random.default_rng(3)
    for _ in range(6):
        shared, e1, e2 = rng.bytes(32), rng.bytes(32), rng.bytes(32)
        assert port_conn._derive(shared, e1, e2) == jax_conn._derive(shared, e1, e2)
        assert port_conn._hkdf_sha256(shared, 77, b"info") == jax_conn._hkdf_sha256(shared, 77, b"info")
    seed = b"\x07" * 32
    pp, jp = PortPrivKey.from_seed(seed), JaxPrivKey.from_seed(seed)
    sig = pp.sign(b"challenge")
    data = port_conn._auth_sig_bytes(pp.pub_key(), sig)
    assert data == jax_conn._auth_sig_bytes(jp.pub_key(), jp.sign(b"challenge"))
    pub, parsed = port_conn._parse_auth_sig(data)
    assert (pub.bytes(), parsed) == (pp.pub_key().bytes(), sig)
    assert port_conn.SecretConnection._nonce(None, 2**40) == jax_conn.SecretConnection._nonce(None, 2**40)


EPH = {"side-a": bytes(range(1, 33)), "side-b": bytes(range(101, 133))}
NODE_SEEDS = {"side-a": b"\x0a" * 32, "side-b": b"\x0b" * 32}


class _JaxFixedX25519:
    """Stands in for the `cryptography` class in the JAX conn.py: the
    ephemeral key of the task that asks for one."""

    @staticmethod
    def generate():
        return OsslX25519.from_private_bytes(EPH[asyncio.current_task().get_name()])


def _fixed_ephemerals(monkeypatch):
    monkeypatch.setattr(jax_conn, "X25519PrivateKey", _JaxFixedX25519)
    monkeypatch.setattr(
        port_conn.X25519PrivateKey, "generate",
        classmethod(lambda cls: cls(EPH[asyncio.current_task().get_name()])),
    )


async def _socket_pair():
    """(reader, writer) of both ends of one 127.0.0.1:0 connection."""
    accepted = asyncio.get_running_loop().create_future()

    async def on_client(reader, writer):
        accepted.set_result((reader, writer))

    server = await asyncio.start_server(on_client, "127.0.0.1", 0)
    port = server.sockets[0].getsockname()[1]
    client = await asyncio.open_connection("127.0.0.1", port)
    return server, client, await accepted


def _recording(writer, into: list):
    inner = writer.write

    def write(data):
        into.append(bytes(data))
        return inner(data)

    writer.write = write


async def _exchange(conn_a, conn_b, keys) -> dict:
    """Handshake side a (conn module conn_a, node key keys[0]) with side
    b over a socket pair, then frames both ways; every byte each side
    wrote, what each read, and the authenticated keys."""
    server, (ra, wa), (rb, wb) = await _socket_pair()
    wrote = {"side-a": [], "side-b": []}
    _recording(wa, wrote["side-a"])
    _recording(wb, wrote["side-b"])
    ta = asyncio.create_task(conn_a.SecretConnection.handshake(ra, wa, keys[0]), name="side-a")
    tb = asyncio.create_task(conn_b.SecretConnection.handshake(rb, wb, keys[1]), name="side-b")
    sa, sb = await asyncio.wait_for(asyncio.gather(ta, tb), 10)
    read = []
    for msg in (b"node-info-a", b"", b"x" * 1000):
        await sa.write_frame(msg)
        read.append(await sb.read_frame())
    await sb.write_frame(b"ack")
    read.append(await sa.read_frame())
    out = {"wrote": wrote, "read": read,
           "remote": (sa.remote_pubkey.bytes(), sb.remote_pubkey.bytes())}
    sa.close()
    sb.close()
    server.close()
    await server.wait_closed()
    return out


def test_secret_connection_bytes_equal_jax(monkeypatch):
    """With the ephemeral keys fixed, both packages write the same bytes
    on the wire: the ephemeral keys, the AuthSig frames and every AEAD
    frame after them."""
    _fixed_ephemerals(monkeypatch)
    port_keys = [PortPrivKey.from_seed(NODE_SEEDS[s]) for s in ("side-a", "side-b")]
    jax_keys = [JaxPrivKey.from_seed(NODE_SEEDS[s]) for s in ("side-a", "side-b")]
    port = run(_exchange(port_conn, port_conn, port_keys))
    jax = run(_exchange(jax_conn, jax_conn, jax_keys))
    assert port == jax
    assert b"".join(port["wrote"]["side-a"])[:32] == port_conn.X25519PrivateKey(EPH["side-a"]).public_key().public_bytes()
    assert port["remote"] == (port_keys[1].pub_key().bytes(), port_keys[0].pub_key().bytes())


@pytest.mark.parametrize("port_side", ["side-a", "side-b"])
def test_port_to_jax_handshake_over_a_socket(port_side):
    """The port on one end, the JAX package (OpenSSL) on the other:
    both authenticate the other's key and read the other's frames."""
    mods = {"side-a": jax_conn, "side-b": jax_conn, port_side: port_conn}
    keys = [
        (PortPrivKey if mods[s] is port_conn else JaxPrivKey).from_seed(NODE_SEEDS[s])
        for s in ("side-a", "side-b")
    ]
    out = run(_exchange(mods["side-a"], mods["side-b"], keys))
    assert out["read"] == [b"node-info-a", b"", b"x" * 1000, b"ack"]
    assert out["remote"] == (keys[1].pub_key().bytes(), keys[0].pub_key().bytes())


# -- p2p/types.py --


def _node_infos(seed):
    rng = np.random.default_rng(seed)
    for i in range(10):
        yield dict(
            node_id=rng.bytes(20).hex(),
            listen_addr=f"10.0.{i}.1:{int(rng.integers(1, 65535))}",
            network=f"chain-{int(rng.integers(0, 3))}",
            version="0.1.%d" % i,
            channels=bytes(rng.integers(0, 256, int(rng.integers(0, 6))).astype(np.uint8)),
            moniker=f"node{i}",
            protocol_version_p2p=int(rng.integers(0, 9)),
            protocol_version_block=int(rng.integers(10, 12)),
            protocol_version_app=int(rng.integers(0, 1 << 40)),
        )


def test_node_info_bytes_and_checks_equal_jax():
    infos = list(_node_infos(5))
    infos.append(dict(node_id="NOT-HEX"))
    infos.append(dict(node_id="ab" * 20, channels=bytes(range(70))))
    for kw in infos:
        p, j = port_types.NodeInfo(**kw), jax_types.NodeInfo(**kw)
        assert p.to_proto() == j.to_proto()
        assert port_types.NodeInfo.from_proto(j.to_proto()) == p
        got = []
        for info in (j, p):
            try:
                info.validate_basic()
                got.append("ok")
            except ValueError as e:
                got.append(str(e))
        assert got[0] == got[1]
    for a in infos[:10]:
        for b in infos[:10]:
            got = []
            for mod in (jax_types, port_types):
                try:
                    mod.NodeInfo(**a).compatible_with(mod.NodeInfo(**b))
                    got.append("ok")
                except ValueError as e:
                    got.append(str(e))
            assert got[0] == got[1]


@pytest.mark.parametrize("addr", [
    "ab" * 20 + "@10.0.0.1:7000", "tcp://" + "cd" * 20 + "@host:1", "host", "host:5",
    "ab" * 19 + "@h:1", "AB" * 20 + "@h:2", "@@", "", "h:notaport",
])
def test_node_address_equal_jax(addr):
    got = []
    for mod in (jax_types, port_types):
        try:
            got.append(mod.parse_node_address(addr))
        except ValueError as e:
            got.append(str(e))
    assert got[0] == got[1]


def test_node_id_from_pubkey_equal_jax():
    seed = b"\x21" * 32
    assert port_types.node_id_from_pubkey(PortPrivKey.from_seed(seed).pub_key()) == (
        jax_types.node_id_from_pubkey(JaxPrivKey.from_seed(seed).pub_key())
    )


# -- p2p/peermanager.py --


def _ids(n):
    return [bytes([i + 1]) * 20 for i in range(n)]


def _pm_snapshot(pm):
    return {
        nid: (sorted(p.addresses), p.persistent, p.dial_attempts, p.last_dial_failure, p.retry_at,
              p.retry_delay_s, p.banned_until, p.dialing, p.connected, p.ready, p.inbound,
              p.evicting, p.evict_reason, p.score, p.connected_at)
        for nid, p in pm._peers.items()
    } | {"peers": pm.peers(), "n": pm.num_connected(), "conn": pm.connected_peers(),
         "evict": list(pm._evict_queue._queue)}


async def _pm_sequence(seed: int, steps: int) -> None:
    rng = np.random.default_rng(seed)
    ids = [i.hex() for i in _ids(6)]
    self_id = ids[0]
    now = {"t": 100.0}
    opts = dict(max_connected=3, max_connected_upgrade=1, max_peers=5,
                persistent_peers=[f"{ids[1]}@10.0.0.2:1"])
    jax = jax_pm.PeerManager(self_id, jax_pm.PeerManagerOptions(**opts), clock=lambda: now["t"])
    port = port_pm.PeerManager(self_id, port_pm.PeerManagerOptions(**opts), clock=lambda: now["t"])
    subs = (jax.subscribe(), port.subscribe())
    actions = ("add", "dial_next", "dialed", "dial_failed", "dial_abandoned", "accepted",
               "ready", "disconnected", "errored", "shed_slow", "ban", "tick")
    for step in range(steps):
        act = actions[int(rng.integers(0, len(actions)))]
        nid = ids[int(rng.integers(0, len(ids)))]
        arg = (f"{nid}@10.0.{int(rng.integers(0, 3))}.1:{int(rng.integers(1, 4))}",
               bool(rng.random() < 0.2))
        state = int(rng.integers(0, 1 << 30))
        got = []
        for pm in (jax, port):
            random.seed(state)  # the backoff's jitter and advertise's shuffle
            try:
                if act == "add":
                    got.append(pm.add(*arg))
                elif act == "dial_next":
                    got.append(await pm.dial_next() if pm._next_dial_candidate() else None)
                elif act == "tick":
                    got.append(None)
                elif act == "ban":
                    got.append(pm.ban(nid, 5.0))
                elif act == "errored":
                    got.append(pm.errored(nid, "bad message"))
                elif act == "shed_slow":
                    got.append(pm.shed_slow(nid, 7.0))
                else:
                    got.append(getattr(pm, act)(nid))
            except ValueError as e:
                got.append((type(e).__name__, str(e)))
        assert got[0] == got[1], (step, act)
        if act == "tick":
            now["t"] += float(rng.choice([0.1, 1.0, 700.0]))
        assert _pm_snapshot(jax) == _pm_snapshot(port), (step, act)
        assert [(u.node_id, u.status) for u in subs[0]._queue] == [(u.node_id, u.status) for u in subs[1]._queue]
        random.seed(state)
        adv = jax.advertise(10)
        random.seed(state)
        assert port.advertise(10) == adv


@pytest.mark.parametrize("seed", range(3))
def test_peer_manager_sequences_equal_jax(seed):
    run(_pm_sequence(seed, 400))


# -- p2p/router.py on MemoryNetwork under the net fault plane --


def _pair(pkg: str):
    """Two routers of one package on their own MemoryNetwork (monikers
    node0, node1; node0 dials), each with the mempool channel."""
    T, R, PM, TY, RE = (
        (jax_transport, jax_router, jax_pm, jax_types, jax_reactor) if pkg == "jax"
        else (port_transport, port_router, port_pm, port_types, port_reactor)
    )
    key = JaxPrivKey if pkg == "jax" else PortPrivKey
    net = T.MemoryNetwork()
    nodes = []
    for i in range(2):
        priv = key.from_seed(bytes([50 + i]) * 32)
        nid = TY.node_id_from_pubkey(priv.pub_key())
        addr = f"node{i}.mem:{i + 1}"
        info = TY.NodeInfo(node_id=nid, listen_addr=addr, network="fault-chain", moniker=f"node{i}")
        pm = PM.PeerManager(nid, PM.PeerManagerOptions(min_retry_time=0.05, max_retry_time=0.1))
        kw = {"metrics": P2PMetrics(Registry())} if pkg == "jax" else {}
        router = R.Router(info, priv, pm, T.MemoryTransport(net, addr), listen_addr=addr, **kw)
        ch = router.open_channel(RE.mempool_channel_descriptor())
        nodes.append((nid, addr, pm, router, ch))
    return nodes, RE.TxsMessage


async def _deliveries(pkg: str, n: int, partition_until: float = 0.0) -> dict:
    nodes, Txs = _pair(pkg)
    (id0, _, pm0, r0, ch0), (id1, addr1, pm1, r1, ch1) = nodes
    plane = jax_faults if pkg == "jax" else port_faults
    out = {}
    for *_, r, _ch in nodes:
        await r.start()
    try:
        pm0.add(f"{id1}@{addr1}")
        if partition_until:
            await asyncio.sleep(partition_until)
            out["connected_while_cut"] = bool(pm0.peers() or pm1.peers())
            plane.set_partition("")
        for _ in range(400):
            if pm0.peers() and pm1.peers():
                break
            await asyncio.sleep(0.01)
        out["connected"] = bool(pm0.peers() and pm1.peers())
        t0 = asyncio.get_running_loop().time()
        for i in range(n):
            await ch0.send(_envelope(pkg, Txs(txs=(b"m%d" % i,)), id1))
        got = []
        while True:
            try:
                env = await asyncio.wait_for(ch1.receive(), 0.3)
            except asyncio.TimeoutError:
                break
            got.append(env.message.txs[0])
        out["got"] = got
        out["elapsed_s"] = asyncio.get_running_loop().time() - t0
    finally:
        for *_, r, _ch in nodes:
            await r.stop()
    return out


def _envelope(pkg, msg, to):
    return (jax_types if pkg == "jax" else port_types).Envelope(message=msg, to=to)


@pytest.mark.parametrize("plan", ["none", "drop", "duplicate", "delay", "partition"])
def test_router_fault_plans_equal_jax(plan):
    """40 messages node0 -> node1 on each package's MemoryNetwork with
    one plan armed on its fault plane (the same seed): the same messages
    arrive, in the same order, in both."""
    results = {}
    for pkg, plane in (("jax", jax_faults), ("port", port_faults)):
        async def go():
            if plan == "partition":
                plane.set_partition("node0|node1")
                return await _deliveries(pkg, 40, partition_until=0.3)
            if plan == "none":
                return await _deliveries(pkg, 40)
            kw = {"drop": dict(p=0.35, seed=7), "duplicate": dict(p=0.5, seed=3, dup=2),
                  "delay": dict(p=0.2, seed=5, delay_s=0.02)}[plan]
            with plane.inject("p2p.send", plan, ch=0x30, src="node0", **kw) as rule:
                res = await _deliveries(pkg, 40)
            res["fired"] = rule.fired
            return res

        results[pkg] = run(go())
    jax, port = results["jax"], results["port"]
    assert port["connected"] and jax["connected"]
    assert port["got"] == jax["got"]
    assert port.get("fired") == jax.get("fired")
    assert port.get("connected_while_cut") is jax.get("connected_while_cut")
    sent = [b"m%d" % i for i in range(40)]
    if plan in ("none", "delay", "partition"):
        assert port["got"] == sent
    if plan == "partition":
        assert port["connected_while_cut"] is False
    if plan == "drop":
        assert 0 < len(port["got"]) < 40 and port["fired"] == 40 - len(port["got"])
    if plan == "duplicate":
        assert len(port["got"]) == 40 + 2 * port["fired"] and sorted(set(port["got"])) == sorted(sent)
    if plan == "delay":
        assert port["fired"] > 0 and port["elapsed_s"] >= 0.02 * port["fired"]


def test_net_plane_helpers_equal_jax():
    """The label match, the partition's cut and the rules' seeded plans
    of both planes, consult by consult."""
    jax_faults.set_partition("validator1,abcdef0123|node5")
    port_faults.set_partition("validator1,abcdef0123|node5")
    cases = [(("validator1",), ("node5",)), (("validator10",), ("node5",)),
             (("abcdef0123456789",), ("node5", "x")), (("node5",), ("validator1",)),
             (("other",), ("node5",)), (("validator1",), ("abcdef01234",))]
    for src, dst in cases:
        assert port_faults.partition_blocked(src, dst) == jax_faults.partition_blocked(src, dst)
    assert port_faults.partition_spec() == jax_faults.partition_spec()
    assert port_faults.net_armed() and jax_faults.net_armed()
    jax_faults.set_partition("")
    port_faults.set_partition("")
    assert not port_faults.net_armed()
    with jax_faults.inject("p2p.recv", "drop", p=0.5, seed=9, dst="node1"), \
            jax_faults.inject("p2p.recv", "delay", p=0.5, seed=4, delay_s=0.3), \
            port_faults.inject("p2p.recv", "drop", p=0.5, seed=9, dst="node1"), \
            port_faults.inject("p2p.recv", "delay", p=0.5, seed=4, delay_s=0.3):
        for i in range(60):
            dst = ("node1",) if i % 3 else ("node2",)
            j = jax_faults.net_plan("p2p.recv", src=("node0",), dst=dst, ch=0x30)
            p = port_faults.net_plan("p2p.recv", src=("node0",), dst=dst, ch=0x30)
            assert repr(p) == repr(j)
    assert not port_faults.net_armed()
