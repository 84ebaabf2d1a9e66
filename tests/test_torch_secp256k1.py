"""The port's secp256k1 keys held against tendermint_tpu/crypto/secp256k1.py
(after tests/test_secp256k1.py).

- RFC 6979 nonces and full signatures against the secp256k1 + SHA-256
  vectors, and equal to the JAX module's;
- seeded keys give the same public keys, RIPEMD160(SHA256) addresses and
  signatures in both packages; every signature is low-s;
- verify outcomes equal the JAX module's on a seeded corpus: valid,
  another message, a corrupt byte, the high-s twin, zero and overflowing
  r and s, wrong lengths, garbage, off-curve and bad-prefix public keys;
- verify_batch bitmaps and the Secp256k1BatchVerifier contract equal the
  JAX ones; crypto.batch serves the key type with a CPU factory and no
  device factory, also with the device plane installed;
- the key dispatch, the PublicKey proto's field 2 and the ABCI codec;
- FilePV files written by each package load in the other and sign a vote
  to the same bytes;
- a 12-validator three-class Commit (workloads.build_three_class_commit)
  with one bad signature of each class, on the vector and the scalar
  route, has the outcomes and error texts of JAX verify_commit,
  verify_commit_light and verify_commit_light_trusting.

Tolerance: zero (bytes, outcomes, messages).
"""

import asyncio
import hashlib
import pathlib
import random

import pytest

from tendermint_tpu.abci import codec as jax_codec
from tendermint_tpu.crypto import secp256k1 as jax_secp
from tendermint_tpu.crypto import sigcache as jax_sigcache
from tendermint_tpu.crypto import sr25519 as _jax_sr  # noqa: F401  (registers the key type)
from tendermint_tpu.privval.file import FilePV as JaxFilePV
from tendermint_tpu.types import validation as jax_validation
from tendermint_tpu.types.block_id import BlockID as JaxBlockID
from tendermint_tpu.types.commit import Commit as JaxCommit
from tendermint_tpu.types.validator import ValidatorSet as JaxValidatorSet
from tendermint_tpu.types.vote import Vote as JaxVote
from tendermint_tpu_torch import workloads
from tendermint_tpu_torch.abci import codec as port_codec
from tendermint_tpu_torch.crypto import batch, gpu_verifier
from tendermint_tpu_torch.crypto import secp256k1 as port_secp
from tendermint_tpu_torch.crypto.keys import (
    generate_priv_key,
    privkey_from_type_and_bytes,
    pubkey_from_proto,
    pubkey_from_type_and_bytes,
    pubkey_to_proto,
)
from tendermint_tpu_torch.privval.file import FilePV
from tendermint_tpu_torch.types import validation as port_validation
from tendermint_tpu_torch.types.block_id import BlockID, PartSetHeader
from tendermint_tpu_torch.types.canonical import PRECOMMIT_TYPE
from tendermint_tpu_torch.types.commit import Commit
from tendermint_tpu_torch.types.validation import Fraction
from tendermint_tpu_torch.types.vote import Vote

from .test_torch_isolation import jax_device_plane_paused  # noqa: F401 (autouse)

N = port_secp._ORDER
CHAIN_ID = "torch-secp-chain"
HEIGHT = 9

# (private scalar, message, k): the secp256k1 + SHA-256 RFC 6979 set
_K_VECTORS = [
    (1, b"Satoshi Nakamoto", 0x8F8A276C19F4149656B280621E358CCE24F5F52542772691EE69063B74F15D15),
    (1, b"All those moments will be lost in time, like tears in rain. Time to die...",
     0x38AA22D72376B4DBC472E06C3BA403EE0A394DA63FC58D88686C611ABA98D6B3),
    (N - 1, b"Satoshi Nakamoto", 0x33A19B60E25FB6F4435AF53A3D42D493644827367E6453928554F43E49AA6F90),
    (0xF8B8AF8CE3C7CCA5E300D33939540C10D45CE001B8F252BFBC57BA0342904181, b"Alan Turing",
     0x525A82B70E67874398067543FD84C83D30C175FDC45FDEEE082FE13B1D7CFDF1),
]
_SIG_VECTORS = [
    (1, b"Satoshi Nakamoto",
     "934b1ea10a4b3c1757e2b0c017d0b6143ce3c9a7e6a4a49860d7a6ab210ee3d8",
     "2442ce9d2b916064108014783e923ec36b49743e2ffa1c4496f01a512aafd9e5"),
    (0xF8B8AF8CE3C7CCA5E300D33939540C10D45CE001B8F252BFBC57BA0342904181, b"Alan Turing",
     "7063ae83e7f62bbb171798131b4a0564b956930092b33b07b395615d9ec7e15c",
     "58dfcc1e00a35e1572f366ffe34ba0fc47db1e7189759b9fb233c5b05ab388ea"),
]

def _pair(d: int):
    """(port key, JAX key) of one scalar."""
    raw = d.to_bytes(32, "big")
    return port_secp.PrivKeySecp256k1(raw), jax_secp.PrivKeySecp256k1(raw)


@pytest.mark.parametrize("d,msg,k", _K_VECTORS)
def test_rfc6979_nonces_equal_the_vectors_and_jax(d, msg, k):
    h1 = hashlib.sha256(msg).digest()
    raw = d.to_bytes(32, "big")
    assert port_secp._rfc6979_k(raw, h1) == k == jax_secp._rfc6979_k(raw, h1)


@pytest.mark.parametrize("d,msg,r_hex,s_hex", _SIG_VECTORS)
def test_signature_vectors(d, msg, r_hex, s_hex):
    port, jax = _pair(d)
    sig = port.sign(msg)
    assert sig.hex() == r_hex + s_hex == jax.sign(msg).hex()
    assert port.pub_key().verify_signature(msg, sig)


def test_seeded_keys_addresses_and_signatures_equal_jax():
    rng = random.Random(0x5EC9)
    for _ in range(12):
        port, jax = _pair(rng.randrange(1, N))
        assert port.pub_key().bytes() == jax.pub_key().bytes()
        assert port.pub_key().address() == jax.pub_key().address()
        msg = rng.randbytes(rng.randrange(0, 200))
        sig = port.sign(msg)
        assert sig == jax.sign(msg) == port.sign(msg)
        assert int.from_bytes(sig[32:], "big") <= port_secp._HALF_ORDER


def _corpus():
    """(name, pubkey bytes, message, signature) of a seeded corpus."""
    rng = random.Random(0xC0FFEE)
    out = []
    for i in range(6):
        priv = port_secp.PrivKeySecp256k1(rng.randrange(1, N).to_bytes(32, "big"))
        pk = priv.pub_key().bytes()
        msg = b"corpus item %d" % i
        sig = priv.sign(msg)
        r, s = int.from_bytes(sig[:32], "big"), int.from_bytes(sig[32:], "big")
        pos = rng.randrange(64)
        out += [
            ("valid", pk, msg, sig),
            ("other message", pk, msg + b"!", sig),
            ("corrupt byte", pk, msg, sig[:pos] + bytes([sig[pos] ^ 0x40]) + sig[pos + 1:]),
            ("high-s twin", pk, msg, sig[:32] + (N - s).to_bytes(32, "big")),
            ("zero r", pk, msg, bytes(32) + sig[32:]),
            ("zero s", pk, msg, sig[:32] + bytes(32)),
            ("r = N", pk, msg, N.to_bytes(32, "big") + sig[32:]),
            ("r + N", pk, msg, ((r + N) % (1 << 256)).to_bytes(32, "big") + sig[32:]),
            ("s = N", pk, msg, sig[:32] + N.to_bytes(32, "big")),
            ("short", pk, msg, sig[:63]),
            ("long", pk, msg, sig + b"\x00"),
            ("garbage", pk, msg, rng.randbytes(64)),
            ("off-curve x", b"\x02" + (5).to_bytes(32, "big"), msg, sig),
            ("x >= P", b"\x02" + port_secp._P.to_bytes(32, "big"), msg, sig),
            ("bad prefix", b"\x04" + pk[1:], msg, sig),
            ("other parity", bytes([pk[0] ^ 1]) + pk[1:], msg, sig),
        ]
    return out


def test_verify_outcomes_equal_jax_on_a_seeded_corpus():
    seen = set()
    for name, pk, msg, sig in _corpus():
        got = port_secp.PubKeySecp256k1(pk).verify_signature(msg, sig)
        assert got == jax_secp.PubKeySecp256k1(pk).verify_signature(msg, sig), name
        assert got == (name == "valid"), name
        seen.add(name)
    assert len(seen) == 16


def test_decompress_and_key_checks_equal_jax():
    rng = random.Random(3)
    encodings = [b"", b"\x02" * 33, b"\x03" + bytes(32), b"\x02" + (7).to_bytes(32, "big")]
    encodings += [bytes([2 + (i & 1)]) + rng.randbytes(32) for i in range(40)]
    for enc in encodings:
        assert port_secp._decompress(enc) == jax_secp._decompress(enc)
    for raw in (bytes(32), N.to_bytes(32, "big"), bytes(31), (N - 1).to_bytes(32, "big")):
        outcomes = []
        for mod in (port_secp, jax_secp):
            try:
                mod.PrivKeySecp256k1(raw)
                outcomes.append("ok")
            except ValueError as e:
                outcomes.append(str(e))
        assert outcomes[0] == outcomes[1]
    with pytest.raises(ValueError):
        port_secp.PubKeySecp256k1(b"\x02" * 32)


def test_verify_batch_bitmaps_equal_jax_and_the_single_loop():
    corpus = [c for c in _corpus() if len(c[3]) == 64]
    ok, bits = port_secp.verify_batch([(port_secp.PubKeySecp256k1(pk), m, s) for _n, pk, m, s in corpus])
    jok, jbits = jax_secp.verify_batch([(jax_secp.PubKeySecp256k1(pk), m, s) for _n, pk, m, s in corpus])
    single = [port_secp.PubKeySecp256k1(pk).verify_signature(m, s) for _n, pk, m, s in corpus]
    assert (ok, bits) == (jok, jbits) and bits == single
    assert any(bits) and not all(bits)
    assert port_secp.verify_batch([]) == (False, [])


def test_batch_verifier_contract_equals_jax():
    corpus = [c for c in _corpus() if len(c[3]) == 64][:20]
    out = []
    for mod in (port_secp, jax_secp):
        bv = mod.Secp256k1BatchVerifier()
        for _n, pk, m, s in corpus:
            bv.add(mod.PubKeySecp256k1(pk), m, s)
        assert len(bv) == len(corpus)
        out.append((bv.verify(), bv.verify()))
        with pytest.raises(ValueError):
            bv.add(mod.PubKeySecp256k1(corpus[0][1]), b"m", b"short")
    assert out[0] == out[1] and out[0][1] == (False, [])
    with pytest.raises(TypeError):
        port_secp.Secp256k1BatchVerifier().add(workloads.seeded_keys(1, 1)[0].pub_key(), b"m", bytes(64))


def test_batch_dispatch_is_the_cpu_factory_also_under_the_device_plane():
    pk = port_secp.PrivKeySecp256k1((5).to_bytes(32, "big")).pub_key()
    assert batch.supports_batch_verifier(pk)
    assert isinstance(batch.create_batch_verifier(pk, 10_000), port_secp.Secp256k1BatchVerifier)
    gpu_verifier.install(device="cpu", min_batch=2)
    try:
        assert not batch.device_factory_installed("secp256k1")
        before = gpu_verifier.stats()
        bv = batch.create_batch_verifier(pk, 10_000)
        assert isinstance(bv, port_secp.Secp256k1BatchVerifier)
        assert gpu_verifier.stats() == before
    finally:
        gpu_verifier.uninstall()


def test_key_dispatch_proto_and_abci_codec():
    sk = generate_priv_key("secp256k1")
    assert isinstance(sk, port_secp.PrivKeySecp256k1) and sk.type() == "secp256k1"
    assert privkey_from_type_and_bytes("secp256k1", sk.bytes()).pub_key() == sk.pub_key()
    assert pubkey_from_type_and_bytes("secp256k1", sk.pub_key().bytes()) == sk.pub_key()
    msg = b"fresh key"
    assert sk.pub_key().verify_signature(msg, sk.sign(msg))
    assert len(sk.pub_key().bytes()) == 33 and len(sk.pub_key().address()) == 20
    port, jax = _pair(42)
    wire = pubkey_to_proto(port.pub_key())
    assert wire[0] == 0x12  # field 2, length-delimited
    assert pubkey_from_proto(wire) == port.pub_key()
    from tendermint_tpu.crypto.keys import pubkey_to_proto as jax_pubkey_to_proto

    assert wire == jax_pubkey_to_proto(jax.pub_key())
    from tendermint_tpu.abci.types import PubKey as JaxABCIPubKey
    from tendermint_tpu_torch.abci.types import PubKey as ABCIPubKey

    enc = port_codec._enc_pub_key(ABCIPubKey(key_type="secp256k1", data=port.pub_key().bytes()))
    assert enc == wire
    assert enc == jax_codec._enc_pub_key(JaxABCIPubKey(key_type="secp256k1", data=jax.pub_key().bytes()))
    assert port_codec._dec_pub_key(enc) == ABCIPubKey(key_type="secp256k1", data=port.pub_key().bytes())


def _run(coro):
    return asyncio.run(asyncio.wait_for(coro, 30.0))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_filepv_files_cross_load_and_sign_alike(tmp_path, writer):
    d = 0x1234567890ABCDEF
    paths = {}
    for pkg in ("port", "jax"):
        home = tmp_path / pkg
        (home / "config").mkdir(parents=True)
        (home / "data").mkdir(parents=True)
        paths[pkg] = (str(home / "config" / "priv_validator_key.json"),
                      str(home / "data" / "priv_validator_state.json"))
    port_key, jax_key = _pair(d)
    (FilePV.from_priv_key(port_key, *paths["port"]) if writer == "port"
     else JaxFilePV.from_priv_key(jax_key, *paths["jax"])).save()
    reader = "jax" if writer == "port" else "port"
    for src, dst in zip(paths[writer], paths[reader]):
        pathlib.Path(dst).write_bytes(pathlib.Path(src).read_bytes())
    port_pv = FilePV.load(*paths["port"])
    jax_pv = JaxFilePV.load(*paths["jax"])
    assert port_pv.key.pub_key.type() == "secp256k1" == jax_pv.key.pub_key.type()
    assert port_pv.key.address == jax_pv.key.address == port_key.pub_key().address()
    bid = BlockID(b"\x07" * 32, PartSetHeader(1, b"\x08" * 32))
    vote = Vote(type=PRECOMMIT_TYPE, height=3, round=0, block_id=bid,
                timestamp_ns=1_700_000_000_000_000_123, validator_address=port_pv.key.address,
                validator_index=0)
    jvote = JaxVote.from_proto(vote.to_proto())
    _run(port_pv.sign_vote(CHAIN_ID, vote))
    _run(jax_pv.sign_vote(CHAIN_ID, jvote))
    assert vote.signature == jvote.signature and len(vote.signature) == 64
    assert vote.to_proto() == jvote.to_proto()
    for a, b in zip(paths["port"], paths["jax"]):
        assert pathlib.Path(a).read_bytes() == pathlib.Path(b).read_bytes()


# -- the three-class Commit --

N_VALS = 12


@pytest.fixture(scope="module")
def three_class():
    return workloads.build_three_class_commit(N_VALS, CHAIN_ID, HEIGHT, seed=5)


def _spoiled(commit: Commit, vals, kinds, flag_at=None) -> Commit:
    """A copy of the commit with the first signature of each key type in
    `kinds` spoiled (its first byte flipped), and, with flag_at, that
    index's BlockIDFlag set outside uint8 (the scalar route)."""
    out = Commit.from_proto(commit.to_proto())
    for kind in kinds:
        i = next(j for j, v in enumerate(vals.validators) if v.pub_key.type() == kind)
        sig = bytearray(out.signatures[i].signature)
        sig[0] ^= 0x01
        out.signatures[i].signature = bytes(sig)
    if flag_at is not None:
        out.signatures[flag_at].block_id_flag = 300
    return out


def _outcome(fn, *args):
    try:
        fn(*args)
    except Exception as e:  # the outcome compared IS the exception
        return type(e).__name__, str(e)
    return "ok", ""


CASES = [
    ((), None),
    (("ed25519",), None),
    (("sr25519",), None),
    (("secp256k1",), None),
    (("secp256k1", "ed25519", "sr25519"), None),
    ((), 4),
    (("secp256k1",), 10),
]


@pytest.mark.parametrize("kinds,flag_at", CASES)
def test_three_class_commit_outcomes_equal_jax(three_class, kinds, flag_at):
    vals, bid, commit = three_class
    assert sorted(v.pub_key.type() for v in vals.validators) == sorted(
        workloads.THREE_CLASSES * (N_VALS // 3))
    spoiled = _spoiled(commit, vals, kinds, flag_at)
    assert (spoiled.block_id_flags_array() is None) == (flag_at is not None)
    jvals = JaxValidatorSet.from_proto(vals.to_proto())
    jbid = JaxBlockID.from_proto(bid.to_proto())
    jcommit = JaxCommit.from_proto(spoiled.to_proto())
    got, want = [], []
    with jax_sigcache.disabled():
        for port_fn, jax_fn, args in (
            (port_validation.verify_commit, jax_validation.verify_commit, (bid, HEIGHT)),
            (port_validation.verify_commit_light, jax_validation.verify_commit_light, (bid, HEIGHT)),
        ):
            got.append(_outcome(port_fn, CHAIN_ID, vals, *args, spoiled))
            want.append(_outcome(jax_fn, CHAIN_ID, jvals, jbid, HEIGHT, jcommit))
        got.append(_outcome(port_validation.verify_commit_light_trusting, CHAIN_ID, vals, spoiled,
                            Fraction(1, 3)))
        want.append(_outcome(jax_validation.verify_commit_light_trusting, CHAIN_ID, jvals, jcommit,
                             jax_validation.Fraction(1, 3)))
    assert got == want
    if not kinds and flag_at is None:
        assert got == [("ok", "")] * 3
    if len(kinds) == 3:
        assert got[0][0] == "InvalidCommitError" and "wrong signature" in got[0][1]
