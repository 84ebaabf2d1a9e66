"""The host path of a Commit in the port, held against the JAX package:
sign-bytes spliced in C (native/signbytes.c), the vector plans of
types/validation.py against the JAX package's and the port's own scalar
loop, and the merlin challenges of a window in one C call.

Inputs come from numpy seeds: keys from seeded bytes, layouts (absent,
nil, for-block, powers, timestamps), bad signatures and foreign or
duplicated addresses. Commits are built with the JAX package's types
(signatures from the port's keys, whose sign() takes its randomness from
the seed) and carried to the port as wire bytes. The JAX side runs as
its own tests run it, on its CPU verifiers, with its verified-signature
cache off. The port runs on its native CPU plane (no device verifier
installed: the device path's plan is the same code, and
test_torch_validation.py drives it through the kernels' plain versions).
The scalar loop is reached the way a commit whose flags do not fit uint8
reaches it: Commit.block_id_flags_array() returns None. Tolerance: zero
(exact bytes, exact outcomes and messages, the same triples in the same
order).
"""

import contextlib

import numpy as np
import pytest

from tendermint_tpu.crypto import sigcache
from tendermint_tpu.crypto.ed25519 import PubKeyEd25519 as JaxEdPub
from tendermint_tpu.crypto.sr25519 import PubKeySr25519 as JaxSrPub
from tendermint_tpu.crypto.sr25519 import challenge_batch as jax_challenge_batch
from tendermint_tpu.types import (
    PRECOMMIT_TYPE,
    BlockID,
    Commit,
    CommitSig,
    Fraction,
    PartSetHeader,
    Validator,
    ValidatorSet,
    Vote,
)
from tendermint_tpu.types import validation as jax_validation
from tendermint_tpu.types.canonical import VoteSignTemplate as JaxTemplate
from tendermint_tpu_torch import interop, native
from tendermint_tpu_torch.crypto import sr25519 as PS
from tendermint_tpu_torch.crypto.ed25519 import PrivKeyEd25519
from tendermint_tpu_torch.crypto.sr25519 import PrivKeySr25519
from tendermint_tpu_torch.types import validation as port_validation
from tendermint_tpu_torch.types.block_id import BlockID as PortBlockID
from tendermint_tpu_torch.types.block_id import PartSetHeader as PortPSH
from tendermint_tpu_torch.types.canonical import VoteSignTemplate as PortTemplate
from tendermint_tpu_torch.types.commit import Commit as PortCommit

from .test_torch_isolation import jax_device_plane_paused  # noqa: F401 (autouse)

CHAIN_ID = "torch-hostpath-chain"
HEIGHT = 21
BID = BlockID(
    hash=b"\x31" * 32, part_set_header=PartSetHeader(total=4, hash=b"\x32" * 32)
)
INT64_MIN, INT64_MAX = -(1 << 63), (1 << 63) - 1
# the cases of tests/test_encoding.py:211-244 (zero, nanos only, seconds
# only, negative, past the epoch), zero seconds or nanos on either side
# of zero, and both int64 bounds
TS_CASES = [
    0,
    1,
    999_999_999,
    1_000_000_000,
    1_700_000_000_123_456_789,
    1_700_000_000_000_000_000,
    -1,
    -999_999_999,
    -1_000_000_000,
    -1_000_000_001,
    2**62,
    INT64_MAX,
    INT64_MIN,
    INT64_MIN + 1,
]


def _templates():
    """(JAX, port) template pairs for a for-block and a nil vote."""
    pbid = PortBlockID(
        hash=BID.hash,
        part_set_header=PortPSH(
            total=BID.part_set_header.total, hash=BID.part_set_header.hash
        ),
    )
    return [
        (
            JaxTemplate(CHAIN_ID, PRECOMMIT_TYPE, HEIGHT, 3, jbid),
            PortTemplate(CHAIN_ID, PRECOMMIT_TYPE, HEIGHT, 3, pb),
        )
        for jbid, pb in ((BID, pbid), (BlockID(), PortBlockID()))
    ]


@contextlib.contextmanager
def _routes(monkeypatch):
    """Counts the timestamps each splice route encodes."""
    seen = {"native": 0, "python": 0}
    real_c = PortTemplate._sign_bytes_native
    real_py = PortTemplate._sign_bytes_python

    def c_route(self, ts):
        seen["native"] += len(ts)
        return real_c(self, ts)

    def py_route(self, ts):
        ts = list(ts)
        seen["python"] += len(ts)
        return real_py(self, ts)

    monkeypatch.setattr(PortTemplate, "_sign_bytes_native", c_route)
    monkeypatch.setattr(PortTemplate, "_sign_bytes_python", py_route)
    yield seen


def test_sign_bytes_c_and_python_equal_the_jax_package(monkeypatch):
    rng = np.random.default_rng(5)
    seeded = rng.integers(INT64_MIN, INT64_MAX, 300, dtype=np.int64, endpoint=True)
    cases = TS_CASES + [int(t) for t in seeded]
    with _routes(monkeypatch) as seen:
        for jax_tpl, port_tpl in _templates():
            want = jax_tpl.sign_bytes_batch(cases)
            assert want == [jax_tpl.sign_bytes(t) for t in cases]
            assert port_tpl.sign_bytes_batch(cases) == want
            assert port_tpl._sign_bytes_python(cases) == want
            assert [port_tpl.sign_bytes(t) for t in TS_CASES] == want[: len(TS_CASES)]
            # outside int64 the whole batch takes the Python splice
            wide = [2**70, -(2**70), INT64_MAX + 1, INT64_MIN - 1, 5]
            assert port_tpl.sign_bytes_batch(wide) == jax_tpl.sign_bytes_batch(wide)
            assert port_tpl.sign_bytes(2**70) == jax_tpl.sign_bytes(2**70)
            assert port_tpl.sign_bytes_batch([]) == []
    # a single in-range row takes the C splice through ctypes scalars
    assert seen == {"native": 2 * len(cases), "python": 2 * (len(cases) + 6)}


def test_commit_sign_bytes_equal_the_jax_package(monkeypatch):
    """Commit.sign_bytes_batch (None at absent indexes, two templates)
    and vote_sign_bytes_batch of an index list, in its order, equal the
    JAX package's per-index encoding; a commit's sign-bytes take two C
    calls and no Python splice."""
    vals, _bid, commit, _privs = _layout(np.random.default_rng(9), 40, mixed=False)
    pcommit = interop.commit_from_proto(commit.to_proto())
    want = commit.sign_bytes_batch(CHAIN_ID)
    calls = []
    real = PortTemplate._sign_bytes_native
    monkeypatch.setattr(
        PortTemplate, "_sign_bytes_native", lambda s, ts: calls.append(len(ts)) or real(s, ts)
    )
    monkeypatch.setattr(PortTemplate, "_sign_bytes_python", None)
    assert pcommit.sign_bytes_batch(CHAIN_ID) == want
    flags = [cs.block_id_flag for cs in commit.signatures]
    assert sorted(calls) == sorted(
        c for c in (flags.count(2), flags.count(3)) if c
    )
    idxs = [i for i, cs in enumerate(commit.signatures) if not cs.is_absent()][::-1]
    got = pcommit.vote_sign_bytes_batch(CHAIN_ID, idxs)
    assert got == [commit.vote_sign_bytes(CHAIN_ID, i) for i in idxs]
    assert pcommit.vote_sign_bytes_batch(CHAIN_ID, []) == []


def test_a_failing_compiler_makes_the_signbytes_loader_raise(monkeypatch, tmp_path):
    """No silent fallback: with a CC that fails, building signbytes.c
    raises, nothing is left in the build directory, and a commit's
    sign-bytes raise with it."""
    monkeypatch.setattr(native, "_SIGNBYTES_LIB", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setenv("CC", "false")
    with pytest.raises(RuntimeError, match="failed on signbytes.c"):
        native.signbytes_lib()
    assert native._SIGNBYTES_LIB is None
    assert list((tmp_path / "native").iterdir()) == []
    _jax_tpl, port_tpl = _templates()[0]
    with pytest.raises(RuntimeError, match="failed"):
        port_tpl.sign_bytes_batch([1, 2])


# -- the vector plans --


def _keys(rng, n, mixed):
    """n port private keys from seeded bytes: ed25519, or each key type
    at random when mixed."""
    out = []
    for _ in range(n):
        seed = rng.bytes(32)
        sr = mixed and rng.random() < 0.5
        out.append(PrivKeySr25519(seed) if sr else PrivKeyEd25519(seed))
    return out


def _jax_pub(priv):
    pub = priv.pub_key().bytes()
    return JaxSrPub(pub) if isinstance(priv, PrivKeySr25519) else JaxEdPub(pub)


def _sign(priv, msg, rng):
    if isinstance(priv, PrivKeySr25519):
        return priv.sign(msg, rng=rng.bytes)
    return priv.sign(msg)


def _layout(rng, n, mixed, p_absent=0.08, p_nil=0.08, bad=False):
    """A JAX-package commit over n validators of random powers, each vote
    absent, nil or for the block at random, with random timestamps;
    optionally one bad signature at a random non-absent index. Returns
    (vals, block_id, commit, {address: port private key})."""
    privs = _keys(rng, n, mixed)
    vals = ValidatorSet(
        [
            Validator(pub_key=_jax_pub(p), voting_power=int(rng.integers(1, 60)))
            for p in privs
        ]
    )
    by_addr = {p.pub_key().address(): p for p in privs}
    sigs = []
    for i, v in enumerate(vals.validators):
        r = float(rng.random())
        if r < p_absent:
            sigs.append(CommitSig.absent())
            continue
        nil = r < p_absent + p_nil
        ts = int(rng.integers(-(10**12), 2 * 10**18))
        if rng.random() < 0.2:
            ts -= ts % 10**9  # zero nanos
        vote = Vote(
            type=PRECOMMIT_TYPE,
            height=HEIGHT,
            round=2,
            block_id=BlockID() if nil else BID,
            timestamp_ns=ts,
            validator_address=v.address,
            validator_index=i,
        )
        sig = _sign(by_addr[v.address], vote.sign_bytes(CHAIN_ID), rng)
        make = CommitSig.for_nil if nil else CommitSig.for_block
        sigs.append(make(sig, v.address, ts))
    commit = Commit(height=HEIGHT, round=2, block_id=BID, signatures=sigs)
    if bad:
        live = [i for i, cs in enumerate(sigs) if not cs.is_absent()]
        if live:
            j = int(rng.choice(live))
            s = bytearray(sigs[j].signature)
            s[int(rng.integers(0, 32))] ^= 1 << int(rng.integers(0, 8))
            sigs[j].signature = bytes(s)
    return vals, BID, commit, by_addr


def _carry(vals, commit):
    return (
        interop.validator_set_from_proto(vals.to_proto()),
        interop.commit_from_proto(commit.to_proto()),
    )


def _port_bid():
    return PortBlockID(
        hash=BID.hash,
        part_set_header=PortPSH(
            total=BID.part_set_header.total, hash=BID.part_set_header.hash
        ),
    )


@contextlib.contextmanager
def _scalar_route():
    """The port's scalar loop, reached as a commit with flags outside
    uint8 reaches it."""
    real = PortCommit.block_id_flags_array
    PortCommit.block_id_flags_array = lambda self: None
    try:
        yield
    finally:
        PortCommit.block_id_flags_array = real


def _port_run(fn, scalar):
    """(outcome, the triples handed to the batch verifiers: per key type
    (pubkey, sign-bytes, signature, index) in add order) of one call of
    the port."""
    handed = {}
    real = port_validation._drain_pending

    def drain(commit, pending):
        for kt, items in pending.items():
            handed[kt] = [(pk.bytes(), sb, sig, i) for pk, sb, sig, i in items]
        return real(commit, pending)

    port_validation._drain_pending = drain
    try:
        with _scalar_route() if scalar else contextlib.nullcontext():
            out = _outcome(fn)
    finally:
        port_validation._drain_pending = real
    return out, handed


def _outcome(fn):
    try:
        fn()
    except Exception as e:  # the outcome compared IS the exception
        return type(e).__name__, str(e)
    return "ok", ""


def _jax_outcome(fn):
    with sigcache.disabled():
        return _outcome(fn)


def _assert_identical(jax_fn, port_fn, where):
    want = _jax_outcome(jax_fn)
    vec, vec_handed = _port_run(port_fn, scalar=False)
    sca, sca_handed = _port_run(port_fn, scalar=True)
    assert vec == want, where
    assert sca == want, where
    assert vec_handed == sca_handed, where
    return want


def _case(seed):
    """n in 1-64, mixed or ed25519-only, bad signatures and too little
    power among the seeds."""
    rng = np.random.default_rng([77, seed])
    n = int(rng.integers(1, 65))
    mixed = bool(seed % 2)
    p_absent = 0.5 if seed % 5 == 0 else 0.08  # too little power
    vals, bid, commit, by_addr = _layout(
        rng, n, mixed, p_absent=p_absent, bad=(seed % 3 == 0)
    )
    return rng, vals, bid, commit, by_addr


N_SEEDS = 24


@pytest.mark.parametrize("seed", range(N_SEEDS))
def test_verify_commit_and_light_match_jax_and_the_scalar_loop(seed):
    _rng, vals, bid, commit, _ = _case(seed)
    pvals, pcommit = _carry(vals, commit)
    pbid = _port_bid()
    for name in ("verify_commit", "verify_commit_light"):
        jax_fn = getattr(jax_validation, name)
        port_fn = getattr(port_validation, name)
        _assert_identical(
            lambda: jax_fn(CHAIN_ID, vals, bid, HEIGHT, commit),
            lambda: port_fn(CHAIN_ID, pvals, pbid, HEIGHT, pcommit),
            f"{name} seed={seed}",
        )


@pytest.mark.parametrize("seed", range(N_SEEDS))
def test_trusting_matches_jax_and_the_scalar_loop(seed):
    """A trusted set that drops some of the commit's validators and holds
    foreign ones, a commit with a foreign address and, on some seeds, a
    duplicated address early or late in the scan."""
    rng, vals, _bid, commit, _ = _case(seed)
    keep = [v for v in vals.validators if rng.random() < 0.8] or vals.validators[:1]
    foreign = [
        Validator(pub_key=_jax_pub(p), voting_power=int(rng.integers(1, 60)))
        for p in _keys(rng, int(rng.integers(0, 4)), bool(seed % 2))
    ]
    trusted = ValidatorSet([v.copy() for v in keep] + foreign)
    sigs = commit.signatures
    live = [i for i, cs in enumerate(sigs) if not cs.is_absent()]
    if seed % 4 == 1 and len(live) >= 2:
        i, j = (live[0], live[1]) if seed % 8 == 1 else (live[0], live[-1])
        sigs[j].validator_address = sigs[i].validator_address
    if seed % 4 == 2 and live:
        sigs[live[len(live) // 2]].validator_address = rng.bytes(20)
    ptrusted, pcommit = _carry(trusted, commit)
    for num, den in ((1, 3), (2, 3), (3, 4)):
        _assert_identical(
            lambda: jax_validation.verify_commit_light_trusting(
                CHAIN_ID, trusted, commit, Fraction(num, den)
            ),
            lambda: port_validation.verify_commit_light_trusting(
                CHAIN_ID, ptrusted, pcommit, port_validation.Fraction(num, den)
            ),
            f"trusting {num}/{den} seed={seed}",
        )


@pytest.mark.parametrize("seed", range(N_SEEDS))
def test_collect_commit_light_matches_jax_and_the_scalar_loop(seed):
    """The same triples in the same order (the same stop index), or the
    same error; and verify_commit_light_bulk of the commit twice gives
    the JAX package's outcome."""
    _rng, vals, bid, commit, _ = _case(seed)
    pvals, pcommit = _carry(vals, commit)
    pbid = _port_bid()

    def triples(fn, *args):
        try:
            return [(pk.bytes(), sb, sig) for pk, sb, sig in fn(*args)], None
        except Exception as e:  # the outcome compared IS the exception
            return None, (type(e).__name__, str(e))

    with sigcache.disabled():
        want = triples(jax_validation.collect_commit_light, CHAIN_ID, vals, bid, HEIGHT, commit)
    args = (CHAIN_ID, pvals, pbid, HEIGHT, pcommit)
    assert triples(port_validation.collect_commit_light, *args) == want
    with _scalar_route():
        assert triples(port_validation.collect_commit_light, *args) == want
    rows = [(vals, bid, HEIGHT, commit)] * 2
    prow = [(pvals, pbid, HEIGHT, pcommit)] * 2
    assert _outcome(
        lambda: port_validation.verify_commit_light_bulk(CHAIN_ID, prow)
    ) == _jax_outcome(lambda: jax_validation.verify_commit_light_bulk(CHAIN_ID, rows))


def test_flags_outside_uint8_take_the_scalar_loop_with_jax_errors(monkeypatch):
    """A flag of 300 (from an unbounded varint) is the data route to the
    scalar loop: the port's vector plan is not entered, and the outcome
    equals the JAX package's on every entry point."""
    vals, bid, commit, _ = _layout(np.random.default_rng(3), 12, mixed=True)
    live = [i for i, cs in enumerate(commit.signatures) if not cs.is_absent()]
    commit.signatures[live[-1]].block_id_flag = 300
    pvals, pcommit = _carry(vals, commit)
    assert pcommit.block_id_flags_array() is None
    monkeypatch.setattr(port_validation, "_verify_commit_batch_vector", None)
    pbid = _port_bid()
    for name in ("verify_commit", "verify_commit_light"):
        assert _outcome(
            lambda: getattr(port_validation, name)(CHAIN_ID, pvals, pbid, HEIGHT, pcommit)
        ) == _jax_outcome(lambda: getattr(jax_validation, name)(CHAIN_ID, vals, bid, HEIGHT, commit))
    assert _outcome(
        lambda: port_validation.verify_commit_light_trusting(
            CHAIN_ID, pvals, pcommit, port_validation.Fraction(1, 3)
        )
    ) == _jax_outcome(
        lambda: jax_validation.verify_commit_light_trusting(CHAIN_ID, vals, commit, Fraction(1, 3))
    )


# -- merlin challenges of a window --


@pytest.mark.parametrize("n", [1, 33, 257])
def test_challenge_window_equals_jax_and_single_calls(n):
    """challenge_rows' one C call equals n calls of the single-signature
    C transcript and the JAX package's challenge_batch, over message
    lengths either side of the 166-byte STROBE rate."""
    rng = np.random.default_rng([13, n])
    pks = [rng.bytes(32) for _ in range(n)]
    rs = [rng.bytes(32) for _ in range(n)]
    msgs = [rng.bytes(int(rng.integers(0, 400))) for _ in range(n)]
    rows = PS.challenge_rows(pks, msgs, rs)
    assert rows.shape == (n, 32) and rows.dtype == np.uint8
    assert [r.tobytes() for r in rows] == [
        native.sr25519_challenge(pk, r, m) for pk, m, r in zip(pks, msgs, rs)
    ]
    ks = PS.challenge_batch(pks, msgs, rs)
    assert ks == jax_challenge_batch(pks, msgs, rs)
    assert ks == [int.from_bytes(r.tobytes(), "little") for r in rows]
