"""The batch split over several GPUs (tendermint_tpu_torch/parallel) on
eight virtual shards of the CPU, against the JAX package's sharded
verifiers on the suite's eight virtual CPU devices.

Each case of tests/test_sharding.py, on a mesh of `cpu` x 8 (the plain
versions, one window a shard):
- bucket rounding: the port's sharded verifiers' buckets and _bucket(n)
  equal the JAX ShardedEd25519Verifier's and ShardedSr25519Verifier's on
  the JAX 8-device mesh, with bucket_sizes [4, 10, 100], for n in 1, 4,
  9, 100, 101 and 20000; building either compiles nothing;
- 13 signatures (an uneven split), the corrupted lanes {0, 7, 9, 15} of a
  16-lane window and sr25519's {2, 8, 12} of 13: each bitmap equals the
  JAX package's host verify of the same bytes, lane for lane;
- install(mesh=...) routes both key types through the sharded
  verifiers, and the node seam with `[gpu] devices = 8` (the visible
  count monkeypatched) installs the split; a batch with a zeroed
  signature flows through each (tests/test_sharding.py's
  `test_matches_single_chip_verifier` batches: 11 ed25519 through the
  node's plane, 9 sr25519 through the mesh install), and its bitmap
  equals the unsharded verifier's and the JAX host verify's;
- `Node._device_mesh`'s rules, held against the JAX function.

The JAX sharded program is not run (tests/test_sharding.py takes minutes
a worker); nothing here compiles a JAX program.

A last case has no card and runs the CUDA side of every launch wrapper
on a mocked list of four CUDA devices: a TorchFunctionMode keeps their
tensors on the CPU under a device tag, and a kernel library stand-in
records, at each launch, the current device, the device its tensors are
on and the stream. Every shard's launches must run under their own
card's device, on a stream of the shard's own, and a wrapper called with
card 3's tensors while card 0 is current must launch under card 3 and
give card 0 back (ops/build.launch). Tolerance: zero (bitmaps).
"""

import contextlib
import hashlib
import itertools

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

import jax

from tendermint_tpu.crypto.keys import pubkey_from_type_and_bytes as jax_pubkey
from tendermint_tpu.crypto import sr25519 as _jax_sr  # noqa: F401  (registers the key type)
from tendermint_tpu.node.node import Node as JaxNode
from tendermint_tpu.parallel import ShardedEd25519Verifier as JaxShardedEd
from tendermint_tpu.parallel import ShardedSr25519Verifier as JaxShardedSr
from tendermint_tpu.parallel import make_mesh as jax_make_mesh
from tendermint_tpu_torch import config
from tendermint_tpu_torch.crypto import batch, gpu_verifier
from tendermint_tpu_torch.crypto.ed25519 import PrivKeyEd25519
from tendermint_tpu_torch.crypto.sr25519 import PrivKeySr25519
from tendermint_tpu_torch.node import device as node_device
from tendermint_tpu_torch.ops import ed25519_cuda, sha512_kernel, sr25519_cuda
from tendermint_tpu_torch.ops.ed25519_kernel import Ed25519Verifier
from tendermint_tpu_torch.ops.sr25519_kernel import Sr25519Verifier
from tendermint_tpu_torch.parallel import (
    ShardedEd25519Verifier,
    ShardedSr25519Verifier,
    make_mesh,
)

from .test_torch_isolation import jax_device_plane_paused  # noqa: F401 (autouse)

SHARDS = 8


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(["cpu"] * SHARDS)


@pytest.fixture(scope="module")
def jax_mesh():
    devs = jax.devices()
    assert len(devs) >= SHARDS, "conftest should provide 8 virtual devices"
    return jax_make_mesh(devs[:SHARDS])


@pytest.fixture(autouse=True)
def _uninstalled():
    yield
    node_device.uninstall_device_plane()


def _sign_set(n, tag=b"shard"):
    """tests/test_sharding.py `_sign_set`, signed by the port."""
    keys = [PrivKeyEd25519.from_seed(hashlib.sha256(tag + bytes([i])).digest()) for i in range(n)]
    msgs = [b"sharded-msg-" + bytes([i]) for i in range(n)]
    return keys, msgs, [k.sign(m) for k, m in zip(keys, msgs)]


def _sr_sign_set(n, tag=b"sr-shard"):
    keys = [PrivKeySr25519.from_seed(hashlib.sha256(tag + bytes([i])).digest()) for i in range(n)]
    msgs = [b"sr-sharded-" + bytes([i]) for i in range(n)]
    return keys, msgs, [k.sign(m) for k, m in zip(keys, msgs)]


def _flip(sigs, bad):
    for i in bad:
        sigs[i] = sigs[i][:40] + bytes([sigs[i][40] ^ 1]) + sigs[i][41:]


def _pks(keys):
    return [k.pub_key().bytes() for k in keys]


def _jax_bitmap(key_type, pks, msgs, sigs):
    """The JAX package's host verify of each triple."""
    return [jax_pubkey(key_type, pk).verify_signature(m, s) for pk, m, s in zip(pks, msgs, sigs)]


@pytest.mark.parametrize("port_cls,jax_cls", [
    (ShardedEd25519Verifier, JaxShardedEd), (ShardedSr25519Verifier, JaxShardedSr)])
def test_bucket_rounds_to_mesh_multiples(mesh, jax_mesh, port_cls, jax_cls, monkeypatch):
    """The same buckets and _bucket(n) as the JAX verifier on 8 devices,
    oversized batches included; building either launches nothing."""
    def no_launch(*_a, **_k):
        raise AssertionError("a verifier launched at construction")

    monkeypatch.setattr(Ed25519Verifier, "dispatch", no_launch)
    monkeypatch.setattr(Sr25519Verifier, "dispatch", no_launch)
    v = port_cls(mesh, bucket_sizes=[4, 10, 100])
    j = jax_cls(jax_mesh, bucket_sizes=[4, 10, 100])
    assert v.bucket_sizes == list(j.bucket_sizes) == [8, 16, 104]
    for n in (1, 4, 9, 100, 101, 20_000):
        assert v._bucket(n) == j._bucket(n)
        assert v._bucket(n) % SHARDS == 0 and v._bucket(n) >= n
    assert v._streams is None and not j._compiled


def test_uneven_batch_verifies(mesh):
    """13 signatures on 8 shards: the bucket pads to 16, two lanes a
    shard, the last shard all padding (it launches all the same)."""
    keys, msgs, sigs = _sign_set(13)
    ok = ShardedEd25519Verifier(mesh, bucket_sizes=[8]).verify(_pks(keys), msgs, sigs)
    assert ok.shape == (13,) and ok.all()
    assert ok.tolist() == _jax_bitmap("ed25519", _pks(keys), msgs, sigs)


def test_invalid_sigs_localized_across_shards(mesh):
    """Corruptions at shard boundaries of a 16-lane window (2 lanes a
    shard) are reported at their own index."""
    keys, msgs, sigs = _sign_set(16)
    bad = {0, 7, 9, 15}
    _flip(sigs, bad)
    ok = ShardedEd25519Verifier(mesh, bucket_sizes=[16]).verify(_pks(keys), msgs, sigs)
    assert ok.tolist() == [i not in bad for i in range(16)]
    assert ok.tolist() == _jax_bitmap("ed25519", _pks(keys), msgs, sigs)


def test_node_installs_sharded_verifier_from_config(monkeypatch):
    """`[gpu] devices = 8` with eight devices visible installs the split
    for both key types (merkle stays unsharded), and 11 signatures, the
    fourth zeroed, flow through it as one window: the default buckets
    rounded to multiples of 8 give it 32 lanes (pad waste 21), its
    bitmap is the unsharded verifier's and JAX's, and no fault."""
    monkeypatch.setattr(node_device, "visible_devices", lambda device="cuda": 8)
    cfg = config.GPUConfig(devices=8, min_batch_size=2)
    assert node_device.install_device_plane(cfg, device="cpu")
    keys, msgs, sigs = _sign_set(11, b"eq")
    sigs[3] = b"\x00" * 64
    bv = batch.create_batch_verifier(keys[0].pub_key(), 64)
    assert isinstance(bv, gpu_verifier.GpuEd25519BatchVerifier)
    assert isinstance(bv._verifier, ShardedEd25519Verifier)
    assert bv._verifier.mesh.size == 8
    assert isinstance(gpu_verifier._VERIFIERS["sr25519"], ShardedSr25519Verifier)
    before = gpu_verifier.stats()
    for k, m, s in zip(keys, msgs, sigs):
        bv.add(k.pub_key(), m, s)
    ok, bits = bv.verify()
    after = gpu_verifier.stats()
    single = Ed25519Verifier(device="cpu").verify(_pks(keys), msgs, sigs)
    assert not ok and bits == single.tolist() == _jax_bitmap("ed25519", _pks(keys), msgs, sigs)
    assert bits == [i != 3 for i in range(11)]
    assert after["pad_waste"] - before["pad_waste"] == 21
    assert after["batches_ed25519"] - before["batches_ed25519"] == 1
    assert after["faults"] == before["faults"] and after["rerouted_sigs"] == before["rerouted_sigs"]


def test_device_mesh_config_validation(monkeypatch):
    """The JAX Node._device_mesh's rules on its 8 visible devices, and
    the port's device_mesh on 8 visible cards (mocked)."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    assert JaxNode._device_mesh(1) is None and node_device.device_mesh(1) is None
    j, m = JaxNode._device_mesh(0), node_device.device_mesh(0)
    assert m.size == j.devices.size == 8
    assert m.devices == tuple(torch.device("cuda", i) for i in range(8))
    for n in (10_000, -1):
        with pytest.raises(RuntimeError) as je:
            JaxNode._device_mesh(n)
        with pytest.raises(RuntimeError) as pe:
            node_device.device_mesh(n)
        assert ("only" in str(je.value)) == ("only" in str(pe.value))
    assert "only 8 device" in str(pe.value) or "must be >= 0" in str(pe.value)


# -- sr25519


def test_sr25519_uneven_batch_and_localization(mesh):
    keys, msgs, sigs = _sr_sign_set(13)
    bad = {2, 8, 12}
    _flip(sigs, bad)
    ok = ShardedSr25519Verifier(mesh, bucket_sizes=[8]).verify(_pks(keys), msgs, sigs)
    assert ok.tolist() == [i not in bad for i in range(13)]
    assert ok.tolist() == _jax_bitmap("sr25519", _pks(keys), msgs, sigs)


def test_mesh_install_shards_both_key_types(mesh):
    """install(mesh=...) routes ed25519 and sr25519 batches through the
    sharded verifiers; 9 sr25519 signatures, the fifth zeroed, verify
    across the mesh as the unsharded verifier and JAX verify them."""
    gpu_verifier.install(device="cpu", min_batch=2, mesh=mesh, gather_deadline_s=None)
    try:
        ed = batch.create_batch_verifier(PrivKeyEd25519.from_seed(b"\x21" * 32).pub_key(), 8)
        assert isinstance(ed._verifier, ShardedEd25519Verifier) and ed._verifier.mesh is mesh
        keys, msgs, sigs = _sr_sign_set(9, b"sr-eq")
        sigs[4] = b"\x00" * 64
        bv = batch.create_batch_verifier(keys[0].pub_key(), 9)
        assert isinstance(bv, gpu_verifier.GpuSr25519BatchVerifier)
        assert isinstance(bv._verifier, ShardedSr25519Verifier) and bv._verifier.mesh is mesh
        for k, m, s in zip(keys, msgs, sigs):
            bv.add(k.pub_key(), m, s)
        ok, bits = bv.verify()
    finally:
        gpu_verifier.uninstall()
    single = Sr25519Verifier(device="cpu").verify(_pks(keys), msgs, sigs)
    assert not ok and bits == single.tolist() == _jax_bitmap("sr25519", _pks(keys), msgs, sigs)
    assert bits == [i != 4 for i in range(9)]


# -- launches on a mocked list of four CUDA devices


class _Stream:
    _ids = itertools.count(0x1000)

    def __init__(self, device=None):
        self.device = torch.device(device if device is not None else "cuda:0")
        self.cuda_stream = next(self._ids)


class _FakeCards(TorchFunctionMode):
    """Four CUDA cards on the CPU: a tensor placed on "cuda:i" stays on
    the CPU and is tagged i, and so is whatever is computed from it; its
    `.device` reads cuda:i. torch.cuda's device and stream contexts keep
    a current device and a current stream a card, as CUDA does."""

    def __init__(self):
        super().__init__()
        self.tags = {}  # id(tensor) -> (tensor, card)
        self.current = 0
        self.streams = {}  # card -> its current stream

    def card_of(self, t):
        hit = self.tags.get(id(t))
        return hit[1] if hit is not None and hit[0] is t else None

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if func is torch.device:
            return func(*args, **kwargs)
        if func == torch.Tensor.device.__get__:
            card = self.card_of(args[0])
            return torch.device("cuda", card) if card is not None else func(*args)
        card = None

        def host(x):
            nonlocal card
            if isinstance(x, str) and x.startswith("cuda"):
                x = torch.device(x)
            if isinstance(x, torch.device) and x.type == "cuda":
                card = x.index or 0
                return torch.device("cpu")
            if isinstance(x, torch.Tensor) and card is None:
                card = self.card_of(x)
            if isinstance(x, (list, tuple)):
                return type(x)(host(y) for y in x)
            return x

        args = tuple(host(a) for a in args)
        kwargs = {k: host(v) for k, v in kwargs.items()}
        out = func(*args, **kwargs)
        if card is not None and getattr(func, "__name__", "") not in ("cpu", "numpy"):
            for t in out if isinstance(out, (tuple, list)) else (out,):
                if isinstance(t, torch.Tensor):
                    self.tags[id(t)] = (t, card)
        return out

    @contextlib.contextmanager
    def device(self, device):
        prev, self.current = self.current, torch.device(device).index
        try:
            yield
        finally:
            self.current = prev

    @contextlib.contextmanager
    def stream(self, stream):
        card = stream.device.index
        prev = (self.current, self.streams.get(card))
        self.current, self.streams[card] = card, stream
        try:
            yield
        finally:
            self.current, self.streams[card] = prev

    def current_stream(self, device=None):
        card = self.current if device is None else torch.device(device).index
        return self.streams.setdefault(card, _Stream(torch.device("cuda", card)))


class _Recorder:
    """The kernel libraries: each launch records (kernel, current card,
    its tensors' card, stream) and writes nothing."""

    def __init__(self, cards):
        self.cards = cards
        self.launches = []

    def __getitem__(self, _stem):
        return self

    def __getattr__(self, name):
        def launch(*args):
            self.launches.append((name, self.cards.current, args[-2], args[-1].value))
            return 0

        return launch


@pytest.fixture
def four_cards(monkeypatch):
    cards = _FakeCards()
    rec = _Recorder(cards)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "device", cards.device)
    monkeypatch.setattr(torch.cuda, "stream", cards.stream)
    monkeypatch.setattr(torch.cuda, "current_stream", cards.current_stream)
    monkeypatch.setattr(torch.cuda, "Stream", _Stream)
    for mod in (ed25519_cuda, sha512_kernel, sr25519_cuda):
        monkeypatch.setattr(mod, "kernels", lambda: rec)
    counts = [dict(m.LAUNCHES) for m in (ed25519_cuda, sha512_kernel, sr25519_cuda)]
    with cards:
        yield cards, rec
    for m, c in zip((ed25519_cuda, sha512_kernel, sr25519_cuda), counts):
        m.LAUNCHES.update(c)


def _per_shard(launches, names):
    """{card: [(kernel, stream), ...]} of the launches of `names`, each
    checked to have run under its tensors' card."""
    out = {}
    for name, current, tensors_card, stream in launches:
        if name in names:
            assert current == tensors_card, (name, current, tensors_card)
            out.setdefault(tensors_card, []).append((name, stream))
    return out


def test_each_shard_launches_under_its_own_card(four_cards):
    """A window of 8 ed25519 and 8 sr25519 signatures split over cuda:0-3:
    every launch under the card its tensors are on, each card's launches
    on one stream of its own (X1 and K2 for ed25519, X3 for sr25519, once
    a shard), and card 0 current again after."""
    cards, rec = four_cards
    mesh = make_mesh([f"cuda:{i}" for i in range(4)])
    keys, msgs, sigs = _sign_set(8, b"cards")
    ed = ShardedEd25519Verifier(mesh, bucket_sizes=[8])
    assert ed.gather(ed.dispatch(_pks(keys), msgs, sigs)).shape == (8,)
    want = ("sha512_ram", "ed25519_verify_tile")
    per = _per_shard(rec.launches, {f"tm_{n}" for n in want})
    assert sorted(per) == [0, 1, 2, 3]
    streams = {card: {s for _n, s in got} for card, got in per.items()}
    assert all(len(s) == 1 for s in streams.values())
    assert len(set().union(*streams.values())) == 4
    assert all(sorted(n for n, _s in got) == sorted(f"tm_{n}" for n in want) for got in per.values())
    assert cards.current == 0

    rec.launches.clear()
    skeys, smsgs, ssigs = _sr_sign_set(8, b"cards")
    sr = ShardedSr25519Verifier(mesh, bucket_sizes=[8])
    assert sr.gather(sr.dispatch(_pks(skeys), smsgs, ssigs)).shape == (8,)
    per = _per_shard(rec.launches, {"tm_sr25519_verify"})
    assert sorted(per) == [0, 1, 2, 3] and all(len(got) == 1 for got in per.values())
    assert len({got[0][1] for got in per.values()}) == 4
    assert cards.current == 0


def test_a_wrapper_launches_under_its_tensors_card(four_cards):
    """Each launch wrapper called with card 3's tensors while card 0 is
    current launches under card 3, on card 3's stream, and leaves card 0
    current."""
    cards, rec = four_cards
    dev = torch.device("cuda", 3)
    z = lambda *shape, dtype=torch.uint8: torch.zeros(shape, dtype=dtype, device=dev)  # noqa: E731
    ed25519_cuda.verify_tile(z(32, 4), z(64, 4), z(64, 4))
    ed25519_cuda.dual_mult(z(4, 20, 4, dtype=torch.int32), z(64, 4, dtype=torch.int32),
                           z(64, 4, dtype=torch.int32))
    sr25519_cuda.verify_sr(z(32, 4), z(64, 4), z(32, 4))
    sha512_kernel.sha512_ragged(z(64, 4), z(32, 4), z(16), z(5, dtype=torch.int32), 0)
    assert [(n, c, t) for n, c, t, _s in rec.launches] == [
        (n, 3, 3) for n in ("tm_ed25519_verify_tile", "tm_ed25519_dual_mult", "tm_sr25519_verify", "tm_sha512_ram")]
    assert {s for *_x, s in rec.launches} == {cards.current_stream(dev).cuda_stream}
    assert cards.current == 0
