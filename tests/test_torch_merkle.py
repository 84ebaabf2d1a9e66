"""The port's merkle slice against the JAX package, on the CPU.

Kernels X4 (SHA-256 rows, tree levels) and X5 (proof walks) run their
plain versions here, because the tensors lie on the CPU; the JAX side
runs its XLA programs on the CPU as tests/test_ops_merkle.py runs them,
at the same shapes (7 rows a length, trees of the same sizes, proof
batches of 37, 3 and 64), so the compiled programs are shared. Inputs
come from seeds through numpy and cross between the packages as bytes
(proofs through their proto form). Tolerance: zero (digests, roots,
proof bytes and bitmaps identical).
"""

import hashlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tendermint_tpu.crypto import merkle as jm
from tendermint_tpu.ops import merkle_kernel as JMK
from tendermint_tpu.ops import sha256_kernel as JSK
from tendermint_tpu.types import tx as jtx
from tendermint_tpu_torch import interop
from tendermint_tpu_torch.crypto import merkle as tm
from tendermint_tpu_torch.ops import merkle_kernel as MK
from tendermint_tpu_torch.ops import sha256_kernel as S
from tendermint_tpu_torch.types import tx as ttx


def _items(n: int, seed: int, lo: int = 1, hi: int = 80):
    rng = np.random.default_rng(seed)
    return [
        rng.integers(0, 256, int(rng.integers(lo, hi)), dtype=np.uint8).tobytes()
        for _ in range(n)
    ]


def _rows(n: int, length: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (n, length), dtype=np.uint8)


@pytest.mark.parametrize("length", [0, 1, 32, 55, 56, 64, 65, 119, 200])
def test_plain_sha256_fixed_matches_jax_and_hashlib(length):
    rows = _rows(7, length, 500 + length)
    got = S.sha256_fixed(torch.from_numpy(rows))  # CPU: the plain version
    assert got.dtype == torch.uint8 and tuple(got.shape) == (7, 32)
    cols = jnp.asarray(rows.T) if length else jnp.zeros((0, 7), jnp.uint8)
    want = np.asarray(JSK.sha256_fixed(cols))
    assert np.array_equal(interop.cols_from_rows(got), want)
    for i in range(7):
        assert got[i].numpy().tobytes() == hashlib.sha256(rows[i].tobytes()).digest()


def test_leaf_and_inner_prefixes_match_jax():
    leaves = _rows(5, 40, 1)
    got = S.leaf_hash_batch(interop.rows_from_cols(leaves.T, "cpu"))
    want = np.asarray(JSK.leaf_hash_batch(jnp.asarray(leaves.T)))
    assert np.array_equal(interop.cols_from_rows(got), want)
    for i in range(5):
        assert got[i].numpy().tobytes() == tm.leaf_hash(leaves[i].tobytes())
    left, right = _rows(5, 32, 2), _rows(5, 32, 3)
    got = S.inner_hash_batch(torch.from_numpy(left), torch.from_numpy(right))
    want = np.asarray(
        JSK.inner_hash_batch(jnp.asarray(left.T), jnp.asarray(right.T))
    )
    assert np.array_equal(interop.cols_from_rows(got), want)
    for i in range(5):
        assert got[i].numpy().tobytes() == jm.inner_hash(
            left[i].tobytes(), right[i].tobytes()
        )


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 7, 8, 13, 64, 100, 257])
def test_tree_root_matches_jax_tree_root_and_both_hash_from_byte_slices(n):
    items = _items(n, 700 + n)
    leaf_hashes = [tm.leaf_hash(it) for it in items]
    got = MK.tree_root(leaf_hashes, device="cpu")
    assert got == JMK.tree_root(leaf_hashes)
    assert got == jm.hash_from_byte_slices(items)
    assert got == tm.hash_from_byte_slices(items)


def _jax_roots(proofs, root: bytes):
    """The JAX verify_proofs' packing and program, keeping the roots:
    (roots (K, 32), bitmap (K,))."""
    jproofs = [jm.Proof.from_proto_bytes(b) for b in interop.proofs_to_proto(proofs)]
    k = len(jproofs)
    sides, max_d = [], 0
    for p in jproofs:
        s = None
        if (
            0 <= p.index < p.total
            and len(p.leaf_hash) == 32
            and all(len(a) == 32 for a in p.aunts)
        ):
            s = JMK._sides_for(p.index, p.total)
            if len(s) != len(p.aunts):
                s = None
        sides.append(s)
        max_d = max(max_d, len(s or ()))
    kb, db = JMK._bucket(k), JMK._bucket(max(max_d, 1))
    leaf = np.zeros((32, kb), dtype=np.uint8)
    aunts = np.zeros((db, 32, kb), dtype=np.uint8)
    flags = np.full((db, kb), JMK._STEP_NOOP, dtype=np.int32)
    for i, (p, s) in enumerate(zip(jproofs, sides)):
        if s is None:
            continue
        leaf[:, i] = np.frombuffer(p.leaf_hash, dtype=np.uint8)
        for d, (aunt, side) in enumerate(zip(p.aunts, s)):
            aunts[d, :, i] = np.frombuffer(aunt, dtype=np.uint8)
            flags[d, i] = side
    roots = np.asarray(
        JMK._verify_program(jnp.asarray(leaf), jnp.asarray(aunts), jnp.asarray(flags))
    )[:, :k]
    bitmap = JMK.verify_proofs(jproofs, root)
    return roots.T, bitmap


def _port_roots(proofs, root: bytes):
    roots, ok = MK.verify_program_plain(*MK.pack_proofs(proofs, root).to("cpu"))
    return roots.numpy(), ok.numpy()


def _proofs(prefix: bytes, n: int):
    return tm.proofs_from_byte_slices([prefix + b"%d" % i for i in range(n)])


def test_verify_program_matches_jax_on_corrupted_proofs():
    """The 37-proof batch of test_ops_merkle.py: one aunt zeroed, one
    leaf hash zeroed, one index moved."""
    root, proofs = tm.proofs_from_byte_slices([b"item-%d" % i for i in range(37)])
    proofs[5].aunts[0] = bytes(32)
    proofs[11].leaf_hash = bytes(32)
    proofs[20].index = 21
    roots, ok = _port_roots(proofs, root)
    j_roots, j_ok = _jax_roots(proofs, root)
    assert np.array_equal(roots, j_roots)
    assert np.array_equal(ok, j_ok)
    assert np.flatnonzero(~ok).tolist() == [5, 11, 20]
    assert np.array_equal(MK.verify_proofs(proofs, root, device="cpu"), j_ok)


def test_verify_program_matches_jax_on_mixed_depths_in_one_batch():
    """Proofs of a 3-leaf and a 64-leaf tree in one port batch against
    each root; the JAX side runs each tree's batch as its test does."""
    root_a, proofs_a = _proofs(b"a", 3)
    root_b, proofs_b = _proofs(b"b", 64)
    for root in (root_a, root_b):
        roots, ok = _port_roots(proofs_a + proofs_b, root)
        ja, ja_ok = _jax_roots(proofs_a, root)
        jb, jb_ok = _jax_roots(proofs_b, root)
        assert np.array_equal(roots, np.concatenate([ja, jb]))
        assert np.array_equal(ok, np.concatenate([ja_ok, jb_ok]))
        assert ok.tolist() == [root == root_a] * 3 + [root == root_b] * 64


def test_verify_program_matches_jax_on_structurally_invalid_proofs():
    root, proofs = _proofs(b"x", 8)
    proofs[2].total = 0
    proofs[3].aunts = proofs[3].aunts[:-1]  # wrong depth
    roots, ok = _port_roots(proofs, root)
    j_roots, j_ok = _jax_roots(proofs, root)
    assert np.array_equal(roots, j_roots)
    assert np.array_equal(ok, j_ok)
    assert np.flatnonzero(~ok).tolist() == [2, 3]
    assert roots[2].tobytes() == roots[3].tobytes() == bytes(32)
    # outside what the wire carries: a total past int64, a root of 31
    # bytes; False as the host path answers, never raised
    proofs[5].total = 2**70
    want = [p.compute_root_hash() == root for p in proofs]
    assert MK.verify_proofs(proofs, root, device="cpu").tolist() == want
    assert not MK.verify_proofs(proofs, root[:31], device="cpu").any()


def test_sides_batch_is_the_recursion_of_both_packages():
    """The level-order side bits of every (index, total) up to 70 leaves
    and of three large trees equal the recursive _sides_for of the port
    and of the JAX package."""
    cases = [(i, t) for t in range(1, 71) for i in range(t)]
    cases += [(i, t) for t in (2**40 + 3, 2**62 + 5) for i in (0, t // 3, t - 1)]
    idx = np.array([c[0] for c in cases], dtype=np.int64)
    tot = np.array([c[1] for c in cases], dtype=np.int64)
    depth, sides = MK.sides_batch(idx, tot)
    for (i, t), d, s in zip(cases, depth.tolist(), sides.tolist()):
        want = JMK._sides_for(i, t)
        assert MK._sides_for(i, t) == want
        assert d == len(want)
        assert [(s >> j) & 1 for j in range(d)] == want, (i, t)


def test_proofs_and_proto_bytes_identical_to_jax():
    items = _items(41, 9)
    root, proofs = tm.proofs_from_byte_slices(items)
    j_root, j_proofs = jm.proofs_from_byte_slices(items)
    assert root == j_root
    blobs = interop.proofs_to_proto(proofs)
    assert blobs == [p.to_proto_bytes() for p in j_proofs]
    assert interop.proofs_from_proto(blobs) == proofs
    for p, leaf in zip(proofs, items):
        p.verify(root, leaf)
        assert p.compute_root_hash() == root
    picks = [0, 7, 40, 7, 33]
    tree = tm.MerkleMultiTree.from_byte_slices(items)
    j_tree = jm.MerkleMultiTree.from_byte_slices(items)
    assert tree.root == j_tree.root == root
    assert interop.proofs_to_proto(tree.proofs(picks)) == [
        p.to_proto_bytes() for p in j_tree.proofs(picks)
    ]
    m_root, m_proofs = tm.multiproofs_from_byte_slices(items, picks)
    assert m_root == root and m_proofs == [proofs[i] for i in picks]
    bad = list(items)
    bad[7] = b"forged"
    bits = tm.verify_multiproofs_batch(m_proofs, root, [bad[i] for i in picks])
    assert bits.tolist() == jm.verify_multiproofs_batch(
        [j_proofs[i] for i in picks], root, [bad[i] for i in picks]
    ).tolist() == [True, False, True, False, True]


def test_txs_hash_and_proofs_identical_to_jax():
    txs = _items(23, 11, 100, 300)
    assert ttx.txs_hash(txs) == jtx.txs_hash(txs)
    assert [ttx.tx_hash(t) for t in txs] == [jtx.tx_hash(t) for t in txs]
    assert ttx.tx_key(txs[0]) == jtx.tx_key(txs[0])
    assert interop.proofs_to_proto(ttx.txs_proofs(txs)) == [
        p.to_proto_bytes() for p in jtx.txs_proofs(txs)
    ]


def test_install_gates_route_large_inputs_to_the_hooks():
    """600 leaves go to the root hook and 4 stay on the host; the proof
    seam catches a tampered leaf at index 7 as the JAX seam does."""
    items = [b"tx-%d" % i for i in range(600)]
    want = jm.hash_from_byte_slices(items)
    MK.install(device="cpu", min_leaves=512)
    try:
        before = MK.stats()
        assert tm.hash_from_byte_slices(items) == want
        assert MK.stats()["roots"] == before["roots"] + 1
        assert MK.stats()["leaves"] == before["leaves"] + 600
        small = [b"s%d" % i for i in range(4)]
        assert tm.hash_from_byte_slices(small) == jm.hash_from_byte_slices(small)
        assert MK.stats()["roots"] == before["roots"] + 1
        assert MK.installed() == 512
    finally:
        MK.uninstall()
    assert MK.installed() is None and tm._device_root_hook is None
    items = [b"p%d" % i for i in range(80)]
    root, proofs = tm.proofs_from_byte_slices(items)
    MK.install(device="cpu", min_leaves=16)
    try:
        before = MK.stats()["proofs"]
        assert tm.verify_proofs_batch(proofs, root, items).all()
        tampered = list(items)
        tampered[7] = b"tampered"
        bitmap = tm.verify_proofs_batch(proofs, root, tampered)
        assert MK.stats()["proofs"] == before + 160
        j_proofs = [jm.Proof.from_proto_bytes(b) for b in interop.proofs_to_proto(proofs)]
        assert bitmap.tolist() == jm.verify_proofs_batch(j_proofs, root, tampered).tolist()
        assert not bitmap[7] and bitmap.sum() == 79
    finally:
        MK.uninstall()


def test_a_device_error_raises_out_of_the_hooks(monkeypatch):
    """What the installed hooks run is not wrapped: an error in it
    reaches the caller, and the host reduction is not run instead."""
    items = [b"e%d" % i for i in range(600)]
    root, proofs = tm.proofs_from_byte_slices(items)

    def broken(*args, **kwargs):
        raise RuntimeError("launch failed")

    def no_host(*args, **kwargs):
        raise AssertionError("the host path ran")

    MK.install(device="cpu", min_leaves=512)
    try:
        monkeypatch.setattr(MK, "tree_root", broken)
        monkeypatch.setattr(MK, "verify_proofs", broken)
        monkeypatch.setattr(tm, "_reduce", no_host)
        monkeypatch.setattr(tm.Proof, "compute_root_hash", no_host)
        with pytest.raises(RuntimeError, match="launch failed"):
            tm.hash_from_byte_slices(items)
        with pytest.raises(RuntimeError, match="launch failed"):
            tm.verify_proofs_batch(proofs, root, items)
    finally:
        MK.uninstall()


def test_install_and_entry_points_without_cuda_raise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    leaf_hashes = [tm.leaf_hash(b"%d" % i) for i in range(3)]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MK.install()
    assert MK.installed() is None and tm._device_root_hook is None
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MK.tree_root(leaf_hashes)
    root, proofs = _proofs(b"c", 3)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MK.verify_proofs(proofs, root)
