"""RFC-6962-style SHA-256 merkle trees and proofs.

Counterpart: tendermint_tpu/crypto/merkle.py (the whole module). Reference
behaviour: 0x00/0x01 leaf/inner domain separation
(crypto/merkle/hash.go:21,34), split point at the largest power of two
< n (crypto/merkle/tree.go:94), empty-tree hash = sha256("") (hash.go:16),
Proof verification with aunts ordered bottom-up
(crypto/merkle/proof.go:52,71), and multi-op ProofOperators chaining
(crypto/merkle/proof_op.go).

The device variant of root computation and proof verification is
ops/merkle_kernel.py, installed behind the two module hooks below; this
module is the host implementation and the oracle. Leaf hashing stays on
the host. A device error raises out of hash_from_byte_slices and
verify_proofs_batch: nothing answers it with the host path.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

__all__ = [
    "hash_from_byte_slices",
    "verify_proofs_batch",
    "verify_multiproofs_batch",
    "proofs_from_byte_slices",
    "multiproofs_from_byte_slices",
    "MerkleMultiTree",
    "Proof",
    "ProofOp",
    "ProofOperators",
    "ValueOp",
    "leaf_hash",
    "inner_hash",
    "empty_hash",
]

_LEAF_PREFIX = b"\x00"
_INNER_PREFIX = b"\x01"

# Device offload hooks, set by ops.merkle_kernel.install(): each takes
# the same inputs as the host path and returns None to decline (batch
# too small), keeping the host the default exactly like the
# BatchVerifier seam (reference plugin boundary: crypto/crypto.go:53-61).
_device_root_hook = None
_device_proofs_hook = None


def empty_hash() -> bytes:
    return hashlib.sha256(b"").digest()


def leaf_hash(leaf: bytes) -> bytes:
    return hashlib.sha256(_LEAF_PREFIX + leaf).digest()


def inner_hash(left: bytes, right: bytes) -> bytes:
    return hashlib.sha256(_INNER_PREFIX + left + right).digest()


def _split_point(n: int) -> int:
    """Largest power of two strictly less than n."""
    if n < 2:
        raise ValueError("n must be >= 2")
    return 1 << ((n - 1).bit_length() - 1)


def hash_from_byte_slices(items: Sequence[bytes]) -> bytes:
    """Merkle root of the list (same tree shape as the reference's
    recursive definition, crypto/merkle/tree.go:11-66). Large lists are
    offloaded when the device backend is installed."""
    if not items:
        return empty_hash()
    leaf_hashes = [leaf_hash(it) for it in items]
    if _device_root_hook is not None:
        root = _device_root_hook(leaf_hashes)
        if root is not None:
            return root
    return _reduce(leaf_hashes)


def verify_proofs_batch(proofs, root_hash: bytes, leaves: Sequence[bytes]):
    """Batch proof verification: bool bitmap, device-backed when
    installed (reference shape: crypto/merkle/proof.go:52 Verify, run
    per proof; the batch form is the merkle analog of
    BatchVerifier.Verify)."""
    import numpy as _np

    checked = _np.array(
        [
            len(p.leaf_hash) == 32 and leaf_hash(leaf) == p.leaf_hash
            for p, leaf in zip(proofs, leaves)
        ],
        dtype=bool,
    )
    if _device_proofs_hook is not None:
        bitmap = _device_proofs_hook(proofs, root_hash)
        if bitmap is not None:
            return checked & bitmap
    cpu = _np.array(
        [p.compute_root_hash() == root_hash for p in proofs], dtype=bool
    )
    return checked & cpu


def _reduce(hashes: List[bytes]) -> bytes:
    if len(hashes) == 1:
        return hashes[0]
    k = _split_point(len(hashes))
    return inner_hash(_reduce(hashes[:k]), _reduce(hashes[k:]))


@dataclass
class Proof:
    """Merkle inclusion proof (reference: crypto/merkle/proof.go:27-38)."""

    total: int
    index: int
    leaf_hash: bytes
    aunts: List[bytes] = field(default_factory=list)

    def verify(self, root_hash: bytes, leaf: bytes) -> None:
        if self.total < 0:
            raise ValueError("proof total must be positive")
        if self.index < 0:
            raise ValueError("proof index cannot be negative")
        lh = leaf_hash(leaf)
        if lh != self.leaf_hash:
            raise ValueError("invalid leaf hash")
        computed = self.compute_root_hash()
        if computed != root_hash:
            raise ValueError("invalid root hash")

    def compute_root_hash(self) -> Optional[bytes]:
        return _compute_hash_from_aunts(
            self.index, self.total, self.leaf_hash, self.aunts
        )

    # proto form (reference: proto/tendermint/crypto/proof.pb.go Proof)
    def to_proto_bytes(self) -> bytes:
        from ..encoding.proto import ProtoWriter

        w = ProtoWriter()
        w.int(1, self.total)
        w.int(2, self.index)
        w.bytes(3, self.leaf_hash)
        for aunt in self.aunts:
            w.bytes(4, aunt)
        return w.finish()

    @classmethod
    def from_proto_bytes(cls, data: bytes) -> "Proof":
        from ..encoding.proto import FieldReader

        r = FieldReader(data)
        return cls(
            total=r.int64(1),
            index=r.int64(2),
            leaf_hash=r.bytes(3),
            aunts=list(r.get_all(4)),
        )


def _compute_hash_from_aunts(
    index: int, total: int, leaf: bytes, aunts: List[bytes]
) -> Optional[bytes]:
    if index >= total or index < 0 or total <= 0:
        return None
    if total == 1:
        return leaf if not aunts else None
    if not aunts:
        return None
    k = _split_point(total)
    if index < k:
        left = _compute_hash_from_aunts(index, k, leaf, aunts[:-1])
        if left is None:
            return None
        return inner_hash(left, aunts[-1])
    right = _compute_hash_from_aunts(index - k, total - k, leaf, aunts[:-1])
    if right is None:
        return None
    return inner_hash(aunts[-1], right)


def proofs_from_byte_slices(
    items: Sequence[bytes],
) -> tuple[bytes, List[Proof]]:
    """Root hash plus an inclusion proof per item
    (reference: crypto/merkle/proof.go ProofsFromByteSlices)."""
    total = len(items)
    leaf_hashes = [leaf_hash(it) for it in items]
    proofs = [
        Proof(total=total, index=i, leaf_hash=leaf_hashes[i], aunts=[])
        for i in range(total)
    ]
    _build_aunts(leaf_hashes, list(range(total)), proofs)
    root = hash_from_byte_slices(items) if items else empty_hash()
    return root, proofs


class MerkleMultiTree:
    """Level-order hash schedule of the RFC-6962 tree: every inner node
    hashed ONCE, held by level, and shared across all proofs served
    from it.

    The schedule is the iterative form of the reference recursion
    (split at the largest power of two < n, crypto/merkle/tree.go:94):
    each round pairs adjacent nodes left-to-right and carries an odd
    trailing node up unchanged, which defers exactly the remainder
    subtree the recursive split would. Build once per block (N-1 inner
    hashes, no per-proof recursion), then answer every multi-proof
    request with aunt gathering alone."""

    __slots__ = ("total", "levels")

    def __init__(self, leaf_hashes: Sequence[bytes]) -> None:
        levels: List[List[bytes]] = [list(leaf_hashes)]
        sha = hashlib.sha256
        while len(levels[-1]) > 1:
            cur = levels[-1]
            nxt: List[bytes] = []
            append = nxt.append
            top = len(cur) - 1
            i = 0
            while i < top:
                append(sha(_INNER_PREFIX + cur[i] + cur[i + 1]).digest())
                i += 2
            if len(cur) & 1:
                append(cur[-1])
            levels.append(nxt)
        self.total = len(levels[0])
        self.levels = levels

    @classmethod
    def from_byte_slices(cls, items: Sequence[bytes]) -> "MerkleMultiTree":
        sha = hashlib.sha256
        return cls([sha(_LEAF_PREFIX + it).digest() for it in items])

    @property
    def root(self) -> bytes:
        return self.levels[-1][0] if self.total else empty_hash()

    def proof(self, index: int) -> Proof:
        """The inclusion proof for one leaf: aunts bottom-up, exactly
        the list `_build_aunts` would have appended."""
        if index < 0 or index >= self.total:
            raise ValueError(
                f"proof index {index} out of range [0, {self.total})"
            )
        aunts: List[bytes] = []
        pos = index
        for level in self.levels[:-1]:
            sib = pos ^ 1
            if sib < len(level):
                aunts.append(level[sib])
            pos >>= 1
        return Proof(
            total=self.total,
            index=index,
            leaf_hash=self.levels[0][index],
            aunts=aunts,
        )

    def proofs(self, indices: Sequence[int]) -> List[Proof]:
        """Proofs for K indices: sibling positions for all K paths per
        level with numpy int ops, the aunts gathered from that level's
        nodes; inner nodes are never re-hashed, and the work is
        K·log2(N), never O(level)."""
        import numpy as _np

        idx = _np.asarray(list(indices), dtype=_np.int64)
        if idx.size and (
            int(idx.min()) < 0 or int(idx.max()) >= self.total
        ):
            bad = int(idx.min()) if int(idx.min()) < 0 else int(idx.max())
            raise ValueError(
                f"proof index {bad} out of range [0, {self.total})"
            )
        leaf_level = self.levels[0]
        out = [
            Proof(
                total=self.total,
                index=int(i),
                leaf_hash=leaf_level[i],
                aunts=[],
            )
            for i in idx.tolist()
        ]
        pos = idx
        for level in self.levels[:-1]:
            sib = pos ^ 1
            sibs = sib.tolist()
            for k in _np.flatnonzero(sib < len(level)).tolist():
                out[k].aunts.append(level[sibs[k]])
            pos = pos >> 1
        return out


def multiproofs_from_byte_slices(
    items: Sequence[bytes], indices: Sequence[int]
) -> tuple[bytes, List[Proof]]:
    """Root hash plus inclusion proofs for the K requested indices,
    built as one level-order schedule (MerkleMultiTree) instead of the
    all-leaves recursion; byte-identical per proof to
    `proofs_from_byte_slices`."""
    tree = MerkleMultiTree.from_byte_slices(items)
    return tree.root, tree.proofs(list(indices))


def _root_from_aunts_iter(
    index: int, total: int, leaf: bytes, aunts: List[bytes], inner
) -> Optional[bytes]:
    """Iterative (level-order) twin of `_compute_hash_from_aunts`:
    consumes aunts bottom-up, skips the carried odd node exactly where
    the recursion's size-1 right subtree consumes nothing, and returns
    None for every aunt-count mismatch the recursion rejects. `inner`
    is injected so the batch verifier can memoize shared nodes."""
    if index >= total or index < 0 or total <= 0:
        return None
    h = leaf
    pos, cnt, used = index, total, 0
    n_aunts = len(aunts)
    while cnt > 1:
        sib = pos ^ 1
        if sib < cnt:
            if used >= n_aunts:
                return None
            aunt = aunts[used]
            used += 1
            h = inner(aunt, h) if pos & 1 else inner(h, aunt)
        pos >>= 1
        cnt = (cnt + 1) >> 1
    return h if used == n_aunts else None


def verify_multiproofs_batch(proofs, root_hash: bytes, leaves):
    """Batched verification of K proofs cut from ONE tree: the same bool
    bitmap as `verify_proofs_batch`, but inner nodes shared between
    proof paths are hashed once (the memo is keyed by the exact hash
    input, so it is sound for hostile aunts too: they simply never
    share). Host only by design, as in the JAX package."""
    import numpy as _np

    sha = hashlib.sha256
    checked = _np.array(
        [
            len(p.leaf_hash) == 32
            and sha(_LEAF_PREFIX + leaf).digest() == p.leaf_hash
            for p, leaf in zip(proofs, leaves)
        ],
        dtype=bool,
    )
    memo: dict = {}

    def inner(left: bytes, right: bytes) -> bytes:
        key = left + right
        v = memo.get(key)
        if v is None:
            v = memo[key] = sha(_INNER_PREFIX + key).digest()
        return v

    ok = _np.fromiter(
        (
            _root_from_aunts_iter(
                p.index, p.total, p.leaf_hash, p.aunts, inner
            )
            == root_hash
            for p in proofs
        ),
        dtype=bool,
        count=len(proofs),
    )
    return checked & ok


def _build_aunts(
    hashes: List[bytes], idxs: List[int], proofs: List[Proof]
) -> bytes:
    if len(hashes) == 1:
        return hashes[0]
    k = _split_point(len(hashes))
    left = _build_aunts(hashes[:k], idxs[:k], proofs)
    right = _build_aunts(hashes[k:], idxs[k:], proofs)
    for i in idxs[:k]:
        proofs[i].aunts.append(right)
    for i in idxs[k:]:
        proofs[i].aunts.append(left)
    return inner_hash(left, right)


# -- multi-op proofs (reference: crypto/merkle/proof_op.go) --


@dataclass
class ProofOp:
    type: str
    key: bytes
    data: bytes


class ProofOperator:
    def run(self, values: List[bytes]) -> List[bytes]:
        raise NotImplementedError

    def get_key(self) -> bytes:
        raise NotImplementedError


class ValueOp(ProofOperator):
    """Proves a (key, value) pair rolls up into a merkle root
    (reference: crypto/merkle/proof_value.go)."""

    TYPE = "simple:v"

    def __init__(self, key: bytes, proof: Proof) -> None:
        self.key = key
        self.proof = proof

    def run(self, values: List[bytes]) -> List[bytes]:
        if len(values) != 1:
            raise ValueError("ValueOp expects one value")
        vhash = hashlib.sha256(values[0]).digest()
        from ..encoding.proto import ProtoWriter

        w = ProtoWriter()
        w.bytes(1, self.key)
        w.bytes(2, vhash)
        kv_bytes = w.finish()
        if leaf_hash(kv_bytes) != self.proof.leaf_hash:
            raise ValueError("leaf hash mismatch in ValueOp")
        root = self.proof.compute_root_hash()
        if root is None:
            raise ValueError("bad proof in ValueOp")
        return [root]

    def get_key(self) -> bytes:
        return self.key


class ProofOperators:
    """A chain of operators verified bottom-up against a root
    (reference: crypto/merkle/proof_op.go:60-90)."""

    def __init__(self, ops: List[ProofOperator]) -> None:
        self.ops = ops

    def verify_value(self, root: bytes, keypath: str, value: bytes) -> None:
        self.verify(root, keypath, [value])

    def verify(self, root: bytes, keypath: str, args: List[bytes]) -> None:
        keys = _parse_key_path(keypath)
        for op in self.ops:
            key = op.get_key()
            if key:
                if not keys or keys[-1] != key:
                    raise ValueError(f"key mismatch on path: {key!r}")
                keys.pop()
            args = op.run(args)
        if args != [root]:
            raise ValueError("proof did not produce the expected root")
        if keys:
            raise ValueError("keypath not fully consumed")


def _parse_key_path(path: str) -> List[bytes]:
    """Parse /url-encoded/key/path into keys, last component first
    (reference: crypto/merkle/proof_key_path.go)."""
    from urllib.parse import unquote_to_bytes

    if not path.startswith("/"):
        raise ValueError("key path must start with /")
    parts = [p for p in path.split("/")[1:] if p]
    keys = []
    for part in parts:
        if part.startswith("x:"):
            keys.append(bytes.fromhex(part[2:]))
        else:
            keys.append(unquote_to_bytes(part))
    return keys
