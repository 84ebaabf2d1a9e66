"""Device merkle: tree roots through kernel X4, proof batches through X5.

Counterpart: tendermint_tpu/ops/merkle_kernel.py. Two offloads
(reference shapes: crypto/merkle/tree.go:68 HashFromByteSlices,
proof.go:52 Proof.Verify):

- tree_root(leaf_hashes): the n - 1 inner hashes of an RFC 6962 tree in
  level order: adjacent pairs hashed, an odd trailing node carried up
  unchanged, which reproduces the reference's split at the largest power
  of two. One upload, one launch of X4's tree kernel (csrc/sha256.cu
  says why its aligned subtrees give the same root), one 32-byte
  download. Levels are not padded to powers of two: the JAX `_bucket`
  (:52) only bounded XLA's compiled shapes.
- verify_proofs(proofs, root_hash): K inclusion proofs in one launch of
  X5. The host packs them (pack_proofs) into one flat buffer: leaf
  hashes, the root, the structural checks, one word of side bits a
  proof, K + 1 aunt offsets and the aunts themselves, ragged; one
  host-to-device copy, and the (K,) bitmap back. The side bits come from
  the level-order walk of every proof at once in numpy, the iterative
  twin of `_sides_for` (:104), not from a recursion a proof.

`verify_program_plain` is the plain version of X5 on the same inputs: the
JAX `_verify_program` (:125) scan over depth, each lane absorbing its aunt
on the left or the right, or neither past its depth. install() puts both
behind the port's crypto/merkle.py hooks with the JAX size gates
(:208-242). A kernel that fails to build or launch raises out of the
hooks; nothing is answered by the host path then.
"""

from __future__ import annotations

from dataclasses import dataclass
from itertools import chain
from typing import List, Optional, Sequence

import numpy as np
import torch

from .build import check_launch, kernels, ptr, stream_of
from .sha256_kernel import INNER_PREFIX, sha256_rows_plain, sha256_tree

__all__ = [
    "LAUNCHES",
    "ProofBatch",
    "install",
    "installed",
    "merkle_proofs",
    "pack_proofs",
    "reset_launches",
    "sides_batch",
    "stats",
    "tree_root",
    "uninstall",
    "verify_program_plain",
    "verify_proofs",
]

# launches of kernel X5, by this module's wrapper only (X4's are counted
# in sha256_kernel.LAUNCHES, the tree form's as "sha256_tree")
LAUNCHES = {"merkle_proofs": 0}

# proof-step flags of the recursive form (the JAX package's)
_STEP_LEFT = 0  # our hash is the left child:  h = inner(h, aunt)
_STEP_RIGHT = 1  # our hash is the right child: h = inner(aunt, h)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "merkle_kernel: CUDA is not available "
            "(pass device='cpu' for the plain version)"
        )
    return dev


def tree_root(leaf_hashes: Sequence[bytes], device="cuda") -> bytes:
    """Root from already-hashed leaves (32 bytes each): one launch of
    X4's tree kernel on `device` (the plain version on the CPU). No launch
    for one leaf."""
    n = len(leaf_hashes)
    if n == 0:
        raise ValueError("tree_root requires at least one leaf hash")
    dev = _device(device)
    flat = b"".join(leaf_hashes)
    if len(flat) != 32 * n:
        raise ValueError("tree_root: every leaf hash must be 32 bytes")
    if n == 1:
        return flat
    leaves = torch.frombuffer(bytearray(flat), dtype=torch.uint8)
    root = sha256_tree(leaves.view(n, 32).to(dev))
    return root.cpu().numpy().tobytes()


def _sides_for(index: int, total: int) -> List[int]:
    """Bottom-up left/right flags matching Proof.aunts order (reference
    recursion: crypto/merkle/proof.go:71 computeHashFromAunts)."""
    out: List[int] = []

    def rec(idx: int, tot: int) -> None:
        if tot == 1:
            return
        k = 1 << ((tot - 1).bit_length() - 1)
        if idx < k:
            rec(idx, k)
            out.append(_STEP_LEFT)
        else:
            rec(idx - k, tot - k)
            out.append(_STEP_RIGHT)

    rec(index, total)
    return out


def sides_batch(index: np.ndarray, total: np.ndarray):
    """(depth, sides) of K proofs with 0 <= index < total, in one
    level-order walk: at each level a node whose sibling exists consumes
    one aunt, on the left when the node is a right child (bit d of sides
    set for aunt d, as _sides_for's _STEP_RIGHT); an odd trailing node is
    carried up and consumes none. depth (K,) int64, sides (K,) int64
    holding 64 bits."""
    pos = np.asarray(index, dtype=np.int64).copy()
    cnt = np.asarray(total, dtype=np.int64).copy()
    depth = np.zeros(pos.shape, dtype=np.int64)
    sides = np.zeros(pos.shape, dtype=np.uint64)
    live = cnt > 1
    while live.any():
        has = live & ((pos ^ 1) < cnt)
        bit = ((pos & 1) == 1) & has
        sides |= bit.astype(np.uint64) << depth.astype(np.uint64)
        depth += has
        pos >>= 1
        cnt = np.where(live, (cnt + 1) >> 1, cnt)
        live = cnt > 1
    return depth, sides.view(np.int64)


def _round16(n: int) -> int:
    return (n + 15) & ~15


@dataclass
class ProofBatch:
    """K proofs packed for X5 in one host buffer: `buf` uint8 and the
    byte offset of each part (leaf (K, 32), want (32,), sides (K,) int64,
    off (K + 1,) int32, ok_in (K,) uint8, aunts (A, 32)), 16-byte
    aligned; `ok` the host's structural checks."""

    buf: np.ndarray
    k: int
    n_aunts: int
    at: dict
    ok: np.ndarray

    def to(self, device):
        """The parts as tensors on `device`, after one host-to-device
        copy: (leaf, aunts, off, sides, want, ok_in)."""
        dev = torch.from_numpy(self.buf).to(device)
        k, a, at = self.k, self.n_aunts, self.at

        def part(name, nbytes):
            return dev[at[name] : at[name] + nbytes]

        return (
            part("leaf", 32 * k).view(k, 32),
            part("aunts", 32 * a).view(a, 32),
            part("off", 4 * (k + 1)).view(torch.int32),
            part("sides", 8 * k).view(torch.int64),
            part("want", 32),
            part("ok_in", k),
        )


def _int64s(values, k: int) -> np.ndarray:
    """Python ints as int64, any outside its range as -1 (invalid as an
    index or total)."""
    try:
        return np.fromiter(values, dtype=np.int64, count=k)
    except OverflowError:
        lo, hi = -(1 << 63), (1 << 63) - 1
        return np.fromiter(
            (v if lo <= v <= hi else -1 for v in values),
            dtype=np.int64,
            count=k,
        )


def pack_proofs(proofs: Sequence, root_hash: bytes) -> ProofBatch:
    """The host side of a proof batch: the structural checks of the JAX
    verify_proofs (index < 0, total <= 0, index >= total, a leaf hash or
    an aunt not 32 bytes, an aunt count other than the depth: the proof is
    False, never raised), and one buffer for X5. A failed proof keeps no
    aunts and a zero leaf, so its root is 32 zero bytes."""
    k = len(proofs)
    idx = _int64s([p.index for p in proofs], k)
    tot = _int64s([p.total for p in proofs], k)
    leaf_len = np.fromiter((len(p.leaf_hash) for p in proofs), np.int64, k)
    n_aunts = np.fromiter((len(p.aunts) for p in proofs), np.int64, k)
    aunt_list = list(chain.from_iterable(p.aunts for p in proofs))
    ok = (idx >= 0) & (tot > 0) & (idx < tot) & (leaf_len == 32)
    if set(map(len, aunt_list)) - {32}:  # the per-aunt pass only then
        aunt_bad = np.fromiter(
            (len(a) != 32 for a in aunt_list), bool, len(aunt_list)
        )
        first = np.concatenate([[0], np.cumsum(n_aunts)[:-1]])
        bad = np.logical_or.reduceat(
            np.append(aunt_bad, False), np.minimum(first, len(aunt_list))
        )
        ok &= ~(bad & (n_aunts > 0))
    depth, sides = sides_batch(np.where(ok, idx, 0), np.where(ok, tot, 1))
    ok &= depth == n_aunts
    kept = np.where(ok, n_aunts, 0)
    if ok.all():
        leaves = b"".join(p.leaf_hash for p in proofs)
        aunts = b"".join(aunt_list)
    else:
        leaves = b"".join(
            p.leaf_hash if g else bytes(32) for p, g in zip(proofs, ok)
        )
        aunts = b"".join(
            chain.from_iterable(p.aunts for p, g in zip(proofs, ok) if g)
        )
    a = int(kept.sum())
    at = {}
    size = 0
    for name, nbytes in (
        ("leaf", 32 * k),
        ("want", 32),
        ("sides", 8 * k),
        ("off", 4 * (k + 1)),
        ("ok_in", k),
        ("aunts", 32 * a),
    ):
        at[name] = size
        size += _round16(nbytes)
    buf = np.zeros(max(size, 16), dtype=np.uint8)
    buf[at["leaf"] : at["leaf"] + 32 * k] = np.frombuffer(leaves, np.uint8)
    if len(root_hash) == 32:
        buf[at["want"] : at["want"] + 32] = np.frombuffer(root_hash, np.uint8)
    else:  # a root of another size matches no proof
        ok = np.zeros(k, dtype=bool)
    buf[at["sides"] : at["sides"] + 8 * k] = np.where(ok, sides, 0).view(
        np.uint8
    )
    off = np.zeros(k + 1, dtype=np.int32)
    np.cumsum(kept, out=off[1:])
    buf[at["off"] : at["off"] + 4 * (k + 1)] = off.view(np.uint8)
    buf[at["ok_in"] : at["ok_in"] + k] = ok
    buf[at["aunts"] : at["aunts"] + 32 * a] = np.frombuffer(aunts, np.uint8)
    return ProofBatch(buf=buf, k=k, n_aunts=a, at=at, ok=ok)


def verify_program_plain(leaf, aunts, off, sides, want, ok_in):
    """Plain version of kernel X5, arguments as merkle_proofs': the JAX
    `_verify_program` scan over the depth, each lane absorbing its aunt
    on the side its bit names, past its own depth a no-op. Returns the
    roots (K, 32) uint8 and the (K,) bool bitmap ok_in & (root == want)."""
    start = off[:-1].to(torch.int64)
    depth = off[1:].to(torch.int64) - start
    h = leaf.clone()
    dmax = int(depth.max()) if leaf.shape[0] else 0
    for d in range(dmax):
        active = depth > d
        a = aunts[torch.where(active, start + d, 0)]
        left = ((sides >> d) & 1).bool()[:, None]
        rows = torch.cat(
            [torch.where(left, a, h), torch.where(left, h, a)], dim=1
        )
        h = torch.where(active[:, None], sha256_rows_plain(rows, INNER_PREFIX), h)
    return h, ok_in.bool() & (h == want[None, :]).all(dim=1)


def merkle_proofs(leaf, aunts, off, sides, want, ok_in):
    """K proofs against one root: leaf (K, 32) uint8, aunts (A, 32) uint8,
    off (K + 1,) int32 (proof k's aunts are rows off[k]..off[k + 1]),
    sides (K,) int64 (bit d set: aunt d on the left), want (32,) uint8,
    ok_in (K,) uint8 host checks -> (roots (K, 32) uint8, ok (K,) bool).
    A CPU tensor runs the plain version; a CUDA tensor launches kernel X5
    on the current stream or raises."""
    dev = leaf.device
    if dev.type == "cpu":
        return verify_program_plain(leaf, aunts, off, sides, want, ok_in)
    if dev.type != "cuda":
        raise ValueError(f"merkle_proofs: unsupported device {dev}")
    k = leaf.shape[0]
    for name, t, shape, dtype in (
        ("leaf", leaf, (k, 32), torch.uint8),
        ("aunts", aunts, (aunts.shape[0], 32), torch.uint8),
        ("off", off, (k + 1,), torch.int32),
        ("sides", sides, (k,), torch.int64),
        ("want", want, (32,), torch.uint8),
        ("ok_in", ok_in, (k,), torch.uint8),
    ):
        if t.device != dev or t.dtype != dtype:
            raise ValueError(f"merkle_proofs: {name} must be {dtype} on {dev}")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"merkle_proofs: {name} must be contiguous {shape}")
        align = 16 if name == "aunts" else 8  # X5 reads aunts 16 bytes a load
        if t.numel() and t.data_ptr() % align:
            raise ValueError(
                f"merkle_proofs: {name} must be {align}-byte aligned"
            )
    roots = torch.empty((k, 32), dtype=torch.uint8, device=dev)
    ok = torch.empty((k,), dtype=torch.bool, device=dev)
    lib = kernels()["merkle_proofs"]
    rc = lib.tm_merkle_proofs(
        ptr(leaf), ptr(aunts), ptr(off), ptr(sides), ptr(want), ptr(ok_in),
        ptr(roots), ptr(ok), k, dev.index, stream_of(dev),
    )
    check_launch(rc, lib, "merkle_proofs")
    LAUNCHES["merkle_proofs"] += 1
    return roots, ok


def verify_proofs(proofs: Sequence, root_hash: bytes, device="cuda"):
    """Batch-verify K inclusion proofs against one root on `device` (the
    plain version on the CPU): a (K,) bool numpy bitmap; structurally
    invalid proofs are False, not raised (BatchVerifier semantics,
    crypto/crypto.go:56-60). One launch of X5 unless no proof passes the
    host checks."""
    dev = _device(device)
    if not proofs:
        return np.zeros(0, dtype=bool)
    batch = pack_proofs(proofs, root_hash)
    if not batch.ok.any():
        return batch.ok
    _roots, ok = merkle_proofs(*batch.to(dev))
    return ok.cpu().numpy()


# -- crypto.merkle device hook ---------------------------------------------

_installed: Optional[int] = None
_stats = {"roots": 0, "leaves": 0, "proofs": 0}


def installed() -> Optional[int]:
    """The installed min_leaves, or None when not installed."""
    return _installed


def stats() -> dict:
    """Roots and their leaves, and proofs, sent to the device since the
    process started."""
    return dict(_stats)


def install(device="cuda", min_leaves: int = 512) -> None:
    """Route merkle roots of at least min_leaves leaves, and proof
    batches of at least max(min_leaves // 8, 2) proofs, through kernels
    X4 and X5 on `device` (CUDA by default; raises when there is none):
    the hooks crypto/merkle.py consults, as the JAX install does."""
    global _installed
    from ..crypto import merkle as cm

    dev = _device(device)
    _installed = min_leaves

    def _root_hook(leaf_hashes: List[bytes]) -> Optional[bytes]:
        if len(leaf_hashes) < min_leaves:
            return None
        _stats["roots"] += 1
        _stats["leaves"] += len(leaf_hashes)
        return tree_root(leaf_hashes, dev)

    def _proofs_hook(proofs, root_hash: bytes):
        if len(proofs) < max(min_leaves // 8, 2):
            return None
        _stats["proofs"] += len(proofs)
        return verify_proofs(proofs, root_hash, dev)

    cm._device_root_hook = _root_hook
    cm._device_proofs_hook = _proofs_hook


def uninstall() -> None:
    global _installed
    from ..crypto import merkle as cm

    _installed = None
    cm._device_root_hook = None
    cm._device_proofs_hook = None
