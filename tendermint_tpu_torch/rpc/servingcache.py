"""Per-block serving cache: encoded light blocks and held tx-proof trees.

Counterpart: tendermint_tpu/rpc/servingcache.py:1-243. The serving
routes pay the same work per request for content that is immutable per
block; this cache keeps it, keyed by height:

- ``encoded_light_block(height)``: the LightBlock proto blob exactly as
  `LightBlock.to_proto()` produces it (the `light_blocks` page wraps
  cached blobs, byte-equal to `LightBlocksResponse.to_proto`);
- ``tx_tree(height)``: a held `MerkleMultiTree` over the block's tx
  hashes (root == `header.data_hash`), serving every `tx_proofs`
  request for the block by aunt gathering.

It stores encodings only and never skips a verification: a light block
served from it is verified by the client like any other.

Safety model:

- **Only canonical heights are cached**: a height enters the cache only
  when `load_block_commit(height)` exists; the tip served from the seen
  commit is assembled afresh every time.
- **No mutation epochs.** The JAX cache flushes itself whenever any
  Commit or Validator of the process is mutated in place
  (`types/commit._MUT_EPOCH`, `types/validator._VAL_MUT_EPOCH`), because
  there a cached encoding could outlive a shared, memoized object. The
  port keeps no commit memo, and its stores decode a fresh object on
  every load (store/block_store.py, state/store.py): the miss path
  encodes objects that no one else holds, and the blob is immutable
  bytes, so nothing can drift from the stored bytes
  (tests/test_torch_rpc.py mutates every loaded object after a fill and
  finds the blob unchanged).
- **Bounded**: one LRU per family, `DEFAULT_CAPACITY` blocks (config
  `RPCConfig.serving_cache_blocks`; 0 disables). The JAX module's kill
  switch (`TM_TPU_NO_SERVCACHE`, `disabled()`, its bench's A/B arm) is
  left out: nothing in the port turns it on, and capacity 0 does the
  same.

The cache is confined to the event loop of the Environment that owns
it; no locking. With an RPCMetrics struct it counts its hits, misses
and evictions (:99-141).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional

from ..crypto.merkle import MerkleMultiTree
from ..types.light import LightBlock, SignedHeader
from ..types.tx import tx_hash

__all__ = ["DEFAULT_CAPACITY", "ServingCache"]

DEFAULT_CAPACITY = 64


class ServingCache:
    """Per-node bounded cache of per-block serving artifacts."""

    def __init__(
        self,
        block_store,
        state_store,
        capacity: int = DEFAULT_CAPACITY,
        metrics=None,  # RPCMetrics or None
    ) -> None:
        self.block_store = block_store
        self.state_store = state_store
        self.capacity = int(capacity)
        self.metrics = metrics
        # height -> LightBlock proto blob / MerkleMultiTree
        self._blobs: "OrderedDict[int, bytes]" = OrderedDict()
        self._trees: "OrderedDict[int, MerkleMultiTree]" = OrderedDict()

    # -- lifecycle --

    def _usable(self) -> bool:
        return self.capacity > 0

    def _count(self, name: str, n: int = 1) -> None:
        if self.metrics is not None:
            getattr(self.metrics, "servingcache_" + name).inc(n)

    def _put(self, lru: OrderedDict, height: int, value) -> None:
        lru[height] = value
        lru.move_to_end(height)
        while len(lru) > self.capacity:
            lru.popitem(last=False)
            self._count("evictions")

    def _get(self, lru: OrderedDict, height: int):
        v = lru.get(height)
        if v is not None:
            lru.move_to_end(height)
            self._count("hits")
        else:
            self._count("misses")
        return v

    # -- light blocks --

    def light_block_at(self, height: int) -> Optional[LightBlock]:
        """Assemble the LightBlock at height from the stores (tip falls
        back to the seen commit), or None when any part is missing.
        Always a fresh assembly — the cached artifact is the BLOB.
        This is the cache's OBJECT surface (callers that need the
        decoded form rather than the wire blob); the routes themselves
        serve blobs via encoded_light_block."""
        meta = self.block_store.load_block_meta(height)
        commit = self.block_store.load_block_commit(height)
        if commit is None and height == self.block_store.height():
            seen = self.block_store.load_seen_commit()
            if seen is not None and seen.height == height:
                commit = seen
        vals = self.state_store.load_validators(height)
        if meta is None or commit is None or vals is None:
            return None
        return LightBlock(
            signed_header=SignedHeader(header=meta.header, commit=commit),
            validator_set=vals,
        )

    def encoded_light_block(self, height: int) -> Optional[bytes]:
        """The `LightBlock.to_proto()` blob for a height, cached for
        canonical (non-tip-fallback) heights. None when the height
        cannot be fully assembled. The miss path assembles for itself:
        whether its first commit load found the canonical commit is the
        cacheability signal, with no second decode."""
        if self._usable():
            blob = self._get(self._blobs, height)
            if blob is not None:
                return blob
        meta = self.block_store.load_block_meta(height)
        commit = self.block_store.load_block_commit(height)
        canonical = commit is not None
        if commit is None and height == self.block_store.height():
            seen = self.block_store.load_seen_commit()
            if seen is not None and seen.height == height:
                commit = seen
        vals = self.state_store.load_validators(height)
        if meta is None or commit is None or vals is None:
            return None
        lb = LightBlock(
            signed_header=SignedHeader(header=meta.header, commit=commit),
            validator_set=vals,
        )
        blob = lb.to_proto()
        if self._usable() and canonical:
            self._put(self._blobs, height, blob)
        return blob

    # -- tx proof trees --

    def tx_tree(self, height: int) -> Optional[MerkleMultiTree]:
        """A held MerkleMultiTree over the block's tx hashes: root ==
        header.data_hash (types/tx.txs_hash computes the identical
        tree), every proof request for the block served by aunt
        gathering. None when the block is not stored."""
        if self._usable():
            tree = self._get(self._trees, height)
            if tree is not None:
                return tree
        block = self.block_store.load_block(height)
        if block is None:
            return None
        tree = MerkleMultiTree.from_byte_slices(
            [tx_hash(tx) for tx in block.txs]
        )
        # cacheability: any height strictly below the tip is immutable
        # (storing block h+1 required h's canonical commit), a check
        # with no decode
        if self._usable() and height < self.block_store.height():
            self._put(self._trees, height, tree)
        return tree
