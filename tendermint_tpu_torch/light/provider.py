"""Light-block providers.

Counterpart: tendermint_tpu/light/provider.py:26-97 and :172-196
(reference: light/provider/provider.go): the Provider interface, with
its default bulk fetch; LocalProvider, which serves light blocks from a
node's block and state stores (any objects with their load methods); and
P2PProvider, which fetches them from a peer through a fetch callable
(state sync's light-block channel). HTTPProvider is not ported: it needs
the RPC layer, which the port does not have yet.
"""

from __future__ import annotations

import asyncio
from abc import ABC, abstractmethod
from typing import Optional

from ..types.light import LightBlock, SignedHeader
from .errors import LightBlockNotFoundError

__all__ = ["LocalProvider", "P2PProvider", "Provider"]


class Provider(ABC):
    @abstractmethod
    def id(self) -> str: ...

    @abstractmethod
    async def light_block(self, height: int) -> LightBlock:
        """The light block at height (0: the latest). Raises
        LightBlockNotFoundError when the provider has none."""

    async def light_blocks(self, first: int, last: int) -> list:
        """The light blocks of heights first..last, ascending: by default
        concurrent light_block fetches, the first failure raised."""
        # return_exceptions, so one failed height leaves no other fetch
        # orphaned
        results = await asyncio.gather(
            *(self.light_block(h) for h in range(first, last + 1)),
            return_exceptions=True,
        )
        for r in results:
            if isinstance(r, BaseException):
                raise r
        return list(results)

    @abstractmethod
    async def report_evidence(self, ev) -> None: ...


class LocalProvider(Provider):
    """Light blocks straight from a node's stores: `block_store` with
    height(), load_block_meta(h), load_block_commit(h) and
    load_seen_commit(); `state_store` with load_validators(h)."""

    def __init__(self, block_store, state_store, id_: str = "local") -> None:
        self.block_store = block_store
        self.state_store = state_store
        self._id = id_
        self.reported_evidence: list = []

    def id(self) -> str:
        return self._id

    async def light_block(self, height: int) -> LightBlock:
        if height == 0:
            height = self.block_store.height()
        meta = self.block_store.load_block_meta(height)
        commit = self.block_store.load_block_commit(height)
        if commit is None and height == self.block_store.height():
            # the tip: its +2/3 commit comes with the next block, so
            # serve the commit seen locally until then
            seen = self.block_store.load_seen_commit()
            if seen is not None and seen.height == height:
                commit = seen
        vals = self.state_store.load_validators(height)
        if meta is None or commit is None or vals is None:
            raise LightBlockNotFoundError(f"no light block at {height}")
        return LightBlock(
            signed_header=SignedHeader(header=meta.header, commit=commit),
            validator_set=vals,
        )

    async def report_evidence(self, ev) -> None:
        self.reported_evidence.append(ev)


class P2PProvider(Provider):
    """Fetch light blocks from a peer via an async fetch callable
    (statesync reactor's light-block channel machinery)."""

    def __init__(self, peer_id: str, fetch, report=None) -> None:
        """`fetch(height, peer_id) -> Optional[LightBlock]`;
        `report(ev)` forwards evidence to the evidence reactor."""
        self.peer_id = peer_id
        self._fetch = fetch
        self._report = report

    def id(self) -> str:
        return self.peer_id

    async def light_block(self, height: int) -> LightBlock:
        lb: Optional[LightBlock] = await self._fetch(height, self.peer_id)
        if lb is None:
            raise LightBlockNotFoundError(
                f"peer {self.peer_id[:12]} has no light block at {height}"
            )
        return lb

    async def report_evidence(self, ev) -> None:
        if self._report is not None:
            await self._report(ev)
