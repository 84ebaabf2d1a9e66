"""Light-block providers.

Counterpart: tendermint_tpu/light/provider.py:1-196 (reference:
light/provider/provider.go, light/provider/http): the Provider
interface, with its default bulk fetch; LocalProvider, which serves
light blocks from a node's block and state stores (any objects with
their load methods); HTTPProvider, which fetches them from a full
node's RPC routes `light_block` and `light_blocks` (paged past the
server's clamp) and reports evidence through `broadcast_evidence`; and
P2PProvider, which fetches them from a peer through a fetch callable
(state sync's light-block channel).
"""

from __future__ import annotations

import asyncio
from abc import ABC, abstractmethod
from typing import Optional

from ..types.light import LightBlock, LightBlocksResponse, SignedHeader
from .errors import LightBlockNotFoundError

__all__ = ["HTTPProvider", "LocalProvider", "P2PProvider", "Provider"]


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


class HTTPProvider(Provider):
    """Fetch light blocks from a full node's RPC `light_block` route
    (reference: light/provider/http)."""

    def __init__(self, addr: str, timeout: float = 10.0) -> None:
        from ..rpc.client import HTTPClient

        self.addr = addr
        self._client = HTTPClient(addr, timeout=timeout)

    def id(self) -> str:
        return self.addr

    async def light_block(self, height: int) -> LightBlock:
        from ..rpc.client import RPCClientError

        try:
            res = await self._client.call("light_block", height=height)
        except RPCClientError as e:
            raise LightBlockNotFoundError(f"{self.addr}: {e}") from e
        return LightBlock.from_proto(bytes.fromhex(res["light_block"]))

    async def light_blocks(self, first: int, last: int) -> list:
        """One `light_blocks` call per served page (the server clamps
        the page; the loop goes on past each clamped page). A page is
        decoded as a LightBlocksResponse and checked height by height:
        a server that skips or reorders heights is treated as having no
        block, like a lying single-height reply."""
        from ..rpc.client import RPCClientError

        out: list = []
        next_h = first
        while next_h <= last:
            try:
                res = await self._client.call(
                    "light_blocks", min_height=next_h, max_height=last
                )
            except RPCClientError as e:
                raise LightBlockNotFoundError(f"{self.addr}: {e}") from e
            page = LightBlocksResponse.from_proto(
                bytes.fromhex(res["light_blocks"])
            ).light_blocks
            if not page:
                raise LightBlockNotFoundError(
                    f"{self.addr}: empty light_blocks page at {next_h}"
                )
            for lb in page:
                if next_h > last:
                    break  # over-full page: ignore the surplus
                if lb.height != next_h:
                    raise LightBlockNotFoundError(
                        f"{self.addr}: light_blocks page out of order: "
                        f"got {lb.height}, want {next_h}"
                    )
                out.append(lb)
                next_h += 1
        return out

    async def report_evidence(self, ev) -> None:
        from ..types.evidence import evidence_to_proto

        try:
            # the Evidence envelope, which the route decodes
            # (evidence_from_proto); the JAX provider sends the bare
            # message, which the JAX route refuses as invalid params
            await self._client.call(
                "broadcast_evidence", evidence=evidence_to_proto(ev).hex()
            )
        except Exception:
            # best effort, as the reference's; no device call runs on
            # this side of the connection
            pass

    async def close(self) -> None:
        await self._client.close()


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
