"""The in-process p2p network the reactor tests build.

Counterpart: tendermint_tpu/p2p/p2ptest.py:1-108 (reference:
internal/p2p/p2ptest/network.go): N router and peer manager nodes on
memory transports, fully connected, each node's router and peer manager
sharing a P2PMetrics struct on the node's own Registry.
"""

from __future__ import annotations

import asyncio
from typing import Optional

from ..crypto.ed25519 import PrivKeyEd25519
from ..libs.metrics import Registry
from .metrics import P2PMetrics
from .peermanager import PeerManager, PeerManagerOptions
from .router import Router, RouterOptions
from .transport import MemoryNetwork, MemoryTransport
from .types import ChannelDescriptor, NodeInfo, node_id_from_pubkey

__all__ = ["TestNetwork", "TestNode"]


class TestNode:
    __test__ = False  # not a pytest class

    def __init__(
        self,
        network: MemoryNetwork,
        index: int,
        chain_id: str,
        router_options: Optional[RouterOptions] = None,
    ) -> None:
        self.priv_key = PrivKeyEd25519.from_seed(index.to_bytes(2, "big") * 16)
        self.node_id = node_id_from_pubkey(self.priv_key.pub_key())
        self.addr = f"node{index}:26656"
        self.node_info = NodeInfo(
            node_id=self.node_id,
            listen_addr=self.addr,
            network=chain_id,
            moniker=f"node{index}",
        )
        self.transport = MemoryTransport(network, self.addr)
        self.registry = Registry()
        self.metrics = P2PMetrics(self.registry)
        self.peer_manager = PeerManager(
            self.node_id, PeerManagerOptions(max_connected=64), metrics=self.metrics
        )
        self.router = Router(
            self.node_info,
            self.priv_key,
            self.peer_manager,
            self.transport,
            options=router_options,
            metrics=self.metrics,
        )

    def open_channel(self, descriptor: ChannelDescriptor):
        return self.router.open_channel(descriptor)


class TestNetwork:
    """N fully connected in-memory nodes."""

    __test__ = False  # not a pytest class

    def __init__(
        self,
        n: int,
        chain_id: str = "test-chain",
        router_options: Optional[RouterOptions] = None,
    ) -> None:
        self.memory = MemoryNetwork()
        self.nodes = [
            TestNode(self.memory, i, chain_id, router_options=router_options) for i in range(n)
        ]

    async def start(self) -> None:
        for node in self.nodes:
            await node.router.start()
        # full mesh: every node dials every higher-index node
        for i, a in enumerate(self.nodes):
            for b in self.nodes[i + 1:]:
                a.peer_manager.add(f"{b.node_id}@{b.addr}")
        await self.wait_connected()

    async def wait_connected(self, timeout: float = 10.0) -> None:
        want = len(self.nodes) - 1

        async def all_up():
            while any(len(n.peer_manager.peers()) < want for n in self.nodes):
                await asyncio.sleep(0.01)

        await asyncio.wait_for(all_up(), timeout=timeout)

    async def stop(self) -> None:
        for node in self.nodes:
            await node.router.stop()
