"""PeerManager: the peer lifecycle state machine and address book.

Counterpart: tendermint_tpu/p2p/peermanager.py: the peer store, scoring,
dial order, backoff (:67), crossover rejection (:312) and PeerUpdates;
reference: internal/p2p/peermanager.go (design comment :63-119, state
transitions :386-778, Subscribe :828, Advertise :793). With a
P2PMetrics struct it observes each failed dial's backoff in
dial_backoff_seconds (:113-118, :263-264). The manager owns
which peers to dial, what to do on failure (exponential backoff), when to
evict, and who gets the connection slots (persistent peers always win).

States (implicit, like the reference):
  candidate → dialing → connected → ready → evicting → disconnected
"""

from __future__ import annotations

import asyncio
import json
import logging
import random
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from ..config import P2PConfig
from .types import NodeID, parse_node_address

__all__ = [
    "PeerManager",
    "PeerManagerOptions",
    "PeerUpdate",
    "PeerStatus",
    "peer_manager_options",
    "AlreadyConnectedError",
    "CrossoverRejectError",
]


class AlreadyConnectedError(ValueError):
    """The peer already holds a live connection slot."""


class CrossoverRejectError(ValueError):
    """Inbound rejected: our own outbound dial to this peer is the
    canonical connection (we have the lower node ID)."""


class PeerStatus:
    UP = "up"
    DOWN = "down"


@dataclass
class PeerUpdate:
    node_id: NodeID
    status: str


@dataclass
class PeerManagerOptions:
    """reference: peermanager.go:121-175."""

    persistent_peers: List[str] = field(default_factory=list)
    max_connected: int = 16
    max_connected_upgrade: int = 4
    max_peers: int = 1000
    min_retry_time: float = 0.25
    max_retry_time: float = 600.0
    max_retry_time_persistent: float = 20.0


def peer_manager_options(cfg: P2PConfig) -> PeerManagerOptions:
    """The peer manager's options from the p2p config, as node start
    builds them (tendermint_tpu/node/node.py:282-298)."""
    return PeerManagerOptions(
        persistent_peers=[p.strip() for p in cfg.persistent_peers.split(",") if p.strip()],
        max_connected=cfg.max_connections,
        min_retry_time=cfg.min_retry_time,
        max_retry_time=cfg.max_retry_time,
        max_retry_time_persistent=cfg.max_retry_time_persistent,
    )


def backoff_delay(
    attempts: int, opts: PeerManagerOptions, persistent: bool, rng=random
) -> float:
    """Jittered capped exponential dial backoff: base · 2^(n−1) capped,
    then full jitter over [d/2, d], so that concurrent boots (every
    localnet node dialing every other) decorrelate instead of retrying
    in lockstep. Computed once per failure (stored as retry_at), so the
    schedule a failure message names is the schedule that ran."""
    if attempts <= 0:
        return 0.0
    cap = (
        opts.max_retry_time_persistent if persistent else opts.max_retry_time
    )
    delay = min(opts.min_retry_time * (2 ** min(attempts - 1, 16)), cap)
    return delay * (0.5 + 0.5 * rng.random())


@dataclass
class _Peer:
    node_id: NodeID
    addresses: Set[Tuple[str, int]] = field(default_factory=set)
    persistent: bool = False
    dial_attempts: int = 0
    last_dial_failure: float = 0.0
    retry_at: float = 0.0  # next dial not before this instant
    retry_delay_s: float = 0.0  # the delay behind retry_at (metrics)
    banned_until: float = 0.0  # shed/misbehaving peers sit out a window
    dialing: bool = False
    connected: bool = False
    ready: bool = False
    inbound: bool = False
    evicting: bool = False
    evict_reason: str = ""
    score: int = 0
    connected_at: float = 0.0


class PeerManager:
    def __init__(
        self,
        self_id: NodeID,
        options: Optional[PeerManagerOptions] = None,
        store=None,  # optional KVStore for address-book persistence
        metrics=None,  # optional P2PMetrics (dial-backoff histogram)
        clock=time.monotonic,  # injectable for backoff-schedule tests
    ) -> None:
        self.self_id = self_id
        self.opts = options or PeerManagerOptions()
        self.metrics = metrics
        self._clock = clock
        self.logger = logging.getLogger(__name__)
        self._peers: Dict[NodeID, _Peer] = {}
        self._subscribers: List[asyncio.Queue] = []
        self._evict_queue: asyncio.Queue[NodeID] = asyncio.Queue()
        self._wakeup = asyncio.Event()  # new candidates / freed slots
        self._store = store
        self._last_persist = 0.0
        self._dirty = False
        if store is not None:
            self._load()
        for addr in self.opts.persistent_peers:
            if addr:
                self.add(addr, persistent=True)

    # -- address book --

    def add(self, address: str, persistent: bool = False) -> bool:
        """Add a peer address; returns True if new
        (reference: peermanager.go:386-420)."""
        node_id, host, port = parse_node_address(address)
        if not node_id:
            raise ValueError(f"address {address!r} has no node ID")
        if node_id == self.self_id:
            return False
        peer = self._peers.get(node_id)
        if peer is None:
            if len(self._peers) >= self.opts.max_peers:
                return False
            peer = _Peer(node_id=node_id)
            self._peers[node_id] = peer
        new = (host, port) not in peer.addresses
        peer.addresses.add((host, port))
        peer.persistent = peer.persistent or persistent
        if new:
            self._persist()
            self._wakeup.set()
        return new

    def advertise(self, limit: int = 100) -> List[str]:
        """Addresses to share via PEX (reference: peermanager.go:793-826)."""
        out = []
        for peer in self._peers.values():
            for host, port in peer.addresses:
                out.append(f"{peer.node_id}@{host}:{port}")
        random.shuffle(out)
        return out[:limit]

    def peers(self) -> List[NodeID]:
        return [p.node_id for p in self._peers.values() if p.ready]

    def connection_inbound(self, node_id: NodeID) -> Optional[bool]:
        """Direction of the peer's live connection (None if not
        connected) — the router's crossover replacement guard."""
        peer = self._peers.get(node_id)
        if peer is None or not peer.connected:
            return None
        return peer.inbound

    def connected_peers(self) -> List[Tuple[NodeID, str]]:
        """(node_id, first known address) for every ready peer —
        the net_info RPC surface (reference: net.go:16-44)."""
        out = []
        for p in self._peers.values():
            if p.ready:
                addr = ""
                if p.addresses:
                    host, port = sorted(p.addresses)[0]
                    addr = f"{host}:{port}"
                out.append((p.node_id, addr))
        return out

    def num_connected(self) -> int:
        # a dialing peer holds a slot too, or we would over-dial
        return sum(
            1 for p in self._peers.values() if p.connected or p.dialing
        )

    # -- dialing --

    async def dial_next(self) -> Tuple[NodeID, str, int]:
        """Block until a peer should be dialed; marks it dialing
        (reference: peermanager.go DialNext/TryDialNext)."""
        while True:
            candidate = self._next_dial_candidate()
            if candidate is not None:
                peer, (host, port) = candidate
                peer.dialing = True  # reserve the slot
                peer.dial_attempts += 1
                return peer.node_id, host, port
            self._wakeup.clear()
            # wake on new peers, or poll for expired backoffs
            try:
                await asyncio.wait_for(self._wakeup.wait(), timeout=0.5)
            except asyncio.TimeoutError:
                pass

    def _next_dial_candidate(self) -> Optional[Tuple[_Peer, Tuple[str, int]]]:
        if self.num_connected() >= self.opts.max_connected:
            return None
        now = self._clock()
        best: Optional[_Peer] = None
        for peer in self._peers.values():
            if peer.connected or peer.dialing or not peer.addresses:
                continue
            if now < peer.retry_at or now < peer.banned_until:
                continue
            if best is None or (
                peer.persistent, peer.score, -peer.dial_attempts
            ) > (best.persistent, best.score, -best.dial_attempts):
                best = peer
        if best is None:
            return None
        # rotate through known addresses across retries so one stale
        # address can't shadow a live one
        addrs = sorted(best.addresses)
        return best, addrs[best.dial_attempts % len(addrs)]

    def dial_abandoned(self, node_id: NodeID) -> None:
        """Clear a dial reservation without the failure penalty — the
        dial was made redundant (e.g. a crossover resolved onto the
        peer's connection), not refused. No score dock, no backoff."""
        peer = self._peers.get(node_id)
        if peer is None:
            return
        peer.dialing = False
        self._wakeup.set()

    def dial_failed(self, node_id: NodeID) -> None:
        """reference: peermanager.go:499-530. Only clears the dialing
        reservation — a live inbound connection accepted during the dial
        (crossover) must keep its connected state. Schedules the next
        retry on the jittered capped exponential schedule (computed
        once, here, so the recorded delay is the one that runs)."""
        peer = self._peers.get(node_id)
        if peer is None:
            return
        peer.dialing = False
        peer.last_dial_failure = self._clock()
        peer.retry_delay_s = backoff_delay(
            peer.dial_attempts, self.opts, peer.persistent
        )
        peer.retry_at = peer.last_dial_failure + peer.retry_delay_s
        peer.score = max(peer.score - 1, -100)
        if self.metrics is not None:
            self.metrics.dial_backoff.observe(peer.retry_delay_s)
        self._wakeup.set()

    def dialed(self, node_id: NodeID) -> None:
        """Outbound connection established. Raises if the peer is
        already connected — a dial/accept crossover must keep the
        existing connection, not silently double-register
        (reference: peermanager.go:569 'peer is already connected')."""
        peer = self._peers.get(node_id)
        if peer is None:
            raise ValueError(f"dialed unknown peer {node_id}")
        if peer.connected:
            raise AlreadyConnectedError(
                f"peer {node_id} is already connected"
            )
        peer.dialing = False
        peer.dial_attempts = 0
        peer.retry_at = 0.0
        peer.connected = True
        peer.inbound = False

    def accepted(self, node_id: NodeID) -> None:
        """Inbound connection; may exceed capacity → schedule eviction of
        someone (reference: peermanager.go:585-640)."""
        if node_id == self.self_id:
            raise ValueError("rejecting connection from self")
        peer = self._peers.get(node_id)
        if peer is None:
            peer = _Peer(node_id=node_id)
            self._peers[node_id] = peer
        if self._clock() < peer.banned_until:
            # a shed peer sits out its ban window on BOTH paths: we
            # neither dial it nor let it immediately reconnect inbound
            raise ValueError(f"peer {node_id} is banned")
        if peer.connected:
            raise AlreadyConnectedError(
                f"peer {node_id} is already connected"
            )
        if peer.dialing and self.self_id < node_id:
            # Simultaneous dial (crossover): without a deterministic
            # winner both sides accept the other's inbound, both
            # dialed() calls raise, both connections close, and the
            # pair livelocks retrying. The canonical connection is the
            # one dialed BY the lower node ID: the lower side rejects
            # the inbound here and keeps its outbound; the higher side
            # replaces its outbound when the canonical inbound arrives
            # (router handles the replacement; reference concern:
            # peermanager.go:569,636 crossover).
            raise CrossoverRejectError(
                f"dial/accept crossover with {node_id}: "
                "lower node ID keeps its outbound dial"
            )
        # capacity check BEFORE reserving the slot, or a rejected inbound
        # peer would leak a phantom connected=True entry forever. This
        # peer's own dialing reservation (crossover) already occupies a
        # slot, so it must not count twice.
        occupied = self.num_connected() - (1 if peer.dialing else 0)
        if (
            occupied + 1
            > self.opts.max_connected + self.opts.max_connected_upgrade
        ):
            raise ValueError("already connected to maximum number of peers")
        peer.connected = True
        peer.inbound = True
        # a live inbound proves the peer is up: future dials (e.g.
        # after this connection drops) start from a fresh schedule
        # instead of inheriting backoff accrued while it was down
        peer.dial_attempts = 0
        peer.retry_at = 0.0
        if self.num_connected() > self.opts.max_connected:
            self._schedule_eviction()

    def ready(self, node_id: NodeID) -> None:
        """Peer handshaked and routed; notify subscribers
        (reference: peermanager.go:642-676)."""
        peer = self._peers.get(node_id)
        if peer is None or not peer.connected:
            return
        peer.ready = True
        peer.connected_at = self._clock()
        self._notify(PeerUpdate(node_id=node_id, status=PeerStatus.UP))

    def disconnected(self, node_id: NodeID) -> None:
        """reference: peermanager.go:696-736."""
        peer = self._peers.get(node_id)
        if peer is None:
            return
        was_ready = peer.ready
        was_evicting = peer.evicting
        # standing reflects SUSTAINED good service, not connection
        # events: +1 only after >=10 min of clean uptime (misbehavior
        # docks -10 via errored()). A reconnect-churning peer gains
        # nothing, so it can't farm eviction resistance or dial priority
        # (reference: peermanager.go scoring intent,
        # peermanager_scoring_test.go)
        if (
            was_ready
            and not was_evicting
            and peer.connected_at
            and self._clock() - peer.connected_at >= 600.0
        ):
            peer.score = min(peer.score + 1, 100)
        peer.connected_at = 0.0
        peer.connected = False
        peer.ready = False
        peer.evicting = False
        peer.evict_reason = ""
        if was_evicting:
            # evicted for misbehavior: apply dial backoff so we don't
            # immediately re-establish the same bad peer
            peer.dial_attempts += 1
            peer.last_dial_failure = self._clock()
            peer.retry_delay_s = backoff_delay(
                peer.dial_attempts, self.opts, peer.persistent
            )
            peer.retry_at = peer.last_dial_failure + peer.retry_delay_s
        if was_ready:
            self._notify(PeerUpdate(node_id=node_id, status=PeerStatus.DOWN))
        self._wakeup.set()

    def errored(self, node_id: NodeID, err: str) -> None:
        """Reactor-reported misbehavior → evict
        (reference: peermanager.go:678-694)."""
        peer = self._peers.get(node_id)
        if peer is None or not peer.connected or peer.evicting:
            return
        self.logger.info("evicting peer %s: %s", node_id, err)
        peer.evicting = True
        peer.evict_reason = "misbehavior"
        peer.score -= 10
        self._evict_queue.put_nowait(node_id)

    def shed_slow(self, node_id: NodeID, ban_s: float = 30.0) -> None:
        """The router detected a slow consumer (its send queues shed
        past the threshold): evict with reason `slow_peer` and sit the
        peer out for `ban_s` — an immediate redial/reconnect would
        rebuild the exact queue that just overflowed."""
        peer = self._peers.get(node_id)
        if peer is None or not peer.connected or peer.evicting:
            return
        self.logger.info("shedding slow peer %s for %s s", node_id, ban_s)
        peer.evicting = True
        peer.evict_reason = "slow_peer"
        peer.score = max(peer.score - 2, -100)
        peer.banned_until = self._clock() + max(ban_s, 0.0)
        self._evict_queue.put_nowait(node_id)

    def ban(self, node_id: NodeID, duration_s: float) -> None:
        """Refuse to dial or accept this peer for `duration_s`."""
        peer = self._peers.get(node_id)
        if peer is None:
            return
        peer.banned_until = self._clock() + max(duration_s, 0.0)

    def evict_reason(self, node_id: NodeID) -> str:
        """Why the peer is being evicted ("" when not evicting) — the
        router stamps this on the disconnect metric and the goodbye
        frame so BOTH sides can attribute the drop."""
        peer = self._peers.get(node_id)
        return peer.evict_reason if peer is not None else ""

    async def evict_next(self) -> NodeID:
        """Next peer the router should disconnect
        (reference: peermanager.go EvictNext)."""
        return await self._evict_queue.get()

    def _schedule_eviction(self) -> None:
        """Pick the lowest-value connected peer to make room."""
        victims = [
            p for p in self._peers.values()
            if p.connected and not p.persistent and not p.evicting
        ]
        if not victims:
            return
        victim = min(victims, key=lambda p: p.score)
        victim.evicting = True
        victim.evict_reason = "capacity"
        self._evict_queue.put_nowait(victim.node_id)

    # -- subscriptions --

    def subscribe(self) -> asyncio.Queue:
        """Peer up/down feed, seeded with peers that are ALREADY up so a
        late subscriber (e.g. a reactor started after connections formed)
        doesn't miss them (reference: peermanager.go:828-870)."""
        q: asyncio.Queue = asyncio.Queue(maxsize=256)
        for p in self._peers.values():
            if p.ready:
                q.put_nowait(
                    PeerUpdate(node_id=p.node_id, status=PeerStatus.UP)
                )
        self._subscribers.append(q)
        return q

    def _notify(self, update: PeerUpdate) -> None:
        for q in self._subscribers:
            try:
                q.put_nowait(update)
            except asyncio.QueueFull:
                self.logger.error(
                    "peer update subscriber overflowed; dropping update"
                )

    # -- persistence (address book) --

    def _persist(self) -> None:
        """Debounced: serializing the full book per PEX address would be
        O(n²) during sync. flush() forces the write (router shutdown)."""
        if self._store is None:
            return
        if time.monotonic() - self._last_persist < 1.0:
            self._dirty = True
            return
        self._write_book()

    def flush(self) -> None:
        if self._store is not None and self._dirty:
            self._write_book()

    def _write_book(self) -> None:
        doc = {
            p.node_id: {
                "addresses": sorted(f"{h}:{pt}" for h, pt in p.addresses),
                "persistent": p.persistent,
                "score": p.score,
            }
            for p in self._peers.values()
        }
        self._store.set(b"peermanager/addressbook", json.dumps(doc).encode())
        self._last_persist = time.monotonic()
        self._dirty = False

    def _load(self) -> None:
        raw = self._store.get(b"peermanager/addressbook")
        if not raw:
            return
        doc = json.loads(raw.decode())
        for node_id, info in doc.items():
            peer = _Peer(node_id=node_id)
            for addr in info.get("addresses", []):
                host, _, port = addr.rpartition(":")
                peer.addresses.add((host, int(port)))
            peer.persistent = info.get("persistent", False)
            peer.score = info.get("score", 0)
            self._peers[node_id] = peer
