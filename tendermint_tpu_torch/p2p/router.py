"""Router: the p2p message hub.

Counterpart: tendermint_tpu/p2p/router.py: RouterOptions (:67), the rate
limiter (:113), the per-peer send queues (:135) and slow-peer shedding
(:863), keepalive (:634), dialing and accepting (:319-503), the per-peer
routines and the net fault points (:359, :435, :546-575); reference:
internal/p2p/router.go (design comment :108-152). Reactors open
typed channels; the router dials/accepts peers via the transport, runs one
send and one receive task per peer, demuxes inbound messages by channel ID
into reactor queues, and routes outbound envelopes (unicast or broadcast)
onto per-peer queues. PeerManager decides who to dial and who to evict.

The per-peer send path carries the reference MConnection's features
(conn/connection.go): per-channel queues drained by priority (votes
preempt block parts), token-bucket send/recv rate limiting
(:45-46 default rates), and ping/pong keepalive with an any-traffic
liveness deadline. They live here at the router layer rather than
inside a TCP framing class so every transport (memory included) gets
identical semantics — one scheduler, not one per transport.

The router takes no metrics (P2PMetrics waits for ROADMAP item 11): a
fault, a drop or a disconnect is counted nowhere, and does what it does
in the JAX router. Its broad catches are the JAX ones, each around a
peer's connection or bytes only (a dial, a handshake, a frame's decode,
a transport's send or receive); none covers a call that reaches the
device (ROADMAP §3).
"""

from __future__ import annotations

import asyncio
import logging
import time as _time
from collections import deque
from typing import Deque, Dict, Optional, Tuple

from ..crypto import faults
from ..crypto.keys import PrivKey
from ..config import P2PConfig
from ..libs.service import Service
from .channel import Channel
from .peermanager import AlreadyConnectedError, PeerManager
from .transport import Connection, Transport
from .types import ChannelDescriptor, Envelope, NodeID, NodeInfo

__all__ = ["Router", "RouterOptions", "PING_CHANNEL_ID", "router_options"]

# Reserved keepalive channel, handled by the router itself
# (reference: conn/connection.go channelTypePing/Pong packets).
PING_CHANNEL_ID = 0xFF
_PING = b"\x01"
_PONG = b"\x02"
# goodbye control frame: 0x03 + utf-8 reason. Sent best-effort before a
# LOCALLY-decided disconnect (eviction, shed, shutdown) so the other
# side's logs/metrics carry the reason instead of a bare reset — a shed
# slow peer used to look identical to a crashed one from the far side.
_BYE = b"\x03"

# the FIXED disconnect-reason vocabulary. Metrics labels only ever come
# from this set (a remote-reported reason outside it becomes "other"),
# so a hostile peer cannot mint label cardinality through BYE frames.
_PEER_REASONS = frozenset(
    {
        "misbehavior",  # reactor/decoder reported bad messages
        "slow_peer",  # send queues shed past the slow-peer threshold
        "capacity",  # evicted to make room (over max_connected)
        "evicted",  # eviction with no recorded reason
        "unresponsive",  # keepalive deadline passed with no traffic
        "send_error",  # transport send failed mid-write
        "recv_error",  # transport receive failed / connection lost
        "crossover",  # replaced by the canonical crossover connection
        "shutdown",  # local node stopping
        "other",
    }
)


class RouterOptions:
    def __init__(
        self,
        handshake_timeout: float = 20.0,
        dial_timeout: float = 5.0,
        peer_queue_size: int = 128,
        num_concurrent_dials: int = 8,
        send_rate: int = 5_120_000,  # bytes/s; reference default 500 KB/s
        recv_rate: int = 5_120_000,
        ping_interval: float = 30.0,
        pong_timeout: float = 15.0,
        max_incoming_per_ip: int = 100,  # attempts per tracking window
        incoming_window: float = 10.0,
        slow_peer_drop_threshold: int = 64,  # queue sheds per window...
        slow_peer_window_s: float = 10.0,  # ...before the peer is shed
        slow_peer_ban_s: float = 30.0,  # sit-out window after a shed
    ) -> None:
        self.handshake_timeout = handshake_timeout
        self.dial_timeout = dial_timeout
        self.peer_queue_size = peer_queue_size
        self.num_concurrent_dials = num_concurrent_dials
        self.send_rate = send_rate
        self.recv_rate = recv_rate
        self.ping_interval = ping_interval
        self.pong_timeout = pong_timeout
        self.max_incoming_per_ip = max_incoming_per_ip
        self.incoming_window = incoming_window
        self.slow_peer_drop_threshold = slow_peer_drop_threshold
        self.slow_peer_window_s = slow_peer_window_s
        self.slow_peer_ban_s = slow_peer_ban_s


def router_options(cfg: P2PConfig) -> RouterOptions:
    """The router's options from the p2p config, as node start builds
    them (tendermint_tpu/node/node.py:314-329)."""
    return RouterOptions(
        handshake_timeout=cfg.handshake_timeout,
        dial_timeout=cfg.dial_timeout,
        send_rate=cfg.send_rate,
        recv_rate=cfg.recv_rate,
        ping_interval=cfg.ping_interval,
        pong_timeout=cfg.pong_timeout,
        max_incoming_per_ip=cfg.max_incoming_connection_attempts,
        slow_peer_drop_threshold=cfg.slow_peer_drop_threshold,
        slow_peer_window_s=cfg.slow_peer_window,
        slow_peer_ban_s=cfg.slow_peer_ban,
    )


def _peer_net_labels(peer_info: NodeInfo) -> tuple:
    """The labels TM_TPU_PARTITION members / p2p rule filters match a
    PEER against: moniker + node ID (and the self-reported listen
    host, the same identity the memory transport dials)."""
    host = (
        peer_info.listen_addr.rsplit(":", 1)[0]
        if peer_info.listen_addr
        else ""
    )
    return tuple(
        x for x in (peer_info.moniker, peer_info.node_id, host) if x
    )


class _RateLimiter:
    """Token bucket (reference: internal/libs/flowrate as used by
    conn/connection.go): await permission to move n bytes."""

    def __init__(self, rate: int) -> None:
        self.rate = rate
        self._tokens = float(rate)  # one-second burst
        self._last = _time.monotonic()

    async def wait(self, n: int) -> None:
        if self.rate <= 0:
            return
        now = _time.monotonic()
        self._tokens = min(
            self.rate, self._tokens + (now - self._last) * self.rate
        )
        self._last = now
        self._tokens -= n
        if self._tokens < 0:
            await asyncio.sleep(-self._tokens / self.rate)


class _PeerSendQueue:
    """Per-channel FIFO queues drained highest-priority-first
    (reference: conn/connection.go sendRoutine + channel priorities).
    Bounded per channel by the descriptor's send_queue_capacity; a full
    channel drops the message (never blocks other channels)."""

    def __init__(self, default_capacity: int = 64) -> None:
        # channel_id -> (priority, capacity, deque)
        self._queues: Dict[int, Tuple[int, int, Deque[bytes]]] = {}
        self._ready = asyncio.Event()
        self._default_capacity = default_capacity
        self._pong_queued = False

    def register(self, descriptor: ChannelDescriptor) -> None:
        old = self._queues.get(descriptor.channel_id)
        self._queues[descriptor.channel_id] = (
            descriptor.priority,
            descriptor.send_queue_capacity,
            old[2] if old is not None else deque(),
        )

    def put(self, channel_id: int, payload: bytes) -> bool:
        entry = self._queues.get(channel_id)
        if entry is None:
            # late-opened or router-internal channel: default slot
            entry = (1, self._default_capacity, deque())
            self._queues[channel_id] = entry
        priority, capacity, q = entry
        if len(q) >= capacity:
            return False
        q.append(payload)
        self._ready.set()
        return True

    def put_keepalive(self, payload: bytes) -> None:
        """Ping/pong traffic: max priority. Pongs coalesce — at most ONE
        pending pong regardless of inbound ping rate (reference:
        conn/connection.go's size-1 pong channel; otherwise a peer
        streaming pings without reading grows this queue unboundedly)."""
        if payload == _PONG:
            if self._pong_queued:
                return
            self._pong_queued = True
        entry = self._queues.get(PING_CHANNEL_ID)
        if entry is None:
            entry = (1 << 30, 1 << 30, deque())
            self._queues[PING_CHANNEL_ID] = entry
        entry[2].append(payload)
        self._ready.set()

    def pending(self) -> bool:
        """Any frame queued on any channel? (The reorder fault only
        parks a frame when a successor is actually waiting to swap
        with — holding the LAST frame of a burst would turn reorder
        into a drop.)"""
        return any(q for _p, _c, q in self._queues.values())

    async def get(self) -> Tuple[int, bytes]:
        while True:
            best = None
            for cid, (priority, _cap, q) in self._queues.items():
                if q and (best is None or priority > best[0]):
                    best = (priority, cid, q)
            if best is not None:
                _, cid, q = best
                payload = q.popleft()
                if cid == PING_CHANNEL_ID and payload == _PONG:
                    self._pong_queued = False
                if not any(
                    qq for _p, _c, qq in self._queues.values() if qq
                ):
                    self._ready.clear()
                return cid, payload
            self._ready.clear()
            await self._ready.wait()


class Router(Service):
    def __init__(
        self,
        node_info: NodeInfo,
        priv_key: PrivKey,
        peer_manager: PeerManager,
        transport: Transport,
        listen_addr: str = "",
        options: Optional[RouterOptions] = None,
    ) -> None:
        super().__init__(name="router", logger=logging.getLogger(__name__))
        self.node_info = node_info
        self.priv_key = priv_key
        self.peer_manager = peer_manager
        self.transport = transport
        self.listen_addr = listen_addr
        self.opts = options or RouterOptions()
        self._channels: Dict[int, Channel] = {}
        self._peer_queues: Dict[NodeID, _PeerSendQueue] = {}
        self._peer_conns: Dict[NodeID, Connection] = {}
        self._peer_tasks: Dict[NodeID, list] = {}
        self._peer_last_recv: Dict[NodeID, float] = {}
        # net-fault-plane identities: what TM_TPU_PARTITION members and
        # p2p.* rule src=/dst= filters match against
        self._net_labels = _peer_net_labels(node_info)
        # the transport consults the dial fault point with our labels
        self.transport.local_labels = self._net_labels
        # per-peer labels (moniker, node_id), learned at handshake;
        # entries removed in _close_peer
        self._peer_labels: Dict[NodeID, tuple] = {}
        # remote-reported disconnect reasons (BYE frames), consumed by
        # the _peer_down that follows the peer's close
        self._peer_bye: Dict[NodeID, str] = {}
        # slow-peer detection: recent send-queue drop instants per peer
        # (each deque pruned to slow_peer_window_s; removed on close)
        self._send_drops: Dict[NodeID, Deque[float]] = {}
        # per-IP connection-attempt tracking
        # (reference: internal/p2p/conn_tracker.go)
        self._conn_tracker: Dict[str, Deque[float]] = {}
        # last crossover replacement per peer (churn rate limit)
        self._last_replacement: Dict[NodeID, float] = {}

    # -- reactor API --

    def open_channel(self, descriptor: ChannelDescriptor) -> Channel:
        """reference: router.go OpenChannel."""
        if descriptor.channel_id in self._channels:
            raise ValueError(
                f"channel {descriptor.channel_id} already open"
            )
        if descriptor.channel_id == PING_CHANNEL_ID:
            raise ValueError(
                f"channel {PING_CHANNEL_ID:#x} is reserved for keepalive"
            )
        ch = Channel(descriptor)
        self._channels[descriptor.channel_id] = ch
        # advertise the channel in our NodeInfo
        if descriptor.channel_id not in self.node_info.channels:
            self.node_info.channels += bytes([descriptor.channel_id])
        # register on queues of peers that connected before this channel
        # opened, so its priority/capacity take effect
        for q in self._peer_queues.values():
            q.register(descriptor)
        self.spawn(self._route_channel_out(ch), f"ch{ch.id}-out")
        self.spawn(self._route_channel_errors(ch), f"ch{ch.id}-err")
        return ch

    def peer_ids(self):
        return list(self._peer_conns.keys())

    # -- lifecycle --

    async def on_start(self) -> None:
        if self.listen_addr:
            await self.transport.listen(self.listen_addr)
        # accept always runs: memory transports accept without listening
        self.spawn(self._accept_loop(), "accept")
        # ONE dispatcher; per-dial concurrency is bounded by the
        # semaphore inside _dial_loop (spawning the loop N times would
        # square the configured dial bound)
        self.spawn(self._dial_loop(), "dial")
        self.spawn(self._evict_loop(), "evict")

    async def on_stop(self) -> None:
        # announce the shutdown to every peer and AWAIT the goodbyes
        # here — a task spawned mid-stop can be cancelled before its
        # first tick (on_stop's remaining awaits never yield), which
        # would both swallow the frame and leak the conn. Bounded:
        # 0.5 s per frame, sent concurrently.
        if self._peer_conns:
            await asyncio.gather(
                *(
                    self._send_bye(conn, "shutdown")
                    for conn in self._peer_conns.values()
                ),
                return_exceptions=True,
            )
        for node_id in list(self._peer_conns):
            self._close_peer(node_id)
        self.peer_manager.flush()  # write any debounced address book state
        await self.transport.close()

    # -- dialing / accepting (reference: router.go dialPeers/acceptPeers) --

    async def _dial_loop(self) -> None:
        # dials run concurrently (bounded): a slow dial or handshake
        # must not head-of-line-block every other candidate
        # (reference: router.go dialPeers spawns per-candidate
        # goroutines under a capacity limit)
        sem = asyncio.Semaphore(self.opts.num_concurrent_dials)
        while True:
            # acquire the slot BEFORE taking a dial reservation:
            # dial_next marks the peer dialing, and a reservation that
            # sits queued behind a full semaphore would make accepted()
            # crossover-reject healthy inbounds for a dial that hasn't
            # even started
            await sem.acquire()
            node_id, host, port = await self.peer_manager.dial_next()
            self.spawn(
                self._dial_one(node_id, host, port, sem),
                f"dial-{node_id[:8]}",
            )

    async def _dial_one(
        self, node_id, host: str, port: int, sem: asyncio.Semaphore
    ) -> None:
        try:
            try:
                conn = await asyncio.wait_for(
                    self.transport.dial(host, port),
                    timeout=self.opts.dial_timeout,
                )
            except Exception as e:
                self.logger.debug("failed to dial peer (peer=%s, err=%s)", node_id, str(e))
                self.peer_manager.dial_failed(node_id)
                return
            try:
                peer_info = await self._handshake(conn)
                if peer_info.node_id != node_id:
                    raise ConnectionError(
                        f"expected {node_id}, got {peer_info.node_id}"
                    )
                if faults.net_armed() and faults.partition_blocked(
                    self._net_labels, _peer_net_labels(peer_info)
                ):
                    # the moniker learned at handshake put the peer on
                    # the far side of the partition (host-level labels
                    # alone — TCP nets — can't tell nodes apart)
                    raise ConnectionError("injected partition")
            except Exception as e:
                self.logger.info("peer handshake failed (peer=%s, err=%s)", node_id, str(e))
                conn.close()
                self.peer_manager.dial_failed(node_id)
                return
            try:
                self.peer_manager.dialed(node_id)
            except AlreadyConnectedError:
                # the peer's connection registered while we dialed —
                # the crossover resolved onto it. Drop this dial
                # WITHOUT the failure penalty: the peer is healthy and
                # connected, a score dock would skew eviction ordering
                conn.close()
                self.peer_manager.dial_abandoned(node_id)
                return
            except Exception as e:
                self.logger.info("dial rejected (peer=%s, err=%s)", node_id, str(e))
                conn.close()
                self.peer_manager.dial_failed(node_id)
                return
            self._start_peer(peer_info, conn)
        finally:
            sem.release()

    async def _accept_loop(self) -> None:
        while True:
            conn = await self.transport.accept()
            if not self._track_incoming(conn.remote_addr):
                self.logger.info(
                    "rejecting connection: too many attempts from IP (addr=%s)",
                    conn.remote_addr,
                )
                conn.close()
                continue
            self.spawn(self._accept_one(conn), "accept-one")

    def _track_incoming(self, remote_addr: str) -> bool:
        """Per-IP accept rate limiting
        (reference: internal/p2p/conn_tracker.go)."""
        ip = remote_addr.rsplit(":", 1)[0]
        now = _time.monotonic()
        window = self._conn_tracker.setdefault(ip, deque())
        while window and now - window[0] > self.opts.incoming_window:
            window.popleft()
        if len(self._conn_tracker) > 1024:
            # sweep drained windows so the tracker can't grow one entry
            # per distinct source IP ever seen
            for tracked_ip in list(self._conn_tracker):
                w = self._conn_tracker[tracked_ip]
                while w and now - w[0] > self.opts.incoming_window:
                    w.popleft()
                if not w and tracked_ip != ip:
                    del self._conn_tracker[tracked_ip]
        if len(window) >= self.opts.max_incoming_per_ip:
            return False
        window.append(now)
        return True

    async def _accept_one(self, conn: Connection) -> None:
        try:
            peer_info = await self._handshake(conn)
        except Exception as e:
            self.logger.debug("inbound handshake failed (err=%s)", str(e))
            conn.close()
            return
        if faults.net_armed() and faults.partition_blocked(
            _peer_net_labels(peer_info), self._net_labels
        ):
            self.logger.debug(
                "rejecting inbound: injected partition (peer=%s)",
                peer_info.node_id[:12],
            )
            conn.close()
            return
        nid = peer_info.node_id
        try:
            self.peer_manager.accepted(nid)
        except AlreadyConnectedError:
            now = _time.monotonic()
            if (
                self.node_info.node_id > nid
                and self.peer_manager.connection_inbound(nid) is False
                and now - self._last_replacement.get(nid, -1e9) > 30.0
            ):
                # dial/accept crossover, higher-ID side with its own
                # outbound already registered: the CANONICAL connection
                # is the lower-ID peer's outbound — this inbound.
                # Replace ours (see peermanager.CrossoverRejectError).
                # Only an existing OUTBOUND is replaced, at most once
                # per peer per 30s: a duplicate inbound must not let a
                # peer churn our reactor state in a loop.
                self._last_replacement[nid] = now
                self.logger.info(
                    "crossover: replacing outbound with canonical inbound (peer=%s)",
                    nid[:12],
                )
                self._peer_down(nid, reason="crossover")
                try:
                    self.peer_manager.accepted(nid)
                except Exception as e:
                    self.logger.debug("crossover replacement failed (err=%s)", str(e))
                    conn.close()
                    return
            else:
                conn.close()
                return
        except Exception as e:
            self.logger.debug("inbound rejected (err=%s)", str(e))
            conn.close()
            return
        # record the peer's self-reported listen address so PEX can
        # advertise inbound peers too (reference: the handshake's
        # NodeInfo.ListenAddr feeding the address book)
        if peer_info.listen_addr:
            try:
                self.peer_manager.add(
                    f"{peer_info.node_id}@{peer_info.listen_addr}"
                )
            except ValueError:
                pass  # unparseable self-report: ignore
        self._start_peer(peer_info, conn)

    async def _handshake(self, conn: Connection) -> NodeInfo:
        peer_info, _peer_pub = await asyncio.wait_for(
            conn.handshake(self.node_info, self.priv_key),
            timeout=self.opts.handshake_timeout,
        )
        peer_info.validate_basic()
        if peer_info.node_id == self.node_info.node_id:
            raise ConnectionError("rejecting connection from self")
        self.node_info.compatible_with(peer_info)
        return peer_info

    # -- per-peer routines (reference: router.go routePeer) --

    def _start_peer(self, peer_info: NodeInfo, conn: Connection) -> None:
        node_id = peer_info.node_id
        if not self.is_running:
            # a dial/accept that finished its handshake while stop()
            # was tearing the router down must not spawn fresh peer
            # tasks — they would outlive the cancel sweep and park
            # stop() forever on their queues
            conn.close()
            return
        if node_id in self._peer_conns:
            # duplicate connection: keep the existing one. No
            # disconnected() — the live peer's state must not be torn
            # down (reactors would drop peer state while its connection
            # keeps delivering).
            conn.close()
            return
        self._peer_conns[node_id] = conn
        self._peer_labels[node_id] = _peer_net_labels(peer_info)
        q = _PeerSendQueue(default_capacity=self.opts.peer_queue_size)
        for ch in self._channels.values():
            q.register(ch.descriptor)
        self._peer_queues[node_id] = q
        self._peer_last_recv[node_id] = _time.monotonic()
        send_t = self.spawn(self._send_peer(node_id, conn, q), f"send-{node_id[:8]}")
        recv_t = self.spawn(self._recv_peer(node_id, conn), f"recv-{node_id[:8]}")
        ping_t = self.spawn(self._ping_peer(node_id, q), f"ping-{node_id[:8]}")
        self._peer_tasks[node_id] = [send_t, recv_t, ping_t]
        self.peer_manager.ready(node_id)
        self.logger.info("peer connected (peer=%s, addr=%s)", node_id[:12], conn.remote_addr)

    def _link_labels(self, point: str, node_id: NodeID):
        labels = self._peer_labels.get(node_id, (node_id,))
        if point == "p2p.send":
            return self._net_labels, labels
        return labels, self._net_labels

    def _partition_cut(self, point: str, node_id: NodeID) -> bool:
        """Is this link cut by the live partition? Asked per frame.
        Callers gate on faults.net_armed()."""
        src, dst = self._link_labels(point, node_id)
        return faults.partition_blocked(src, dst)

    async def _consult_net_rules(
        self, point: str, node_id: NodeID, channel_id: int
    ):
        """One p2p.send / p2p.recv per-message RULE consult (the
        partition check is separate — on the recv side it must run
        BEFORE the liveness stamp, rules after). Returns
        (drop, extra_copies, reorder) after paying any injected delay.
        Callers gate on faults.net_armed() so the unarmed hot path
        never reaches here."""
        src, dst = self._link_labels(point, node_id)
        plan = faults.net_plan(point, src=src, dst=dst, ch=channel_id)
        if plan is None:
            return False, 0, False
        if plan.delay_s > 0:
            await asyncio.sleep(plan.delay_s)
        if plan.drop:
            return True, 0, False
        return False, plan.dup, plan.reorder

    async def _send_peer(
        self, node_id: NodeID, conn: Connection, queue: _PeerSendQueue
    ) -> None:
        limiter = _RateLimiter(self.opts.send_rate)
        held = None  # reorder fault: message parked behind its successor
        while True:
            channel_id, payload = await queue.get()
            batch = [(channel_id, payload)]
            if faults.net_armed():
                if self._partition_cut("p2p.send", node_id):
                    held = None  # the cut link eats the parked frame too
                    continue
                drop, dup, reorder = await self._consult_net_rules(
                    "p2p.send", node_id, channel_id
                )
                if drop:
                    if held is None:
                        continue
                    # the dropped frame dies but the PARKED one was
                    # only reordered: flush it now, or a dropped
                    # successor at the end of a burst would turn
                    # reorder into a silent drop
                    batch, held = [held], None
                else:
                    if reorder and held is None and queue.pending():
                        # park ONLY when a successor is already queued
                        # — holding the last frame of a burst would
                        # await a successor that never comes
                        # (reorder ≠ drop)
                        held = (channel_id, payload)
                        continue
                    batch += [(channel_id, payload)] * dup
            if held is not None:
                batch.append(held)  # swapped behind its successor
                held = None
            for cid, pl in batch:
                await limiter.wait(len(pl))
                try:
                    await conn.send(cid, pl)
                except asyncio.CancelledError:
                    raise
                except ValueError as e:
                    # our own oversized/bad payload: drop it, keep the
                    # peer
                    self.logger.error("dropping unsendable message (ch=%s, err=%s)", cid, str(e))
                except Exception:
                    # any transport failure means the connection is
                    # done; it must never escape into Service fail-fast
                    # and kill the whole router (single-peer failure ≠
                    # node failure)
                    self._peer_down(node_id, reason="send_error")
                    return

    async def _ping_peer(self, node_id: NodeID, queue: _PeerSendQueue) -> None:
        """Keepalive: ping on the reserved channel; ANY received traffic
        counts as liveness (reference: conn/connection.go pingRoutine +
        recv deadline)."""
        interval = self.opts.ping_interval
        if interval <= 0:
            return
        while True:
            await asyncio.sleep(interval)
            last = self._peer_last_recv.get(node_id)
            if last is None:
                return
            idle = _time.monotonic() - last
            if idle > interval + self.opts.pong_timeout:
                self.logger.info(
                    "peer unresponsive; disconnecting (peer=%s, idle=%s)",
                    node_id[:12], round(idle, 1),
                )
                self._peer_down(node_id, reason="unresponsive")
                return
            if idle > interval / 2:
                queue.put_keepalive(_PING)

    def _deliver_inbound(
        self, node_id: NodeID, channel_id: int, payload: bytes
    ) -> bool:
        """Demux one received frame into its reactor queue. Returns
        False when the peer must be dropped (invalid message)."""
        if channel_id == PING_CHANNEL_ID:
            if payload == _PING:
                q = self._peer_queues.get(node_id)
                if q is not None:
                    q.put_keepalive(_PONG)
            elif payload[:1] == _BYE:
                # the peer told us WHY it is about to hang up; stash it
                # so the imminent _peer_down attributes the close.
                # Sanitized against the fixed vocabulary: wire bytes
                # never become a metrics label.
                said = payload[1:64].decode("utf-8", "replace")
                reason = said if said in _PEER_REASONS else "other"
                self._peer_bye[node_id] = f"remote/{reason}"
                self.logger.info(
                    "peer announced disconnect (peer=%s, reason=%s)",
                    node_id[:12], reason,
                )
            # pongs need no action: any traffic is liveness
            return True
        ch = self._channels.get(channel_id)
        if ch is None:
            return True  # unknown channel: drop
        try:
            msg = ch.descriptor.decode(payload)
        except Exception as e:
            self.logger.info(
                "peer sent invalid message; evicting (peer=%s, ch=%s, err=%s)",
                node_id[:12], channel_id, str(e),
            )
            self.peer_manager.errored(node_id, f"bad message: {e}")
            return False
        if not ch.deliver(Envelope(message=msg, from_peer=node_id)):
            self.logger.debug("reactor queue full; dropping message (ch=%s)", channel_id)
        return True

    async def _recv_peer(self, node_id: NodeID, conn: Connection) -> None:
        limiter = _RateLimiter(self.opts.recv_rate)
        held = None  # reorder fault: frame parked behind its successor

        def flush_held() -> None:
            # timer-driven flush for a parked frame whose successor
            # never came: reorder delays, it never silently drops.
            # Runs as a loop callback so conn.receive() is never
            # cancelled mid-read (a cancel there loses the racing
            # frame on the memory transport and desyncs the
            # length-prefixed TCP stream). The send side guards with
            # queue.pending() instead; inbound traffic can't be
            # peeked, hence the deadline.
            nonlocal held
            if held is None:
                return
            cid, pl = held
            held = None
            self._deliver_inbound(node_id, cid, pl)

        try:
            while True:
                channel_id, payload = await conn.receive()
                # ONLY the partition check runs before the liveness
                # stamp: a fully-cut peer must go stale and trip the
                # keepalive deadline, exactly like a real one. A
                # rule-dropped/held frame still ARRIVED — a lossy link
                # delivers bytes, so it must not fake unresponsiveness
                if faults.net_armed() and self._partition_cut(
                    "p2p.recv", node_id
                ):
                    held = None  # the cut link eats a parked frame too
                    continue
                self._peer_last_recv[node_id] = _time.monotonic()
                batch = [(channel_id, payload)]
                if faults.net_armed():
                    drop, dup, reorder = await self._consult_net_rules(
                        "p2p.recv", node_id, channel_id
                    )
                    if drop:
                        continue  # held (if any) flushes on its timer
                    if reorder and held is None:
                        held = (channel_id, payload)
                        asyncio.get_running_loop().call_later(
                            0.5, flush_held
                        )
                        continue
                    batch += [(channel_id, payload)] * dup
                if held is not None:
                    batch.append(held)
                    held = None
                for cid, pl in batch:
                    await limiter.wait(len(pl))
                    if not self._deliver_inbound(node_id, cid, pl):
                        return
        except asyncio.CancelledError:
            raise
        except Exception as e:
            # tampered AEAD frames (InvalidTag), oversized frames, resets —
            # all are peer-connection failures, not router failures
            self.logger.debug("peer receive failed (peer=%s, err=%s)", node_id[:12], str(e))
            self._peer_down(node_id, reason="recv_error")

    def _peer_down(
        self,
        node_id: NodeID,
        reason: str = "other",
        notify: bool = False,
    ) -> None:
        """Tear down a peer. `reason` labels the disconnect metric and
        the log line; a BYE the peer sent first wins the attribution.
        `notify=True` sends the reason to the peer (best-effort) for
        LOCALLY-decided disconnects (evictions, shed, shutdown)."""
        if node_id not in self._peer_conns:
            return
        reason = self._peer_bye.pop(node_id, reason)
        self._close_peer(node_id, bye_reason=reason if notify else None)
        self.peer_manager.disconnected(node_id)
        self.logger.info("peer disconnected (peer=%s, reason=%s)", node_id[:12], reason)

    async def _send_bye(self, conn: Connection, reason: str) -> None:
        """Best-effort goodbye frame — bounded so a wedged transport
        can't hold the caller open."""
        try:
            await asyncio.wait_for(
                conn.send(PING_CHANNEL_ID, _BYE + reason.encode()),
                timeout=0.5,
            )
        except Exception:
            pass

    async def _say_bye(self, conn: Connection, reason: str) -> None:
        """Goodbye frame, then close (the eviction path's spawned
        teardown)."""
        try:
            await self._send_bye(conn, reason)
        finally:
            conn.close()

    def _close_peer(
        self, node_id: NodeID, bye_reason: Optional[str] = None
    ) -> None:
        conn = self._peer_conns.pop(node_id, None)
        if conn is not None:
            if bye_reason is not None and self.is_running:
                # eviction path: the loop keeps running, the spawned
                # bye gets its tick. During stop, spawning is unsafe
                # (a task cancelled before its first tick never runs
                # its finally and would leak the conn) — on_stop sends
                # its shutdown byes inline instead.
                self.spawn(
                    self._say_bye(conn, bye_reason),
                    f"bye-{node_id[:8]}",
                )
            else:
                conn.close()
        self._peer_queues.pop(node_id, None)
        self._peer_last_recv.pop(node_id, None)
        self._peer_labels.pop(node_id, None)
        self._peer_bye.pop(node_id, None)
        self._send_drops.pop(node_id, None)
        for t in self._peer_tasks.pop(node_id, []):
            if not t.done() and t is not asyncio.current_task():
                t.cancel()

    # -- outbound routing (reference: router.go routeChannel) --

    async def _route_channel_out(self, ch: Channel) -> None:
        while True:
            envelope = await ch.out_queue.get()
            try:
                payload = ch.descriptor.encode(envelope.message)
            except Exception as e:
                self.logger.error(
                    "failed to encode outbound message (ch=%s, err=%s)",
                    ch.id, str(e),
                )
                continue
            if envelope.broadcast:
                targets = list(self._peer_queues.keys())
            elif envelope.to:
                targets = [envelope.to]
            else:
                self.logger.error("outbound envelope has no destination")
                continue
            for node_id in targets:
                q = self._peer_queues.get(node_id)
                if q is None:
                    continue
                if not q.put(ch.id, payload):
                    self.logger.debug(
                        "peer channel queue full; dropping message (peer=%s, ch=%s)",
                        node_id[:12], ch.id,
                    )
                    self._note_send_drop(node_id)

    def _note_send_drop(self, node_id: NodeID) -> None:
        """Slow-peer detection: a peer whose queues shed more than
        `slow_peer_drop_threshold` messages inside
        `slow_peer_window_s` is not consuming — evict it with reason
        `slow_peer` and ban it for the sit-out window rather than
        letting its queues shed forever (bounded memory was already
        guaranteed; bounded USELESS WORK was not)."""
        if node_id not in self._peer_conns:
            return
        now = _time.monotonic()
        window = self._send_drops.setdefault(node_id, deque())
        cutoff = now - self.opts.slow_peer_window_s
        while window and window[0] < cutoff:
            window.popleft()
        window.append(now)
        if len(window) >= self.opts.slow_peer_drop_threshold:
            window.clear()
            self.peer_manager.shed_slow(
                node_id, ban_s=self.opts.slow_peer_ban_s
            )

    async def _route_channel_errors(self, ch: Channel) -> None:
        while True:
            peer_error = await ch.error_queue.get()
            self.peer_manager.errored(peer_error.node_id, peer_error.err)

    async def _evict_loop(self) -> None:
        """reference: router.go evictPeers."""
        while True:
            node_id = await self.peer_manager.evict_next()
            reason = self.peer_manager.evict_reason(node_id) or "evicted"
            self._peer_down(node_id, reason=reason, notify=True)
