"""State sync: bootstrap a fresh node from an application snapshot.

Counterpart: tendermint_tpu/statesync/reactor.py:1-774, whole (reference:
internal/statesync/reactor.go (channels :36-45), syncer.go (:159-552:
discovery, selection, OfferSnapshot, the parallel chunk fetch,
ApplySnapshotChunk, the app's hash check), stateprovider.go (the trusted
state from light blocks over the LightBlock channel), chunks.go,
snapshots.go): the serving handlers, sync() with its discovery, the
embedded light client (:383-406), _sync_snapshot, _fetch_chunks,
_apply_chunks, _verify_light_block (:681-699), _build_state and backfill
(:745-774).

Trust model: state sync needs the operator's trust root (trust_height
and trust_hash, reference config.go:811-895). The light blocks at the
snapshot's height h, h+1 and h+2 are verified from that root by an
embedded light client (light/client.py, bisection from the pinned root)
whose P2PProviders fetch from the peers over the LightBlock channel;
consecutive headers must also chain by hash and next-validators hash.
Backfill fetches the headers below the snapshot's height from the peers
one height at a time, each light block verified by _verify_light_block.
With the device plane installed every commit check of both is
verify_commit_light (or its trusting form) on the card.

ERRORS. The JAX package catches every exception around
_verify_light_block and moves on to the next peer (:672). Here only a
check error (light.verifier CHECK_ERRORS: ValueError, the commit errors
among them, and OverflowError) does; a light block without a commit or
a validator set is refused as a ValueError first, where the JAX package
meets an AttributeError, so both move on to the next peer. A DeviceFault
never reaches the reactor: the device verifier's fault policy contains
it and the CPU plane gives the same outcome. Any other error, a failed
launch among them, raises to sync()'s or backfill()'s caller. The peers
of one backfill height are tried in sorted order (the JAX package's is
a set's, which hash seeding makes arbitrary). The serving handlers keep
the JAX catch (:160-166): none of them runs a device call (they read the
app's snapshots and the stores, or resolve a waiting fetch). The
`except BaseException` of _fetch_chunks (:580) stays: it cancels the
sibling fetches and re-raises.
"""

from __future__ import annotations

import asyncio
import logging
from dataclasses import dataclass, field
from typing import Dict, Optional, Set, Tuple

from ..abci import types as abci
from ..config import StateSyncConfig
from ..libs import rng
from ..libs.service import Service
from ..p2p.channel import Channel
from ..p2p.peermanager import PeerStatus
from ..p2p.types import ChannelDescriptor, Envelope
from ..state.types import State
from ..types.light import LightBlock
from ..types.params import ConsensusParams
from ..light.errors import LightClientError
from ..light.verifier import CHECK_ERRORS
from ..types.validation import verify_commit_light
from .chunks import ChunkQueue
from .msgs import (
    ChunkRequestMessage,
    ChunkResponseMessage,
    LightBlockRequestMessage,
    LightBlockResponseMessage,
    ParamsRequestMessage,
    ParamsResponseMessage,
    SnapshotsRequestMessage,
    SnapshotsResponseMessage,
    StatesyncCodec,
)

__all__ = [
    "StatesyncReactor",
    "SNAPSHOT_CHANNEL",
    "CHUNK_CHANNEL",
    "LIGHT_BLOCK_CHANNEL",
    "PARAMS_CHANNEL",
    "statesync_channel_descriptors",
    "SyncError",
]

SNAPSHOT_CHANNEL = 0x60
CHUNK_CHANNEL = 0x61
LIGHT_BLOCK_CHANNEL = 0x62
PARAMS_CHANNEL = 0x63

_RECENT_SNAPSHOTS = 10  # serve at most N (reference: reactor.go:56)
_CHUNK_TIMEOUT = 10.0
_LIGHT_BLOCK_TIMEOUT = 5.0


class SyncError(Exception):
    pass


def statesync_channel_descriptors():
    """reference: reactor.go:36-45."""
    return {
        cid: ChannelDescriptor(
            channel_id=cid,
            message_type=StatesyncCodec,
            priority=p,
            send_queue_capacity=cap,
            recv_buffer_capacity=128,
            name=name,
        )
        for cid, p, cap, name in (
            (SNAPSHOT_CHANNEL, 6, 10, "snapshot"),
            (CHUNK_CHANNEL, 3, 4, "chunk"),
            (LIGHT_BLOCK_CHANNEL, 2, 10, "lightblock"),
            (PARAMS_CHANNEL, 2, 10, "params"),
        )
    }


@dataclass
class _Snapshot:
    height: int
    format: int
    chunks: int
    hash: bytes
    metadata: bytes
    peers: Set[str] = field(default_factory=set)

    def key(self) -> Tuple[int, int, bytes]:
        return (self.height, self.format, self.hash)


class StatesyncReactor(Service):
    def __init__(
        self,
        chain_id: str,
        initial_state: State,
        app_client,  # snapshot connection
        state_store,
        block_store,
        channels: Dict[int, Channel],
        peer_updates: asyncio.Queue,
        cfg: Optional[StateSyncConfig] = None,
    ) -> None:
        super().__init__(name="statesync", logger=logging.getLogger(__name__))
        self.chain_id = chain_id
        self.initial_state = initial_state
        self.app = app_client
        self.state_store = state_store
        self.block_store = block_store
        self.snapshot_ch = channels[SNAPSHOT_CHANNEL]
        self.chunk_ch = channels[CHUNK_CHANNEL]
        self.light_ch = channels[LIGHT_BLOCK_CHANNEL]
        self.params_ch = channels[PARAMS_CHANNEL]
        self.peer_updates = peer_updates
        self.cfg = cfg or StateSyncConfig()
        self.peers: Set[str] = set()
        # discovery pool
        self._snapshots: Dict[Tuple[int, int, bytes], _Snapshot] = {}
        self._rejected: Set[Tuple[int, int, bytes]] = set()
        # peers the app flagged via ResponseApplySnapshotChunk
        # .reject_senders — excluded from chunk fetches for the rest of
        # the restore (reference: syncer.go:431-441)
        self._rejected_senders: Set[str] = set()
        # in-flight response routing, keyed by (sender_peer, request key)
        self._chunk_waiters: Dict[Tuple, asyncio.Future] = {}
        self._light_waiters: Dict[Tuple[str, int], asyncio.Future] = {}
        self._params_waiters: Dict[Tuple[str, int], asyncio.Future] = {}
        self.synced_state: Optional[State] = None

    async def on_start(self) -> None:
        self.spawn(self._peer_update_routine(), "peer-updates")
        self.spawn(self._recv(self.snapshot_ch, self._on_snapshot_msg), "recv-snap")
        self.spawn(self._recv(self.chunk_ch, self._on_chunk_msg), "recv-chunk")
        self.spawn(self._recv(self.light_ch, self._on_light_msg), "recv-light")
        self.spawn(self._recv(self.params_ch, self._on_params_msg), "recv-params")

    # ------------------------------------------------------------------
    # serving side (every node serves; reference: reactor.go handle*)

    async def _recv(self, channel: Channel, handler) -> None:
        async for envelope in channel:
            try:
                await handler(envelope)
            except asyncio.CancelledError:
                raise
            except Exception as e:  # no device call runs under it
                self.logger.error("statesync message failed (ch=%s): %s", channel.name, e)

    async def _peer_update_routine(self) -> None:
        while True:
            update = await self.peer_updates.get()
            if update.status == PeerStatus.UP:
                self.peers.add(update.node_id)
            else:
                self.peers.discard(update.node_id)
                for snap in self._snapshots.values():
                    snap.peers.discard(update.node_id)

    async def _on_snapshot_msg(self, envelope: Envelope) -> None:
        msg = envelope.message
        if isinstance(msg, SnapshotsRequestMessage):
            res = await self.app.list_snapshots(abci.RequestListSnapshots())
            for snap in sorted(
                res.snapshots, key=lambda s: s.height, reverse=True
            )[:_RECENT_SNAPSHOTS]:
                self.snapshot_ch.try_send(
                    Envelope(
                        message=SnapshotsResponseMessage(
                            height=snap.height,
                            format=snap.format,
                            chunks=snap.chunks,
                            hash=snap.hash,
                            metadata=snap.metadata,
                        ),
                        to=envelope.from_peer,
                    )
                )
        elif isinstance(msg, SnapshotsResponseMessage):
            key = (msg.height, msg.format, msg.hash)
            if key in self._rejected:
                return
            snap = self._snapshots.get(key)
            if snap is None:
                snap = _Snapshot(
                    height=msg.height, format=msg.format, chunks=msg.chunks,
                    hash=msg.hash, metadata=msg.metadata,
                )
                self._snapshots[key] = snap
            snap.peers.add(envelope.from_peer)

    async def _on_chunk_msg(self, envelope: Envelope) -> None:
        msg = envelope.message
        if isinstance(msg, ChunkRequestMessage):
            res = await self.app.load_snapshot_chunk(
                abci.RequestLoadSnapshotChunk(
                    height=msg.height, format=msg.format, chunk=msg.index
                )
            )
            self.chunk_ch.try_send(
                Envelope(
                    message=ChunkResponseMessage(
                        height=msg.height,
                        format=msg.format,
                        index=msg.index,
                        chunk=res.chunk,
                        missing=not res.chunk,
                    ),
                    to=envelope.from_peer,
                )
            )
        elif isinstance(msg, ChunkResponseMessage):
            # sender-keyed: a third peer can't poison the future of a
            # request we sent to someone else
            fut = self._chunk_waiters.pop(
                (envelope.from_peer, msg.height, msg.format, msg.index),
                None,
            )
            if fut is not None and not fut.done():
                fut.set_result(msg)

    async def _on_light_msg(self, envelope: Envelope) -> None:
        msg = envelope.message
        if isinstance(msg, LightBlockRequestMessage):
            lb = await self._load_light_block(msg.height)
            self.light_ch.try_send(
                Envelope(
                    message=LightBlockResponseMessage(light_block=lb),
                    to=envelope.from_peer,
                )
            )
        elif isinstance(msg, LightBlockResponseMessage):
            if msg.light_block is None or msg.light_block.signed_header is None:
                return
            h = msg.light_block.signed_header.header.height
            # a tip request is keyed (peer, 0); the response carries
            # the actual height
            fut = self._light_waiters.pop(
                (envelope.from_peer, h), None
            ) or self._light_waiters.pop((envelope.from_peer, 0), None)
            if fut is not None and not fut.done():
                fut.set_result(msg.light_block)

    async def _on_params_msg(self, envelope: Envelope) -> None:
        msg = envelope.message
        if isinstance(msg, ParamsRequestMessage):
            params = self.state_store.load_params(msg.height)
            if params is None:
                state = self.state_store.load()
                params = state.consensus_params if state else None
            if params is not None:
                self.params_ch.try_send(
                    Envelope(
                        message=ParamsResponseMessage(
                            height=msg.height,
                            consensus_params=params.to_proto(),
                        ),
                        to=envelope.from_peer,
                    )
                )
        elif isinstance(msg, ParamsResponseMessage):
            fut = self._params_waiters.pop(
                (envelope.from_peer, msg.height), None
            )
            if fut is not None and not fut.done():
                fut.set_result(msg.consensus_params)

    async def _load_light_block(self, height: int) -> Optional[LightBlock]:
        """reference: statesync/reactor.go handleLightBlockMessage.
        Serving delegates to the same LocalProvider logic the light
        proxy uses (0 = tip, seen-commit fallback at the tip)."""
        from ..light.errors import LightBlockNotFoundError
        from ..light.provider import LocalProvider

        provider = LocalProvider(self.block_store, self.state_store)
        try:
            return await provider.light_block(height)
        except LightBlockNotFoundError:
            return None

    # ------------------------------------------------------------------
    # sync side (reference: syncer.go SyncAny :159)

    async def sync(self) -> State:
        """Discover snapshots, restore the best one, return the
        bootstrapped State. Raises SyncError if no snapshot worked.

        Requires the operator trust root (reference: config.go:811-895
        — TrustHeight/TrustHash are mandatory for state sync)."""
        if self.cfg.trust_height <= 0 or not self.cfg.trust_hash:
            raise SyncError(
                "state sync requires statesync.trust_height and "
                "statesync.trust_hash (obtain them out-of-band from a "
                "trusted source)"
            )
        try:
            trust_hash = bytes.fromhex(self.cfg.trust_hash)
        except ValueError as e:
            raise SyncError(f"invalid statesync.trust_hash: {e}") from e
        if len(trust_hash) != 32:
            raise SyncError(
                f"statesync.trust_hash must be 32 hex bytes, got "
                f"{len(trust_hash)}"
            )
        self.logger.info("discovering snapshots (%ss)", self.cfg.discovery_time)
        self.snapshot_ch.try_send(
            Envelope(message=SnapshotsRequestMessage(), broadcast=True)
        )
        await asyncio.sleep(self.cfg.discovery_time)

        light_client = self._make_light_client(trust_hash)
        # pin the trust root up front: a root failure is an operator
        # config / provider problem, NOT a reason to reject snapshots
        try:
            await light_client.initialize()
        except LightClientError as e:
            raise SyncError(f"trust root verification failed: {e}") from e

        discovery_rounds = 0
        while True:
            snapshot = self._best_snapshot()
            if snapshot is None:
                # providers prune old snapshots while the chain moves;
                # a one-shot discovery pool can empty out after a slow
                # chunk round. Re-discover a few times before giving up
                # (reference: syncer.go SyncAny's discovery retry loop).
                discovery_rounds += 1
                if discovery_rounds > 3:
                    raise SyncError("no viable snapshots discovered")
                self.logger.info("re-discovering snapshots (attempt %d)", discovery_rounds)
                # transiently-rejected snapshots (e.g. light blocks at
                # h+1/h+2 didn't exist yet) may verify now that the
                # chain has advanced; the bounded round count keeps a
                # permanently-bad snapshot from looping forever
                self._rejected.clear()
                self.snapshot_ch.try_send(
                    Envelope(
                        message=SnapshotsRequestMessage(), broadcast=True
                    )
                )
                await asyncio.sleep(self.cfg.discovery_time)
                continue
            try:
                state = await self._sync_snapshot(snapshot, light_client)
                self.synced_state = state
                return state
            except (SyncError, LightClientError) as e:
                self.logger.error(
                    "snapshot restore failed; trying next (height=%d): %s",
                    snapshot.height,
                    e,
                )
                self._rejected.add(snapshot.key())
                self._snapshots.pop(snapshot.key(), None)

    def _make_light_client(self, trust_hash: bytes):
        """Embedded light client over the snapshot peers (reference:
        stateprovider.go:33-51 — trusted state via light client over
        the LightBlock channel)."""
        from ..light import Client, LightStore, P2PProvider, TrustOptions
        from ..store.kv import MemKV

        providers = [
            P2PProvider(peer, self._fetch_light_block_from)
            for peer in sorted(self.peers)
        ]
        if not providers:
            raise SyncError("no peers to serve light blocks")
        return Client(
            self.chain_id,
            TrustOptions(
                period_ns=int(self.cfg.trust_period * 1e9),
                height=self.cfg.trust_height,
                hash=trust_hash,
            ),
            providers[0],
            providers[1:],
            LightStore(MemKV()),
        )

    def _best_snapshot(self) -> Optional[_Snapshot]:
        """Highest height, then most peers (reference: snapshots.go
        snapshotPool.Best ranking)."""
        candidates = [
            s for s in self._snapshots.values()
            if s.peers and s.key() not in self._rejected
            # can't anchor trust for snapshots below the trust height
            and s.height >= self.cfg.trust_height
        ]
        if not candidates:
            return None
        return max(candidates, key=lambda s: (s.height, len(s.peers)))

    async def _sync_snapshot(
        self, snapshot: _Snapshot, light_client
    ) -> State:
        """reference: syncer.go Sync :263-460."""
        h = snapshot.height
        self._rejected_senders.clear()  # per-restore, like the syncer's
        self.logger.info(
            "restoring snapshot height=%d format=%d chunks=%d",
            h, snapshot.format, snapshot.chunks,
        )
        # 1. trusted state info from light blocks at h, h+1, h+2 —
        # each verified from the operator trust root by the embedded
        # light client (bisection through validator churn)
        lb_h = await light_client.verify_light_block_at_height(h)
        lb_h1 = await light_client.verify_light_block_at_height(h + 1)
        lb_h2 = await light_client.verify_light_block_at_height(h + 2)

        # cross-height linkage: headers must chain by hash and by
        # next-validators-hash (defense in depth over the light
        # client's commit checks)
        for older, newer in ((lb_h, lb_h1), (lb_h1, lb_h2)):
            oh, nh = older.signed_header.header, newer.signed_header.header
            if nh.last_block_id.hash != oh.hash():
                raise SyncError(
                    f"light block at {nh.height} does not link to header "
                    f"at {oh.height}"
                )
            if oh.next_validators_hash != newer.validator_set.hash():
                raise SyncError(
                    f"validator set at {nh.height} does not match "
                    f"next_validators_hash at {oh.height}"
                )
        app_hash = lb_h1.signed_header.header.app_hash

        # 2. offer to the app
        offer = await self.app.offer_snapshot(
            abci.RequestOfferSnapshot(
                snapshot=abci.Snapshot(
                    height=snapshot.height,
                    format=snapshot.format,
                    chunks=snapshot.chunks,
                    hash=snapshot.hash,
                    metadata=snapshot.metadata,
                ),
                app_hash=app_hash,
            )
        )
        if offer.result != abci.OFFER_SNAPSHOT_ACCEPT:
            raise SyncError(f"snapshot rejected by app: {offer.result}")

        # 3. fetch chunks in parallel into the on-disk queue, apply in
        # order reading one chunk at a time — restore memory is bounded
        # by a single chunk, not the snapshot (reference: chunks.go
        # tempdir spool; syncer.go applyChunks :403-460)
        queue = ChunkQueue(snapshot.chunks)
        try:
            await self._fetch_chunks(snapshot, queue)
            await self._apply_chunks(snapshot, queue)
        finally:
            queue.close()

        # 4. verify the app landed on the trusted hash
        info = await self.app.info(abci.RequestInfo())
        if info.last_block_height != h:
            raise SyncError(
                f"app restored to height {info.last_block_height}, "
                f"expected {h}"
            )
        if info.last_block_app_hash != app_hash:
            raise SyncError(
                f"app hash mismatch after restore: "
                f"{info.last_block_app_hash.hex()[:16]} != "
                f"{app_hash.hex()[:16]}"
            )

        # 5. build + persist the trusted state
        params = await self._fetch_params(h + 1, snapshot.peers)
        state = self._build_state(lb_h, lb_h1, lb_h2, params)
        self.state_store.bootstrap(state)
        self.block_store.save_signed_header(
            lb_h.signed_header,
            lb_h1.signed_header.header.last_block_id,
        )
        self.logger.info("snapshot restored (height=%d)", h)
        return state

    async def _fetch_light_block_from(
        self, height: int, peer: str
    ) -> Optional[LightBlock]:
        """Raw per-peer fetch for the embedded light client's
        P2PProviders; verification is the client's job. height 0 asks
        for the peer's tip."""
        fut = asyncio.get_event_loop().create_future()
        self._light_waiters[(peer, height)] = fut
        try:
            self.light_ch.try_send(
                Envelope(
                    message=LightBlockRequestMessage(height=height), to=peer
                )
            )
            return await asyncio.wait_for(fut, timeout=_LIGHT_BLOCK_TIMEOUT)
        except asyncio.TimeoutError:
            return None
        finally:
            self._light_waiters.pop((peer, height), None)

    async def _fetch_chunks(
        self, snapshot: _Snapshot, queue: ChunkQueue, indexes=None
    ) -> None:
        """Parallel chunk fetch with per-chunk retry over providers,
        spooling straight to the on-disk queue (reference: syncer.go
        fetchChunks :464-520, chunks.go). `indexes` limits the fetch to
        a subset — the re-fetch path after the app discards chunks."""
        sem = asyncio.Semaphore(self.cfg.fetchers)

        async def fetch(index: int) -> None:
            async with sem:
                for attempt in range(4):
                    providers = sorted(
                        p for p in snapshot.peers
                        if p not in self._rejected_senders
                    )
                    if not providers:
                        # all providers disconnected mid-fetch (or the
                        # app rejected every remaining sender)
                        raise SyncError("no remaining snapshot providers")
                    peer = rng.choice(providers)
                    fut = asyncio.get_event_loop().create_future()
                    self._chunk_waiters[
                        (peer, snapshot.height, snapshot.format, index)
                    ] = fut
                    self.chunk_ch.try_send(
                        Envelope(
                            message=ChunkRequestMessage(
                                height=snapshot.height,
                                format=snapshot.format,
                                index=index,
                            ),
                            to=peer,
                        )
                    )
                    try:
                        res = await asyncio.wait_for(
                            fut, timeout=self.cfg.chunk_request_timeout
                        )
                    except asyncio.TimeoutError:
                        continue
                    if res.missing:
                        continue
                    queue.put(index, res.chunk, sender=peer)
                    return
                raise SyncError(f"failed to fetch chunk {index}")

        todo = list(indexes) if indexes is not None else list(
            range(snapshot.chunks)
        )
        tasks = [asyncio.ensure_future(fetch(i)) for i in todo]
        try:
            await asyncio.gather(*tasks)
        except BaseException:
            # one chunk failing must not leave sibling fetches running:
            # they would later put() into a closed (deleted) queue and
            # die as never-retrieved task exceptions
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)
            raise

    async def _apply_chunks(
        self, snapshot: _Snapshot, queue: ChunkQueue
    ) -> None:
        """Feed queued chunks to the app in index order, honoring the
        app's control results (reference: syncer.go applyChunks
        :403-460): ACCEPT marks the chunk returned and the cursor moves
        to the lowest unreturned index; refetch_chunks are discarded
        (file deleted + returned flag cleared, so the cursor rewinds to
        them) and re-fetched from providers; RETRY clears the returned
        flag without refetching; ABORT/RETRY_SNAPSHOT/REJECT_SNAPSHOT
        fail this restore. Chunk files persist until the queue closes —
        disk, not RAM, bounds the restore."""
        steps = 0
        while True:
            index = queue.next_up()
            if index is None:
                return
            steps += 1
            if steps > 4 * snapshot.chunks + 16:
                raise SyncError("app keeps retrying/refetching chunks")
            if not queue.has(index):
                # a hole left by a rejected sender's discarded chunks:
                # refetch from the remaining (non-rejected) providers
                await self._fetch_chunks(snapshot, queue, indexes=[index])
            res = await self.app.apply_snapshot_chunk(
                abci.RequestApplySnapshotChunk(
                    index=index,
                    chunk=queue.get(index),
                    sender=queue.sender(index),
                )
            )
            queue.mark_returned(index)
            # senders the app flagged as bad: ban them from further
            # fetches this restore and drop their not-yet-applied
            # chunks so re-fetches come from someone else (reference:
            # syncer.go:431-441 rejectSenders)
            for bad in res.reject_senders:
                if not bad:
                    continue
                self._rejected_senders.add(bad)
                for i in range(snapshot.chunks):
                    if (
                        queue.has(i)
                        and queue.sender(i) == bad
                        and not queue.is_returned(i)
                    ):
                        queue.discard(i)
            # validate refetch indexes BEFORE acting on them: a
            # misbehaving app must fail the restore as a SyncError,
            # not crash the reactor with a bare IndexError
            refetch = []
            for r in res.refetch_chunks:
                if not 0 <= r < snapshot.chunks:
                    raise SyncError(
                        f"app requested refetch of out-of-range "
                        f"chunk {r} (snapshot has {snapshot.chunks})"
                    )
                refetch.append(r)
            for r in refetch:
                queue.discard(r)
            # terminal results first: an ABORT/REJECT must not trigger
            # a round of network fetches that gets thrown away
            if res.result not in (
                abci.APPLY_CHUNK_ACCEPT, abci.APPLY_CHUNK_RETRY
            ):
                raise SyncError(f"chunk {index} rejected: {res.result}")
            if refetch:
                await self._fetch_chunks(snapshot, queue, indexes=refetch)
            if res.result == abci.APPLY_CHUNK_RETRY:
                queue.retry(index)

    async def _fetch_light_block(
        self, height: int, peers: Set[str]
    ) -> LightBlock:
        """Fetch + verify a light block from snapshot providers
        (reference: stateprovider.go P2P provider)."""
        candidates = list(dict.fromkeys(sorted(peers) + sorted(self.peers)))
        for peer in candidates:
            lb = await self._fetch_light_block_from(height, peer)
            if lb is None:
                continue
            try:
                self._verify_light_block(lb, height)
            except CHECK_ERRORS as e:
                self.logger.info("peer sent invalid light block (peer=%s): %s", peer[:12], e)
                continue
            return lb
        raise SyncError(f"could not fetch light block at height {height}")

    def _verify_light_block(self, lb: LightBlock, height: int) -> None:
        """Internal-consistency verification (see module docstring)."""
        sh = lb.signed_header
        if sh.commit is None:
            raise ValueError("missing commit")
        if lb.validator_set is None:
            raise ValueError("missing validator set")
        if sh.header.height != height:
            raise ValueError("wrong height")
        if sh.header.chain_id != self.chain_id:
            raise ValueError("wrong chain id")
        if lb.validator_set.hash() != sh.header.validators_hash:
            raise ValueError("validator set doesn't match header")
        if sh.commit.block_id.hash != sh.header.hash():
            raise ValueError("commit is for a different block")
        # 2/3 of the set signed — one batched device verify
        verify_commit_light(
            self.chain_id,
            lb.validator_set,
            sh.commit.block_id,
            height,
            sh.commit,
        )

    async def _fetch_params(
        self, height: int, peers: Set[str]
    ) -> ConsensusParams:
        for peer in list(peers) + list(self.peers):
            fut = asyncio.get_event_loop().create_future()
            self._params_waiters[(peer, height)] = fut
            self.params_ch.try_send(
                Envelope(
                    message=ParamsRequestMessage(height=height), to=peer
                )
            )
            try:
                raw = await asyncio.wait_for(fut, timeout=_LIGHT_BLOCK_TIMEOUT)
            except asyncio.TimeoutError:
                continue
            return ConsensusParams.from_proto(raw)
        raise SyncError(f"could not fetch consensus params at {height}")

    def _build_state(
        self,
        lb_h: LightBlock,
        lb_h1: LightBlock,
        lb_h2: LightBlock,
        params: ConsensusParams,
    ) -> State:
        """reference: stateprovider.go State() :150-200."""
        h = lb_h.signed_header.header.height
        state = self.initial_state.copy()
        state.last_block_height = h
        state.last_block_time_ns = lb_h.signed_header.header.time_ns
        state.last_block_id = lb_h.signed_header.commit.block_id
        state.app_hash = lb_h1.signed_header.header.app_hash
        state.last_results_hash = lb_h1.signed_header.header.last_results_hash
        state.last_validators = lb_h.validator_set
        state.validators = lb_h1.validator_set
        state.next_validators = lb_h2.validator_set
        state.last_height_validators_changed = h + 1
        state.consensus_params = params
        state.last_height_consensus_params_changed = h + 1
        return state

    # ------------------------------------------------------------------
    # backfill (reference: reactor.go:341-363, ADR-068)

    async def backfill(self, state: State) -> int:
        """Fetch and store verified signed headers backward from the sync
        base to the evidence window; returns how many were stored."""
        max_age = state.consensus_params.evidence.max_age_num_blocks
        stop_height = max(state.initial_height, state.last_block_height - max_age)
        height = self.block_store.base() - 1
        stored = 0
        prev_header = None
        meta = self.block_store.load_block_meta(self.block_store.base())
        if meta is not None:
            prev_header = meta.header
        while height >= stop_height and prev_header is not None:
            try:
                lb = await self._fetch_light_block(height, self.peers)
            except SyncError:
                break
            # linkage: the newer header must point at this block
            if prev_header.last_block_id.hash != lb.signed_header.header.hash():
                self.logger.error("backfill light block does not link (height=%d)", height)
                break
            self.block_store.save_signed_header(
                lb.signed_header, prev_header.last_block_id
            )
            self.state_store.save_validators(height, lb.validator_set)
            prev_header = lb.signed_header.header
            height -= 1
            stored += 1
        return stored
