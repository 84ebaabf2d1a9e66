"""Node assembly: every subsystem composed into a node that runs.

Counterpart: tendermint_tpu/node/node.py:70-912 (reference:
node/node.go:116-412 makeNode, node/setup.go, node/public.go): Node's
construction (:79-346: DBs and stores, the three `abci` modes
:176-189, gRPC through abci/grpc_transport.py, the event bus and the
indexer sinks, the node key, FilePV, the remote signer's
SignerListenerEndpoint or the gRPC signer's client :222-262, NodeInfo,
PeerManager and Router on a TCPTransport unless one is passed in), on_start (:350) and
_start_impl (:413-626: the ABCI handshake, then the reactors built
against the post-handshake state with the JAX wait_sync, block_sync and
state_sync flags :493-497, the Byzantine plane armed at assembly, then
the RPC Environment and RPCServer), _start_seed (:727),
_state_sync_then_follow (:742: state sync, then block sync, then
consensus, StateSyncStatus on the event bus), _only_validator_is_us
(:754), on_stop and _teardown (:763-821), acquire_pid_lock and
release_pid_lock (:822-895), and make_node (:896).

The device plane is installed first, before any check runs, through
node/device.py install_device_plane(cfg.gpu, device) in place of the
JAX install (:136-158); `device` is "cuda" unless the caller asks for
the CPU (the tests). gpu.enable = true without CUDA raises at install;
gpu.enable = false runs the native CPU plane, an explicit choice. A
second node in the process with the same [gpu] config reuses the
install; one with another config installs its own and logs it, as the
JAX node does.

Errors: a failed start tears down what it started and raises. The
teardown stops every part, closes every DB and releases the data lock,
then raises the first error a part was stopped with (block sync's pool
routine, the evidence reactor's receive loop, the step machine's loop,
an RPC route, the state sync task), where the JAX teardown logs them: a
failed launch reaches the caller of stop(). failure() returns such an
error while the node runs.

Left out (ROADMAP item 11): the metrics registry and the Prometheus
server (:627-726; `instrumentation.prometheus = true` raises
NotImplementedError), the trace ring, the slow-request exemplars, the
profiler and the TimelineRecorder (the step machine keeps NopTimeline);
the switches of them that are on are logged once at construction as not
honored.
"""

from __future__ import annotations

import asyncio
import os
from typing import Optional

from ..abci.client import local_creator, socket_creator
from ..abci.kvstore import KVStoreApplication
from ..abci.proxy import AppConns
from ..config import MODE_SEED, MODE_VALIDATOR, Config
from ..consensus.reactor import ConsensusReactor, consensus_channel_descriptors
from ..consensus.replay import Handshaker
from ..consensus.state import ConsensusState
from ..consensus.wal import WAL
from ..eventbus import EventBus
from ..evidence.pool import EvidencePool
from ..evidence.reactor import EvidenceReactor, evidence_channel_descriptor
from ..libs.log import get_logger
from ..libs.service import Service
from ..mempool.mempool import TxMempool
from ..mempool.reactor import MempoolReactor, mempool_channel_descriptor
from ..p2p.peermanager import PeerManager, peer_manager_options
from ..p2p.router import Router, router_options
from ..p2p.transport import TCPTransport, Transport
from ..p2p.types import NodeInfo
from ..privval.file import FilePV
from ..state.execution import BlockExecutor
from ..state.indexer import IndexerService, KVSink, NullSink
from ..state.store import StateStore
from ..state.types import state_from_genesis
from ..store.block_store import BlockStore
from ..store.kv import open_db
from ..types.genesis import GenesisDoc
from . import device as device_plane
from .key import NodeKey

__all__ = ["Node", "acquire_pid_lock", "make_node", "release_pid_lock"]

# the instrumentation switches whose subsystems are ROADMAP item 11
_NOT_HONORED = ("trace_spans", "slo_exemplars", "consensus_timeline", "profiler", "profiler_labels")


class Node(Service):
    """A full node (validator or not), assembled from a Config
    (reference: node/node.go nodeImpl). Construction is synchronous;
    everything with an order of I/O (the proxy, the ABCI handshake, the
    reactors, the sync) happens in on_start."""

    def __init__(
        self,
        cfg: Config,
        genesis: GenesisDoc,
        app=None,
        transport: Optional[Transport] = None,
        device="cuda",
    ) -> None:
        super().__init__(name="node", logger=get_logger("tendermint_tpu_torch.node"))
        self.cfg = cfg
        self.genesis = genesis
        genesis.validate_and_complete()
        inst = cfg.instrumentation
        if inst.prometheus:
            raise NotImplementedError(
                "instrumentation.prometheus = true: the metrics server is "
                "ROADMAP item 11, not ported"
            )
        on = [k for k in _NOT_HONORED if getattr(inst, k)]
        if on:
            self.logger.info("instrumentation not yet honored (ROADMAP item 11)", on=",".join(on))

        # -- the device plane, first: every later check dispatches
        # through it. Its install is process-wide.
        self.device = device
        self._install_device_plane(cfg, device)

        # -- DBs and stores (reference: node/setup.go initDBs) --
        backend = cfg.base.db_backend
        db_dir = cfg.base.path(cfg.base.db_dir)
        self._dbs = []

        def _db(name: str):
            db = open_db(name, backend, db_dir)
            self._dbs.append(db)
            return db

        self.block_store = BlockStore(_db("blockstore"))
        self.state_store = StateStore(_db("state"))
        self._evidence_db = _db("evidence")

        # -- the proxy app (reference: internal/proxy) --
        if cfg.base.abci == "builtin":
            self._app = app if app is not None else KVStoreApplication()
            creator = local_creator(self._app)
        elif cfg.base.abci == "socket":
            self._app = None
            creator = socket_creator(cfg.base.proxy_app, must_connect=True)
        elif cfg.base.abci == "grpc":
            from ..abci.grpc_transport import grpc_creator

            self._app = None
            creator = grpc_creator(cfg.base.proxy_app, must_connect=True)
        else:
            raise ValueError(f"unknown abci mode {cfg.base.abci!r}")
        self.proxy = AppConns(creator)

        # -- the event bus and the indexer --
        self.event_bus = EventBus()
        sinks = []
        for kind in cfg.tx_index.indexer:
            if kind == "kv":
                sinks.append(KVSink(_db("tx_index")))
            elif kind == "null":
                sinks.append(NullSink())
            elif kind == "psql":
                from ..state.sink_sql import SQLSink

                dsn = cfg.tx_index.psql_conn or (
                    "sqlite:" + os.path.join(db_dir, "tx_index.sqlite")
                )
                sinks.append(SQLSink(dsn, chain_id=self.genesis.chain_id))
            else:
                raise ValueError(f"unknown indexer {kind!r}")
        self.indexer = IndexerService(sinks or [NullSink()], self.event_bus)

        # the node's identity key (also the remote signer's transport key)
        self.node_key = NodeKey.load_or_generate(cfg.base.path(cfg.base.node_key_file))

        # -- privval (reference: node/setup.go createPrivval) --
        self.privval = None
        self.privval_listener = None
        self.privval_pub_key = None
        if cfg.base.mode == MODE_VALIDATOR:
            addr = cfg.priv_validator.listen_addr
            if addr.startswith("grpc://"):
                # the node dials a gRPC signer (reference: node/setup.go:586),
                # under the socket path's retries; started and stopped as
                # privval_listener
                from ..privval.grpc import GRPCSignerClient
                from ..privval.signer import RetrySignerClient

                self.privval_listener = GRPCSignerClient(addr)
                self.privval = RetrySignerClient(self.privval_listener)
            elif addr:
                # the remote signer dials in (reference:
                # privval/signer_listener_endpoint.go)
                from ..privval.signer import RetrySignerClient, SignerListenerEndpoint

                self.privval_listener = SignerListenerEndpoint(addr, self.node_key.priv_key)
                self.privval = RetrySignerClient(self.privval_listener)
            else:
                self.privval = FilePV.load_or_generate(
                    cfg.base.path(cfg.priv_validator.key_file),
                    cfg.base.path(cfg.priv_validator.state_file),
                )

        # -- state --
        state = self.state_store.load()
        if state is None:
            state = state_from_genesis(genesis)
            self.state_store.save(state)
        self.initial_state = state

        # -- p2p (reference: node/setup.go createPeerManager, createRouter) --
        listen = cfg.p2p.laddr.replace("tcp://", "")
        advertise = (
            cfg.p2p.external_address.replace("tcp://", "")
            if cfg.p2p.external_address
            else listen
        )
        self.node_info = NodeInfo(
            node_id=self.node_key.node_id,
            listen_addr=advertise,
            network=genesis.chain_id,
            moniker=cfg.base.moniker,
        )
        self.peer_manager = PeerManager(
            self.node_key.node_id, peer_manager_options(cfg.p2p), store=_db("peerstore")
        )
        for addr in (a.strip() for a in cfg.p2p.bootstrap_peers.split(",")):
            if addr:
                self.peer_manager.add(addr)
        self.transport = transport if transport is not None else TCPTransport()
        self.router = Router(
            self.node_info,
            self.node_key.priv_key,
            self.peer_manager,
            self.transport,
            listen_addr=listen,
            options=router_options(cfg.p2p),
        )

        # built in on_start, after the ABCI handshake
        self.handshaker: Optional[Handshaker] = None
        self.mempool: Optional[TxMempool] = None
        self.evidence_pool: Optional[EvidencePool] = None
        self.block_exec: Optional[BlockExecutor] = None
        self.consensus: Optional[ConsensusState] = None
        self.consensus_reactor: Optional[ConsensusReactor] = None
        self.mempool_reactor: Optional[MempoolReactor] = None
        self.evidence_reactor: Optional[EvidenceReactor] = None
        self.blocksync_reactor = None
        self.statesync_reactor = None
        self.pex_reactor = None
        self.rpc_server = None
        self.rpc_env = None
        self.genesis_state_synced = False
        self._state_sync_task: Optional[asyncio.Task] = None

    def _install_device_plane(self, cfg: Config, device) -> None:
        """install_device_plane(cfg.gpu, device), unless this process
        already runs a plane of the same config on the same device."""
        prior = device_plane.installed_plane()
        want = (cfg.gpu, str(device))
        if cfg.gpu.enable:
            if prior == want:
                return
            if prior is not None:
                self.logger.info(
                    "device plane already installed with another [gpu] config; "
                    "overriding process-wide",
                    prior=prior, new=want,
                )
            device_plane.install_device_plane(cfg.gpu, device)
            self.logger.info(
                "device plane installed", device=str(device),
                min_batch=cfg.gpu.min_batch_size, devices=cfg.gpu.devices,
            )
        elif prior is not None:
            self.logger.info(
                "gpu.enable = false but another node installed the device plane "
                "process-wide; it stays active"
            )

    # ------------------------------------------------------------------

    async def on_start(self) -> None:
        """reference: node/node.go OnStart :415-470. A failed start tears
        down what it started (Service.stop() calls no on_stop after a
        failed start)."""
        self._acquire_data_lock()
        try:
            await self._start_impl()
        except BaseException:
            try:
                await self._teardown()
            except Exception as e:  # the start's own error is the one raised
                self.logger.error("error tearing down a failed start", err=str(e))
            raise

    def _acquire_data_lock(self) -> None:
        """The advisory data-dir lock: the offline commands (rollback,
        reset, reindex-event, key-migrate) refuse the DBs of a running
        node, and a second node process on the same home fails fast. A
        lock holding this process's pid is stale, so that an in-process
        restart takes it again."""
        data_dir = self.cfg.base.path(self.cfg.base.db_dir)
        self._lock_path = os.path.join(data_dir, "LOCK")
        self._lock_fd = acquire_pid_lock(self._lock_path, what=f"data dir {data_dir}")

    def _release_data_lock(self) -> None:
        fd = getattr(self, "_lock_fd", None)
        if fd is not None:
            release_pid_lock(self._lock_path, fd)
            self._lock_fd = None

    @property
    def data_locked(self) -> bool:
        return getattr(self, "_lock_fd", None) is not None

    async def _start_impl(self) -> None:
        cfg = self.cfg
        if cfg.base.mode == MODE_SEED:
            # a seed runs the router and PEX only (reference: node/seed.go)
            await self._start_seed()
            return
        await self.proxy.start()
        await self.event_bus.start()
        await self.indexer.start()
        if self.privval_listener is not None:
            await self.privval_listener.start()
        # with a remote signer this waits until the signer dials in
        self.privval_pub_key = None
        if self.privval is not None:
            self.privval_pub_key = await self.privval.get_pub_key()

        # the ABCI handshake: replay stored blocks into the app until app,
        # store and state agree (reference: replay.go:240)
        self.handshaker = Handshaker(
            self.state_store,
            self.initial_state,
            self.block_store,
            self.genesis,
            event_bus=self.event_bus,
        )
        await self.handshaker.handshake(self.proxy.consensus)
        state = self.state_store.load()
        assert state is not None

        # -- the reactors, against the post-handshake state --
        self.mempool = TxMempool(self.proxy.mempool, cfg.mempool, height=state.last_block_height)
        self.evidence_pool = EvidencePool(self._evidence_db, self.state_store, self.block_store)
        self.block_exec = BlockExecutor(
            self.state_store,
            self.proxy.consensus,
            self.mempool,
            evidence_pool=self.evidence_pool,
            block_store=self.block_store,
            event_bus=self.event_bus,
        )
        self.consensus = ConsensusState(
            cfg.consensus,
            state,
            self.block_exec,
            self.block_store,
            privval=self.privval,
            event_bus=self.event_bus,
            wal=WAL(cfg.base.path(cfg.consensus.wal_file)),
            evidence_pool=self.evidence_pool,
        )

        # the sync flags (reference: node/node.go:230; onlyValidatorIsUs
        # skips block sync)
        state_sync = cfg.statesync.enable and state.last_block_height == 0
        block_sync = cfg.blocksync.enable and not self._only_validator_is_us(state)
        wait_sync = state_sync or block_sync

        cs_channels = {
            cid: self.router.open_channel(d)
            for cid, d in consensus_channel_descriptors().items()
        }
        self.consensus_reactor = ConsensusReactor(
            self.consensus,
            cs_channels,
            self.peer_manager.subscribe(),
            self.event_bus,
            cfg=cfg.consensus,
            wait_sync=wait_sync,
        )
        # the Byzantine plane: a disarmed process (TM_TPU_BYZ unset)
        # installs nothing
        from ..consensus import byzantine

        if byzantine.armed():
            byzantine.maybe_install(self.consensus, self.consensus_reactor, cfg.base.moniker)
        self.mempool_reactor = MempoolReactor(
            self.mempool,
            self.router.open_channel(mempool_channel_descriptor()),
            self.peer_manager.subscribe(),
        )
        self.evidence_reactor = EvidenceReactor(
            self.evidence_pool,
            self.router.open_channel(evidence_channel_descriptor()),
            self.peer_manager.subscribe(),
        )
        from ..blocksync import BlocksyncReactor, blocksync_channel_descriptor

        self.blocksync_reactor = BlocksyncReactor(
            state,
            self.block_exec,
            self.block_store,
            self.router.open_channel(blocksync_channel_descriptor()),
            self.peer_manager.subscribe(),
            block_sync=block_sync and not state_sync,
            consensus_reactor=self.consensus_reactor,
            event_bus=self.event_bus,
        )
        from ..statesync import StatesyncReactor, statesync_channel_descriptors

        self.statesync_reactor = StatesyncReactor(
            self.genesis.chain_id,
            state,
            self.proxy.snapshot,
            self.state_store,
            self.block_store,
            {cid: self.router.open_channel(d) for cid, d in statesync_channel_descriptors().items()},
            self.peer_manager.subscribe(),
            cfg=cfg.statesync,
        )
        if cfg.p2p.pex:
            from ..p2p.pex import PexReactor, pex_channel_descriptor

            self.pex_reactor = PexReactor(
                self.peer_manager,
                self.router.open_channel(pex_channel_descriptor()),
                self.peer_manager.subscribe(),
            )

        # -- start them (the channels are open: safe to listen) --
        await self.router.start()
        await self.consensus_reactor.start()
        await self.mempool_reactor.start()
        await self.evidence_reactor.start()
        await self.blocksync_reactor.start()
        await self.statesync_reactor.start()
        if self.pex_reactor is not None:
            await self.pex_reactor.start()

        # -- RPC (reference: node/node.go:480-540). The Environment
        # always exists, for in-process clients; the server only with a
        # listen address --
        from ..rpc import Environment, RPCServer

        self.rpc_env = Environment(
            chain_id=self.genesis.chain_id,
            block_store=self.block_store,
            state_store=self.state_store,
            mempool=self.mempool,
            event_bus=self.event_bus,
            consensus=self.consensus,
            consensus_reactor=self.consensus_reactor,
            peer_manager=self.peer_manager,
            proxy=self.proxy,
            genesis=self.genesis,
            evidence_pool=self.evidence_pool,
            event_sinks=self.indexer.sinks,
            node_info=self.node_info,
            privval_pub_key=self.privval_pub_key,
            cfg=cfg,
        )
        if cfg.rpc.laddr:
            self.rpc_server = RPCServer(
                self.rpc_env, laddr=cfg.rpc.laddr, max_body_bytes=cfg.rpc.max_body_bytes
            )
            await self.rpc_server.start()

        if state_sync:
            # the node's own task: an error that ends it is raised by
            # failure() and stop()
            self._state_sync_task = asyncio.get_running_loop().create_task(
                self._state_sync_then_follow()
            )

        self.logger.info(
            "node started",
            node_id=self.node_key.node_id,
            chain_id=self.genesis.chain_id,
            mode=cfg.base.mode,
            gpu=f"installed on {self.device}" if cfg.gpu.enable else "disabled",
        )

    async def _start_seed(self) -> None:
        """A seed: the router and PEX only (reference: node/seed.go)."""
        from ..p2p.pex import PexReactor, pex_channel_descriptor

        self.pex_reactor = PexReactor(
            self.peer_manager,
            self.router.open_channel(pex_channel_descriptor()),
            self.peer_manager.subscribe(),
        )
        await self.router.start()
        await self.pex_reactor.start()
        self.logger.info("seed node started", node_id=self.node_key.node_id)

    async def _state_sync_then_follow(self) -> None:
        """State sync, then block sync, then consensus (reference:
        node/node.go:592 startStateSync, then SwitchToBlockSync)."""
        from ..types import events as E

        state = await self.statesync_reactor.sync()
        await self.statesync_reactor.backfill(state)
        self.genesis_state_synced = True
        self.event_bus.publish_state_sync_status(
            E.EventDataStateSyncStatus(complete=True, height=state.last_block_height)
        )
        await self.blocksync_reactor.start_sync(state)

    def _only_validator_is_us(self, state) -> bool:
        """reference: node/node.go:230 onlyValidatorIsUs."""
        if self.privval_pub_key is None:
            return False
        if state.validators.size() != 1:
            return False
        return state.validators.validators[0].address == self.privval_pub_key.address()

    def failure(self) -> Optional[BaseException]:
        """The first error that ended a part of the running node (the
        state sync task, block sync's pool routine, the step machine's
        receive loop, the evidence reactor's receive loop, an RPC route),
        or None."""
        task = self._state_sync_task
        if task is not None and task.done() and not task.cancelled() and task.exception():
            return task.exception()
        for part in (self.blocksync_reactor, self.consensus, self.evidence_reactor, self.rpc_server):
            err = part.failure() if part is not None else None
            if err is not None:
                return err
        return None

    async def on_stop(self) -> None:
        """reference: node/node.go OnStop: the reverse of the start."""
        await self._teardown()

    async def _teardown(self) -> None:
        errors = []
        task, self._state_sync_task = self._state_sync_task, None
        if task is not None:
            if not task.done():
                task.cancel()
            try:
                await task
            except asyncio.CancelledError:
                pass
            except Exception as e:  # raised below, once every part is down
                errors.append(e)
        for svc in (
            self.rpc_server,
            self.pex_reactor,
            self.statesync_reactor,
            self.blocksync_reactor,
            self.evidence_reactor,
            self.mempool_reactor,
            self.consensus_reactor,
            self.consensus,
            self.router,
            self.privval_listener,
            self.indexer,
            self.event_bus,
            self.proxy,
        ):
            if svc is not None and svc.is_running:
                try:
                    await svc.stop()
                except Exception as e:  # raised below, once every part is down
                    self.logger.error("error stopping service", svc=svc.name, err=str(e))
                    errors.append(e)
        self.peer_manager.flush()
        for sink in getattr(self.indexer, "sinks", ()):
            close = getattr(sink, "close", None)
            if close is not None:
                close()
        for db in self._dbs:
            db.close()
        self._dbs = []
        self._release_data_lock()
        if errors:
            raise errors[0]


def _read_lock_pid(path: str) -> int:
    try:
        with open(path) as f:
            return int(f.read().strip() or 0)
    except (OSError, ValueError):
        return 0


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except OSError:
        return False
    return True


def acquire_pid_lock(path: str, what: str = "") -> int:
    """Claim the advisory lock file at `path`; returns an fd to keep open
    while held and to pass to release_pid_lock().

    flock() on the held fd is the claim: two processes starting at once
    cannot both succeed, the kernel drops the lock when its holder dies,
    and a reused pid cannot fake a live holder. The pid in the file names
    the holder in the error, and a live pid of another process written
    there without the flock still refuses. This process's own pid is
    fine: an in-process restart takes the lock again."""
    import fcntl

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fd = os.open(path, os.O_CREAT | os.O_RDWR, 0o644)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
    except OSError:
        pid = _read_lock_pid(path)
        os.close(fd)
        holder = f"process {pid}" if pid else "another process"
        raise RuntimeError(f"{what or path} is locked by running {holder}") from None
    pid = _read_lock_pid(path)
    if pid and pid != os.getpid() and _pid_alive(pid):
        fcntl.flock(fd, fcntl.LOCK_UN)
        os.close(fd)
        raise RuntimeError(f"{what or path} is locked by running process {pid}")
    os.ftruncate(fd, 0)
    os.write(fd, str(os.getpid()).encode())
    return fd


def release_pid_lock(path: str, fd: int) -> None:
    """Empty the pid file and drop the flock. The file stays: unlinking
    a locked path would let a third process lock a fresh inode while a
    second still holds the old one."""
    import fcntl

    try:
        os.ftruncate(fd, 0)
        fcntl.flock(fd, fcntl.LOCK_UN)
    except OSError:
        pass
    finally:
        try:
            os.close(fd)
        except OSError:
            pass


def make_node(
    cfg: Config,
    app=None,
    genesis: Optional[GenesisDoc] = None,
    transport: Optional[Transport] = None,
    device="cuda",
) -> Node:
    """A Node from the config files on disk (reference:
    node/node.go:116 makeNode, node/public.go New). `app` replaces the
    builtin kvstore app; `genesis` and `transport` serve tests and
    in-process harnesses; `device` is where the device plane runs
    ("cuda"; the tests pass "cpu")."""
    cfg.ensure_dirs()
    if genesis is None:
        genesis = GenesisDoc.from_file(cfg.base.path(cfg.base.genesis_file))
    return Node(cfg, genesis, app=app, transport=transport, device=device)
