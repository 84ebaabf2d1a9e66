"""The ABCI handshake: bring the application level with the stores at
start.

Counterpart: tendermint_tpu/consensus/replay.py:43-360: HandshakeError
(:43), _MockReplayClient (:47-97), Handshaker (:100-360) with handshake
(:119) and every case of replay_blocks (:144-237); reference:
internal/consensus/replay.go:240-544, replay_stubs.go.

At a restart the app may be behind the block store (a crash before
Commit), or the state one height behind it (a crash between SaveBlock
and the state's save). The handshake asks the app its height (Info) and
replays stored blocks into it until app, store and state agree. Blocks
the state already holds go to the app alone (_exec_commit_block, which
checks nothing); the one height the state lacks goes through a full
BlockExecutor.apply_block (_replay_block), which verifies the block's
LastCommit with verify_commit, on the card when the device plane is
installed. Nothing here catches: a failed launch raises to node start,
and a DeviceFault is contained inside the verifier (the fault policy,
crypto/gpu_verifier.py).
"""

from __future__ import annotations

from typing import Optional

from ..abci import types as abci
from ..abci.client import ABCIClient
from ..abci.codec import dec_resp_begin_block, dec_resp_deliver_tx, dec_resp_end_block
from ..crypto.merkle import hash_from_byte_slices
from ..eventbus import EventBus
from ..libs.log import get_logger
from ..mempool.nop import NopMempool
from ..state.execution import BlockExecutor, build_last_commit_info, validator_updates_from_abci
from ..state.store import StateStore
from ..state.types import State
from ..store.block_store import BlockStore
from ..types.block import Block
from ..types.genesis import GenesisDoc
from ..types.validator import ValidatorSet

__all__ = ["Handshaker", "HandshakeError"]


class HandshakeError(Exception):
    pass


class _MockReplayClient:
    """An ABCI client that answers with the responses recorded for a
    height, for the case "Commit ran, the state was not saved"
    (reference: replay_stubs.go:57-95 newMockProxyApp)."""

    def __init__(self, app_hash: bytes, abci_responses) -> None:
        self._app_hash = app_hash
        self._deliver = [
            dec_resp_deliver_tx(b) for b in abci_responses.deliver_txs
        ]
        self._end_block = (
            dec_resp_end_block(abci_responses.end_block)
            if abci_responses.end_block
            else abci.ResponseEndBlock()
        )
        # the recorded BeginBlock too: apply_block saves the responses it
        # sees again, and an empty one would replace the height's events
        self._begin_block = (
            dec_resp_begin_block(abci_responses.begin_block)
            if abci_responses.begin_block
            else abci.ResponseBeginBlock()
        )
        self._i = 0

    async def begin_block(self, req) -> abci.ResponseBeginBlock:
        return self._begin_block

    async def deliver_tx(self, req) -> abci.ResponseDeliverTx:
        r = self._deliver[self._i]
        self._i += 1
        return r

    async def end_block(self, req) -> abci.ResponseEndBlock:
        return self._end_block

    async def commit(self) -> abci.ResponseCommit:
        return abci.ResponseCommit(data=self._app_hash)

    async def flush(self) -> None: ...

    # unused surface
    async def echo(self, msg: str): ...
    async def info(self, req): ...
    async def init_chain(self, req): ...
    async def query(self, req): ...
    async def check_tx(self, req): ...
    async def list_snapshots(self, req): ...
    async def offer_snapshot(self, req): ...
    async def load_snapshot_chunk(self, req): ...
    async def apply_snapshot_chunk(self, req): ...


class Handshaker:
    """reference: internal/consensus/replay.go:214-281."""

    def __init__(
        self,
        state_store: StateStore,
        state: State,
        block_store: BlockStore,
        genesis: GenesisDoc,
        event_bus: Optional[EventBus] = None,
    ) -> None:
        self.state_store = state_store
        self.initial_state = state
        self.block_store = block_store
        self.genesis = genesis
        self.event_bus = event_bus
        self.logger = get_logger("consensus.handshaker")
        self.n_blocks = 0  # blocks replayed into the app

    async def handshake(self, app_client: ABCIClient) -> bytes:
        """Info → ReplayBlocks; returns the app hash both sides agree on
        (reference: replay.go:240-281)."""
        res = await app_client.info(abci.RequestInfo(version="tpu"))
        block_height = res.last_block_height
        if block_height < 0:
            raise HandshakeError(
                f"got negative last block height {block_height} from app"
            )
        app_hash = res.last_block_app_hash
        self.logger.info(
            "ABCI handshake",
            app_height=block_height,
            app_hash=app_hash.hex()[:16],
        )
        app_hash = await self.replay_blocks(
            self.initial_state, app_hash, block_height, app_client
        )
        self.logger.info(
            "completed ABCI handshake",
            app_height=block_height,
            replayed=self.n_blocks,
        )
        return app_hash

    async def replay_blocks(
        self,
        state: State,
        app_hash: bytes,
        app_block_height: int,
        app_client: ABCIClient,
    ) -> bytes:
        """The decision table over (app, store, state) heights
        (reference: replay.go:283-445)."""
        store_base = self.block_store.base()
        store_height = self.block_store.height()
        state_height = state.last_block_height
        self.logger.info(
            "ABCI replay blocks",
            app_height=app_block_height,
            store_height=store_height,
            state_height=state_height,
        )

        # Genesis: send InitChain
        if app_block_height == 0:
            res = await app_client.init_chain(self._init_chain_request())
            app_hash = res.app_hash
            if state_height == 0:
                state = self._apply_init_chain_response(state, res)
                self.state_store.save(state)
                self.initial_state = state

        if store_height == 0:
            return app_hash
        if app_block_height == 0 and state.initial_height < store_base:
            raise HandshakeError(
                f"app has no state; block store is pruned above initial "
                f"height (base {store_base})"
            )
        if 0 < app_block_height < store_base - 1:
            raise HandshakeError(
                f"app height {app_block_height} is too far below store "
                f"base {store_base}"
            )
        if store_height < app_block_height:
            raise HandshakeError(
                f"app height {app_block_height} ahead of store "
                f"{store_height}"
            )
        if store_height < state_height:
            raise RuntimeError(
                f"state height {state_height} > store height {store_height}"
            )
        if store_height > state_height + 1:
            raise RuntimeError(
                f"store height {store_height} > state height + 1 "
                f"({state_height + 1})"
            )

        if store_height == state_height:
            # Commit ran and state saved: app replay only, no state change
            if app_block_height < store_height:
                return await self._replay_blocks_into_app(
                    state, app_client, app_block_height, store_height,
                    mutate_state=False,
                )
            return app_hash  # all synced

        # store == state + 1: block saved, state not updated
        if app_block_height < state_height:
            return await self._replay_blocks_into_app(
                state, app_client, app_block_height, store_height,
                mutate_state=True,
            )
        if app_block_height == state_height:
            # Commit never ran: replay final block with the real app
            self.logger.info("replaying last block with real app")
            new_state = await self._replay_block(
                state, store_height, app_client
            )
            return new_state.app_hash
        if app_block_height == store_height:
            # Commit ran but state save didn't: mock app from saved responses
            responses = self.state_store.load_abci_responses(store_height)
            if responses is None:
                raise HandshakeError(
                    f"no saved ABCI responses for height {store_height}"
                )
            self.logger.info("replaying last block with mock app")
            mock = _MockReplayClient(app_hash, responses)
            new_state = await self._replay_block(state, store_height, mock)
            return new_state.app_hash
        raise RuntimeError(
            f"uncovered handshake case: app={app_block_height} "
            f"store={store_height} state={state_height}"
        )

    # -- helpers --

    def _init_chain_request(self) -> abci.RequestInitChain:
        updates = tuple(
            abci.ValidatorUpdate(
                pub_key=abci.PubKey(
                    key_type=gv.pub_key.type(), data=gv.pub_key.bytes()
                ),
                power=gv.power,
            )
            for gv in self.genesis.validators
        )
        return abci.RequestInitChain(
            time_ns=self.genesis.genesis_time_ns,
            chain_id=self.genesis.chain_id,
            consensus_params=None,
            validators=updates,
            app_state_bytes=self.genesis.app_state,
            initial_height=self.genesis.initial_height,
        )

    def _apply_init_chain_response(
        self, state: State, res: abci.ResponseInitChain
    ) -> State:
        """reference: replay.go:330-355."""
        state = state.copy()
        if res.app_hash:
            state.app_hash = res.app_hash
        if res.validators:
            vals = validator_updates_from_abci(res.validators)
            state.validators = ValidatorSet(vals)
            nxt = ValidatorSet(vals)
            nxt.increment_proposer_priority(1)
            state.next_validators = nxt
        elif not self.genesis.validators:
            raise HandshakeError(
                "validator set is nil in genesis and still empty after "
                "InitChain"
            )
        if res.consensus_params is not None:
            state.consensus_params = state.consensus_params.update(
                res.consensus_params
            )
            state.app_version = state.consensus_params.version.app_version
        state.last_results_hash = hash_from_byte_slices([])
        return state

    async def _replay_blocks_into_app(
        self,
        state: State,
        app_client: ABCIClient,
        app_block_height: int,
        store_height: int,
        mutate_state: bool,
    ) -> bytes:
        """Replay blocks app_height+1..store_height into the app without
        touching consensus state; if mutate_state, the final block goes
        through full ApplyBlock (reference: replay.go:447-520)."""
        app_hash = b""
        final_block = store_height - 1 if mutate_state else store_height
        first_block = app_block_height + 1
        if first_block == 1:
            first_block = state.initial_height
        for height in range(first_block, final_block + 1):
            self.logger.info("applying block against app", height=height)
            block = self.block_store.load_block(height)
            app_hash = await self._exec_commit_block(
                app_client, block, state.initial_height
            )
            self.n_blocks += 1
        if mutate_state:
            new_state = await self._replay_block(
                state, store_height, app_client
            )
            app_hash = new_state.app_hash
        return app_hash

    async def _exec_commit_block(
        self, client: ABCIClient, block: Block, initial_height: int
    ) -> bytes:
        """BeginBlock → DeliverTx×N → EndBlock → Commit without state
        bookkeeping (reference: internal/state/execution.go
        ExecCommitBlock)."""
        commit_info = self._last_commit_info(block, initial_height)
        await client.begin_block(
            abci.RequestBeginBlock(
                hash=block.hash(),
                header_bytes=block.header.to_proto(),
                last_commit_info=commit_info,
            )
        )
        for tx in block.txs:
            await client.deliver_tx(abci.RequestDeliverTx(tx=tx))
        await client.end_block(
            abci.RequestEndBlock(height=block.header.height)
        )
        res = await client.commit()
        return res.data

    def _last_commit_info(
        self, block: Block, initial_height: int
    ) -> abci.LastCommitInfo:
        vals = self.state_store.load_validators(block.header.height - 1)
        return build_last_commit_info(block, vals, initial_height)

    async def _replay_block(
        self, state: State, height: int, client: ABCIClient
    ) -> State:
        """Full ApplyBlock of the stored block at `height`
        (reference: replay.go:522-544)."""
        block = self.block_store.load_block(height)
        meta = self.block_store.load_block_meta(height)
        block_exec = BlockExecutor(
            self.state_store,
            client,
            NopMempool(),
            block_store=self.block_store,
            event_bus=self.event_bus,
        )
        new_state = await block_exec.apply_block(
            state, meta.block_id, block
        )
        self.n_blocks += 1
        return new_state
