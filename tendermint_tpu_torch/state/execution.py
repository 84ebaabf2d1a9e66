"""BlockExecutor: proposal creation, validation and block application.

Counterpart: tendermint_tpu/state/execution.py:1-534:
build_last_commit_info (:53), results_hash (:97), the validator-update
checks (:105-130), EmptyEvidencePool (:133), validate_block (:147),
BlockExecutor (:227) with create_proposal_block, apply_block, _exec_block
(:339), _commit (:416) and _fire_events (:440), and update_state (:487);
reference: internal/state/execution.go and validation.go:14.

validate_block checks the LastCommit with one
types.validation.verify_commit, so with the device plane installed a
block's LastCommit runs on the card (kernels X1 and K2 for ed25519, X3
for sr25519); its data, LastCommit, validator-set and results roots, and
the kvstore app's hash, go to kernel X4 at 512 leaves or more. With an
event bus, apply_block publishes the new block, its header, its evidence
and every transaction, as the JAX package does. apply_block observes its
wall time, failed blocks included, in the StateMetrics struct's
block_processing_seconds (:238-246, :284). Left out: the block_execute
trace span (ROADMAP item 11b).
"""

from __future__ import annotations

import logging
from typing import List, Optional, Sequence, Tuple

from ..abci import types as abci
from ..abci.client import ABCIClient
from ..abci.codec import enc_resp_begin_block, enc_resp_deliver_tx, enc_resp_end_block
from ..eventbus import EventBus
from ..crypto.keys import pubkey_from_type_and_bytes
from ..crypto.merkle import hash_from_byte_slices
from ..encoding.proto import ProtoWriter
from ..mempool.types import Mempool
from ..types.block import Block, max_data_bytes
from ..types.block_id import BlockID
from ..types.commit import BLOCK_ID_FLAG_ABSENT, Commit
from ..types.evidence import (
    DuplicateVoteEvidence,
    Evidence,
    LightClientAttackEvidence,
)
from ..types import events as E
from ..types.header import BLOCK_PROTOCOL
from ..types.tx import tx_hash
from ..types.validation import verify_commit
from ..types.validator import Validator, ValidatorSet
from .metrics import StateMetrics
from .store import ABCIResponses, StateStore
from .types import State, median_time

__all__ = [
    "BlockExecutor",
    "EmptyEvidencePool",
    "build_last_commit_info",
    "results_hash",
    "update_state",
    "validate_block",
    "validator_updates_from_abci",
]

_log = logging.getLogger(__name__)


def build_last_commit_info(
    block: Block, last_vals: "ValidatorSet | None", initial_height: int
) -> abci.LastCommitInfo:
    """ABCI LastCommitInfo from a block's LastCommit and the validator set
    of the previous height; None last_vals (pruned history) yields votes=()
    (reference: internal/state/execution.go getBeginBlockValidatorInfo).
    Shared by BlockExecutor and the handshake replay path."""
    if block.header.height == initial_height:
        return abci.LastCommitInfo()
    if last_vals is None:
        return abci.LastCommitInfo(round=block.last_commit.round)
    votes = []
    for i, v in enumerate(last_vals.validators):
        sig = (
            block.last_commit.signatures[i]
            if i < len(block.last_commit.signatures)
            else None
        )
        signed = sig is not None and sig.block_id_flag != BLOCK_ID_FLAG_ABSENT
        votes.append(
            abci.VoteInfo(
                validator=abci.Validator(
                    address=v.address, power=v.voting_power
                ),
                signed_last_block=signed,
            )
        )
    return abci.LastCommitInfo(
        round=block.last_commit.round, votes=tuple(votes)
    )


def _deterministic_deliver_tx(r: abci.ResponseDeliverTx) -> bytes:
    """Deterministic subset of a DeliverTx result — only consensus-relevant
    fields (reference: abci/types/result.go deterministicResponseDeliverTx:
    code, data, gas_wanted, gas_used)."""
    w = ProtoWriter()
    w.uint(1, r.code)
    w.bytes(2, r.data)
    w.int(5, r.gas_wanted)
    w.int(6, r.gas_used)
    return w.finish()


def results_hash(responses: Sequence[abci.ResponseDeliverTx]) -> bytes:
    """Merkle root of deterministic DeliverTx results
    (reference: types/results.go ABCIResults.Hash)."""
    return hash_from_byte_slices(
        [_deterministic_deliver_tx(r) for r in responses]
    )


def validator_updates_from_abci(
    updates: Sequence[abci.ValidatorUpdate],
) -> List[Validator]:
    """ABCI pubkey/power pairs → domain validators
    (reference: types/protobuf.go PB2TM.ValidatorUpdates)."""
    out = []
    for vu in updates:
        pk = pubkey_from_type_and_bytes(vu.pub_key.key_type, vu.pub_key.data)
        out.append(Validator(address=pk.address(), pub_key=pk, voting_power=vu.power))
    return out


def validate_validator_updates(
    updates: Sequence[abci.ValidatorUpdate], params
) -> None:
    """reference: internal/state/execution.go:378-400."""
    for vu in updates:
        if vu.power < 0:
            raise ValueError(f"voting power can't be negative: {vu}")
        if vu.power == 0:
            continue
        if not params.validator.is_valid_pubkey_type(vu.pub_key.key_type):
            raise ValueError(
                f"validator {vu} is using pubkey {vu.pub_key.key_type}, "
                "which is unsupported for consensus"
            )


class EmptyEvidencePool:
    """No-op pool for nodes without the evidence subsystem wired
    (reference: internal/state/services.go EmptyEvidencePool)."""

    def pending_evidence(self, max_bytes: int) -> Tuple[List[Evidence], int]:
        return [], 0

    def add_evidence(self, ev: Evidence) -> None: ...

    def update(self, state: State, evidence: List[Evidence]) -> None: ...

    def check_evidence(self, evidence: List[Evidence]) -> None: ...


def validate_block(state: State, block: Block) -> None:
    """Header wiring against the state (reference:
    internal/state/validation.go:14), and the LastCommit's signatures in
    one verify_commit: the device batch path when the plane is
    installed."""
    block.validate_basic()
    h = block.header
    if h.version.block != BLOCK_PROTOCOL or h.version.app != state.app_version:
        raise ValueError(
            f"wrong Block.Header.Version: got {h.version}, "
            f"expected block={BLOCK_PROTOCOL} app={state.app_version}"
        )
    if h.chain_id != state.chain_id:
        raise ValueError(
            f"wrong Block.Header.ChainID: got {h.chain_id!r}, "
            f"expected {state.chain_id!r}"
        )
    if state.last_block_height == 0 and h.height != state.initial_height:
        raise ValueError(
            f"wrong Block.Header.Height: got {h.height}, expected initial "
            f"height {state.initial_height}"
        )
    if state.last_block_height > 0 and h.height != state.last_block_height + 1:
        raise ValueError(
            f"wrong Block.Header.Height: got {h.height}, "
            f"expected {state.last_block_height + 1}"
        )
    if h.last_block_id != state.last_block_id:
        raise ValueError(
            f"wrong Block.Header.LastBlockID: got {h.last_block_id}, "
            f"expected {state.last_block_id}"
        )
    if h.app_hash != state.app_hash:
        raise ValueError(
            f"wrong Block.Header.AppHash: got {h.app_hash.hex()}, "
            f"expected {state.app_hash.hex()}"
        )
    if h.consensus_hash != state.consensus_params.hash():
        raise ValueError("wrong Block.Header.ConsensusHash")
    if h.last_results_hash != state.last_results_hash:
        raise ValueError("wrong Block.Header.LastResultsHash")
    if h.validators_hash != state.validators.hash():
        raise ValueError("wrong Block.Header.ValidatorsHash")
    if h.next_validators_hash != state.next_validators.hash():
        raise ValueError("wrong Block.Header.NextValidatorsHash")

    # LastCommit
    if block.header.height == state.initial_height:
        if len(block.last_commit.signatures) != 0:
            raise ValueError("initial block can't have LastCommit signatures")
    else:
        # The whole previous commit in one batched device call.
        verify_commit(
            state.chain_id,
            state.last_validators,
            state.last_block_id,
            h.height - 1,
            block.last_commit,
        )

    if not state.validators.has_address(h.proposer_address):
        raise ValueError(
            f"block proposer {h.proposer_address.hex()} is not a validator"
        )

    # Evidence size cap (contents validated by the evidence pool)
    max_ev_bytes = state.consensus_params.evidence.max_bytes
    ev_bytes = sum(len(ev.bytes()) for ev in block.evidence)
    if ev_bytes > max_ev_bytes:
        raise ValueError(
            f"evidence bytes {ev_bytes} exceed max {max_ev_bytes}"
        )

    if h.height > state.initial_height:
        if h.time_ns != median_time(block.last_commit, state.last_validators):
            raise ValueError("invalid block time (not median of last commit)")
    elif h.time_ns != state.last_block_time_ns:
        raise ValueError("block time != genesis time for initial block")


class BlockExecutor:
    """reference: internal/state/execution.go:53-100. `metrics` is a
    StateMetrics (DEFAULT_REGISTRY's unless given)."""

    def __init__(
        self,
        state_store: StateStore,
        app_conn: ABCIClient,
        mempool: Mempool,
        evidence_pool=None,
        block_store=None,
        event_bus: Optional[EventBus] = None,
        metrics: Optional[StateMetrics] = None,
    ) -> None:
        self.store = state_store
        self.metrics = metrics if metrics is not None else StateMetrics()
        self.app = app_conn
        self.mempool = mempool
        self.evpool = evidence_pool or EmptyEvidencePool()
        self.block_store = block_store
        self.event_bus = event_bus
        self.logger = _log

    # -- proposal --

    def create_proposal_block(
        self, height: int, state: State, commit: Commit, proposer_addr: bytes
    ):
        """Reap mempool + evidence into a new block
        (reference: internal/state/execution.go:102-123)."""
        max_bytes = state.consensus_params.block.max_bytes
        max_gas = state.consensus_params.block.max_gas
        evidence, ev_size = self.evpool.pending_evidence(
            state.consensus_params.evidence.max_bytes
        )
        data_cap = max_data_bytes(
            max_bytes, ev_size, len(state.validators)
        )
        txs = self.mempool.reap_max_bytes_max_gas(data_cap, max_gas)
        return state.make_block(height, txs, commit, evidence, proposer_addr)

    # -- validation --

    def validate_block(self, state: State, block: Block) -> None:
        validate_block(state, block)
        self.evpool.check_evidence(list(block.evidence))

    # -- application --

    async def apply_block(
        self, state: State, block_id: BlockID, block: Block
    ) -> State:
        """Validate, execute against the app, update state, commit
        (reference: internal/state/execution.go:151-237). A block that
        fails validation raises before the app sees it, and the store
        is left as it was."""
        with self.metrics.block_processing.time():
            return await self._apply_block_timed(state, block_id, block)

    async def _apply_block_timed(
        self, state: State, block_id: BlockID, block: Block
    ) -> State:
        self.validate_block(state, block)

        responses = await self._exec_block(state, block)

        self.store.save_abci_responses(block.header.height, responses)

        end_block = responses.end_block_obj
        validate_validator_updates(
            end_block.validator_updates, state.consensus_params
        )
        validator_updates = validator_updates_from_abci(
            end_block.validator_updates
        )
        if validator_updates:
            self.logger.info(
                "updates to validators: %s",
                ",".join(
                    f"{v.address.hex()[:12]}:{v.voting_power}"
                    for v in validator_updates
                ),
            )

        new_state = update_state(
            state, block_id, block, responses, validator_updates
        )

        # Lock mempool, commit app state, update mempool
        app_hash, retain_height = await self._commit(new_state, block, responses)
        new_state.app_hash = app_hash

        self.evpool.update(new_state, list(block.evidence))

        self.store.save(new_state)

        if retain_height > 0 and self.block_store is not None:
            try:
                pruned = self.block_store.prune_blocks(retain_height)
                self.logger.info(
                    "pruned blocks: %d, retain height %d", pruned, retain_height
                )
            except Exception as e:
                self.logger.error("failed to prune blocks: %s", e)

        self._fire_events(block, block_id, responses, validator_updates)
        return new_state

    async def _exec_block(self, state: State, block: Block) -> ABCIResponses:
        """BeginBlock → DeliverTx×N → EndBlock
        (reference: internal/state/execution.go:290-352)."""
        commit_info = self._begin_block_commit_info(state, block)
        byz = self._begin_block_evidence(state, block)
        begin = await self.app.begin_block(
            abci.RequestBeginBlock(
                hash=block.hash(),
                header_bytes=block.header.to_proto(),
                last_commit_info=commit_info,
                byzantine_validators=byz,
            )
        )
        deliver_txs: List[abci.ResponseDeliverTx] = []
        for txb in block.txs:
            r = await self.app.deliver_tx(abci.RequestDeliverTx(tx=txb))
            if not r.is_ok:
                self.logger.debug("invalid tx: code %d, %s", r.code, r.log)
            deliver_txs.append(r)
        end = await self.app.end_block(
            abci.RequestEndBlock(height=block.header.height)
        )
        resp = ABCIResponses(
            deliver_txs=[enc_resp_deliver_tx(r) for r in deliver_txs],
            end_block=enc_resp_end_block(end),
            begin_block=enc_resp_begin_block(begin),
        )
        # keep the objects for the state update
        resp.deliver_tx_objs = deliver_txs
        resp.end_block_obj = end
        resp.begin_block_obj = begin
        return resp

    def _begin_block_commit_info(
        self, state: State, block: Block
    ) -> abci.LastCommitInfo:
        """reference: internal/state/execution.go getBeginBlockValidatorInfo."""
        last_vals = self.store.load_validators(block.header.height - 1)
        if last_vals is None:
            last_vals = state.last_validators
        return build_last_commit_info(block, last_vals, state.initial_height)

    def _begin_block_evidence(
        self, state: State, block: Block
    ) -> tuple:
        out = []
        for ev in block.evidence:
            if isinstance(ev, DuplicateVoteEvidence):
                out.append(
                    abci.Misbehavior(
                        kind=abci.MISBEHAVIOR_DUPLICATE_VOTE,
                        validator=abci.Validator(
                            address=ev.vote_a.validator_address,
                            power=ev.validator_power,
                        ),
                        height=ev.height(),
                        time_ns=ev.timestamp_ns,
                        total_voting_power=ev.total_voting_power,
                    )
                )
            elif isinstance(ev, LightClientAttackEvidence):
                for v in ev.byzantine_validators:
                    out.append(
                        abci.Misbehavior(
                            kind=abci.MISBEHAVIOR_LIGHT_CLIENT_ATTACK,
                            validator=abci.Validator(
                                address=v.address, power=v.voting_power
                            ),
                            height=ev.height(),
                            time_ns=ev.timestamp_ns,
                            total_voting_power=ev.total_voting_power,
                        )
                    )
        return tuple(out)

    async def _commit(
        self, state: State, block: Block, responses: ABCIResponses
    ) -> Tuple[bytes, int]:
        """Mempool-locked ABCI Commit + mempool Update
        (reference: internal/state/execution.go:240-283)."""
        await self.mempool.lock()
        try:
            await self.mempool.flush_app_conn()
            res = await self.app.commit()
            self.logger.info(
                "committed state: height %d, %d txs, app hash %s",
                block.header.height,
                len(block.txs),
                res.data.hex()[:16],
            )
            await self.mempool.update(
                block.header.height,
                list(block.txs),
                responses.deliver_tx_objs,
            )
            return res.data, res.retain_height
        finally:
            self.mempool.unlock()

    def _fire_events(
        self, block: Block, block_id: BlockID, responses: ABCIResponses,
        validator_updates: List[Validator],
    ) -> None:
        """reference: internal/state/execution.go:505-550."""
        if self.event_bus is None:
            return
        self.event_bus.publish_new_block(
            E.EventDataNewBlock(
                block=block,
                block_id=block_id,
                result_begin_block=responses.begin_block_obj,
                result_end_block=responses.end_block_obj,
            )
        )
        self.event_bus.publish_new_block_header(
            E.EventDataNewBlockHeader(
                header=block.header,
                num_txs=len(block.txs),
                result_begin_block=responses.begin_block_obj,
                result_end_block=responses.end_block_obj,
            )
        )
        for ev in block.evidence:
            self.event_bus.publish_new_evidence(
                E.EventDataNewEvidence(evidence=ev, height=block.header.height)
            )
        for i, txb in enumerate(block.txs):
            self.event_bus.publish_tx(
                E.EventDataTx(
                    height=block.header.height,
                    tx=txb,
                    index=i,
                    result=responses.deliver_tx_objs[i],
                ),
                tx_hash=tx_hash(txb),
            )
        if validator_updates:
            self.event_bus.publish_validator_set_updates(
                E.EventDataValidatorSetUpdates(validator_updates=tuple(validator_updates))
            )

def update_state(
    state: State,
    block_id: BlockID,
    block: Block,
    responses: ABCIResponses,
    validator_updates: List[Validator],
) -> State:
    """The pure state-transition function
    (reference: internal/state/execution.go:426-500)."""
    h = block.header
    n_val_set = state.next_validators.copy()
    last_height_vals_changed = state.last_height_validators_changed
    if validator_updates:
        n_val_set.update_with_change_set(validator_updates)
        last_height_vals_changed = h.height + 1 + 1

    n_val_set.increment_proposer_priority(1)

    params = state.consensus_params
    last_height_params_changed = state.last_height_consensus_params_changed
    app_version = state.app_version
    end_block = responses.end_block_obj
    if end_block.consensus_param_updates is not None:
        params = params.update(end_block.consensus_param_updates)
        params.validate()
        app_version = params.version.app_version
        last_height_params_changed = h.height + 1

    new_state = state.copy()
    new_state.last_block_height = h.height
    new_state.last_block_id = block_id
    new_state.last_block_time_ns = h.time_ns
    new_state.next_validators = n_val_set
    new_state.validators = state.next_validators.copy()
    new_state.last_validators = state.validators.copy()
    new_state.last_height_validators_changed = last_height_vals_changed
    new_state.consensus_params = params
    new_state.app_version = app_version
    new_state.last_height_consensus_params_changed = last_height_params_changed
    new_state.last_results_hash = results_hash(responses.deliver_tx_objs)
    new_state.app_hash = b""  # set after ABCI Commit
    return new_state
