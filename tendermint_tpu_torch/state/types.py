"""State: the replicated state after a height.

Counterpart: tendermint_tpu/state/types.py:1-222 (median_time :26, State
:49 with copy, make_block :102 and the store form, state_from_genesis
:198; reference: internal/state/state.go).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import List, Optional

from ..encoding.proto import FieldReader, ProtoWriter
from ..types.block import Block, make_block
from ..types.block_id import BlockID
from ..types.commit import Commit
from ..types.evidence import Evidence
from ..types.genesis import GenesisDoc
from ..types.header import Consensus
from ..types.params import ConsensusParams
from ..types.part_set import BLOCK_PART_SIZE_BYTES, PartSet
from ..types.timestamp import decode_timestamp, encode_timestamp
from ..types.validator import ValidatorSet

__all__ = ["State", "median_time", "state_from_genesis"]


def median_time(commit: Commit, validators: ValidatorSet) -> int:
    """Voting-power-weighted median of commit timestamps — bounded by
    honest votes (reference: internal/state/state.go:291-312)."""
    weighted: List[tuple[int, int]] = []  # (time_ns, power)
    total = 0
    for cs in commit.signatures:
        if cs.is_absent():
            continue
        _, val = validators.get_by_address(cs.validator_address)
        if val is not None:
            total += val.voting_power
            weighted.append((cs.timestamp_ns, val.voting_power))
    weighted.sort()
    median = total // 2
    acc = 0
    for t, power in weighted:
        acc += power
        if acc > median:
            return t
    raise ValueError("median time: no votes")


@dataclass
class State:
    chain_id: str = ""
    initial_height: int = 1
    last_block_height: int = 0
    last_block_id: BlockID = field(default_factory=BlockID)
    last_block_time_ns: int = 0
    next_validators: Optional[ValidatorSet] = None
    validators: Optional[ValidatorSet] = None
    last_validators: Optional[ValidatorSet] = None
    last_height_validators_changed: int = 0
    consensus_params: ConsensusParams = field(
        default_factory=ConsensusParams
    )
    last_height_consensus_params_changed: int = 0
    last_results_hash: bytes = b""
    app_hash: bytes = b""
    app_version: int = 0

    def copy(self) -> "State":
        return State(
            chain_id=self.chain_id,
            initial_height=self.initial_height,
            last_block_height=self.last_block_height,
            last_block_id=self.last_block_id,
            last_block_time_ns=self.last_block_time_ns,
            next_validators=(
                self.next_validators.copy()
                if self.next_validators
                else None
            ),
            validators=(
                self.validators.copy() if self.validators else None
            ),
            last_validators=(
                self.last_validators.copy()
                if self.last_validators
                else None
            ),
            last_height_validators_changed=(
                self.last_height_validators_changed
            ),
            consensus_params=replace(self.consensus_params),
            last_height_consensus_params_changed=(
                self.last_height_consensus_params_changed
            ),
            last_results_hash=self.last_results_hash,
            app_hash=self.app_hash,
            app_version=self.app_version,
        )

    def make_block(
        self,
        height: int,
        txs: List[bytes],
        commit: Commit,
        evidence: List[Evidence],
        proposer_address: bytes,
    ) -> tuple[Block, PartSet]:
        """reference: internal/state/state.go:255-289."""
        block = make_block(height, txs, commit, evidence)
        if height == self.initial_height:
            timestamp = self.last_block_time_ns  # genesis time
        else:
            timestamp = median_time(commit, self.last_validators)
        h = block.header
        h.version = Consensus(app=self.app_version)
        h.chain_id = self.chain_id
        h.time_ns = timestamp
        h.last_block_id = self.last_block_id
        h.validators_hash = self.validators.hash()
        h.next_validators_hash = self.next_validators.hash()
        h.consensus_hash = self.consensus_params.hash()
        h.app_hash = self.app_hash
        h.last_results_hash = self.last_results_hash
        h.proposer_address = proposer_address
        bps = block.make_part_set(BLOCK_PART_SIZE_BYTES)
        return block, bps

    # -- the store form --

    def to_proto(self) -> bytes:
        w = ProtoWriter()
        w.string(2, self.chain_id)
        w.int(3, self.initial_height)
        w.int(4, self.last_block_height)
        w.message(5, self.last_block_id.to_proto())
        w.message(6, encode_timestamp(self.last_block_time_ns))
        if self.next_validators is not None:
            w.message(7, self.next_validators.to_proto())
        if self.validators is not None:
            w.message(8, self.validators.to_proto())
        if self.last_validators is not None:
            w.message(9, self.last_validators.to_proto())
        w.int(10, self.last_height_validators_changed)
        w.message(11, self.consensus_params.to_proto())
        w.int(12, self.last_height_consensus_params_changed)
        w.bytes(13, self.last_results_hash)
        w.bytes(14, self.app_hash)
        w.int(15, self.app_version)
        return w.finish()

    @classmethod
    def from_proto(cls, data: bytes) -> "State":
        r = FieldReader(data)
        bid = r.get(5)
        ts = r.get(6)
        nv, v, lv = r.get(7), r.get(8), r.get(9)
        cp = r.get(11)
        return cls(
            chain_id=r.string(2),
            initial_height=r.int64(3),
            last_block_height=r.int64(4),
            last_block_id=(
                BlockID.from_proto(bid) if bid is not None else BlockID()
            ),
            last_block_time_ns=(
                decode_timestamp(ts) if ts is not None else 0
            ),
            next_validators=(
                ValidatorSet.from_proto(nv) if nv is not None else None
            ),
            validators=(
                ValidatorSet.from_proto(v) if v is not None else None
            ),
            last_validators=(
                ValidatorSet.from_proto(lv) if lv is not None else None
            ),
            last_height_validators_changed=r.int64(10),
            consensus_params=(
                ConsensusParams.from_proto(cp)
                if cp is not None
                else ConsensusParams()
            ),
            last_height_consensus_params_changed=r.int64(12),
            last_results_hash=r.bytes(13),
            app_hash=r.bytes(14),
            app_version=r.int64(15),
        )


def state_from_genesis(genesis: GenesisDoc) -> State:
    """reference: internal/state/state.go MakeGenesisState (:340-400)."""
    genesis.validate_and_complete()
    if genesis.validators:
        val_set = genesis.validator_set()
        next_vals = val_set.copy_increment_proposer_priority(1)
    else:
        val_set = None  # awaiting InitChain validators from the app
        next_vals = None
    return State(
        chain_id=genesis.chain_id,
        initial_height=genesis.initial_height,
        last_block_height=0,
        last_block_id=BlockID(),
        last_block_time_ns=genesis.genesis_time_ns,
        next_validators=next_vals,
        validators=val_set,
        last_validators=None,
        last_height_validators_changed=genesis.initial_height,
        consensus_params=genesis.consensus_params,
        last_height_consensus_params_changed=genesis.initial_height,
        last_results_hash=b"",
        app_hash=genesis.app_hash,
        app_version=genesis.consensus_params.version.app_version,
    )
