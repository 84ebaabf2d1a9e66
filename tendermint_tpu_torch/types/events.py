"""Event names and the payloads published on the event bus.

Counterpart: tendermint_tpu/types/events.py:1-137 (reference:
types/events.go: event values :15-47, reserved composite keys :197-208,
payloads :100-190). Payloads are light frozen dataclasses; the tag
flattening that makes them queryable lives in eventbus/. Node start
publishes the state-sync status at the end of a restore
(node/node.py _state_sync_then_follow).
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = [
    "BLOCK_HEIGHT_KEY",
    "EVENT_TYPE_KEY",
    "TX_HASH_KEY",
    "TX_HEIGHT_KEY",
    "EventDataBlockSyncStatus",
    "EventDataCompleteProposal",
    "EventDataNewBlock",
    "EventDataNewBlockHeader",
    "EventDataNewEvidence",
    "EventDataNewRound",
    "EventDataRoundState",
    "EventDataStateSyncStatus",
    "EventDataTx",
    "EventDataValidatorSetUpdates",
    "EventDataVote",
    "EventValue",
]

# reserved composite keys
EVENT_TYPE_KEY = "tm.event"
TX_HASH_KEY = "tx.hash"
TX_HEIGHT_KEY = "tx.height"
BLOCK_HEIGHT_KEY = "block.height"


class EventValue:
    """Event names (reference: types/events.go:15-47)."""

    NEW_BLOCK = "NewBlock"
    NEW_BLOCK_HEADER = "NewBlockHeader"
    NEW_EVIDENCE = "NewEvidence"
    TX = "Tx"
    VALIDATOR_SET_UPDATES = "ValidatorSetUpdates"

    COMPLETE_PROPOSAL = "CompleteProposal"
    BLOCK_SYNC_STATUS = "BlockSyncStatus"
    LOCK = "Lock"
    NEW_ROUND = "NewRound"
    NEW_ROUND_STEP = "NewRoundStep"
    POLKA = "Polka"
    RELOCK = "Relock"
    STATE_SYNC_STATUS = "StateSyncStatus"
    TIMEOUT_PROPOSE = "TimeoutPropose"
    TIMEOUT_WAIT = "TimeoutWait"
    UNLOCK = "Unlock"
    VALID_BLOCK = "ValidBlock"
    VOTE = "Vote"


@dataclass(frozen=True)
class EventDataNewBlock:
    block: object  # types.block.Block
    block_id: object  # types.block_id.BlockID
    result_begin_block: object = None  # abci.ResponseBeginBlock
    result_end_block: object = None  # abci.ResponseEndBlock


@dataclass(frozen=True)
class EventDataNewBlockHeader:
    header: object
    num_txs: int = 0
    result_begin_block: object = None
    result_end_block: object = None


@dataclass(frozen=True)
class EventDataNewEvidence:
    evidence: object
    height: int = 0


@dataclass(frozen=True)
class EventDataTx:
    height: int
    tx: bytes
    index: int
    result: object  # abci.ResponseDeliverTx


@dataclass(frozen=True)
class EventDataNewRound:
    height: int
    round: int
    step: str
    proposer_address: bytes = b""
    proposer_index: int = -1


@dataclass(frozen=True)
class EventDataRoundState:
    height: int
    round: int
    step: str


@dataclass(frozen=True)
class EventDataCompleteProposal:
    height: int
    round: int
    step: str
    block_id: object = None


@dataclass(frozen=True)
class EventDataVote:
    vote: object  # types.vote.Vote


@dataclass(frozen=True)
class EventDataValidatorSetUpdates:
    validator_updates: tuple = ()


@dataclass(frozen=True)
class EventDataBlockSyncStatus:
    complete: bool
    height: int


@dataclass(frozen=True)
class EventDataStateSyncStatus:
    complete: bool
    height: int
