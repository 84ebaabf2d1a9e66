"""ABCI: the application boundary's payloads and interface.

Counterpart: tendermint_tpu/abci/types.py:1-508 (the request and
response dataclasses, the state-sync payloads :165, :246-269, :375-410,
and Application / BaseApplication with the four state-sync methods;
reference: abci/types/application.go:11-31, abci/types/types.pb.go),
with ResponseException (:275), which only the socket transport carries.
Nothing here touches the device.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ..types.params import ConsensusParams

__all__ = [
    "CODE_TYPE_OK",
    "CheckTxType",
    "Event",
    "EventAttribute",
    "PubKey",
    "ValidatorUpdate",
    "Validator",
    "VoteInfo",
    "LastCommitInfo",
    "Misbehavior",
    "MISBEHAVIOR_DUPLICATE_VOTE",
    "MISBEHAVIOR_LIGHT_CLIENT_ATTACK",
    "RequestEcho",
    "RequestFlush",
    "RequestInfo",
    "RequestInitChain",
    "RequestQuery",
    "RequestBeginBlock",
    "RequestCheckTx",
    "RequestDeliverTx",
    "RequestEndBlock",
    "RequestCommit",
    "RequestListSnapshots",
    "RequestOfferSnapshot",
    "RequestLoadSnapshotChunk",
    "RequestApplySnapshotChunk",
    "ResponseEcho",
    "ResponseException",
    "ResponseFlush",
    "ResponseInfo",
    "ResponseInitChain",
    "ResponseQuery",
    "ResponseBeginBlock",
    "ResponseCheckTx",
    "ResponseDeliverTx",
    "ResponseEndBlock",
    "ResponseCommit",
    "ResponseListSnapshots",
    "ResponseOfferSnapshot",
    "ResponseLoadSnapshotChunk",
    "ResponseApplySnapshotChunk",
    "OFFER_SNAPSHOT_ACCEPT",
    "OFFER_SNAPSHOT_ABORT",
    "OFFER_SNAPSHOT_REJECT",
    "OFFER_SNAPSHOT_REJECT_FORMAT",
    "OFFER_SNAPSHOT_REJECT_SENDER",
    "APPLY_CHUNK_ACCEPT",
    "APPLY_CHUNK_ABORT",
    "APPLY_CHUNK_RETRY",
    "APPLY_CHUNK_RETRY_SNAPSHOT",
    "APPLY_CHUNK_REJECT_SNAPSHOT",
    "Snapshot",
    "Application",
    "BaseApplication",
]

CODE_TYPE_OK = 0  # reference: abci/types/types.go:9


class CheckTxType:
    """reference: abci/types/types.pb.go CheckTxType enum."""

    NEW = 0
    RECHECK = 1


# ---------------------------------------------------------------------------
# Shared payload types


@dataclass(frozen=True)
class EventAttribute:
    """A key/value tag on an event; `index` marks it for the event indexer
    (reference: abci/types/types.pb.go EventAttribute)."""

    key: bytes
    value: bytes
    index: bool = False


@dataclass(frozen=True)
class Event:
    """A typed bag of attributes emitted by the app per-tx / per-block."""

    type: str
    attributes: tuple[EventAttribute, ...] = ()


@dataclass(frozen=True)
class PubKey:
    """ABCI public-key wrapper: (key type name, raw bytes)
    (reference: proto/tendermint/crypto/keys.pb.go oneof sum)."""

    key_type: str  # "ed25519" | "sr25519" | "secp256k1"
    data: bytes


@dataclass(frozen=True)
class ValidatorUpdate:
    """Validator-set delta returned from EndBlock; power 0 removes."""

    pub_key: PubKey
    power: int


@dataclass(frozen=True)
class Validator:
    """Compact validator reference inside commit info (address, not key)."""

    address: bytes
    power: int


@dataclass(frozen=True)
class VoteInfo:
    validator: Validator
    signed_last_block: bool


@dataclass(frozen=True)
class LastCommitInfo:
    round: int = 0
    votes: tuple[VoteInfo, ...] = ()


MISBEHAVIOR_DUPLICATE_VOTE = 1
MISBEHAVIOR_LIGHT_CLIENT_ATTACK = 2


@dataclass(frozen=True)
class Misbehavior:
    """Evidence forwarded to the app in BeginBlock
    (reference: abci/types/types.pb.go Evidence)."""

    kind: int
    validator: Validator
    height: int
    time_ns: int
    total_voting_power: int


# ---------------------------------------------------------------------------
# Requests


@dataclass(frozen=True)
class Snapshot:
    """State-sync snapshot advertisement
    (reference: abci/types/types.pb.go Snapshot)."""

    height: int
    format: int
    chunks: int
    hash: bytes
    metadata: bytes = b""


# ---------------------------------------------------------------------------
# Requests


@dataclass(frozen=True)
class RequestEcho:
    message: str = ""


@dataclass(frozen=True)
class RequestFlush:
    pass


@dataclass(frozen=True)
class RequestInfo:
    version: str = ""
    block_version: int = 0
    p2p_version: int = 0
    abci_version: str = ""


@dataclass(frozen=True)
class RequestInitChain:
    time_ns: int = 0
    chain_id: str = ""
    consensus_params: Optional[ConsensusParams] = None
    validators: tuple[ValidatorUpdate, ...] = ()
    app_state_bytes: bytes = b""
    initial_height: int = 1


@dataclass(frozen=True)
class RequestQuery:
    data: bytes = b""
    path: str = ""
    height: int = 0
    prove: bool = False


@dataclass(frozen=True)
class RequestBeginBlock:
    hash: bytes = b""
    header_bytes: bytes = b""  # proto-encoded Header (opaque to the app)
    last_commit_info: LastCommitInfo = field(default_factory=LastCommitInfo)
    byzantine_validators: tuple[Misbehavior, ...] = ()


@dataclass(frozen=True)
class RequestCheckTx:
    tx: bytes = b""
    type: int = CheckTxType.NEW


@dataclass(frozen=True)
class RequestDeliverTx:
    tx: bytes = b""


@dataclass(frozen=True)
class RequestEndBlock:
    height: int = 0


@dataclass(frozen=True)
class RequestCommit:
    pass


# ---------------------------------------------------------------------------
# Responses


@dataclass(frozen=True)
class RequestListSnapshots:
    pass


@dataclass(frozen=True)
class RequestOfferSnapshot:
    snapshot: Optional[Snapshot] = None
    app_hash: bytes = b""


@dataclass(frozen=True)
class RequestLoadSnapshotChunk:
    height: int = 0
    format: int = 0
    chunk: int = 0


@dataclass(frozen=True)
class RequestApplySnapshotChunk:
    index: int = 0
    chunk: bytes = b""
    sender: str = ""


# ---------------------------------------------------------------------------
# Responses


@dataclass(frozen=True)
class ResponseException:
    error: str = ""


@dataclass(frozen=True)
class ResponseEcho:
    message: str = ""


@dataclass(frozen=True)
class ResponseFlush:
    pass


@dataclass(frozen=True)
class ResponseInfo:
    data: str = ""
    version: str = ""
    app_version: int = 0
    last_block_height: int = 0
    last_block_app_hash: bytes = b""


@dataclass(frozen=True)
class ResponseInitChain:
    consensus_params: Optional[ConsensusParams] = None
    validators: tuple[ValidatorUpdate, ...] = ()
    app_hash: bytes = b""


@dataclass(frozen=True)
class ResponseQuery:
    code: int = CODE_TYPE_OK
    log: str = ""
    info: str = ""
    index: int = 0
    key: bytes = b""
    value: bytes = b""
    proof_ops: tuple = ()  # tuple of crypto.merkle ProofOp
    height: int = 0
    codespace: str = ""

    @property
    def is_ok(self) -> bool:
        return self.code == CODE_TYPE_OK


@dataclass(frozen=True)
class ResponseBeginBlock:
    events: tuple[Event, ...] = ()


@dataclass(frozen=True)
class ResponseCheckTx:
    code: int = CODE_TYPE_OK
    data: bytes = b""
    log: str = ""
    info: str = ""
    gas_wanted: int = 0
    gas_used: int = 0
    events: tuple[Event, ...] = ()
    codespace: str = ""
    sender: str = ""
    priority: int = 0
    mempool_error: str = ""

    @property
    def is_ok(self) -> bool:
        return self.code == CODE_TYPE_OK


@dataclass(frozen=True)
class ResponseDeliverTx:
    code: int = CODE_TYPE_OK
    data: bytes = b""
    log: str = ""
    info: str = ""
    gas_wanted: int = 0
    gas_used: int = 0
    events: tuple[Event, ...] = ()
    codespace: str = ""

    @property
    def is_ok(self) -> bool:
        return self.code == CODE_TYPE_OK


@dataclass(frozen=True)
class ResponseEndBlock:
    validator_updates: tuple[ValidatorUpdate, ...] = ()
    consensus_param_updates: Optional[ConsensusParams] = None
    events: tuple[Event, ...] = ()


@dataclass(frozen=True)
class ResponseCommit:
    data: bytes = b""  # the app hash
    retain_height: int = 0


# ---------------------------------------------------------------------------
# Application interface


@dataclass(frozen=True)
class ResponseListSnapshots:
    snapshots: tuple[Snapshot, ...] = ()


OFFER_SNAPSHOT_ACCEPT = 1
OFFER_SNAPSHOT_ABORT = 2
OFFER_SNAPSHOT_REJECT = 3
OFFER_SNAPSHOT_REJECT_FORMAT = 4
OFFER_SNAPSHOT_REJECT_SENDER = 5


@dataclass(frozen=True)
class ResponseOfferSnapshot:
    result: int = 0


@dataclass(frozen=True)
class ResponseLoadSnapshotChunk:
    chunk: bytes = b""


APPLY_CHUNK_ACCEPT = 1
APPLY_CHUNK_ABORT = 2
APPLY_CHUNK_RETRY = 3
APPLY_CHUNK_RETRY_SNAPSHOT = 4
APPLY_CHUNK_REJECT_SNAPSHOT = 5


@dataclass(frozen=True)
class ResponseApplySnapshotChunk:
    result: int = 0
    refetch_chunks: tuple[int, ...] = ()
    reject_senders: tuple[str, ...] = ()


class Application:
    """The deterministic state machine interface (reference:
    abci/types/application.go:11-31). Synchronous: the client serializes
    the calls."""

    # Info/Query connection
    def info(self, req: RequestInfo) -> ResponseInfo:
        raise NotImplementedError

    def query(self, req: RequestQuery) -> ResponseQuery:
        raise NotImplementedError

    # Mempool connection
    def check_tx(self, req: RequestCheckTx) -> ResponseCheckTx:
        raise NotImplementedError

    # Consensus connection
    def init_chain(self, req: RequestInitChain) -> ResponseInitChain:
        raise NotImplementedError

    def begin_block(self, req: RequestBeginBlock) -> ResponseBeginBlock:
        raise NotImplementedError

    def deliver_tx(self, req: RequestDeliverTx) -> ResponseDeliverTx:
        raise NotImplementedError

    def end_block(self, req: RequestEndBlock) -> ResponseEndBlock:
        raise NotImplementedError

    def commit(self) -> ResponseCommit:
        raise NotImplementedError

    # State-sync connection
    def list_snapshots(self, req: RequestListSnapshots) -> ResponseListSnapshots:
        raise NotImplementedError

    def offer_snapshot(self, req: RequestOfferSnapshot) -> ResponseOfferSnapshot:
        raise NotImplementedError

    def load_snapshot_chunk(
        self, req: RequestLoadSnapshotChunk
    ) -> ResponseLoadSnapshotChunk:
        raise NotImplementedError

    def apply_snapshot_chunk(
        self, req: RequestApplySnapshotChunk
    ) -> ResponseApplySnapshotChunk:
        raise NotImplementedError


class BaseApplication(Application):
    """No-op application accepting everything
    (reference: abci/types/application.go:36-95)."""

    def info(self, req: RequestInfo) -> ResponseInfo:
        return ResponseInfo()

    def query(self, req: RequestQuery) -> ResponseQuery:
        return ResponseQuery()

    def check_tx(self, req: RequestCheckTx) -> ResponseCheckTx:
        return ResponseCheckTx()

    def init_chain(self, req: RequestInitChain) -> ResponseInitChain:
        return ResponseInitChain()

    def begin_block(self, req: RequestBeginBlock) -> ResponseBeginBlock:
        return ResponseBeginBlock()

    def deliver_tx(self, req: RequestDeliverTx) -> ResponseDeliverTx:
        return ResponseDeliverTx()

    def end_block(self, req: RequestEndBlock) -> ResponseEndBlock:
        return ResponseEndBlock()

    def commit(self) -> ResponseCommit:
        return ResponseCommit()

    def list_snapshots(self, req: RequestListSnapshots) -> ResponseListSnapshots:
        return ResponseListSnapshots()

    def offer_snapshot(self, req: RequestOfferSnapshot) -> ResponseOfferSnapshot:
        return ResponseOfferSnapshot()

    def load_snapshot_chunk(
        self, req: RequestLoadSnapshotChunk
    ) -> ResponseLoadSnapshotChunk:
        return ResponseLoadSnapshotChunk()

    def apply_snapshot_chunk(
        self, req: RequestApplySnapshotChunk
    ) -> ResponseApplySnapshotChunk:
        return ResponseApplySnapshotChunk()
