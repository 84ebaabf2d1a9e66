"""Replicated state, its store, block execution, and the tx indexer with
its KV and SQL sinks, and the state metrics (counterpart:
tendermint_tpu/state/)."""

from .execution import (  # noqa: F401
    BlockExecutor,
    EmptyEvidencePool,
    results_hash,
    update_state,
    validate_block,
)
from .store import ABCIResponses, StateStore  # noqa: F401
from .types import State, median_time, state_from_genesis  # noqa: F401
