"""Replicated state, its store, and block execution (counterpart:
tendermint_tpu/state/). The indexer, the SQL sink and the state metrics
are not ported yet."""

from .execution import (  # noqa: F401
    BlockExecutor,
    EmptyEvidencePool,
    results_hash,
    update_state,
    validate_block,
)
from .store import ABCIResponses, StateStore  # noqa: F401
from .types import State, median_time, state_from_genesis  # noqa: F401
