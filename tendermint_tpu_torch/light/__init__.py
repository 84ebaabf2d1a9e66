"""Light client (counterpart: tendermint_tpu/light/__init__.py): client,
verifier, divergence detection, providers and the trusted store."""

from .client import SEQUENTIAL_BATCH_HOPS, Client, TrustOptions
from .errors import (
    DivergenceError,
    InvalidHeaderError,
    LightBlockNotFoundError,
    LightClientError,
    NewValSetCantBeTrustedError,
    NoWitnessesError,
    OldHeaderExpiredError,
    VerificationError,
)
from .provider import LocalProvider, Provider
from .store import LightStore
from .verifier import (
    DEFAULT_TRUST_LEVEL,
    MAX_CLOCK_DRIFT_NS,
    header_expired,
    verify,
    verify_adjacent,
    verify_adjacent_batch,
    verify_backwards,
    verify_non_adjacent,
)

__all__ = [
    "Client",
    "DEFAULT_TRUST_LEVEL",
    "DivergenceError",
    "InvalidHeaderError",
    "LightBlockNotFoundError",
    "LightClientError",
    "LightStore",
    "LocalProvider",
    "MAX_CLOCK_DRIFT_NS",
    "NewValSetCantBeTrustedError",
    "NoWitnessesError",
    "OldHeaderExpiredError",
    "Provider",
    "SEQUENTIAL_BATCH_HOPS",
    "TrustOptions",
    "VerificationError",
    "header_expired",
    "verify",
    "verify_adjacent",
    "verify_adjacent_batch",
    "verify_backwards",
    "verify_non_adjacent",
]
