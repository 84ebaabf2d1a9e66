"""Light client errors.

Counterpart: tendermint_tpu/light/errors.py (reference: light/errors.go,
light/provider/errors.go), whole.
"""

from __future__ import annotations

__all__ = [
    "DivergenceError",
    "InvalidHeaderError",
    "LightBlockNotFoundError",
    "LightClientError",
    "NewValSetCantBeTrustedError",
    "NoWitnessesError",
    "OldHeaderExpiredError",
    "VerificationError",
]


class LightClientError(Exception):
    pass


class OldHeaderExpiredError(LightClientError):
    """The trusted header is outside the trusting period."""

    def __init__(self, at_ns: int, now_ns: int) -> None:
        super().__init__(
            f"old header has expired at {at_ns} (now: {now_ns})"
        )
        self.at_ns = at_ns
        self.now_ns = now_ns


class NewValSetCantBeTrustedError(LightClientError):
    """Less than the trust level of the trusted set signed the new
    header: the caller should bisect."""


class InvalidHeaderError(LightClientError):
    """The header failed basic or signature validation: the provider is
    faulty."""


class VerificationError(LightClientError):
    pass


class LightBlockNotFoundError(LightClientError):
    """The provider has no block at the requested height."""


class NoWitnessesError(LightClientError):
    """Every witness has been removed: the client cannot cross-check and
    must halt."""


class DivergenceError(LightClientError):
    """A witness provided a conflicting, verifiable header: a possible
    light-client attack, whose evidence has been reported."""

    def __init__(self, msg: str, evidence=None) -> None:
        super().__init__(msg)
        self.evidence = evidence or []
