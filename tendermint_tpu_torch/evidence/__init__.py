"""The evidence pool, evidence verification and the evidence reactor
and its metrics (counterpart: tendermint_tpu/evidence/)."""

from .pool import EvidenceError, EvidencePool
from .verify import verify_duplicate_vote, verify_evidence, verify_light_client_attack

__all__ = [
    "EvidenceError",
    "EvidencePool",
    "verify_duplicate_vote",
    "verify_evidence",
    "verify_light_client_attack",
]
