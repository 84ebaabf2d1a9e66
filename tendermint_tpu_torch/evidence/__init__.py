"""The evidence pool and evidence verification (counterpart:
tendermint_tpu/evidence/). The gossip reactor waits for p2p (ROADMAP
item 17), the metrics for the port's metrics library (item 11)."""

from .pool import EvidenceError, EvidencePool
from .verify import verify_duplicate_vote, verify_evidence, verify_light_client_attack

__all__ = [
    "EvidenceError",
    "EvidencePool",
    "verify_duplicate_vote",
    "verify_evidence",
    "verify_light_client_attack",
]
