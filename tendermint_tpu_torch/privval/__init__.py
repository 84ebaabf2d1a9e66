"""Validator signing, the PrivValidator boundary (counterpart:
tendermint_tpu/privval/): the interface, MockPV and FilePV. Signing is
host work by design: never signing twice is a property of the disk, not
of compute. The remote signer over SecretConnection and the gRPC signer
wait for p2p and node start (ROADMAP items 17 and 21)."""

from .file import FilePV, FilePVKey, FilePVLastSignState
from .types import MockPV, PrivValidator

__all__ = ["FilePV", "FilePVKey", "FilePVLastSignState", "MockPV", "PrivValidator"]
