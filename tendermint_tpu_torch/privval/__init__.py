"""Validator signing, the PrivValidator boundary (counterpart:
tendermint_tpu/privval/): the interface, MockPV, FilePV and the remote
signer over SecretConnection (privval/signer.py). Signing is host work
by design: never signing twice is a property of the disk, not of
compute. The gRPC signer is privval/grpc.py."""

from .file import FilePV, FilePVKey, FilePVLastSignState
from .types import MockPV, PrivValidator

__all__ = ["FilePV", "FilePVKey", "FilePVLastSignState", "MockPV", "PrivValidator"]
