"""Carrying state across from the JAX package, by bytes and arrays only.

The port never imports tendermint_tpu; these functions read what the
JAX package writes:

- commit_from_proto: the wire bytes of tendermint_tpu's
  Commit.to_proto() (types/commit.py:438) -> the port's Commit;
- validator_set_from_proto: the wire bytes of
  ValidatorSet.to_proto() (types/validator.py:516) -> the port's
  ValidatorSet, ed25519 and sr25519 keys alike;
- light_block_from_proto / signed_header_from_proto: the wire bytes of
  LightBlock.to_proto() and SignedHeader.to_proto() (types/light.py:98,
  :54) -> the port's LightBlock and SignedHeader;
- points_from_numpy: a (k, 20, N) int32 limb stack from the JAX field
  and point functions (as numpy) -> a tensor for kernel K1 and the
  point-level functions here;
- rows_from_cols / cols_from_rows: the JAX package's (L, N) uint8 byte
  columns (ops/sha256_kernel.py) <-> the port's (N, L) rows
  (ops/sha256_kernel.py here);
- proofs_from_proto / proofs_to_proto: merkle Proofs through their wire
  bytes (tendermint_tpu/crypto/merkle.py:149-170 Proof.to_proto_bytes /
  from_proto_bytes on the JAX side);
- vote_from_proto: the wire bytes of Vote.to_proto() (types/vote.py:116)
  -> the port's Vote;
- msg_from_proto: the wire bytes of a consensus Message envelope
  (consensus/msgs.py:450 encode_msg) -> the port's vote-path message, or
  of a MsgInfo.to_proto() (:480) with `info=True` -> the port's MsgInfo;
- genesis_from_json: the text of GenesisDoc.to_json() (types/genesis.py:88)
  -> the port's GenesisDoc;
- state_from_proto: the store bytes of State.to_proto() (state/types.py:132)
  -> the port's State;
- block_from_proto: the wire bytes of Block.to_proto() (types/block.py:132)
  -> the port's Block;
- abci_responses_from_proto: the store bytes of ABCIResponses.to_proto()
  (state/store.py:99) -> the port's ABCIResponses.
"""

from __future__ import annotations

import numpy as np
import torch

from .crypto import batch  # noqa: F401  (registers the key types)
from .consensus.msgs import decode_msg
from .crypto.merkle import Proof
from .ops import field25519 as F
from .state.store import ABCIResponses
from .state.types import State
from .types.block import Block
from .types.commit import Commit
from .types.genesis import GenesisDoc
from .types.light import LightBlock, SignedHeader
from .types.validator import ValidatorSet
from .types.vote import Vote

__all__ = [
    "abci_responses_from_proto",
    "block_from_proto",
    "cols_from_rows",
    "commit_from_proto",
    "genesis_from_json",
    "light_block_from_proto",
    "msg_from_proto",
    "points_from_numpy",
    "proofs_from_proto",
    "proofs_to_proto",
    "rows_from_cols",
    "signed_header_from_proto",
    "state_from_proto",
    "validator_set_from_proto",
    "vote_from_proto",
]


def commit_from_proto(data: bytes) -> Commit:
    return Commit.from_proto(bytes(data))


def validator_set_from_proto(data: bytes) -> ValidatorSet:
    return ValidatorSet.from_proto(bytes(data))


def light_block_from_proto(data: bytes) -> LightBlock:
    return LightBlock.from_proto(bytes(data))


def signed_header_from_proto(data: bytes) -> SignedHeader:
    return SignedHeader.from_proto(bytes(data))


def vote_from_proto(data: bytes) -> Vote:
    return Vote.from_proto(bytes(data))


def msg_from_proto(data: bytes):
    """A Message envelope's vote-path message."""
    return decode_msg(bytes(data))


def genesis_from_json(text: str) -> GenesisDoc:
    return GenesisDoc.from_json(text)


def state_from_proto(data: bytes) -> State:
    return State.from_proto(bytes(data))


def block_from_proto(data: bytes) -> Block:
    return Block.from_proto(bytes(data))


def abci_responses_from_proto(data: bytes) -> ABCIResponses:
    return ABCIResponses.from_proto(bytes(data))


def points_from_numpy(arr, device="cuda") -> torch.Tensor:
    """(..., k, 20, N) int32 limbs -> contiguous int32 tensor on device."""
    a = np.array(arr, dtype=np.int32, order="C")  # a writable copy
    if a.ndim < 2 or a.shape[-2] != F.NLIMBS:
        raise ValueError(f"want (..., {F.NLIMBS}, N) limbs, got {a.shape}")
    return torch.from_numpy(a).to(device)


def rows_from_cols(cols, device="cuda") -> torch.Tensor:
    """(L, N) uint8 byte columns -> contiguous (N, L) uint8 rows on device."""
    a = np.ascontiguousarray(np.asarray(cols, dtype=np.uint8).T)
    return torch.from_numpy(a).to(device)


def cols_from_rows(rows: torch.Tensor) -> np.ndarray:
    """(N, L) rows -> (L, N) uint8 numpy columns."""
    return np.ascontiguousarray(rows.cpu().numpy().T)


def proofs_from_proto(blobs) -> list:
    """Proof wire bytes -> the port's merkle Proofs."""
    return [Proof.from_proto_bytes(bytes(b)) for b in blobs]


def proofs_to_proto(proofs) -> list:
    """The port's merkle Proofs -> their wire bytes."""
    return [p.to_proto_bytes() for p in proofs]
