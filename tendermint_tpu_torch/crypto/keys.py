"""Key and batch-verifier interfaces: the plugin boundary.

Counterpart: tendermint_tpu/crypto/keys.py (PubKey, PrivKey,
BatchVerifier, the key-type registry and the PublicKey proto mapping).
The BatchVerifier contract is the seam the device path hangs on:

    add(pubkey, message, signature) -> None   (may raise on bad input)
    verify() -> (all_ok: bool, per_item: list[bool])

verify() reports exactly which indices failed: consensus attributes
invalid signatures to validators from the bitmap.
"""

from __future__ import annotations

import hashlib
from abc import ABC, abstractmethod
from typing import List, Tuple

from ..encoding.proto import ProtoWriter, iter_fields

__all__ = [
    "ADDRESS_SIZE",
    "Address",
    "BatchVerifier",
    "PrivKey",
    "PubKey",
    "address_hash",
    "pubkey_from_proto",
    "pubkey_from_type_and_bytes",
    "pubkey_to_proto",
    "register_key_type",
]

ADDRESS_SIZE = 20

Address = bytes


def address_hash(data: bytes) -> Address:
    """sha256(data)[:20]."""
    return hashlib.sha256(data).digest()[:ADDRESS_SIZE]


class PubKey(ABC):
    @abstractmethod
    def address(self) -> Address: ...

    @abstractmethod
    def bytes(self) -> bytes: ...

    @abstractmethod
    def verify_signature(self, msg: bytes, sig: bytes) -> bool: ...

    @abstractmethod
    def type(self) -> str: ...

    def equals(self, other: "PubKey") -> bool:
        return self.type() == other.type() and self.bytes() == other.bytes()

    def __eq__(self, other: object) -> bool:
        return isinstance(other, PubKey) and self.equals(other)

    def __hash__(self) -> int:
        return hash((self.type(), self.bytes()))

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.bytes().hex()[:16]}…)"


class PrivKey(ABC):
    @abstractmethod
    def bytes(self) -> bytes: ...

    @abstractmethod
    def sign(self, msg: bytes) -> bytes: ...

    @abstractmethod
    def pub_key(self) -> PubKey: ...

    @abstractmethod
    def type(self) -> str: ...

    def __repr__(self) -> str:
        # never render key material
        return f"<{type(self).__name__} redacted>"


class BatchVerifier(ABC):
    """Accumulate (pk, msg, sig) triples, verify all at once. verify()
    returns (every sig valid, bitmap in add order) and drains the
    queue: a second call without new add()s returns (False, [])."""

    @abstractmethod
    def add(
        self, pub_key: PubKey, message: bytes, signature: bytes
    ) -> None: ...

    @abstractmethod
    def verify(self) -> Tuple[bool, List[bool]]: ...

    def __len__(self) -> int:
        raise NotImplementedError


_KEY_TYPES: dict[str, type] = {}
_PROTO_FIELD: dict[str, int] = {}  # key type -> PublicKey oneof field


def register_key_type(
    key_type: str, pubkey_cls: type, proto_field: int
) -> None:
    _KEY_TYPES[key_type] = pubkey_cls
    _PROTO_FIELD[key_type] = proto_field


def pubkey_from_type_and_bytes(key_type: str, data: bytes) -> PubKey:
    cls = _KEY_TYPES.get(key_type)
    if cls is None:
        raise ValueError(f"unknown key type {key_type!r}")
    return cls(data)


def pubkey_to_proto(pk: PubKey) -> bytes:
    """tendermint.crypto.PublicKey (oneof: ed25519=1, secp256k1=2,
    sr25519=3)."""
    field = _PROTO_FIELD.get(pk.type())
    if field is None:
        raise ValueError(f"key type {pk.type()!r} has no proto mapping")
    w = ProtoWriter()
    w.bytes(field, pk.bytes())
    return w.finish()


def pubkey_from_proto(data: bytes) -> PubKey:
    for field, _wt, value in iter_fields(data):
        for key_type, f in _PROTO_FIELD.items():
            if f == field:
                return pubkey_from_type_and_bytes(key_type, value)
    raise ValueError("PublicKey proto has no recognized key")
