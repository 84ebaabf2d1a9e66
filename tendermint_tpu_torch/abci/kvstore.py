"""KVStoreApplication: the test application of BASELINE.md config 1.

Counterpart: tendermint_tpu/abci/kvstore.py:27-259 (reference:
abci/example/kvstore/kvstore.go, and persistent_kvstore.go for validator
updates). A transaction is `key=value` (a bare `t` is stored as `t=t`);
`val:<hex ed25519 pubkey>!<power>` updates a validator
(persistent_kvstore.go:190-209). The app hash is the merkle root of the
sorted `key=value` pairs and the validator entries (the reference's
kvstore hashes only its size), so with ops.merkle_kernel installed a
store of at least 512 entries commits with one root on the card (kernel
X4). Left out: state-sync snapshots (take_snapshot, the four snapshot
methods), which wait for statesync.
"""

from __future__ import annotations

import json
from typing import Dict, List

from ..crypto.merkle import hash_from_byte_slices
from . import types as T

__all__ = ["KVStoreApplication"]

VALIDATOR_TX_PREFIX = "val:"


class KVStoreApplication(T.Application):
    def __init__(self, retain_blocks: int = 0) -> None:
        self.state: Dict[bytes, bytes] = {}
        self.height = 0
        self.app_hash = b""
        self.retain_blocks = retain_blocks
        self.validator_set: Dict[str, T.ValidatorUpdate] = {}  # hex(pk) -> update
        self._staged_updates: List[T.ValidatorUpdate] = []

    # -- deterministic commitment --

    def _compute_app_hash(self) -> bytes:
        if not self.state and not self.validator_set:
            return b""
        leaves = [k + b"=" + v for k, v in sorted(self.state.items())]
        leaves += [
            f"val:{pk}!{vu.power}".encode()
            for pk, vu in sorted(self.validator_set.items())
        ]
        return hash_from_byte_slices(leaves)

    # -- Info/Query --

    def info(self, req: T.RequestInfo) -> T.ResponseInfo:
        return T.ResponseInfo(
            data=json.dumps({"size": len(self.state)}),
            version="kvstore/1",
            app_version=1,
            last_block_height=self.height,
            last_block_app_hash=self.app_hash,
        )

    def query(self, req: T.RequestQuery) -> T.ResponseQuery:
        if req.path == "/val":
            vu = self.validator_set.get(req.data.decode(), None)
            power = vu.power if vu else 0
            return T.ResponseQuery(key=req.data, value=str(power).encode())
        value = self.state.get(req.data)
        if value is None:
            return T.ResponseQuery(key=req.data, log="does not exist")
        return T.ResponseQuery(key=req.data, value=value, log="exists")

    # -- Mempool --

    def check_tx(self, req: T.RequestCheckTx) -> T.ResponseCheckTx:
        tx = req.tx
        if tx.startswith(VALIDATOR_TX_PREFIX.encode()):
            ok, err = _parse_validator_tx(tx)
            if ok is None:
                return T.ResponseCheckTx(code=1, log=err)
        return T.ResponseCheckTx(gas_wanted=1)

    # -- Consensus --

    def init_chain(self, req: T.RequestInitChain) -> T.ResponseInitChain:
        for vu in req.validators:
            self.validator_set[vu.pub_key.data.hex()] = vu
        return T.ResponseInitChain(app_hash=self._compute_app_hash())

    def begin_block(self, req: T.RequestBeginBlock) -> T.ResponseBeginBlock:
        self._staged_updates = []
        return T.ResponseBeginBlock()

    def deliver_tx(self, req: T.RequestDeliverTx) -> T.ResponseDeliverTx:
        tx = req.tx
        if tx.startswith(VALIDATOR_TX_PREFIX.encode()):
            vu, err = _parse_validator_tx(tx)
            if vu is None:
                return T.ResponseDeliverTx(code=1, log=err)
            self._staged_updates.append(vu)
            if vu.power == 0:
                self.validator_set.pop(vu.pub_key.data.hex(), None)
            else:
                self.validator_set[vu.pub_key.data.hex()] = vu
            return T.ResponseDeliverTx(
                events=(
                    T.Event(
                        type="val_update",
                        attributes=(
                            T.EventAttribute(
                                b"pubkey", vu.pub_key.data.hex().encode(), True
                            ),
                        ),
                    ),
                )
            )
        key, sep, value = tx.partition(b"=")
        if not sep:
            value = key
        self.state[key] = value
        return T.ResponseDeliverTx(
            events=(
                T.Event(
                    type="app",
                    attributes=(
                        T.EventAttribute(b"creator", b"kvstore", True),
                        T.EventAttribute(b"key", key, True),
                    ),
                ),
            )
        )

    def end_block(self, req: T.RequestEndBlock) -> T.ResponseEndBlock:
        return T.ResponseEndBlock(validator_updates=tuple(self._staged_updates))

    def commit(self) -> T.ResponseCommit:
        self.height += 1
        self.app_hash = self._compute_app_hash()
        retain = 0
        if self.retain_blocks and self.height >= self.retain_blocks:
            retain = self.height - self.retain_blocks + 1
        return T.ResponseCommit(data=self.app_hash, retain_height=retain)

def _parse_validator_tx(tx: bytes):
    """`val:<hex pubkey>!<power>` -> (ValidatorUpdate, "") or (None, err)."""
    body = tx[len(VALIDATOR_TX_PREFIX) :].decode(errors="replace")
    pk_hex, sep, power_s = body.partition("!")
    if not sep:
        return None, "expected val:<pubkey>!<power>"
    try:
        pk = bytes.fromhex(pk_hex)
    except ValueError:
        return None, f"pubkey {pk_hex!r} is not hex"
    try:
        power = int(power_s)
    except ValueError:
        return None, f"power {power_s!r} is not an int"
    if power < 0:
        return None, "power must be >= 0"
    return T.ValidatorUpdate(pub_key=T.PubKey("ed25519", pk), power=power), ""
