"""KVStoreApplication: the test application of BASELINE.md config 1.

Counterpart: tendermint_tpu/abci/kvstore.py:27-259, whole (reference:
abci/example/kvstore/kvstore.go, and persistent_kvstore.go for validator
updates). A transaction is `key=value` (a bare `t` is stored as `t=t`);
`val:<hex ed25519 pubkey>!<power>` updates a validator
(persistent_kvstore.go:190-209). The app hash is the merkle root of the
sorted `key=value` pairs and the validator entries (the reference's
kvstore hashes only its size), so with ops.merkle_kernel installed a
store of at least 512 entries commits with one root on the card (kernel
X4). State sync: with snapshot_interval N > 0 the app takes a snapshot
every N heights (:28-43, :141-151): a JSON blob of its entries and
validators, served in 64 KiB chunks (:24), of which the last four are
kept; restoring parses the blob as it grows, chunk by chunk (:210-240).
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

from ..crypto.merkle import hash_from_byte_slices
from . import types as T

__all__ = ["KVStoreApplication"]

VALIDATOR_TX_PREFIX = "val:"
_SNAPSHOT_CHUNK = 1 << 16


class KVStoreApplication(T.Application):
    def __init__(
        self, retain_blocks: int = 0, snapshot_interval: int = 0
    ) -> None:
        self.state: Dict[bytes, bytes] = {}
        self.height = 0
        self.app_hash = b""
        self.retain_blocks = retain_blocks
        # >0: advertise a state-sync snapshot every N heights (the
        # reference's e2e app shape, test/e2e/app/snapshots.go)
        self.snapshot_interval = snapshot_interval
        self.validator_set: Dict[str, T.ValidatorUpdate] = {}  # hex(pk) -> update
        self._staged_updates: List[T.ValidatorUpdate] = []
        self._snapshots: Dict[Tuple[int, int], bytes] = {}  # (height, format)
        self._restoring: Optional[bytearray] = None
        self._restore_chunks_expected = 0
        self._restore_chunks_applied = 0

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
        if (
            self.snapshot_interval
            and self.height % self.snapshot_interval == 0
        ):
            self.take_snapshot()
        retain = 0
        if self.retain_blocks and self.height >= self.retain_blocks:
            retain = self.height - self.retain_blocks + 1
        return T.ResponseCommit(data=self.app_hash, retain_height=retain)

    # -- State sync --

    def take_snapshot(self) -> T.Snapshot:
        """Serialize current state into chunks, advertise it."""
        blob = json.dumps(
            {
                "height": self.height,
                "state": {k.hex(): v.hex() for k, v in sorted(self.state.items())},
                "vals": {
                    pk: vu.power for pk, vu in sorted(self.validator_set.items())
                },
            },
            sort_keys=True,
        ).encode()
        chunks = max(1, (len(blob) + _SNAPSHOT_CHUNK - 1) // _SNAPSHOT_CHUNK)
        self._snapshots[(self.height, 1)] = blob
        while len(self._snapshots) > 4:  # bounded retention
            del self._snapshots[min(self._snapshots)]
        return T.Snapshot(
            height=self.height,
            format=1,
            chunks=chunks,
            hash=hash_from_byte_slices([blob]),
        )

    def list_snapshots(self, req: T.RequestListSnapshots) -> T.ResponseListSnapshots:
        snaps = []
        for (height, fmt), blob in sorted(self._snapshots.items()):
            chunks = max(1, (len(blob) + _SNAPSHOT_CHUNK - 1) // _SNAPSHOT_CHUNK)
            snaps.append(
                T.Snapshot(
                    height=height,
                    format=fmt,
                    chunks=chunks,
                    hash=hash_from_byte_slices([blob]),
                )
            )
        return T.ResponseListSnapshots(snapshots=tuple(snaps))

    def offer_snapshot(self, req: T.RequestOfferSnapshot) -> T.ResponseOfferSnapshot:
        if req.snapshot is None or req.snapshot.format != 1:
            return T.ResponseOfferSnapshot(result=T.OFFER_SNAPSHOT_REJECT_FORMAT)
        self._restoring = bytearray()
        self._restore_chunks_expected = req.snapshot.chunks
        self._restore_chunks_applied = 0
        return T.ResponseOfferSnapshot(result=T.OFFER_SNAPSHOT_ACCEPT)

    def load_snapshot_chunk(
        self, req: T.RequestLoadSnapshotChunk
    ) -> T.ResponseLoadSnapshotChunk:
        blob = self._snapshots.get((req.height, req.format))
        if blob is None:
            return T.ResponseLoadSnapshotChunk()
        start = req.chunk * _SNAPSHOT_CHUNK
        return T.ResponseLoadSnapshotChunk(chunk=blob[start : start + _SNAPSHOT_CHUNK])

    def apply_snapshot_chunk(
        self, req: T.RequestApplySnapshotChunk
    ) -> T.ResponseApplySnapshotChunk:
        if self._restoring is None:
            return T.ResponseApplySnapshotChunk(result=T.APPLY_CHUNK_ABORT)
        self._restoring += req.chunk
        self._restore_chunks_applied += 1
        try:
            doc = json.loads(bytes(self._restoring))
        except ValueError:
            if self._restore_chunks_applied >= self._restore_chunks_expected:
                # all chunks in but the blob won't parse — corrupt snapshot
                self._restoring = None
                return T.ResponseApplySnapshotChunk(
                    result=T.APPLY_CHUNK_REJECT_SNAPSHOT
                )
            return T.ResponseApplySnapshotChunk(result=T.APPLY_CHUNK_ACCEPT)
        # full blob assembled
        self.height = doc["height"]
        self.state = {
            bytes.fromhex(k): bytes.fromhex(v) for k, v in doc["state"].items()
        }
        self.validator_set = {
            pk: T.ValidatorUpdate(
                pub_key=T.PubKey("ed25519", bytes.fromhex(pk)), power=power
            )
            for pk, power in doc["vals"].items()
        }
        self.app_hash = self._compute_app_hash()
        self._restoring = None
        return T.ResponseApplySnapshotChunk(result=T.APPLY_CHUNK_ACCEPT)


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
