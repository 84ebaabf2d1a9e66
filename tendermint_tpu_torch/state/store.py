"""StateStore: the State, validator sets, params and ABCI responses of
each height.

Counterpart: tendermint_tpu/state/store.py: ABCIResponses (:44-119),
StateStore's load and save (:153-182), the sparse validator sets
(:209-250), consensus params (:252-276) and ABCI responses (:278-288);
reference: internal/state/store.go. Left out: bootstrap and
save_validators (state sync's), prune (the node's pruning of old
heights) and rollback (the CLI's), which wait for those items.
"""

from __future__ import annotations

import struct
from typing import List, Optional

from ..abci.codec import (
    dec_resp_begin_block,
    dec_resp_deliver_tx,
    dec_resp_end_block,
)
from ..encoding.proto import FieldReader, ProtoWriter, iter_fields
from ..types.params import ConsensusParams
from ..types.validator import ValidatorSet
from ..store.kv import KVStore
from .types import State

__all__ = ["StateStore", "ABCIResponses"]

_STATE = b"\x10"
_VALIDATORS = b"\x11"
_PARAMS = b"\x12"
_ABCI_RESPONSES = b"\x13"

# Validator sets are persisted every height; unchanged sets are stored as
# a pointer to the last height they changed (the reference's sparse
# storage, internal/state/store.go:330-360).
VALSET_CHECKPOINT_INTERVAL = 100000


def _vals_key(height: int) -> bytes:
    return _VALIDATORS + struct.pack(">q", height)


def _params_key(height: int) -> bytes:
    return _PARAMS + struct.pack(">q", height)


def _abci_key(height: int) -> bytes:
    return _ABCI_RESPONSES + struct.pack(">q", height)


class ABCIResponses:
    """DeliverTx/EndBlock results saved per height (reference:
    proto/tendermint/state/types.pb.go ABCIResponses). Stored as raw
    proto bytes of each DeliverTx response plus the EndBlock response."""

    def __init__(
        self,
        deliver_txs: Optional[List[bytes]] = None,
        end_block: bytes = b"",
        begin_block: bytes = b"",
    ) -> None:
        self.deliver_txs = deliver_txs or []
        self.end_block = end_block
        self.begin_block = begin_block

    @property
    def deliver_tx_objs(self):
        """Decoded DeliverTx responses (decoded lazily when loaded from
        disk; the executor sets the cache directly after execution)."""
        if not hasattr(self, "_deliver_tx_objs"):
            self._deliver_tx_objs = [
                dec_resp_deliver_tx(d) for d in self.deliver_txs
            ]
        return self._deliver_tx_objs

    @deliver_tx_objs.setter
    def deliver_tx_objs(self, objs) -> None:
        self._deliver_tx_objs = objs

    @property
    def end_block_obj(self):
        if not hasattr(self, "_end_block_obj"):
            self._end_block_obj = dec_resp_end_block(self.end_block)
        return self._end_block_obj

    @end_block_obj.setter
    def end_block_obj(self, obj) -> None:
        self._end_block_obj = obj

    @property
    def begin_block_obj(self):
        if not hasattr(self, "_begin_block_obj"):
            self._begin_block_obj = dec_resp_begin_block(self.begin_block)
        return self._begin_block_obj

    @begin_block_obj.setter
    def begin_block_obj(self, obj) -> None:
        self._begin_block_obj = obj

    def to_proto(self) -> bytes:
        w = ProtoWriter()
        for dt in self.deliver_txs:
            w.message(1, dt)
        w.message(2, self.end_block)
        w.message(3, self.begin_block)
        return w.finish()

    @classmethod
    def from_proto(cls, data: bytes) -> "ABCIResponses":
        dts: List[bytes] = []
        eb = b""
        bb = b""
        for f, _wt, v in iter_fields(data):
            if f == 1:
                dts.append(v)
            elif f == 2:
                eb = v
            elif f == 3:
                bb = v
        return cls(deliver_txs=dts, end_block=eb, begin_block=bb)


class _ValInfo:
    """Validator-set record: either the set itself or a pointer to the
    last height it changed."""

    def __init__(
        self,
        val_set: Optional[ValidatorSet] = None,
        last_height_changed: int = 0,
    ) -> None:
        self.val_set = val_set
        self.last_height_changed = last_height_changed

    def to_proto(self) -> bytes:
        w = ProtoWriter()
        if self.val_set is not None:
            w.message(1, self.val_set.to_proto())
        w.int(2, self.last_height_changed)
        return w.finish()

    @classmethod
    def from_proto(cls, data: bytes) -> "_ValInfo":
        r = FieldReader(data)
        vs = r.get(1)
        return cls(
            val_set=(
                ValidatorSet.from_proto(vs) if vs is not None else None
            ),
            last_height_changed=r.int64(2),
        )


class StateStore:
    def __init__(self, db: KVStore) -> None:
        self._db = db

    # -- state --

    def load(self) -> Optional[State]:
        data = self._db.get(_STATE)
        return State.from_proto(data) if data is not None else None

    def save(self, state: State) -> None:
        """Persist state + the validator set & params it defines for
        future heights (reference: internal/state/store.go:150-220)."""
        next_height = state.last_block_height + 1
        if next_height == 1:
            next_height = state.initial_height
            # genesis bootstrap: persist validators for height 1 and 2
            self._save_validators(
                next_height, state.validators,
                state.last_height_validators_changed,
            )
        self._save_validators(
            next_height + 1, state.next_validators,
            state.last_height_validators_changed,
        )
        self._save_params(
            next_height, state.consensus_params,
            state.last_height_consensus_params_changed,
        )
        self._db.set(_STATE, state.to_proto())

    # -- validator sets per height --

    def _save_validators(
        self,
        height: int,
        vals: Optional[ValidatorSet],
        last_changed: int,
    ) -> None:
        if vals is None:
            return
        if (
            last_changed == height
            or height % VALSET_CHECKPOINT_INTERVAL == 0
        ):
            info = _ValInfo(val_set=vals, last_height_changed=last_changed)
        else:
            info = _ValInfo(val_set=None, last_height_changed=last_changed)
        self._db.set(_vals_key(height), info.to_proto())

    def load_validators(self, height: int) -> Optional[ValidatorSet]:
        """Sparse lookup: follow the pointer when the stored record has
        no set (reference: internal/state/store.go:300-360)."""
        data = self._db.get(_vals_key(height))
        if data is None:
            return None
        info = _ValInfo.from_proto(data)
        if info.val_set is not None:
            vs = info.val_set
        else:
            data2 = self._db.get(_vals_key(info.last_height_changed))
            if data2 is None:
                return None
            info2 = _ValInfo.from_proto(data2)
            if info2.val_set is None:
                return None
            vs = info2.val_set
            # advance priorities to this height, like the reference
            if height > info.last_height_changed:
                vs = vs.copy_increment_proposer_priority(
                    height - info.last_height_changed
                )
        return vs

    # -- consensus params per height --

    def _save_params(
        self, height: int, params: ConsensusParams, last_changed: int
    ) -> None:
        w = ProtoWriter()
        if last_changed == height:
            w.message(1, params.to_proto())
        w.int(2, last_changed)
        self._db.set(_params_key(height), w.finish())

    def load_params(self, height: int) -> Optional[ConsensusParams]:
        data = self._db.get(_params_key(height))
        if data is None:
            return None
        r = FieldReader(data)
        p = r.get(1)
        if p is not None:
            return ConsensusParams.from_proto(p)
        data2 = self._db.get(_params_key(r.int64(2)))
        if data2 is None:
            return None
        r2 = FieldReader(data2)
        p2 = r2.get(1)
        return ConsensusParams.from_proto(p2) if p2 is not None else None

    # -- ABCI responses --

    def save_abci_responses(
        self, height: int, responses: ABCIResponses
    ) -> None:
        self._db.set(_abci_key(height), responses.to_proto())

    def load_abci_responses(self, height: int) -> Optional[ABCIResponses]:
        data = self._db.get(_abci_key(height))
        return (
            ABCIResponses.from_proto(data) if data is not None else None
        )
