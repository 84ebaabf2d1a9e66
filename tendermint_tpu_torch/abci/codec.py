"""ABCI response encodings that a height's stored results need.

Counterpart: tendermint_tpu/abci/codec.py: the payload encoders and
decoders of events (:35-68), public keys (:71-85), validator updates
(:88-99) and the BeginBlock, DeliverTx and EndBlock responses
(:441-452, :488-537), which state/store.py's ABCIResponses stores
(reference field numbers: abci/types/types.pb.go). The request and
response envelopes (encode_request / decode_response and the other
payloads) carry the socket transport, which is not ported yet: the
local client hands the objects over as they are.
"""

from __future__ import annotations

from ..encoding.proto import FieldReader, ProtoWriter, iter_fields
from ..types.params import ConsensusParams
from . import types as T

__all__ = [
    "dec_resp_begin_block",
    "dec_resp_deliver_tx",
    "dec_resp_end_block",
    "enc_resp_begin_block",
    "enc_resp_deliver_tx",
    "enc_resp_end_block",
]


def _enc_event_attr(a: T.EventAttribute) -> bytes:
    w = ProtoWriter()
    w.bytes(1, a.key)
    w.bytes(2, a.value)
    w.bool(3, a.index)
    return w.finish()


def _enc_event(e: T.Event) -> bytes:
    w = ProtoWriter()
    w.string(1, e.type)
    for a in e.attributes:
        w.message(2, _enc_event_attr(a))
    return w.finish()


def _dec_event(data: bytes) -> T.Event:
    etype = ""
    attrs = []
    for f, _wt, v in iter_fields(data):
        if f == 1:
            if not isinstance(v, bytes):
                raise ValueError("Event.type: expected length-delimited")
            etype = v.decode()
        elif f == 2:
            r = FieldReader(v)
            attrs.append(
                T.EventAttribute(key=r.bytes(1), value=r.bytes(2), index=bool(r.uint(3)))
            )
    return T.Event(type=etype, attributes=tuple(attrs))


def _enc_pub_key(pk: T.PubKey) -> bytes:
    # oneof sum: ed25519=1, secp256k1=2, sr25519=3
    # (reference: proto/tendermint/crypto/keys.pb.go)
    w = ProtoWriter()
    fieldno = {"ed25519": 1, "secp256k1": 2, "sr25519": 3}[pk.key_type]
    w.bytes(fieldno, pk.data)
    return w.finish()


def _dec_pub_key(data: bytes) -> T.PubKey:
    names = {1: "ed25519", 2: "secp256k1", 3: "sr25519"}
    for f, _wt, v in iter_fields(data):
        if f in names:
            return T.PubKey(key_type=names[f], data=v)
    raise ValueError("empty ABCI PubKey")


def _enc_val_update(vu: T.ValidatorUpdate) -> bytes:
    w = ProtoWriter()
    w.message(1, _enc_pub_key(vu.pub_key))
    w.int(2, vu.power)
    return w.finish()


def _dec_val_update(data: bytes) -> T.ValidatorUpdate:
    r = FieldReader(data)
    return T.ValidatorUpdate(pub_key=_dec_pub_key(r.bytes(1)), power=r.int64(2))


def enc_resp_begin_block(m: T.ResponseBeginBlock) -> bytes:
    w = ProtoWriter()
    for e in m.events:
        w.message(1, _enc_event(e))
    return w.finish()


def dec_resp_begin_block(data: bytes) -> T.ResponseBeginBlock:
    return T.ResponseBeginBlock(
        events=tuple(_dec_event(v) for f, _wt, v in iter_fields(data) if f == 1)
    )


def enc_resp_deliver_tx(m: T.ResponseDeliverTx) -> bytes:
    w = ProtoWriter()
    w.uint(1, m.code)
    w.bytes(2, m.data)
    w.string(3, m.log)
    w.string(4, m.info)
    w.int(5, m.gas_wanted)
    w.int(6, m.gas_used)
    for e in m.events:
        w.message(7, _enc_event(e))
    w.string(8, m.codespace)
    return w.finish()


def dec_resp_deliver_tx(data: bytes) -> T.ResponseDeliverTx:
    r = FieldReader(data)
    return T.ResponseDeliverTx(
        code=r.uint(1),
        data=r.bytes(2),
        log=r.bytes(3, b"").decode(),
        info=r.bytes(4, b"").decode(),
        gas_wanted=r.int64(5),
        gas_used=r.int64(6),
        events=tuple(_dec_event(v) for v in r.get_all(7)),
        codespace=r.bytes(8, b"").decode(),
    )


def enc_resp_end_block(m: T.ResponseEndBlock) -> bytes:
    w = ProtoWriter()
    for vu in m.validator_updates:
        w.message(1, _enc_val_update(vu))
    if m.consensus_param_updates is not None:
        w.message(2, m.consensus_param_updates.to_proto())
    for e in m.events:
        w.message(3, _enc_event(e))
    return w.finish()


def dec_resp_end_block(data: bytes) -> T.ResponseEndBlock:
    r = FieldReader(data)
    params = None
    if r.get(2) is not None:
        params = ConsensusParams.from_proto(r.bytes(2))
    return T.ResponseEndBlock(
        validator_updates=tuple(_dec_val_update(v) for v in r.get_all(1)),
        consensus_param_updates=params,
        events=tuple(_dec_event(v) for v in r.get_all(3)),
    )
