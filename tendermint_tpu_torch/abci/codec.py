"""ABCI wire codec: the deterministic protobuf of every Request and
Response, and their oneof envelopes.

Counterpart: tendermint_tpu/abci/codec.py:25-727: the payload encoders
and decoders (events, public keys, validator updates, the validator and
vote info of LastCommitInfo, misbehavior, snapshots, every request and
response) and the envelopes encode_request / decode_request /
encode_response / decode_response, whose oneof field numbers are the
reference's (abci/types/types.pb.go:218-261 Request, :1226-1262
Response). The socket transport frames them varint-length-delimited
(abci/client.py SocketClient, abci/server.py SocketServer). The BeginBlock,
DeliverTx and EndBlock response codecs are public: state/store.py's
ABCIResponses stores their bytes.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

from ..encoding.proto import FieldReader, ProtoWriter, decode_varint, encode_varint, iter_fields
from ..types.params import ConsensusParams
from . import types as T

__all__ = [
    "dec_resp_begin_block",
    "dec_resp_deliver_tx",
    "dec_resp_end_block",
    "decode_request",
    "decode_response",
    "enc_resp_begin_block",
    "enc_resp_deliver_tx",
    "enc_resp_end_block",
    "encode_request",
    "encode_response",
]


# ---------------------------------------------------------------------------
# Payload encoders (inner messages)


def _enc_echo(msg) -> bytes:
    w = ProtoWriter()
    w.string(1, msg.message)
    return w.finish()


def _enc_empty(_msg) -> bytes:
    return b""


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
                T.EventAttribute(
                    key=r.bytes(1), value=r.bytes(2), index=bool(r.uint(3))
                )
            )
    return T.Event(type=etype, attributes=tuple(attrs))


def _enc_pub_key(pk: T.PubKey) -> bytes:
    # oneof sum — ed25519=1, secp256k1=2, sr25519=3
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
    return T.ValidatorUpdate(
        pub_key=_dec_pub_key(r.bytes(1)), power=r.int64(2)
    )


def _enc_validator(v: T.Validator) -> bytes:
    w = ProtoWriter()
    w.bytes(1, v.address)
    w.int(3, v.power)  # field 2 unused, matching reference Validator
    return w.finish()


def _dec_validator(data: bytes) -> T.Validator:
    r = FieldReader(data)
    return T.Validator(address=r.bytes(1), power=r.int64(3))


def _enc_vote_info(vi: T.VoteInfo) -> bytes:
    w = ProtoWriter()
    w.message(1, _enc_validator(vi.validator))
    w.bool(2, vi.signed_last_block)
    return w.finish()


def _enc_commit_info(ci: T.LastCommitInfo) -> bytes:
    w = ProtoWriter()
    w.int(1, ci.round)
    for vi in ci.votes:
        w.message(2, _enc_vote_info(vi))
    return w.finish()


def _dec_commit_info(data: bytes) -> T.LastCommitInfo:
    rnd = 0
    votes = []
    for f, _wt, v in iter_fields(data):
        if f == 1:
            rnd = int(v)
        elif f == 2:
            r = FieldReader(v)
            votes.append(
                T.VoteInfo(
                    validator=_dec_validator(r.bytes(1)),
                    signed_last_block=bool(r.uint(2)),
                )
            )
    return T.LastCommitInfo(round=rnd, votes=tuple(votes))


def _enc_misbehavior(m: T.Misbehavior) -> bytes:
    w = ProtoWriter()
    w.int(1, m.kind)
    w.message(2, _enc_validator(m.validator))
    w.int(3, m.height)
    w.sfixed64(4, m.time_ns)
    w.int(5, m.total_voting_power)
    return w.finish()


def _dec_misbehavior(data: bytes) -> T.Misbehavior:
    r = FieldReader(data)
    return T.Misbehavior(
        kind=r.int64(1),
        validator=_dec_validator(r.bytes(2, b"")),
        height=r.int64(3),
        time_ns=r.sfixed64(4),
        total_voting_power=r.int64(5),
    )


def _enc_snapshot(s: T.Snapshot) -> bytes:
    w = ProtoWriter()
    w.uint(1, s.height)
    w.uint(2, s.format)
    w.uint(3, s.chunks)
    w.bytes(4, s.hash)
    w.bytes(5, s.metadata)
    return w.finish()


def _dec_snapshot(data: bytes) -> T.Snapshot:
    r = FieldReader(data)
    return T.Snapshot(
        height=r.uint(1),
        format=r.uint(2),
        chunks=r.uint(3),
        hash=r.bytes(4),
        metadata=r.bytes(5),
    )


# -- requests --


def _enc_req_info(m: T.RequestInfo) -> bytes:
    w = ProtoWriter()
    w.string(1, m.version)
    w.uint(2, m.block_version)
    w.uint(3, m.p2p_version)
    w.string(4, m.abci_version)
    return w.finish()


def _dec_req_info(data: bytes) -> T.RequestInfo:
    r = FieldReader(data)
    return T.RequestInfo(
        version=r.bytes(1, b"").decode(),
        block_version=r.uint(2),
        p2p_version=r.uint(3),
        abci_version=r.bytes(4, b"").decode(),
    )


def _enc_req_init_chain(m: T.RequestInitChain) -> bytes:
    w = ProtoWriter()
    w.sfixed64(1, m.time_ns)
    w.string(2, m.chain_id)
    if m.consensus_params is not None:
        w.message(3, m.consensus_params.to_proto())
    for vu in m.validators:
        w.message(4, _enc_val_update(vu))
    w.bytes(5, m.app_state_bytes)
    w.int(6, m.initial_height)
    return w.finish()


def _dec_req_init_chain(data: bytes) -> T.RequestInitChain:
    params = None
    vals = []
    r = FieldReader(data)
    if r.get(3) is not None:
        params = ConsensusParams.from_proto(r.bytes(3))
    for v in r.get_all(4):
        vals.append(_dec_val_update(v))
    return T.RequestInitChain(
        time_ns=r.sfixed64(1),
        chain_id=r.bytes(2, b"").decode(),
        consensus_params=params,
        validators=tuple(vals),
        app_state_bytes=r.bytes(5),
        initial_height=r.int64(6),
    )


def _enc_req_query(m: T.RequestQuery) -> bytes:
    w = ProtoWriter()
    w.bytes(1, m.data)
    w.string(2, m.path)
    w.int(3, m.height)
    w.bool(4, m.prove)
    return w.finish()


def _dec_req_query(data: bytes) -> T.RequestQuery:
    r = FieldReader(data)
    return T.RequestQuery(
        data=r.bytes(1),
        path=r.bytes(2, b"").decode(),
        height=r.int64(3),
        prove=bool(r.uint(4)),
    )


def _enc_req_begin_block(m: T.RequestBeginBlock) -> bytes:
    w = ProtoWriter()
    w.bytes(1, m.hash)
    w.message(2, m.header_bytes)
    w.message(3, _enc_commit_info(m.last_commit_info))
    for ev in m.byzantine_validators:
        w.message(4, _enc_misbehavior(ev))
    return w.finish()


def _dec_req_begin_block(data: bytes) -> T.RequestBeginBlock:
    r = FieldReader(data)
    return T.RequestBeginBlock(
        hash=r.bytes(1),
        header_bytes=r.bytes(2),
        last_commit_info=_dec_commit_info(r.bytes(3)),
        byzantine_validators=tuple(
            _dec_misbehavior(v) for v in r.get_all(4)
        ),
    )


def _enc_req_check_tx(m: T.RequestCheckTx) -> bytes:
    w = ProtoWriter()
    w.bytes(1, m.tx)
    w.int(2, m.type)
    return w.finish()


def _dec_req_check_tx(data: bytes) -> T.RequestCheckTx:
    r = FieldReader(data)
    return T.RequestCheckTx(tx=r.bytes(1), type=r.int64(2))


def _enc_req_deliver_tx(m: T.RequestDeliverTx) -> bytes:
    w = ProtoWriter()
    w.bytes(1, m.tx)
    return w.finish()


def _dec_req_deliver_tx(data: bytes) -> T.RequestDeliverTx:
    return T.RequestDeliverTx(tx=FieldReader(data).bytes(1))


def _enc_req_end_block(m: T.RequestEndBlock) -> bytes:
    w = ProtoWriter()
    w.int(1, m.height)
    return w.finish()


def _dec_req_end_block(data: bytes) -> T.RequestEndBlock:
    return T.RequestEndBlock(height=FieldReader(data).int64(1))


def _enc_req_offer_snapshot(m: T.RequestOfferSnapshot) -> bytes:
    w = ProtoWriter()
    if m.snapshot is not None:
        w.message(1, _enc_snapshot(m.snapshot))
    w.bytes(2, m.app_hash)
    return w.finish()


def _dec_req_offer_snapshot(data: bytes) -> T.RequestOfferSnapshot:
    r = FieldReader(data)
    snap = None
    if r.get(1) is not None:
        snap = _dec_snapshot(r.bytes(1))
    return T.RequestOfferSnapshot(snapshot=snap, app_hash=r.bytes(2))


def _enc_req_load_chunk(m: T.RequestLoadSnapshotChunk) -> bytes:
    w = ProtoWriter()
    w.uint(1, m.height)
    w.uint(2, m.format)
    w.uint(3, m.chunk)
    return w.finish()


def _dec_req_load_chunk(data: bytes) -> T.RequestLoadSnapshotChunk:
    r = FieldReader(data)
    return T.RequestLoadSnapshotChunk(
        height=r.uint(1), format=r.uint(2), chunk=r.uint(3)
    )


def _enc_req_apply_chunk(m: T.RequestApplySnapshotChunk) -> bytes:
    w = ProtoWriter()
    w.uint(1, m.index)
    w.bytes(2, m.chunk)
    w.string(3, m.sender)
    return w.finish()


def _dec_req_apply_chunk(data: bytes) -> T.RequestApplySnapshotChunk:
    r = FieldReader(data)
    return T.RequestApplySnapshotChunk(
        index=r.uint(1), chunk=r.bytes(2), sender=r.bytes(3, b"").decode()
    )


# -- responses --


def _enc_resp_exception(m: T.ResponseException) -> bytes:
    w = ProtoWriter()
    w.string(1, m.error)
    return w.finish()


def _enc_resp_info(m: T.ResponseInfo) -> bytes:
    w = ProtoWriter()
    w.string(1, m.data)
    w.string(2, m.version)
    w.uint(3, m.app_version)
    w.int(4, m.last_block_height)
    w.bytes(5, m.last_block_app_hash)
    return w.finish()


def _dec_resp_info(data: bytes) -> T.ResponseInfo:
    r = FieldReader(data)
    return T.ResponseInfo(
        data=r.bytes(1, b"").decode(),
        version=r.bytes(2, b"").decode(),
        app_version=r.uint(3),
        last_block_height=r.int64(4),
        last_block_app_hash=r.bytes(5),
    )


def _enc_resp_init_chain(m: T.ResponseInitChain) -> bytes:
    w = ProtoWriter()
    if m.consensus_params is not None:
        w.message(1, m.consensus_params.to_proto())
    for vu in m.validators:
        w.message(2, _enc_val_update(vu))
    w.bytes(3, m.app_hash)
    return w.finish()


def _dec_resp_init_chain(data: bytes) -> T.ResponseInitChain:
    r = FieldReader(data)
    params = None
    if r.get(1) is not None:
        params = ConsensusParams.from_proto(r.bytes(1))
    return T.ResponseInitChain(
        consensus_params=params,
        validators=tuple(_dec_val_update(v) for v in r.get_all(2)),
        app_hash=r.bytes(3),
    )


def _enc_resp_query(m: T.ResponseQuery) -> bytes:
    w = ProtoWriter()
    w.uint(1, m.code)
    w.string(3, m.log)
    w.string(4, m.info)
    w.int(5, m.index)
    w.bytes(6, m.key)
    w.bytes(7, m.value)
    # field 8 proof_ops omitted from wire for now (host-local clients pass
    # the object through; socket apps requiring proofs encode their own)
    w.int(9, m.height)
    w.string(10, m.codespace)
    return w.finish()


def _dec_resp_query(data: bytes) -> T.ResponseQuery:
    r = FieldReader(data)
    return T.ResponseQuery(
        code=r.uint(1),
        log=r.bytes(3, b"").decode(),
        info=r.bytes(4, b"").decode(),
        index=r.int64(5),
        key=r.bytes(6),
        value=r.bytes(7),
        height=r.int64(9),
        codespace=r.bytes(10, b"").decode(),
    )


def enc_resp_begin_block(m: T.ResponseBeginBlock) -> bytes:
    w = ProtoWriter()
    for e in m.events:
        w.message(1, _enc_event(e))
    return w.finish()


def dec_resp_begin_block(data: bytes) -> T.ResponseBeginBlock:
    return T.ResponseBeginBlock(
        events=tuple(_dec_event(v) for _f, _wt, v in iter_fields(data) if _f == 1)
    )


def _enc_resp_check_tx(m: T.ResponseCheckTx) -> bytes:
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
    w.string(9, m.sender)
    w.int(10, m.priority)
    w.string(11, m.mempool_error)
    return w.finish()


def _dec_resp_check_tx(data: bytes) -> T.ResponseCheckTx:
    r = FieldReader(data)
    return T.ResponseCheckTx(
        code=r.uint(1),
        data=r.bytes(2),
        log=r.bytes(3, b"").decode(),
        info=r.bytes(4, b"").decode(),
        gas_wanted=r.int64(5),
        gas_used=r.int64(6),
        events=tuple(_dec_event(v) for v in r.get_all(7)),
        codespace=r.bytes(8, b"").decode(),
        sender=r.bytes(9, b"").decode(),
        priority=r.int64(10),
        mempool_error=r.bytes(11, b"").decode(),
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


def _enc_resp_commit(m: T.ResponseCommit) -> bytes:
    w = ProtoWriter()
    w.bytes(2, m.data)
    w.int(3, m.retain_height)
    return w.finish()


def _dec_resp_commit(data: bytes) -> T.ResponseCommit:
    r = FieldReader(data)
    return T.ResponseCommit(data=r.bytes(2), retain_height=r.int64(3))


def _enc_resp_list_snapshots(m: T.ResponseListSnapshots) -> bytes:
    w = ProtoWriter()
    for s in m.snapshots:
        w.message(1, _enc_snapshot(s))
    return w.finish()


def _dec_resp_list_snapshots(data: bytes) -> T.ResponseListSnapshots:
    return T.ResponseListSnapshots(
        snapshots=tuple(
            _dec_snapshot(v) for f, _wt, v in iter_fields(data) if f == 1
        )
    )


def _enc_resp_offer_snapshot(m: T.ResponseOfferSnapshot) -> bytes:
    w = ProtoWriter()
    w.int(1, m.result)
    return w.finish()


def _dec_resp_offer_snapshot(data: bytes) -> T.ResponseOfferSnapshot:
    return T.ResponseOfferSnapshot(result=FieldReader(data).int64(1))


def _enc_resp_load_chunk(m: T.ResponseLoadSnapshotChunk) -> bytes:
    w = ProtoWriter()
    w.bytes(1, m.chunk)
    return w.finish()


def _dec_resp_load_chunk(data: bytes) -> T.ResponseLoadSnapshotChunk:
    return T.ResponseLoadSnapshotChunk(chunk=FieldReader(data).bytes(1))


def _enc_resp_apply_chunk(m: T.ResponseApplySnapshotChunk) -> bytes:
    w = ProtoWriter()
    w.int(1, m.result)
    if m.refetch_chunks:  # packed repeated uint64 (zero indices must survive)
        w.bytes(2, b"".join(encode_varint(c) for c in m.refetch_chunks))
    for s in m.reject_senders:
        w.string(3, s)
    return w.finish()


def _dec_resp_apply_chunk(data: bytes) -> T.ResponseApplySnapshotChunk:
    result = 0
    refetch = []
    reject = []
    for f, wt, v in iter_fields(data):
        if f == 1:
            result = int(v)
        elif f == 2:
            if wt == 2:  # packed
                off = 0
                while off < len(v):
                    c, off = decode_varint(v, off)
                    refetch.append(c)
            else:
                refetch.append(int(v))
        elif f == 3:
            reject.append(v.decode())
    return T.ResponseApplySnapshotChunk(
        result=result, refetch_chunks=tuple(refetch), reject_senders=tuple(reject)
    )


# ---------------------------------------------------------------------------
# Oneof envelope (field numbers: reference abci/types/types.pb.go)

_REQ_TABLE: Dict[type, Tuple[int, Callable]] = {
    T.RequestEcho: (1, _enc_echo),
    T.RequestFlush: (2, _enc_empty),
    T.RequestInfo: (3, _enc_req_info),
    T.RequestInitChain: (4, _enc_req_init_chain),
    T.RequestQuery: (5, _enc_req_query),
    T.RequestBeginBlock: (6, _enc_req_begin_block),
    T.RequestCheckTx: (7, _enc_req_check_tx),
    T.RequestDeliverTx: (8, _enc_req_deliver_tx),
    T.RequestEndBlock: (9, _enc_req_end_block),
    T.RequestCommit: (10, _enc_empty),
    T.RequestListSnapshots: (11, _enc_empty),
    T.RequestOfferSnapshot: (12, _enc_req_offer_snapshot),
    T.RequestLoadSnapshotChunk: (13, _enc_req_load_chunk),
    T.RequestApplySnapshotChunk: (14, _enc_req_apply_chunk),
}

_REQ_DECODE: Dict[int, Callable] = {
    1: lambda d: T.RequestEcho(message=FieldReader(d).bytes(1, b"").decode()),
    2: lambda d: T.RequestFlush(),
    3: _dec_req_info,
    4: _dec_req_init_chain,
    5: _dec_req_query,
    6: _dec_req_begin_block,
    7: _dec_req_check_tx,
    8: _dec_req_deliver_tx,
    9: _dec_req_end_block,
    10: lambda d: T.RequestCommit(),
    11: lambda d: T.RequestListSnapshots(),
    12: _dec_req_offer_snapshot,
    13: _dec_req_load_chunk,
    14: _dec_req_apply_chunk,
}

_RESP_TABLE: Dict[type, Tuple[int, Callable]] = {
    T.ResponseException: (1, _enc_resp_exception),
    T.ResponseEcho: (2, _enc_echo),
    T.ResponseFlush: (3, _enc_empty),
    T.ResponseInfo: (4, _enc_resp_info),
    T.ResponseInitChain: (5, _enc_resp_init_chain),
    T.ResponseQuery: (6, _enc_resp_query),
    T.ResponseBeginBlock: (7, enc_resp_begin_block),
    T.ResponseCheckTx: (8, _enc_resp_check_tx),
    T.ResponseDeliverTx: (9, enc_resp_deliver_tx),
    T.ResponseEndBlock: (10, enc_resp_end_block),
    T.ResponseCommit: (11, _enc_resp_commit),
    T.ResponseListSnapshots: (12, _enc_resp_list_snapshots),
    T.ResponseOfferSnapshot: (13, _enc_resp_offer_snapshot),
    T.ResponseLoadSnapshotChunk: (14, _enc_resp_load_chunk),
    T.ResponseApplySnapshotChunk: (15, _enc_resp_apply_chunk),
}

_RESP_DECODE: Dict[int, Callable] = {
    1: lambda d: T.ResponseException(error=FieldReader(d).bytes(1, b"").decode()),
    2: lambda d: T.ResponseEcho(message=FieldReader(d).bytes(1, b"").decode()),
    3: lambda d: T.ResponseFlush(),
    4: _dec_resp_info,
    5: _dec_resp_init_chain,
    6: _dec_resp_query,
    7: dec_resp_begin_block,
    8: _dec_resp_check_tx,
    9: dec_resp_deliver_tx,
    10: dec_resp_end_block,
    11: _dec_resp_commit,
    12: _dec_resp_list_snapshots,
    13: _dec_resp_offer_snapshot,
    14: _dec_resp_load_chunk,
    15: _dec_resp_apply_chunk,
}


def _encode_oneof(msg, table: Dict[type, Tuple[int, Callable]]) -> bytes:
    entry = table.get(type(msg))
    if entry is None:
        raise TypeError(f"not an ABCI oneof payload: {type(msg).__name__}")
    fieldno, enc = entry
    w = ProtoWriter()
    w.message(fieldno, enc(msg))
    return w.finish()


def _decode_oneof(data: bytes, table: Dict[int, Callable]):
    for f, _wt, v in iter_fields(data):
        dec = table.get(f)
        if dec is not None:
            return dec(v)
    raise ValueError("empty/unknown ABCI envelope")


def encode_request(msg) -> bytes:
    return _encode_oneof(msg, _REQ_TABLE)


def decode_request(data: bytes):
    return _decode_oneof(data, _REQ_DECODE)


def encode_response(msg) -> bytes:
    return _encode_oneof(msg, _RESP_TABLE)


def decode_response(data: bytes):
    return _decode_oneof(data, _RESP_DECODE)
