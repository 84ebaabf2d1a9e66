"""FilePV: a file-backed validator signer with double-sign protection.

Counterpart: tendermint_tpu/privval/file.py:1-406 (reference:
privval/file.go: FilePVKey :39-77, FilePVLastSignState :84-168 with
CheckHRS :109, FilePV :171-420 with signVote :281, signProposal :341,
saveSigned :371, and the only-the-timestamp-differs checks :388-420).
The key and state files are the JAX package's JSON, byte for byte.

The last-sign state is fsynced before a signature leaves this object, so
a crash never releases two conflicting signatures for one height, round
and step. Fault point `privval.save` (crypto/faults.py: io_error, an
fsync failure; raise, a crash before the checkpoint), keyed by the node
home's basename. Fault point `privval.release`
(tendermint_tpu/privval/file.py:339), same key, fires between the
checkpoint's fsync and the signature leaving this object: a raise there
stands for a SIGKILL between sign and send, and the restarted signer must
re-release that signature, never a conflicting one.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field

from ..crypto import faults
from ..crypto.keys import (
    PrivKey,
    PubKey,
    generate_priv_key,
    privkey_from_type_and_bytes,
    pubkey_from_type_and_bytes,
)
from ..encoding.proto import ProtoWriter, iter_fields
from ..libs.osutil import atomic_write
from ..types.canonical import PRECOMMIT_TYPE, PREVOTE_TYPE
from ..types.proposal import Proposal
from ..types.vote import Vote
from .types import PrivValidator

__all__ = ["FilePV", "FilePVKey", "FilePVLastSignState"]

# Sign step numbering (reference: privval/file.go:29-36)
STEP_NONE = 0
STEP_PROPOSE = 1
STEP_PREVOTE = 2
STEP_PRECOMMIT = 3


def vote_to_step(vote: Vote) -> int:
    if vote.type == PREVOTE_TYPE:
        return STEP_PREVOTE
    if vote.type == PRECOMMIT_TYPE:
        return STEP_PRECOMMIT
    raise ValueError(f"unknown vote type: {vote.type}")


# A signature must never escape before its HRS checkpoint is on disk;
# the consensus core serializes signing, so the fsync happens at most
# once per own-vote — same policy as the reference's WAL WriteSync.
_atomic_write = atomic_write


def _node_key(state_file_path: str) -> str:
    """Fault-point key for the privval.* points: the node home's
    basename (key/state files live at <home>/config/... and
    <home>/data/...), so a rule's `key=` can target one validator in a
    multi-node net."""
    d = os.path.dirname(state_file_path)
    if os.path.basename(d) in ("config", "data"):
        d = os.path.dirname(d)
    return os.path.basename(d)


def _strip_timestamp(sign_bytes: bytes, ts_field: int) -> bytes:
    """Re-encode canonical sign-bytes with the Timestamp field removed, so
    two requests can be compared modulo timestamp (reference:
    privval/file.go:388-420 zeroes the timestamp and re-marshals)."""
    # sign_bytes is varint-length-prefixed; strip the prefix first.
    from ..encoding.proto import read_length_prefixed

    body, _ = read_length_prefixed(sign_bytes)
    w = ProtoWriter()
    for fieldnum, wtype, value in iter_fields(body):
        if fieldnum == ts_field:
            continue
        if wtype == 0:
            w.uint(fieldnum, value)
        elif wtype == 1:
            w.fixed64(fieldnum, value)
        elif wtype == 2:
            w.bytes(fieldnum, value)
        else:  # pragma: no cover - canonical messages only use 0/1/2
            raise ValueError(f"unexpected wire type {wtype}")
    return w.finish()


@dataclass
class FilePVKey:
    """Immutable key part, stored in the key file
    (reference: privval/file.go:39-77)."""

    address: bytes
    pub_key: PubKey
    # repr=False: the generated __repr__ never shows key material
    priv_key: PrivKey = field(repr=False)
    file_path: str = ""

    def save(self) -> None:
        data = json.dumps(
            {
                "address": self.address.hex().upper(),
                "pub_key": {
                    "type": self.pub_key.type(),
                    "value": self.pub_key.bytes().hex(),
                },
                "priv_key": {
                    "type": self.priv_key.type(),
                    "value": self.priv_key.bytes().hex(),
                },
            },
            indent=2,
        )
        _atomic_write(self.file_path, data)

    @classmethod
    def load(cls, path: str) -> "FilePVKey":
        with open(path) as f:
            raw = json.load(f)
        key_type = raw["priv_key"]["type"]
        priv = privkey_from_type_and_bytes(
            key_type, bytes.fromhex(raw["priv_key"]["value"])
        )
        pub = pubkey_from_type_and_bytes(
            raw["pub_key"]["type"], bytes.fromhex(raw["pub_key"]["value"])
        )
        addr = bytes.fromhex(raw["address"])
        if pub.address() != addr:
            raise ValueError("privval key file address/pubkey mismatch")
        return cls(address=addr, pub_key=pub, priv_key=priv, file_path=path)


@dataclass
class FilePVLastSignState:
    """Mutable part — the double-sign checkpoint
    (reference: privval/file.go:84-168)."""

    height: int = 0
    round: int = 0
    step: int = STEP_NONE
    signature: bytes = b""
    sign_bytes: bytes = b""
    file_path: str = ""

    def check_hrs(self, height: int, round_: int, step: int) -> bool:
        """Error if the HRS regressed; True if this exact HRS was already
        signed (caller must then reuse/refuse) (reference:
        privval/file.go:109-151)."""
        if self.height > height:
            raise ValueError(f"height regression. Got {height}, last height {self.height}")
        if self.height == height:
            if self.round > round_:
                raise ValueError(
                    f"round regression at height {height}. "
                    f"Got {round_}, last round {self.round}"
                )
            if self.round == round_:
                if self.step > step:
                    raise ValueError(
                        f"step regression at height {height} round {round_}. "
                        f"Got {step}, last step {self.step}"
                    )
                if self.step == step:
                    if not self.sign_bytes:
                        raise ValueError("no sign_bytes but HRS matches")
                    if not self.signature:
                        raise RuntimeError(
                            "privval: signature is nil but sign_bytes is not"
                        )
                    return True
        return False

    def save(self) -> None:
        if faults.armed():
            # "privval.save": the checkpoint write/fsync itself fails
            # (io_error) or the process dies before persisting (raise).
            # Keyed by the node home's basename so multi-node chaos
            # scenarios can target one validator's signer.
            faults.fire("privval.save", key=_node_key(self.file_path))
        data = json.dumps(
            {
                "height": self.height,
                "round": self.round,
                "step": self.step,
                "signature": self.signature.hex(),
                "signbytes": self.sign_bytes.hex(),
            },
            indent=2,
        )
        _atomic_write(self.file_path, data)

    @classmethod
    def load(cls, path: str) -> "FilePVLastSignState":
        with open(path) as f:
            raw = json.load(f)
        return cls(
            height=raw.get("height", 0),
            round=raw.get("round", 0),
            step=raw.get("step", STEP_NONE),
            signature=bytes.fromhex(raw.get("signature", "")),
            sign_bytes=bytes.fromhex(raw.get("signbytes", "")),
            file_path=path,
        )


class FilePV(PrivValidator):
    """reference: privval/file.go:171-420."""

    def __init__(self, key: FilePVKey, last_sign_state: FilePVLastSignState):
        self.key = key
        self.last_sign_state = last_sign_state

    # -- construction --

    @classmethod
    def generate(
        cls,
        key_file_path: str,
        state_file_path: str,
        key_type: str = "ed25519",
    ) -> "FilePV":
        """reference: privval/file.go:188 GenFilePV: ed25519 by default,
        secp256k1 on request, any other type refused."""
        priv = generate_priv_key(key_type)
        return cls.from_priv_key(priv, key_file_path, state_file_path)

    @classmethod
    def from_priv_key(
        cls, priv: PrivKey, key_file_path: str, state_file_path: str
    ) -> "FilePV":
        pub = priv.pub_key()
        key = FilePVKey(
            address=pub.address(),
            pub_key=pub,
            priv_key=priv,
            file_path=key_file_path,
        )
        lss = FilePVLastSignState(file_path=state_file_path)
        return cls(key, lss)

    @classmethod
    def load(cls, key_file_path: str, state_file_path: str) -> "FilePV":
        """A missing state file is an error: silently starting from an
        empty last-sign-state would disable double-sign protection after
        e.g. a partial backup restore (reference: privval/file.go
        LoadFilePV vs the separate, explicit LoadFilePVEmptyState)."""
        key = FilePVKey.load(key_file_path)
        lss = FilePVLastSignState.load(state_file_path)
        return cls(key, lss)

    @classmethod
    def load_empty_state(
        cls, key_file_path: str, state_file_path: str
    ) -> "FilePV":
        """Explicitly discard any last-sign-state (reference:
        privval/file.go LoadFilePVEmptyState). Only safe when the operator
        knows this key has never signed, or accepts the slashing risk."""
        key = FilePVKey.load(key_file_path)
        return cls(key, FilePVLastSignState(file_path=state_file_path))

    @classmethod
    def load_or_generate(
        cls,
        key_file_path: str,
        state_file_path: str,
        key_type: str = "ed25519",
    ) -> "FilePV":
        """reference: privval/file.go LoadOrGenFilePV (key_type applies
        only when generating; an existing file keeps its own type)."""
        if os.path.exists(key_file_path):
            return cls.load(key_file_path, state_file_path)
        pv = cls.generate(key_file_path, state_file_path, key_type)
        pv.save()
        return pv

    def save(self) -> None:
        self.key.save()
        self.last_sign_state.save()

    # -- PrivValidator --

    async def get_pub_key(self) -> PubKey:
        return self.key.pub_key

    async def sign_vote(self, chain_id: str, vote: Vote) -> None:
        self._sign_vote(chain_id, vote)

    async def sign_proposal(self, chain_id: str, proposal: Proposal) -> None:
        self._sign_proposal(chain_id, proposal)

    # -- internals --

    def _sign_vote(self, chain_id: str, vote: Vote) -> None:
        """reference: privval/file.go:281-338."""
        height, round_, step = vote.height, vote.round, vote_to_step(vote)
        lss = self.last_sign_state
        same_hrs = lss.check_hrs(height, round_, step)

        if vote.timestamp_ns == 0:
            vote.timestamp_ns = time.time_ns()
        sign_bytes = vote.sign_bytes(chain_id)

        if same_hrs:
            # Only the timestamp may differ; re-release the saved signature
            # with the saved timestamp (reference: privval/file.go:313-330).
            if sign_bytes == lss.sign_bytes:
                vote.signature = lss.signature
            elif _strip_timestamp(sign_bytes, 5) == _strip_timestamp(
                lss.sign_bytes, 5
            ):
                vote.timestamp_ns = _extract_ts(lss.sign_bytes, 5)
                vote.signature = lss.signature
            else:
                raise ValueError(
                    "conflicting data: vote differs from last signed vote "
                    "at the same height/round/step"
                )
            return

        sig = self.key.priv_key.sign(sign_bytes)
        self._save_signed(height, round_, step, sign_bytes, sig)
        if faults.armed():
            faults.fire("privval.release", key=_node_key(lss.file_path))
        vote.signature = sig

    def _sign_proposal(self, chain_id: str, proposal: Proposal) -> None:
        """reference: privval/file.go:341-370."""
        height, round_, step = proposal.height, proposal.round, STEP_PROPOSE
        lss = self.last_sign_state
        same_hrs = lss.check_hrs(height, round_, step)

        if proposal.timestamp_ns == 0:
            proposal.timestamp_ns = time.time_ns()
        sign_bytes = proposal.sign_bytes(chain_id)

        if same_hrs:
            if sign_bytes == lss.sign_bytes:
                proposal.signature = lss.signature
            elif _strip_timestamp(sign_bytes, 6) == _strip_timestamp(
                lss.sign_bytes, 6
            ):
                proposal.timestamp_ns = _extract_ts(lss.sign_bytes, 6)
                proposal.signature = lss.signature
            else:
                raise ValueError(
                    "conflicting data: proposal differs from last signed "
                    "proposal at the same height/round"
                )
            return

        sig = self.key.priv_key.sign(sign_bytes)
        self._save_signed(height, round_, step, sign_bytes, sig)
        if faults.armed():
            faults.fire("privval.release", key=_node_key(lss.file_path))
        proposal.signature = sig

    def _save_signed(
        self, height: int, round_: int, step: int,
        sign_bytes: bytes, sig: bytes,
    ) -> None:
        """Persist BEFORE the signature escapes
        (reference: privval/file.go:371-385)."""
        lss = self.last_sign_state
        lss.height = height
        lss.round = round_
        lss.step = step
        lss.signature = sig
        lss.sign_bytes = sign_bytes
        lss.save()


def _extract_ts(sign_bytes: bytes, ts_field: int) -> int:
    """Pull the canonical Timestamp back out of saved sign-bytes."""
    from ..encoding.proto import read_length_prefixed
    from ..types.timestamp import decode_timestamp

    body, _ = read_length_prefixed(sign_bytes)
    for fieldnum, wtype, value in iter_fields(body):
        if fieldnum == ts_field and wtype == 2:
            return decode_timestamp(value)
    return 0
