"""NodeKey: the p2p identity key, kept at config/node_key.json.

Counterpart: tendermint_tpu/node/key.py:23-58 (reference:
types/node_key.go NodeKey, LoadOrGenNodeKey). The node ID is the
lowercase hex of SHA-256(pubkey)[:20] (p2p.types.node_id_from_pubkey),
which the peer manager and the router take.
"""

from __future__ import annotations

import base64
import json
import os
from dataclasses import dataclass, field

from ..crypto.ed25519 import PrivKeyEd25519
from ..libs.osutil import atomic_write
from ..p2p.types import NodeID, node_id_from_pubkey

__all__ = ["NodeKey"]


@dataclass
class NodeKey:
    # repr=False: a log line renders reprs, and must never carry the key
    priv_key: PrivKeyEd25519 = field(repr=False)

    @property
    def node_id(self) -> NodeID:
        return node_id_from_pubkey(self.priv_key.pub_key())

    def save_as(self, path: str) -> None:
        doc = {
            "priv_key": {
                "type": "tendermint/PrivKeyEd25519",
                "value": base64.b64encode(self.priv_key.bytes()).decode(),
            }
        }
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        atomic_write(path, json.dumps(doc, indent=2))

    @classmethod
    def load(cls, path: str) -> "NodeKey":
        with open(path) as f:
            doc = json.load(f)
        raw = base64.b64decode(doc["priv_key"]["value"])
        return cls(priv_key=PrivKeyEd25519(raw))

    @classmethod
    def load_or_generate(cls, path: str) -> "NodeKey":
        """reference: types/node_key.go LoadOrGenNodeKey."""
        if os.path.exists(path):
            return cls.load(path)
        nk = cls(priv_key=PrivKeyEd25519.generate())
        nk.save_as(path)
        return nk
