"""GenesisDoc: the chain's consensus-critical first state, and its JSON.

Counterpart: tendermint_tpu/types/genesis.py:25-195 (GenesisValidator
:25, GenesisDoc :37 with validate_and_complete :48, validator_set,
to_json / from_json :88-186, save_as / from_file :188-195; reference:
types/genesis.go). The JSON is the reference's genesis.json.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import List, Optional

from ..crypto.keys import PubKey, pubkey_from_type_and_bytes
from .params import ConsensusParams
from .timestamp import from_rfc3339, now_ns, to_rfc3339
from .validator import Validator, ValidatorSet

__all__ = ["GenesisValidator", "GenesisDoc", "MAX_CHAIN_ID_LEN"]

MAX_CHAIN_ID_LEN = 50  # reference: types/genesis.go:27


@dataclass
class GenesisValidator:
    pub_key: PubKey
    power: int
    name: str = ""
    address: bytes = b""

    def __post_init__(self) -> None:
        if not self.address:
            self.address = self.pub_key.address()


@dataclass
class GenesisDoc:
    chain_id: str
    genesis_time_ns: int = 0
    initial_height: int = 1
    consensus_params: Optional[ConsensusParams] = field(
        default_factory=ConsensusParams
    )
    validators: List[GenesisValidator] = field(default_factory=list)
    app_hash: bytes = b""
    app_state: bytes = b""  # raw JSON passed to the app at InitChain

    def validate_and_complete(self) -> None:
        """reference: types/genesis.go:75-130."""
        if not self.chain_id:
            raise ValueError("genesis doc must include non-empty chain_id")
        if len(self.chain_id) > MAX_CHAIN_ID_LEN:
            raise ValueError(
                f"chain_id in genesis doc is too long (max: "
                f"{MAX_CHAIN_ID_LEN})"
            )
        if self.initial_height < 0:
            raise ValueError("initial_height cannot be negative")
        if self.initial_height == 0:
            self.initial_height = 1
        if self.consensus_params is None:
            self.consensus_params = ConsensusParams()
        else:
            self.consensus_params.validate()
        for i, v in enumerate(self.validators):
            if v.power == 0:
                raise ValueError(
                    f"the genesis file cannot contain validators with "
                    f"no voting power: {v.name or i}"
                )
            if v.address and v.pub_key.address() != v.address:
                raise ValueError(
                    f"incorrect address for validator {v.name or i}"
                )
        if self.genesis_time_ns == 0:
            self.genesis_time_ns = now_ns()

    def validator_set(self) -> ValidatorSet:
        return ValidatorSet(
            [
                Validator(pub_key=v.pub_key, voting_power=v.power)
                for v in self.validators
            ]
        )

    # -- JSON round-trip (canonical on-disk form) --

    def to_json(self) -> str:
        doc = {
            "genesis_time": to_rfc3339(self.genesis_time_ns),
            "chain_id": self.chain_id,
            "initial_height": str(self.initial_height),
            "consensus_params": {
                "block": {
                    "max_bytes": str(self.consensus_params.block.max_bytes),
                    "max_gas": str(self.consensus_params.block.max_gas),
                },
                "evidence": {
                    "max_age_num_blocks": str(
                        self.consensus_params.evidence.max_age_num_blocks
                    ),
                    "max_age_duration": str(
                        self.consensus_params.evidence.max_age_duration_ns
                    ),
                    "max_bytes": str(
                        self.consensus_params.evidence.max_bytes
                    ),
                },
                "validator": {
                    "pub_key_types": list(
                        self.consensus_params.validator.pub_key_types
                    ),
                },
                "version": {
                    "app_version": str(
                        self.consensus_params.version.app_version
                    ),
                },
            },
            "validators": [
                {
                    "address": v.address.hex().upper(),
                    "pub_key": {
                        "type": v.pub_key.type(),
                        "value": v.pub_key.bytes().hex(),
                    },
                    "power": str(v.power),
                    "name": v.name,
                }
                for v in self.validators
            ],
            "app_hash": self.app_hash.hex().upper(),
        }
        if self.app_state:
            doc["app_state"] = json.loads(self.app_state.decode("utf-8"))
        return json.dumps(doc, indent=2, sort_keys=False)

    @classmethod
    def from_json(cls, data: str) -> "GenesisDoc":
        doc = json.loads(data)
        cp = ConsensusParams()
        p = doc.get("consensus_params") or {}
        if "block" in p:
            cp.block.max_bytes = int(p["block"]["max_bytes"])
            cp.block.max_gas = int(p["block"]["max_gas"])
        if "evidence" in p:
            cp.evidence.max_age_num_blocks = int(
                p["evidence"]["max_age_num_blocks"]
            )
            cp.evidence.max_age_duration_ns = int(
                p["evidence"]["max_age_duration"]
            )
            cp.evidence.max_bytes = int(p["evidence"].get("max_bytes", 0))
        if "validator" in p:
            cp.validator.pub_key_types = list(
                p["validator"]["pub_key_types"]
            )
        if "version" in p:
            cp.version.app_version = int(
                p["version"].get("app_version", 0)
            )
        validators = [
            GenesisValidator(
                pub_key=pubkey_from_type_and_bytes(
                    v["pub_key"]["type"], bytes.fromhex(v["pub_key"]["value"])
                ),
                power=int(v["power"]),
                name=v.get("name", ""),
                address=bytes.fromhex(v.get("address", "")),
            )
            for v in doc.get("validators") or []
        ]
        app_state = b""
        if "app_state" in doc:
            app_state = json.dumps(doc["app_state"]).encode("utf-8")
        g = cls(
            chain_id=doc["chain_id"],
            genesis_time_ns=from_rfc3339(doc["genesis_time"]),
            initial_height=int(doc.get("initial_height", 1)),
            consensus_params=cp,
            validators=validators,
            app_hash=bytes.fromhex(doc.get("app_hash", "")),
            app_state=app_state,
        )
        g.validate_and_complete()
        return g

    def save_as(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def from_file(cls, path: str) -> "GenesisDoc":
        with open(path) as f:
            return cls.from_json(f.read())
