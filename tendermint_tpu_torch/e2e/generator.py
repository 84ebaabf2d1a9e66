"""Seeded manifest generation.

Counterpart: tendermint_tpu/e2e/generator.py:1-71 (reference:
test/e2e/generator/generate.go). `generate(seed, count)` draws the same
manifests as the JAX package from the same seed, draw for draw:
validator counts, initial heights, databases, block-sync late joiners,
kill/disconnect/restart perturbations, a double-signer, and load.
"""

from __future__ import annotations

import random
from typing import List

from .manifest import LoadSpec, Manifest, NodeSpec, Perturbation

__all__ = ["generate"]


def _gen_one(rng: random.Random, idx: int) -> Manifest:
    n_vals = rng.choice([2, 3, 4, 4])
    # every scheduled height is relative to the chain's first block
    ih = rng.choice([1, 1, 1000])
    m = Manifest(
        chain_id=f"gen-{idx}",
        initial_height=ih,
        target_height=ih + rng.randint(3, 5),
        validators={
            f"validator{i:02d}": rng.choice([5, 10, 10])
            for i in range(1, n_vals + 1)
        },
    )
    for name in m.validators:
        m.nodes[name] = NodeSpec(
            name=name,
            database=rng.choice(["memdb", "memdb", "sqlite"]),
        )
    # a late-joining full node exercising block sync (sometimes)
    if rng.random() < 0.5:
        m.nodes["full01"] = NodeSpec(
            name="full01",
            mode="full",
            start_at=ih + 1,
            database=rng.choice(["memdb", "sqlite"]),
        )
    # perturbations on a minority of validators
    if n_vals >= 4 and rng.random() < 0.6:
        victim = rng.choice(sorted(m.validators))
        action = rng.choice(["kill", "disconnect", "restart"])
        height = ih + rng.randint(1, 2)
        spec = m.nodes[victim]
        spec.perturb = [Perturbation(action=action, height=height)]
        if action == "kill":
            spec.perturb.append(
                Perturbation(action="restart", height=height + 1)
            )
    # a double-signer needs >3 validators to stay below 1/3 power
    if n_vals >= 4 and rng.random() < 0.4:
        byz = sorted(m.validators)[-1]
        m.nodes[byz].misbehaviors = {"double-prevote": ih + 1}
    if rng.random() < 0.5:
        m.load = LoadSpec(tx_rate=rng.choice([2.0, 5.0]), tx_size=64)
    m.validate()
    return m


def generate(seed: int, count: int = 8) -> List[Manifest]:
    rng = random.Random(seed)
    return [_gen_one(rng, i) for i in range(count)]
