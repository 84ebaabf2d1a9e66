"""The batch split over several GPUs (counterpart:
tendermint_tpu/parallel/__init__.py)."""

from .sharding import (  # noqa: F401
    Mesh,
    ShardedEd25519Verifier,
    ShardedSr25519Verifier,
    make_mesh,
    sharded_batch_verify,
)

__all__ = [
    "Mesh",
    "ShardedEd25519Verifier",
    "ShardedSr25519Verifier",
    "make_mesh",
    "sharded_batch_verify",
]
