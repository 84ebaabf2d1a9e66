"""PyTorch/CUDA port of tendermint_tpu's device plane.

The JAX package (`tendermint_tpu/`) is the reference this package is
held against; nothing here imports it or JAX. It carries the
north-star path: `types.validation.verify_commit` of a Commit of
ed25519 and sr25519 validators through hand-written Hopper kernels
(ops/csrc/*.cu) for SHA-512, the ZIP-215 cofactored check and the
sr25519 check over ristretto255; merkle roots and proofs (SHA-256
kernels); and the light client (`light/`), whose sequential sync merges
the signatures of up to 32 commits into one device batch. Entry points
run on CUDA unless the caller passes device="cpu", and then take the
kernels' plain PyTorch versions. `python3 -m tendermint_tpu_torch.bench`
prints the port's numbers on the card.
"""
