"""PyTorch/CUDA port of tendermint_tpu's device plane.

The JAX package (`tendermint_tpu/`) is the reference this package is
held against; nothing here imports it or JAX. The first slice carries
the north-star path: `types.validation.verify_commit` of an ed25519
Commit through hand-written Hopper kernels (ops/csrc/*.cu) for SHA-512
and the ZIP-215 cofactored check. Entry points run on CUDA unless the
caller passes device="cpu", and then take the kernels' plain PyTorch
versions.
"""
