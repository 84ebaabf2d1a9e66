"""The operator CLI (counterpart: tendermint_tpu/cmd/; reference:
cmd/tendermint/)."""

from .commands import build_parser, main  # noqa: F401
