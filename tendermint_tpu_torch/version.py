"""The port's version.

Counterpart: tendermint_tpu/version.py:1. The CLI's `version` command
prints it.
"""

__version__ = "0.1.0"
