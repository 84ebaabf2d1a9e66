"""See the package docstring. The two secp256k1 key classes are exported
here, as tendermint_tpu/crypto/__init__.py:25 does."""

from .secp256k1 import PrivKeySecp256k1, PubKeySecp256k1  # noqa: F401
