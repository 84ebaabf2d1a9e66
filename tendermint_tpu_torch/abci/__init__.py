"""ABCI, the application boundary: payloads, the local client, the proxy
mux and the kvstore app (counterpart: tendermint_tpu/abci/). The socket
and gRPC transports and servers are not ported yet."""

from . import types  # noqa: F401
from .client import ABCIClient, LocalClient, local_creator  # noqa: F401
from .kvstore import KVStoreApplication  # noqa: F401
from .proxy import AppConns  # noqa: F401
from .types import Application, BaseApplication  # noqa: F401
