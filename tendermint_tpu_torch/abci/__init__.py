"""ABCI, the application boundary: payloads and their codec, the local
and socket clients, the socket server, the proxy mux and the kvstore app
(counterpart: tendermint_tpu/abci/). The gRPC transport is ROADMAP item
21b."""

from . import types  # noqa: F401
from .client import ABCIClient, LocalClient, SocketClient, local_creator, socket_creator  # noqa: F401
from .kvstore import KVStoreApplication  # noqa: F401
from .proxy import AppConns  # noqa: F401
from .types import Application, BaseApplication  # noqa: F401
