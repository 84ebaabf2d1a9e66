"""JSON-RPC layer: server, route implementations, clients.

Counterpart: tendermint_tpu/rpc/__init__.py:1-15 (reference: rpc/, the JSON-RPC
machinery and clients; internal/rpc/core, the methods;
node/node.go:480-540, the server's start), and `rpc/metrics.py`.
"""

from .client import (  # noqa: F401
    HTTPClient,
    LocalClient,
    RPCClientError,
    WSClient,
)
from .core import Environment  # noqa: F401
from .jsonrpc import JSONRPCServer, RPCError, RPCRequest  # noqa: F401
from .server import RPCServer  # noqa: F401
