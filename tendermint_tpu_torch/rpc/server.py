"""RPC server service: binds the route table to the JSON-RPC machinery.

Counterpart: tendermint_tpu/rpc/server.py:1-58 (reference:
node/node.go:480-540 startRPC and rpc/jsonrpc/server). The port's server
also reports what its routes raised beyond their answers: `failure()`
returns the first such error (rpc/jsonrpc.py), and `stop()` raises it
after the listener is closed, so a failed kernel launch under a route
does not end as one client's INTERNAL_ERROR alone.
"""

from __future__ import annotations

import logging
from typing import Optional

from ..libs.service import Service
from .core import Environment
from .jsonrpc import JSONRPCServer

__all__ = ["RPCServer"]


def _split_laddr(laddr: str) -> tuple[str, int]:
    addr = laddr.replace("tcp://", "")
    host, _, port = addr.rpartition(":")
    return host or "127.0.0.1", int(port)


class RPCServer(Service):
    """Serves the Environment's routes over HTTP/WS on laddr."""

    def __init__(
        self,
        env: Environment,
        laddr: str = "tcp://127.0.0.1:26657",
        max_body_bytes: int = 1_000_000,
    ) -> None:
        super().__init__(name="rpc", logger=logging.getLogger(__name__))
        self.env = env
        self.laddr = laddr
        self._srv: Optional[JSONRPCServer] = None
        self._max_body = max_body_bytes
        self._failure: Optional[BaseException] = None

    @property
    def bound_port(self) -> int:
        """Actual listen port (laddr may specify port 0)."""
        assert self._srv is not None
        return self._srv.bound_port

    def failure(self) -> Optional[BaseException]:
        """The first error a route raised beyond its answer, or None."""
        if self._srv is not None:
            return self._srv.failure()
        return self._failure

    async def on_start(self) -> None:
        host, port = _split_laddr(self.laddr)
        self._srv = JSONRPCServer(
            self.env.routes(), max_body_bytes=self._max_body, metrics=self.env.metrics
        )
        await self._srv.start(host, port)
        self.logger.info("rpc server listening addr=%s:%d", host, self.bound_port)

    async def on_stop(self) -> None:
        if self._srv is not None:
            await self._srv.stop()
            self._failure = self._srv.failure()
            self._srv = None
        if self._failure is not None:
            raise self._failure
