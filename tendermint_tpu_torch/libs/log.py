"""Structured key-value logging on the standard logging module.

Counterpart: tendermint_tpu/libs/log.py:1-89 (reference:
libs/log/default.go:27). `configure(level, json_format)` sets the root
handler as `start` and `signer` call it
(tendermint_tpu/cmd/commands.py:151-163); `get_logger(name)` returns a
Logger whose methods take the message and key-value fields, rendered
as `L | name | msg | k=v ...` or, with json_format, one JSON object a
line.
"""

from __future__ import annotations

import json
import logging
import sys
import time
import traceback
from typing import Any

__all__ = ["Logger", "configure", "get_logger"]

_FORMAT_JSON = False


def configure(level: str = "info", json_format: bool = False) -> None:
    global _FORMAT_JSON
    _FORMAT_JSON = json_format
    logging.basicConfig(
        stream=sys.stderr,
        level=getattr(logging, level.upper(), logging.INFO),
        format="%(message)s",
    )


class Logger:
    """A logger carrying bound key-value context."""

    __slots__ = ("_log", "_fields")

    def __init__(self, name: str, fields: dict[str, Any] | None = None) -> None:
        self._log = logging.getLogger(name)
        self._fields = fields or {}

    def with_fields(self, **fields: Any) -> "Logger":
        return Logger(self._log.name, {**self._fields, **fields})

    def _emit(self, level: int, msg: str, fields: dict[str, Any]) -> None:
        if not self._log.isEnabledFor(level):
            return
        all_fields = {**self._fields, **fields}
        if _FORMAT_JSON:
            record = {
                "ts": time.time(),
                "level": logging.getLevelName(level).lower(),
                "module": self._log.name,
                "msg": msg,
                **all_fields,
            }
            self._log.log(level, json.dumps(record, default=str))
        else:
            kv = " ".join(f"{k}={v}" for k, v in all_fields.items())
            self._log.log(
                level,
                f"{logging.getLevelName(level)[0]} | {self._log.name} | {msg}"
                + (f" | {kv}" if kv else ""),
            )

    def debug(self, msg: str, **fields: Any) -> None:
        self._emit(logging.DEBUG, msg, fields)

    def info(self, msg: str, **fields: Any) -> None:
        self._emit(logging.INFO, msg, fields)

    def warning(self, msg: str, **fields: Any) -> None:
        self._emit(logging.WARNING, msg, fields)

    warn = warning

    def error(self, msg: str, **fields: Any) -> None:
        self._emit(logging.ERROR, msg, fields)

    def exception(self, msg: str, **fields: Any) -> None:
        fields = dict(fields)
        fields["exc"] = traceback.format_exc(limit=20).strip().replace("\n", " | ")
        self._emit(logging.ERROR, msg, fields)


def get_logger(name: str, **fields: Any) -> Logger:
    return Logger(name, fields or None)
