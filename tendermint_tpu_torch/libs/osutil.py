"""Filesystem helpers.

Counterpart: tendermint_tpu/libs/osutil.py:1-34 (reference:
internal/libs/tempfile).
"""

from __future__ import annotations

import os

__all__ = ["atomic_write"]


def atomic_write(path: str, data: str, mode: int = 0o600) -> None:
    """Write, fsync, rename, fsync the directory: the file is never torn
    and the rename survives a crash (reference:
    internal/libs/tempfile/tempfile.go WriteFileAtomic; key and state
    files are 0600 as in privval/file.go). Synchronous on purpose: the
    signer must not go on before the bytes are on disk."""
    tmp = path + ".tmp"
    fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, mode)
    try:
        with os.fdopen(fd, "w") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        dir_fd = os.open(os.path.dirname(path) or ".", os.O_RDONLY)
        try:
            os.fsync(dir_fd)
        finally:
            os.close(dir_fd)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
