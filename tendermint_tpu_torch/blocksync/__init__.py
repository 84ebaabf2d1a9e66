"""Block sync: catch up to the chain's head by fetching verified blocks.

Counterpart: tendermint_tpu/blocksync/__init__.py (reference:
internal/blocksync/): the messages and codec, the BlockPool and the
reactor.
"""

from .msgs import (
    BlockRequestMessage,
    BlockResponseMessage,
    BlocksyncCodec,
    NoBlockResponseMessage,
    StatusRequestMessage,
    StatusResponseMessage,
)
from .pool import BlockPool
from .reactor import (
    BLOCKSYNC_CHANNEL,
    BlocksyncReactor,
    blocksync_channel_descriptor,
)

__all__ = [
    "BLOCKSYNC_CHANNEL",
    "BlockPool",
    "BlockRequestMessage",
    "BlockResponseMessage",
    "BlocksyncCodec",
    "BlocksyncReactor",
    "NoBlockResponseMessage",
    "StatusRequestMessage",
    "StatusResponseMessage",
    "blocksync_channel_descriptor",
]
