"""State sync: bootstrap a fresh node from an application snapshot.

Counterpart: tendermint_tpu/statesync/__init__.py (reference:
internal/statesync/): the messages and codec, the chunk queue and the
reactor.
"""

from .msgs import (
    ChunkRequestMessage,
    ChunkResponseMessage,
    LightBlockRequestMessage,
    LightBlockResponseMessage,
    ParamsRequestMessage,
    ParamsResponseMessage,
    SnapshotsRequestMessage,
    SnapshotsResponseMessage,
    StatesyncCodec,
)
from .reactor import (
    CHUNK_CHANNEL,
    LIGHT_BLOCK_CHANNEL,
    PARAMS_CHANNEL,
    SNAPSHOT_CHANNEL,
    StatesyncReactor,
    SyncError,
    statesync_channel_descriptors,
)

__all__ = [
    "CHUNK_CHANNEL",
    "ChunkRequestMessage",
    "ChunkResponseMessage",
    "LIGHT_BLOCK_CHANNEL",
    "LightBlockRequestMessage",
    "LightBlockResponseMessage",
    "PARAMS_CHANNEL",
    "ParamsRequestMessage",
    "ParamsResponseMessage",
    "SNAPSHOT_CHANNEL",
    "SnapshotsRequestMessage",
    "SnapshotsResponseMessage",
    "StatesyncCodec",
    "StatesyncReactor",
    "SyncError",
    "statesync_channel_descriptors",
]
