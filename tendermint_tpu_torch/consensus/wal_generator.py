"""The WAL a live node writes: the replay and crash tests' fixture.

Counterpart: tendermint_tpu/consensus/wal_generator.py:21 (reference:
internal/consensus/wal_generator.go WALGenerateNBlocks). A
single-validator node over the builtin kvstore app runs in process until
`n_blocks` are committed; the WAL file it wrote holds the real sequence
of proposals, votes and timeouts a consensus run writes.
"""

from __future__ import annotations

import os
import time

__all__ = ["generate_wal"]


async def generate_wal(
    home: str,
    n_blocks: int,
    chain_id: str = "wal-generator",
    timeout: float = 60.0,
    seed: bytes = b"\x57" * 32,
):
    """Run a node until `n_blocks` are committed; returns (wal_path,
    genesis, priv_key). The node is stopped (its WAL flushed and closed)
    before this returns. The device plane is off: the fixture is about
    the WAL's bytes."""
    from ..config import Config
    from ..crypto.ed25519 import PrivKeyEd25519
    from ..node.node import make_node
    from ..privval.file import FilePV
    from ..types.genesis import GenesisDoc, GenesisValidator

    priv = PrivKeyEd25519.from_seed(seed)
    genesis = GenesisDoc(
        chain_id=chain_id,
        genesis_time_ns=time.time_ns(),
        validators=[GenesisValidator(pub_key=priv.pub_key(), power=10)],
    )
    cfg = Config()
    cfg.base.home = home
    cfg.base.chain_id = chain_id
    cfg.base.db_backend = "memdb"
    cfg.consensus.timeout_commit = 0.05
    cfg.rpc.laddr = "tcp://127.0.0.1:0"
    cfg.p2p.laddr = "tcp://127.0.0.1:0"
    cfg.gpu.enable = False
    cfg.ensure_dirs()
    genesis.save_as(cfg.base.path(cfg.base.genesis_file))
    FilePV.from_priv_key(
        priv,
        cfg.base.path(cfg.priv_validator.key_file),
        cfg.base.path(cfg.priv_validator.state_file),
    ).save()

    node = make_node(cfg, device="cpu")
    await node.start()
    try:
        await node.consensus.wait_for_height(n_blocks + 1, timeout=timeout)
    finally:
        await node.stop()
    wal_path = cfg.base.path(cfg.consensus.wal_file)
    assert os.path.exists(wal_path), wal_path
    return wal_path, genesis, priv
