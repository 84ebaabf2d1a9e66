"""A dry run of the batch split over n virtual shards of one device.

Counterpart: __graft_entry__.py:79 `dryrun_multichip`, which partitions
the check over an n-device mesh of XLA's virtual CPU devices. Here the
mesh repeats one device n times (parallel/sharding.py: virtual shards),
so the production split, its launches a shard on streams of their own
and the gather run on one card, or on the CPU's plain versions:

- one crypto.batch.create_batch_verifier batch routed through a mesh
  install (crypto/gpu_verifier.install(mesh=...), what node/device.py
  installs for `[gpu] devices > 1`) must come back a sharded verifier;
- n signatures, one a shard, the last one's S zeroed, verified by
  ShardedEd25519Verifier over the mesh: every lane valid but the last.

    python -m tendermint_tpu_torch.parallel.dryrun [n] [device]
"""

from __future__ import annotations

import sys

import numpy as np

__all__ = ["dryrun_multichip"]


class _ProbeEdKey:
    """A PubKey stand-in for probing the batch-verifier seam."""

    def type(self) -> str:
        return "ed25519"


def dryrun_multichip(n_devices: int, device="cuda") -> np.ndarray:
    """Run the split over `n_devices` virtual shards of `device`; returns
    the bitmap (raises when a check fails). Leaves no factory installed."""
    from ..crypto import batch as crypto_batch
    from ..crypto import gpu_verifier
    from ..crypto.ed25519 import PrivKeyEd25519
    from . import ShardedEd25519Verifier, make_mesh

    mesh = make_mesh([device] * n_devices)
    verifier = ShardedEd25519Verifier(mesh, bucket_sizes=[n_devices])

    gpu_verifier.install(min_batch=2, mesh=mesh)
    try:
        probe = crypto_batch.create_batch_verifier(_ProbeEdKey(), size_hint=n_devices)
        if not isinstance(probe, gpu_verifier.GpuEd25519BatchVerifier) or not isinstance(
            probe._verifier, ShardedEd25519Verifier
        ):
            raise AssertionError("a mesh install did not give a sharded verifier")
    finally:
        gpu_verifier.uninstall()

    rng = np.random.default_rng(3)
    pks, msgs, sigs = [], [], []
    for i in range(n_devices):  # one signature a shard
        priv = PrivKeyEd25519.from_seed(rng.integers(0, 256, 32, dtype=np.uint8).tobytes())
        msg = b"dryrun-%d" % i
        pks.append(priv.pub_key().bytes())
        msgs.append(msg)
        sigs.append(priv.sign(msg))
    # one signature spoiled: the bitmap must name its lane alone
    sigs[-1] = sigs[-1][:32] + bytes(32)
    ok = verifier.verify(pks, msgs, sigs)
    if ok.shape != (n_devices,) or not ok[:-1].all() or ok[-1]:
        raise AssertionError(f"dryrun_multichip({n_devices}): bitmap {ok.tolist()}")
    return ok


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    dev = sys.argv[2] if len(sys.argv) > 2 else "cuda"
    dryrun_multichip(n, dev)
    print(f"dryrun_multichip({n}, {dev!r}): OK")
