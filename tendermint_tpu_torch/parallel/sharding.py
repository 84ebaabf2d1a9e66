"""The batch split over several GPUs (X6).

Counterpart: tendermint_tpu/parallel/sharding.py (`make_mesh` :38,
`_MeshSharded` :51-95 with its bucket rounding :64-77 and `_program`
:79, `ShardedEd25519Verifier` :98, `ShardedSr25519Verifier` :105,
`sharded_batch_verify` :116). The JAX package jits the whole check (X2 or
X3) with its byte rows sharded P(None, "sig") and its bitmap P("sig")
over a 1-D mesh: XLA partitions the program, and the devices exchange
nothing until the bitmap gather. Here the placement is explicit, and
the kernels are the single-card ones:

- a window of B lanes, B rounded up to a multiple of the mesh's k
  devices (oversized batches too), is cut into k contiguous windows of
  B/k lanes, shard i taking lanes i B/k .. (i + 1) B/k - 1;
- each shard is one single-card window on its own device and its own
  stream: its own host packing into one batch-minor buffer with its own
  offsets, one host-to-device copy, then kernel X1 and K2 (or the
  sr25519 challenges on the host and X3), or K1 inside the hybrid
  program. Columns of one window's buffer would not be contiguous, so
  nothing is sliced out of a whole window's rows. Every shard launches,
  a shard of padding lanes too, as XLA runs every lane;
- gather() copies each shard's bitmap to the host under its shard's
  stream, in add order, and joins them: the (N,) bitmap, each lane at
  its own index.

A mesh may list a device more than once: those are virtual shards, the
port's counterpart of XLA's virtual CPU devices
(`--xla_force_host_platform_device_count`, tests/conftest.py). The split,
the launches a shard on streams of their own and the gather then run on
one card as on k. Each launch runs under `torch.cuda.device` of its
shard's card (ops/build.launch). The verifiers compile nothing when they
are made, and make their streams at their first window.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional, Sequence

import numpy as np
import torch

from ..config import DEFAULT_BUCKET_SIZES
from ..ops.ed25519_kernel import Ed25519Verifier
from ..ops.sr25519_kernel import Sr25519Verifier

__all__ = [
    "Mesh",
    "ShardedEd25519Verifier",
    "ShardedSr25519Verifier",
    "make_mesh",
    "sharded_batch_verify",
]

class Mesh:
    """A 1-D mesh: the devices of the batch axis, in shard order. A
    device may repeat (virtual shards)."""

    def __init__(self, devices: Sequence) -> None:
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]})"


def make_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """A 1-D mesh over the given devices (torch devices or their names;
    repeated entries are virtual shards), or over every visible CUDA
    card."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return Mesh(devices)


def _on_stream(stream):
    """The context a shard's work runs in: its stream (which also makes
    its card current), or nothing for the CPU."""
    if stream is None:
        return contextlib.nullcontext()
    return torch.cuda.stream(stream)


class _MeshSharded:
    """A bucketed verifier whose windows are split over a mesh (module
    docstring). Subclasses name the single-card verifier of a shard in
    _SINGLE; bucket rounding, the split and the gather are shared so that
    the two curves' layouts cannot drift apart."""

    _SINGLE = None  # the single-card verifier class of a shard
    _DEFAULT_SIZES: Sequence[int] = DEFAULT_BUCKET_SIZES

    def __init__(
        self,
        mesh: Mesh,
        bucket_sizes: Optional[Sequence[int]] = None,
        program: str = "tile",
    ) -> None:
        self.mesh = mesh
        k = mesh.size
        sizes = bucket_sizes or self._DEFAULT_SIZES
        super().__init__(
            sorted({-(-s // k) * k for s in sizes}),
            device=mesh.devices[0],
            program=program,
        )
        self._shards = [
            self._SINGLE(self.bucket_sizes, device=d, program=program)
            for d in mesh.devices
        ]
        self._streams: Optional[list] = None
        self._streams_lock = threading.Lock()

    def _bucket(self, n: int) -> int:
        b = super()._bucket(n)
        k = self.mesh.size
        return -(-b // k) * k  # oversized batches still pad to a multiple

    def _shard_streams(self) -> list:
        """One stream a shard (None for a CPU shard), made at the first
        window: a virtual shard of a card has a stream of its own too."""
        with self._streams_lock:
            if self._streams is None:
                self._streams = [
                    torch.cuda.Stream(device=d) if d.type == "cuda" else None
                    for d in self.mesh.devices
                ]
            return self._streams

    def dispatch(self, pubkeys, msgs, sigs, bucket: Optional[int] = None):
        """Enqueue one window split over the mesh; returns the handle for
        gather(): each shard's handle and stream, in shard order."""
        n = len(pubkeys)
        if n == 0 and bucket is None:
            return []
        if bucket is None:
            bucket = self._bucket(n)
        k = self.mesh.size
        if bucket % k:
            raise ValueError(f"a window of {bucket} lanes does not split over {k} shards")
        width = bucket // k
        parts = []
        for i, (shard, stream) in enumerate(zip(self._shards, self._shard_streams())):
            lo, hi = min(i * width, n), min((i + 1) * width, n)
            with _on_stream(stream):
                h = shard.dispatch(pubkeys[lo:hi], msgs[lo:hi], sigs[lo:hi], bucket=width)
            parts.append((h, stream))
        return parts

    def gather(self, handle) -> np.ndarray:
        """Wait for each shard's bitmap under its stream and join them in
        add order."""
        out = []
        for shard, (h, stream) in zip(self._shards, handle):
            with _on_stream(stream):
                out.append(shard.gather(h))
        if not out:
            return np.zeros(0, dtype=bool)
        return np.concatenate(out)


class ShardedEd25519Verifier(_MeshSharded, Ed25519Verifier):
    """Ed25519Verifier whose windows are split over a mesh: X1 and K2 (or
    K1 in the hybrid program) once a shard."""

    _SINGLE = Ed25519Verifier


class ShardedSr25519Verifier(_MeshSharded, Sr25519Verifier):
    """Sr25519Verifier split over a mesh, the ed25519 layout: the merlin
    challenges on the host a shard, then X3 (or K1 in the hybrid program)
    once a shard."""

    _SINGLE = Sr25519Verifier


def sharded_batch_verify(mesh: Mesh, pubkeys, msgs, sigs) -> np.ndarray:
    """One-shot convenience: verify an ed25519 batch across `mesh`."""
    return ShardedEd25519Verifier(mesh).verify(pubkeys, msgs, sigs)
