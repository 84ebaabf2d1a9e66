"""The node's device seam: install the device plane from its config.

Counterpart: tendermint_tpu/node/node.py:136-158 (the device verifier
and merkle installs of Node.__init__) and :368-392 (`_device_mesh`).
install_device_plane puts crypto/gpu_verifier (ed25519 and sr25519
batches) and ops/merkle_kernel (tree roots and proof batches) behind the
port's crypto.batch and crypto/merkle.py seams, from a config.GPUConfig.
Consensus, p2p and the rest of make_node stay out: none of them runs a
device program.

`devices` follows the JAX node: 1 is one card, 0 every visible card.
More than one card is X6, the batch split over a mesh (ROADMAP item 10),
which the port does not have: asking for it raises NotImplementedError
rather than running on one card, as the JAX node refuses a mesh smaller
than asked for.
"""

from __future__ import annotations

from ..config import GPUConfig

__all__ = ["install_device_plane", "uninstall_device_plane", "visible_devices"]


def visible_devices(device="cuda") -> int:
    """The cards a `devices = 0` config would take: every visible CUDA
    device, and 1 for the CPU (the tests' device)."""
    import torch

    if torch.device(device).type != "cuda":
        return 1
    return torch.cuda.device_count()


def _one_card(devices: int, device) -> None:
    """Raise unless `devices` names one card."""
    if devices < 0:
        raise ValueError(f"GPUConfig.devices = {devices}: must be >= 0")
    n = visible_devices(device) if devices == 0 else devices
    if n > 1:
        raise NotImplementedError(
            f"GPUConfig.devices = {devices} asks for {n} cards: the batch "
            f"split over several GPUs (X6, ROADMAP item 10) is not ported"
        )


def install_device_plane(cfg: GPUConfig, device="cuda") -> bool:
    """Install the device plane `cfg` describes on `device` (CUDA by
    default; device="cpu" runs the kernels' plain versions, for tests).
    True when installed, False when cfg.enable is off. Raises when a
    kernel or the native CPU plane fails to build, when CUDA is absent,
    or when cfg.devices asks for more than one card."""
    if not cfg.enable:
        return False
    _one_card(cfg.devices, device)
    from ..crypto import gpu_verifier
    from ..ops import merkle_kernel

    gpu_verifier.install(
        device=device,
        min_batch=cfg.min_batch_size,
        bucket_sizes=cfg.bucket_sizes,
    )
    merkle_kernel.install(device=device)
    return True


def uninstall_device_plane() -> None:
    """Remove both: batches, roots and proofs go back to the CPU."""
    from ..crypto import gpu_verifier
    from ..ops import merkle_kernel

    gpu_verifier.uninstall()
    merkle_kernel.uninstall()
