"""The node's device seam: install the device plane from its config.

Counterpart: tendermint_tpu/node/node.py:136-158 (the device verifier
and merkle installs of Node.__init__) and :368-392 (`_device_mesh`).
install_device_plane puts crypto/gpu_verifier (ed25519 and sr25519
batches) and ops/merkle_kernel (tree roots and proof batches) behind the
port's crypto.batch and crypto/merkle.py seams, from a config.GPUConfig.
Consensus, p2p and the rest of make_node stay out: none of them runs a
device program. plane_report() is what a process ran on its plane: the
kernels' launch counts and the verifier's stats (faults, rerouted
signatures), which the `light` and `replay` commands print at exit.

`devices` follows the JAX node: 1 is one card, 0 every visible card.
More than one card is X6, the batch split over a mesh (ROADMAP item 10),
which the port does not have: asking for it raises NotImplementedError
rather than running on one card, as the JAX node refuses a mesh smaller
than asked for.
"""

from __future__ import annotations

import copy

from ..config import GPUConfig

__all__ = [
    "install_device_plane",
    "installed_plane",
    "launch_counts",
    "plane_report",
    "reset_launch_counts",
    "uninstall_device_plane",
    "visible_devices",
]

# what install_device_plane last installed: (a copy of the GPUConfig,
# the device), while it stays installed
_CURRENT = None


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
    global _CURRENT
    if not cfg.enable:
        return False
    _one_card(cfg.devices, device)
    from ..crypto import gpu_verifier
    from ..ops import merkle_kernel

    _CURRENT = None
    gpu_verifier.install(
        device=device,
        min_batch=cfg.min_batch_size,
        bucket_sizes=cfg.bucket_sizes,
    )
    merkle_kernel.install(device=device)
    _CURRENT = (copy.deepcopy(cfg), str(device))
    return True


def installed_plane():
    """(the GPUConfig, the device) of the plane install_device_plane
    installed, while both of its parts stay installed with that config's
    gate; else None."""
    from ..crypto import gpu_verifier
    from ..ops import merkle_kernel

    if _CURRENT is None or merkle_kernel.installed() is None:
        return None
    if gpu_verifier.installed() != _CURRENT[0].min_batch_size:
        return None
    return _CURRENT


def uninstall_device_plane() -> None:
    """Remove both: batches, roots and proofs go back to the CPU."""
    global _CURRENT
    from ..crypto import gpu_verifier
    from ..ops import merkle_kernel

    _CURRENT = None
    gpu_verifier.uninstall()
    merkle_kernel.uninstall()


def _counted_modules():
    from ..ops import ed25519_cuda, merkle_kernel, sha256_kernel, sha512_kernel, sr25519_cuda

    return (ed25519_cuda, sha512_kernel, sr25519_cuda, sha256_kernel, merkle_kernel)


def launch_counts() -> dict:
    """Every kernel's launches in this process, by kernel name (each
    wrapper counts where it launches)."""
    out = {}
    for mod in _counted_modules():
        out.update(mod.LAUNCHES)
    return out


def reset_launch_counts() -> None:
    for mod in _counted_modules():
        mod.reset_launches()


def plane_report() -> dict:
    """{"installed": (the device, or None), "launches": launch_counts(),
    "stats": gpu_verifier.stats()}: faults are the contained device
    faults, rerouted_sigs the signatures they sent to the CPU plane."""
    from ..crypto import gpu_verifier

    plane = installed_plane()
    return {
        "installed": plane[1] if plane is not None else None,
        "launches": launch_counts(),
        "stats": gpu_verifier.stats(),
    }
