"""Device resolution for the port's entry points.

``device=None`` means the card. Nothing on the port's path carries on on
the CPU when the card is missing: the caller asks for the CPU explicitly.
"""

from __future__ import annotations

import torch

# what device=None means; None: the card (utils/platform.force_cpu_platform
# sets "cpu" for a script run with --cpu)
_DEFAULT: str | None = None


def set_default_device(device: str | None) -> None:
    """Make ``device=None`` mean ``device`` (None restores the card)."""
    global _DEFAULT
    _DEFAULT = device


def default_device() -> torch.device:
    """What ``device=None`` means, without checking that it is present."""
    return torch.device(_DEFAULT or "cuda")


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (raising when no card is present) unless a
    script forced the CPU, else as given."""
    if device is None:
        device = _DEFAULT
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the host"
            )
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not available")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the card's queued work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
