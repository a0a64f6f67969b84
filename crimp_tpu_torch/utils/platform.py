"""Device forcing and the kernel build directory for scripts.

Port of ``crimp_tpu/utils/platform.py``. The port's entry points run on the
card unless the caller asks for the CPU; a script's ``--cpu`` flag
(``add_cpu_flag``) asks for it process-wide (``force_cpu_platform``: every
``device=None`` then means the CPU). JAX's persistent compilation cache
becomes the directory the hand kernels' nvcc builds land in and are reused
from (``ops/z2_grid.build``).
"""

from __future__ import annotations

import pathlib

from crimp_tpu_torch import knobs
from crimp_tpu_torch.utils import device

# the checkout's build/kernels/ (listed in .gitignore)
DEFAULT_BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "kernels"


def add_cpu_flag(parser) -> None:
    """Add the standard ``--cpu`` flag to an argparse parser."""
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU (the plain PyTorch twins) instead of the card")


def force_cpu_platform() -> None:
    """Make ``device=None`` mean the CPU for the rest of the process."""
    device.set_default_device("cpu")


def compilation_cache_dir() -> pathlib.Path | None:
    """The kernel build directory, or None when disabled.

    ``CRIMP_TORCH_COMPILE_CACHE``: unset/empty -> the checkout's
    ``build/kernels/``; ``0/off/none/false`` -> disabled (each process
    builds into a fresh temporary directory); anything else is the path.
    """
    env = knobs.raw("CRIMP_TORCH_COMPILE_CACHE")
    if env.lower() in ("0", "off", "none", "false"):
        return None
    if env:
        return pathlib.Path(env)
    return DEFAULT_BUILD_DIR


def configure_compilation_cache() -> pathlib.Path | None:
    """Create the build directory; returns it, or None when disabled or not
    creatable (the build then uses a per-process directory)."""
    target = compilation_cache_dir()
    if target is None:
        return None
    try:
        target.mkdir(parents=True, exist_ok=True)
    except OSError:
        return None
    return target
