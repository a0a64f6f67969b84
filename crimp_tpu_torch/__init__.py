"""crimp_tpu_torch: the PyTorch/CUDA port of crimp_tpu for NVIDIA Hopper.

The JAX package ``crimp_tpu`` stays the reference; this package mirrors its
layout module for module and never imports it (nor JAX). Plain tensor code
is PyTorch in explicit float64; the uniform-grid Z^2 tile kernel and the
general exact-phase Z^2 kernel are hand-written CUDA C++ for ``sm_90a``
(``csrc/z2_grid.cu``, ``csrc/z2_general.cu``), built with ``nvcc`` on
first use and bound with ``ctypes`` (``ops/z2_grid.py``,
``ops/z2_general.py``).

Entry points take ``device=None``, which means ``cuda``; with no card they
raise (``utils.device.resolve_device``). Pass ``device="cpu"`` to run the
plain PyTorch twins on the host, as the tests do. The environment is read
only through ``knobs`` (prefix ``CRIMP_TORCH_``); ``resilience`` classifies
failures and holds the degradation ladders, ``obs`` the run telemetry.
"""

__all__ = ["io", "knobs", "models", "obs", "ops", "parallel", "pipelines", "resilience", "utils", "warmup"]


def warmup(**kwargs):
    """Build the hand kernels and run each hot path once at its real shapes.

    Thin lazy delegate to :func:`crimp_tpu_torch.aot.warmup`, the JAX
    package's ``crimp_tpu.warmup``: importing the package stays free of
    torch; calling this builds and launches on the card.
    """
    from crimp_tpu_torch import aot

    return aot.warmup(**kwargs)
