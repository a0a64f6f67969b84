"""Polynomial sin/cos on mod-1-reduced phases.

Port of ``crimp_tpu/ops/fasttrig.py`` with the identical coefficients. The
search kernels reduce the trial phase mod 1 in f64 before any trig, so the
argument is always in [-0.5, 0.5] cycles, where these fixed odd/even
least-squares polynomials evaluate sin(2*pi*x) and cos(2*pi*x) directly:

    max |error| = 3.1e-7 (sin), 3.6e-8 (cos)  over |x| <= 0.5

The Z^2 kernels (``csrc/z2_grid.cu``, ``csrc/z2_general.cu``) and their
plain twins take this pair with ``poly=True`` and f32 sin/cos of
2*pi*frac with ``poly=False``. ``poly_trig_enabled`` resolves the default
as the JAX package does: the explicit argument, then
CRIMP_TORCH_POLY_TRIG, then the device (on for the card, the accelerator
the hand kernels were written for, as the TPU is for the JAX package; off
on the CPU, JAX's own default there). The coefficients below are repeated
in both CUDA sources as float literals; ``tests/test_torch_z2.py`` and
``tests/test_torch_search_general.py`` pin the copies equal.
"""

from __future__ import annotations

import torch

from crimp_tpu_torch import knobs
from crimp_tpu_torch.utils import device as device_mod

# Least-squares fits on [-0.5, 0.5] (degree 11 odd / 12 even in x).
_SIN_COEFFS = (
    6.2831834664e00,
    -4.1341480362e01,
    8.1597658022e01,
    -7.6594929804e01,
    4.1269936976e01,
    -1.2372507211e01,
)
_COS_COEFFS = (
    9.9999999229e-01,
    -1.9739205554e01,
    6.4939172239e01,
    -8.5451165912e01,
    6.0176231390e01,
    -2.6000532120e01,
    6.5756180224e00,
)


def poly_trig_enabled(override: bool | None = None, device=None) -> bool:
    """Whether the search kernels take the polynomial sin/cos pair.

    Precedence: explicit ``override`` > CRIMP_TORCH_POLY_TRIG > the device
    of the call: on for ``cuda``, off for the CPU (``device=None`` is the
    port's default device, the card unless a script forced the CPU). A word
    outside the on/off sets raises, as in the JAX package.
    """
    if override is not None:
        return bool(override)
    state = knobs.env_onoff("CRIMP_TORCH_POLY_TRIG")
    if state is not None:
        return state
    dev = device_mod.default_device() if device is None else torch.device(device)
    return dev.type == "cuda"


def centered_frac(x: torch.Tensor) -> torch.Tensor:
    """x minus its nearest integer via floor -- in [-0.5, 0.5).

    Floor-based (never ``x - round(x)``), as in the JAX package: both steps
    are exact for |x| >= 1 and |x| < 2^52 (Sterbenz), and the one inexact
    window, x in (-0.5, 0), differs from x by at most half an ulp of 1.0.
    Works for f32 and f64 alike.
    """
    f = x - torch.floor(x)
    return f - (f >= 0.5).to(f.dtype)


def sincos_cycles(frac: torch.Tensor):
    """(sin, cos) of 2*pi*frac for frac in [-0.5, 0.5] (any float dtype).

    Horner evaluation in z = frac^2: 1 mul + 5 FMA + 1 mul for sin,
    6 FMA for cos.
    """
    z = frac * frac
    s = _SIN_COEFFS[-1]
    for coef in _SIN_COEFFS[-2::-1]:
        s = s * z + coef
    s = s * frac
    c = _COS_COEFFS[-1] * z + _COS_COEFFS[-2]
    for coef in _COS_COEFFS[-3::-1]:
        c = c * z + coef
    return s, c
