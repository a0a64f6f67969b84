"""Phase folding: Taylor, glitch and wave phases as torch f64 functions.

Port of ``crimp_tpu/ops/fold.py`` (parity with CRIMP's calcphase.py):

  phi(t) = sum_{n=1..13} F_{n-1}/n! * dt^n                (dt = (t-PEPOCH)*86400 s)
         + per glitch with t >= GLEP:
             GLPH + GLF0*dt_g + GLF1/2*dt_g^2 + GLF2/6*dt_g^3
             + GLF0D*GLTD*86400*(1 - exp(-(t-GLEP)/GLTD))  (dt_g in s, GLTD in days)
         + F0 * sum_k [ A_k sin(k*OM*(t-WEP)) + B_k cos(k*OM*(t-WEP)) ]

The order of operations is the JAX package's: Horner from F12 down and one
final multiply by dt; glitches added one at a time in index order, masked
before the ``exp``; wave harmonics in order, times F0.

Every function broadcasts over leading batch axes of the timing fields:
``tm.f`` of shape (W, 13) (with ``glep`` (W, G), ``wave_a`` (W, K), ...)
and times of shape (N,) give phases of shape (W, N). That batch axis takes
the place of ``jax.vmap`` over walkers in the ensemble MCMC
(``pipelines/fit_toas.py``). A scalar field (``pepoch``, ``wave_om``, ...)
broadcasts against any batch.
"""

from __future__ import annotations

import numpy as np
import torch

from crimp_tpu_torch.models import timing
from crimp_tpu_torch.models.timing import N_FREQ_TERMS, TimingParams
from crimp_tpu_torch.ops import anchored

SECONDS_PER_DAY = 86400.0


def _inv_factorials(like: torch.Tensor) -> torch.Tensor:
    """1/(k+1)! for k = 0..12 on ``like``'s device, built there (no host
    copy, so a CUDA graph can capture it): the factorials are exact in f64
    and the reciprocal is correctly rounded, as numpy's 1.0 / factorial."""
    n = torch.arange(1, N_FREQ_TERMS + 1, dtype=like.dtype, device=like.device)
    return 1.0 / torch.cumprod(n, dim=0)


def _col(x: torch.Tensor) -> torch.Tensor:
    """A batched parameter (...,) as (..., 1), to broadcast against times."""
    return x[..., None]


def taylor_phase(tm: TimingParams, time_mjd: torch.Tensor) -> torch.Tensor:
    """Taylor-expansion phase (cycles) at time_mjd."""
    dt = (time_mjd - _col(tm.pepoch)) * SECONDS_PER_DAY
    coeffs = tm.f * _inv_factorials(tm.f)
    # Horner: c0 + dt*(c1 + dt*(... )) then one final multiply by dt.
    acc = torch.zeros_like(dt)
    for k in range(N_FREQ_TERMS - 1, -1, -1):
        acc = acc * dt + coeffs[..., k, None]
    return acc * dt


def glitch_phase(tm: TimingParams, time_mjd: torch.Tensor) -> torch.Tensor:
    """Summed glitch phase contributions (cycles) at time_mjd."""
    total = torch.zeros_like(time_mjd)
    for g in range(tm.n_glitch):
        glep = tm.glep[..., g, None]
        gltd = tm.gltd[..., g, None]
        after = time_mjd >= glep
        # Mask before exp/polynomial so +inf-padded rows never produce NaN.
        dt_days = torch.where(after, time_mjd - glep, 0.0)
        dt_sec = dt_days * SECONDS_PER_DAY
        recovery = torch.where(
            gltd == 0.0,
            0.0,
            gltd * SECONDS_PER_DAY * (1.0 - torch.exp(-dt_days / gltd)),
        )
        contrib = (
            tm.glph[..., g, None]
            + tm.glf0[..., g, None] * dt_sec
            + 0.5 * tm.glf1[..., g, None] * dt_sec**2
            + (1.0 / 6.0) * tm.glf2[..., g, None] * dt_sec**3
            + tm.glf0d[..., g, None] * recovery
        )
        total = total + torch.where(after, contrib, 0.0)
    return total


def wave_phase(tm: TimingParams, time_mjd: torch.Tensor) -> torch.Tensor:
    """Whitening-wave phase (cycles): seconds-residual sinusoids times F0."""
    total = torch.zeros_like(time_mjd)
    if tm.n_wave == 0:
        return total
    base = time_mjd - _col(tm.wave_epoch)
    for k in range(1, tm.n_wave + 1):
        # k as a Python float, the JAX package's f64 harmonic number (an
        # int64 tensor of harmonics would change torch's type promotion)
        arg = (float(k) * _col(tm.wave_om)) * base
        total = (total + tm.wave_a[..., k - 1, None] * torch.sin(arg)
                 + tm.wave_b[..., k - 1, None] * torch.cos(arg))
    return total * tm.f[..., 0, None]


def total_phase(tm: TimingParams, time_mjd: torch.Tensor) -> torch.Tensor:
    """Total model phase in cycles (Taylor + glitches + waves)."""
    return taylor_phase(tm, time_mjd) + glitch_phase(tm, time_mjd) + wave_phase(tm, time_mjd)


def phase_no_waves(tm: TimingParams, time_mjd: torch.Tensor) -> torch.Tensor:
    """Taylor + glitch phase only (integer-rotation anchoring uses this)."""
    return taylor_phase(tm, time_mjd) + glitch_phase(tm, time_mjd)


def fold(tm: TimingParams, time_mjd: torch.Tensor):
    """(total_phase, cycle_folded_phase in [0,1)) for a tensor of MJDs.

    Absolute phases in f64: for search and diagnostics, where only relative
    phase matters. ``fold_phases`` is the precise fold.
    """
    total = total_phase(tm, time_mjd)
    return total, total - torch.floor(total)


def fold_phases(time_mjd, timMod, device=None):
    """Host-friendly fold: accepts .par path / dict / TimingParams.

    Mirrors CRIMP's calcphase(timeMJD, timMod): returns (totalphases,
    cycleFoldedPhases) as numpy arrays with the input's shape (scalars in,
    scalars out). Total phases come from the host longdouble Taylor, folded
    phases from the anchored fold (``anchored.fold_chunked``) on ``device``
    (default cuda).
    """
    tm = timing.resolve(timMod)
    arr = np.atleast_1d(np.asarray(time_mjd, dtype=np.float64)).reshape(-1)
    shape = np.shape(time_mjd)
    total = anchored.host_total_phase(tm, arr).astype(np.float64)
    folded = anchored.fold_chunked(arr, tm, device=device)
    if shape == ():
        return total.item(), folded.item()
    return total.reshape(shape), folded.reshape(shape)


# Reference-named alias (calcphase.py:152).
calcphase = fold_phases
