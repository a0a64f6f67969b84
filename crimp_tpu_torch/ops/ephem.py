"""Spin ephemerides: F(t), Fdot(t), and integer-rotation anchor times.

Port of ``crimp_tpu/ops/ephem.py``: the torch f64 ``spin_frequency`` and
``integer_rotation`` (a fixed-iteration, convergence-masked Newton solve
over a whole batch of times), the host-friendly ``ephem_at`` and
``ephem_integer_rotation``, and the host twins ``spin_frequency_host`` and
``integer_rotation_host`` (exact f64 / longdouble numpy), which the ToA
anchoring uses, as the JAX package does.
"""

from __future__ import annotations

from math import factorial

import numpy as np
import torch

from crimp_tpu_torch.models import timing
from crimp_tpu_torch.models.timing import N_FREQ_TERMS, TimingParams
from crimp_tpu_torch.ops import fasttrig
from crimp_tpu_torch.ops.fold import phase_no_waves
from crimp_tpu_torch.utils.device import resolve_device

SECONDS_PER_DAY = 86400.0

_INV_FACT = np.array([1.0 / factorial(n) for n in range(N_FREQ_TERMS)])


def spin_frequency(tm: TimingParams, time_mjd: torch.Tensor):
    """(freq, freqdot) at time_mjd from Taylor + glitch terms (torch f64;
    broadcasts over leading batch axes of the fields like ``ops.fold``)."""
    dt = (time_mjd - tm.pepoch[..., None]) * SECONDS_PER_DAY

    # freq = sum_{n=0..12} F_n/n! dt^n ; freqdot = sum_{n=1..12} F_n/(n-1)! dt^(n-1)
    freq = torch.zeros_like(dt)
    for n in range(N_FREQ_TERMS - 1, -1, -1):
        freq = freq * dt + (tm.f[..., n] * float(_INV_FACT[n]))[..., None]
    fdot = torch.zeros_like(dt)
    for n in range(N_FREQ_TERMS - 1, 0, -1):
        fdot = fdot * dt + (tm.f[..., n] * float(_INV_FACT[n - 1]))[..., None]

    for g in range(tm.n_glitch):
        glep, glf0, glf1, glf2, glf0d, gltd = (
            getattr(tm, name)[..., g, None]
            for name in ("glep", "glf0", "glf1", "glf2", "glf0d", "gltd")
        )
        after = time_mjd >= glep
        dt_days = torch.where(after, time_mjd - glep, 0.0)
        dt_sec = dt_days * SECONDS_PER_DAY
        # GLTD = 0 means "no recovery term": guard the exp argument and the
        # 1/GLTD factor.
        safe_gltd = torch.where(gltd == 0.0, 1.0, gltd)
        decay = torch.where(gltd == 0.0, 0.0, torch.exp(-dt_days / safe_gltd))
        dfreq = glf0 + glf1 * dt_sec + 0.5 * glf2 * dt_sec**2 + glf0d * decay
        dfdot = glf1 + glf2 * dt_sec - (glf0d / (safe_gltd * SECONDS_PER_DAY)) * decay
        freq = freq + torch.where(after, dfreq, 0.0)
        fdot = fdot + torch.where(after, dfdot, 0.0)
    return freq, fdot


def integer_rotation(tm: TimingParams, time_mjd: torch.Tensor, tol_phase: float = 1e-10,
                     max_iter: int = 10) -> dict:
    """Nearest earlier integer-rotation epochs for a batch of MJDs (torch f64).

    Newton-iterates t <- t - (phi(t) - floor(phi(t0)))/f(t)/86400 for
    ``max_iter`` steps with a per-element convergence mask; waves are
    excluded from the phase. Absolute f64 phases limit it to ~1e-10 cycles
    at 1e6-cycle magnitudes: ``integer_rotation_host`` is the exact twin.
    """
    target = torch.floor(phase_no_waves(tm, time_mjd))
    t = time_mjd
    for _ in range(max_iter):
        err = phase_no_waves(tm, t) - target
        freq, _ = spin_frequency(tm, t)
        t = torch.where(torch.abs(err) < tol_phase, t, t - (err / freq) / SECONDS_PER_DAY)
    freq, fdot = spin_frequency(tm, t)
    ph = phase_no_waves(tm, t)
    return {
        "Tmjd_intRotation": t,
        "freq_intRotation": freq,
        "freqdot_intRotation": fdot,
        "ph_intRotation": ph,
        "phase_residual_from_integer": fasttrig.centered_frac(ph),
    }


def ephem_at(Tmjd, timMod, device=None) -> dict:
    """F, Fdot at one or more MJDs (reference: ephemTmjd.py:19), computed on
    ``device`` (default cuda)."""
    dev = resolve_device(device)
    tm = timing.resolve(timMod).to(dev)
    arr = torch.as_tensor(np.atleast_1d(np.asarray(Tmjd, dtype=np.float64)), device=dev)
    freq, fdot = spin_frequency(tm, arr)
    squeeze = np.isscalar(Tmjd) or np.shape(Tmjd) == ()
    to_out = lambda x: x.cpu().numpy()[0] if squeeze else x.cpu().numpy()
    return {"Tmjd": Tmjd, "freqAtTmjd": to_out(freq), "freqdotAtTmjd": to_out(fdot)}


def spin_frequency_host(tm: TimingParams, time_mjd: np.ndarray):
    """(freq, freqdot) at time_mjd from Taylor + glitch terms (host, exact f64)."""
    t = np.atleast_1d(np.asarray(time_mjd, dtype=np.float64))
    dt = (t - float(tm.pepoch)) * SECONDS_PER_DAY
    f = tm.numpy("f")
    freq = np.zeros_like(dt)
    for n in range(N_FREQ_TERMS - 1, -1, -1):
        freq = freq * dt + f[n] * _INV_FACT[n]
    fdot = np.zeros_like(dt)
    for n in range(N_FREQ_TERMS - 1, 0, -1):
        fdot = fdot * dt + f[n] * _INV_FACT[n - 1]
    glep = tm.numpy("glep")
    for g in range(tm.n_glitch):
        if not np.isfinite(glep[g]):
            continue
        after = t >= glep[g]
        dt_days = np.where(after, t - glep[g], 0.0)
        dt_sec = dt_days * SECONDS_PER_DAY
        gltd = float(tm.gltd[g])
        glf0d = float(tm.glf0d[g])
        glf1 = float(tm.glf1[g])
        glf2 = float(tm.glf2[g])
        # GLTD = 0 disables the recovery term entirely.
        if gltd == 0.0:
            decay = 0.0
            recovery_fdot = 0.0
        else:
            decay = np.exp(-dt_days / gltd)
            recovery_fdot = -(glf0d / (gltd * SECONDS_PER_DAY)) * decay
        freq += np.where(after, float(tm.glf0[g]) + glf1 * dt_sec + 0.5 * glf2 * dt_sec**2 + glf0d * decay, 0.0)
        fdot += np.where(after, glf1 + glf2 * dt_sec + recovery_fdot, 0.0)
    return freq, fdot


def integer_rotation_host(tm: TimingParams, time_mjd: np.ndarray, tol_phase: float = 1e-10, max_iter: int = 10) -> dict:
    """Host (longdouble-phase) Newton solve for integer-rotation anchors:
    the nearest earlier epoch with an integer number of rotations of the
    spin-down model (waves excluded)."""
    from crimp_tpu_torch.ops import anchored

    def phase_nw(t):
        return anchored._host_taylor_phase(tm, t) + anchored._host_glitch_phase(tm, t).astype(np.longdouble)  # graftlint: disable=GL004 (host-only Newton twin of the device solve; it extends anchored.py's longdouble phase and nothing here is ever traced)

    t = np.atleast_1d(np.asarray(time_mjd, dtype=np.float64))
    target = np.floor(phase_nw(t))
    t_cur = t.copy()
    for _ in range(max_iter):
        err = (phase_nw(t_cur) - target).astype(np.float64)
        if np.all(np.abs(err) < tol_phase):
            break
        freq, _ = spin_frequency_host(tm, t_cur)
        t_cur = np.where(np.abs(err) < tol_phase, t_cur, t_cur - (err / freq) / SECONDS_PER_DAY)
    freq, fdot = spin_frequency_host(tm, t_cur)
    ph = phase_nw(t_cur).astype(np.float64)
    return {
        "Tmjd_intRotation": t_cur,
        "freq_intRotation": freq,
        "freqdot_intRotation": fdot,
        "ph_intRotation": ph,
        "phase_residual_from_integer": ph - np.round(ph),
    }


def ephem_integer_rotation(Tmjd, timMod, printOutput: bool = False, tol_phase: float = 1e-10,
                           max_iter: int = 10) -> dict:
    """Integer-rotation ephemerides (reference: ephemIntegerRotation.py:25),
    solved by the exact host twin, as in the JAX package."""
    tm = timing.resolve(timMod)
    arr = np.atleast_1d(np.asarray(Tmjd, dtype=np.float64))
    out = integer_rotation_host(tm, arr, tol_phase=tol_phase, max_iter=max_iter)
    squeeze = np.isscalar(Tmjd) or np.shape(Tmjd) == ()
    result = {key: (np.asarray(val)[0] if squeeze else np.asarray(val)) for key, val in out.items()}
    if printOutput:
        print(
            f"Input Tmjd = {Tmjd} days."
            f"\n Earliest Tmjd with integer number of rotations = {result['Tmjd_intRotation']}."
            f" Corresponding frequency = {result['freq_intRotation']}."
            f" Corresponding phase = {result['ph_intRotation']}"
            f"\n Phase residual from integer = {result['phase_residual_from_integer']}"
        )
    return result


# Reference-named aliases.
ephemTmjd = ephem_at
ephemIntegerRotation = ephem_integer_rotation
