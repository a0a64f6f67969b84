"""Spin ephemerides on the host: F(t), Fdot(t), integer-rotation anchors.

Port of the host twins in ``crimp_tpu/ops/ephem.py`` (``spin_frequency_host``,
``integer_rotation_host``): exact f64 / longdouble numpy, vectorized over a
batch of anchor times. The device versions wait for a later slice.
"""

from __future__ import annotations

from math import factorial

import numpy as np

from crimp_tpu_torch.models.timing import N_FREQ_TERMS, TimingParams

SECONDS_PER_DAY = 86400.0

_INV_FACT = np.array([1.0 / factorial(n) for n in range(N_FREQ_TERMS)])


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
        return anchored._host_taylor_phase(tm, t) + anchored._host_glitch_phase(tm, t).astype(np.longdouble)

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
