"""Timing-model fitting support: free-parameter bookkeeping and the
delta-parameterization (host side).

Port of ``crimp_tpu/pipelines/fit_utils.py`` (semantics of CRIMP's
utilities_fittoas.py:14-293):

- free parameters are the .par entries with fit flag 1; a flagged WAVE_OM
  expands to every WAVEk_A / WAVEk_B coefficient;
- the fit works on parameter DELTAS in phase space: the fit dict carries
  the deltas (epochs keep their base values and are never fit), and the
  full dict reconstructs as base - delta for frequency-like terms,
  base + delta for GLTD, and the raw delta for GLEP;
- GLTD is zeroed when the paired GLF0D is 0;
- model phase residuals are mean-subtracted, with the WAVE terms needing
  the FULL F0 (they are seconds-residuals scaled by F0). They are
  evaluated on the host through the longdouble Taylor of ``ops.anchored``.

The delta-fold fast path (``linear_key_columns``, ``delta_basis``,
``model_phase_residuals_delta``) evaluates linear free sets as one basis
product on the device (``ops/deltafold.py``).
"""

from __future__ import annotations

import copy
import re

import numpy as np
import torch

from crimp_tpu_torch.models import timing
from crimp_tpu_torch.ops import anchored

_GLEP_RE = re.compile(r"^GLEP_\d+$")
_GLTD_RE = re.compile(r"^GLTD_\d+$")
_WAVE_AB_RE = re.compile(r"^WAVE\d+_[AB]$")
_WAVE_RE = re.compile(r"^WAVE\d+$")


def list_fit_keys(parfile: dict) -> list[str]:
    """Keys with fit flag 1; WAVE_OM flag 1 expands to all WAVEk_A/B."""
    keys = [
        k
        for k, v in parfile.items()
        if isinstance(v, dict) and "value" in v and "flag" in v and v["flag"] == 1
    ]
    if "WAVE_OM" in parfile and parfile["WAVE_OM"].get("flag") == 1:
        keys = [k for k in keys if k != "WAVE_OM"]
        keys.extend(
            f"{k}_{suffix}"
            for k in parfile
            if _WAVE_RE.match(k)
            for suffix in ("A", "B")
        )
    return keys


def extract_free_params(parfile: dict, yaml_initialguesses: str | None = None):
    """(p0, keys): the free-parameter vector (zeros or YAML guesses)."""
    keys = list_fit_keys(parfile)
    if yaml_initialguesses is not None:
        from crimp_tpu_torch.io.yamlcfg import load_prior

        prior = load_prior(yaml_initialguesses)
        if not prior.initial_guess:
            raise ValueError("No initial guesses found in YAML file.")
        missing = [k for k in keys if k not in prior.initial_guess]
        if missing:
            raise KeyError(f"Missing initial guesses for: {', '.join(missing)}")
        p0 = np.array([prior.initial_guess[k] for k in keys], dtype=float)
    else:
        p0 = np.zeros(len(keys), dtype=float)
    return p0, keys


def _zero_gltd_without_glf0d(parfile: dict) -> None:
    """GLTD is meaningless when GLF0D = 0: zero it (in place)."""
    for key, entry in parfile.items():
        if not key.startswith("GLTD_"):
            continue
        suffix = key.split("_", 1)[1]
        glf0d = parfile.get(f"GLF0D_{suffix}")
        if glf0d and glf0d.get("value") == 0:
            entry["value"] = 0


def inject_free_params(parfile: dict, pvec: np.ndarray, keys: list[str]):
    """(fit_dict, full_dict): delta-space dict and reconstructed full dict."""
    _zero_gltd_without_glf0d(parfile)

    fit_dict: dict = {}
    full_dict: dict = {}
    for key, entry in parfile.items():
        if isinstance(entry, dict) and "value" in entry and not isinstance(entry["value"], dict):
            base = entry["value"]
            keep_base = key == "PEPOCH" or _GLEP_RE.match(key) or key in ("WAVEEPOCH", "WAVE_OM")
            fit_dict[key] = base if keep_base else 0.0
            full_dict[key] = base
        else:
            fit_dict[key] = copy.deepcopy(entry)
            full_dict[key] = copy.deepcopy(entry)

    for key, delta in zip(keys, pvec):
        if key == "PEPOCH" or key in ("WAVEEPOCH", "WAVE_OM"):
            continue
        if _WAVE_AB_RE.match(key):
            base_name, coeff = key.rsplit("_", 1)
            if base_name not in parfile:
                raise KeyError(f"Parameter {base_name!r} not found in parfile.")
            base_coeff = parfile[base_name]["value"][coeff]
            fit_dict[base_name]["value"][coeff] = delta
            full_dict[base_name]["value"][coeff] = base_coeff - delta
            continue
        if key not in parfile:
            raise KeyError(f"Parameter {key!r} not found in parfile.")
        base = parfile[key]["value"]
        fit_dict[key] = delta
        if _GLEP_RE.match(key):
            full_dict[key] = delta  # the epoch itself is fit
        elif _GLTD_RE.match(key):
            full_dict[key] = base + delta
        else:
            full_dict[key] = base - delta  # phase-space sign convention
    return fit_dict, full_dict


def validate_parfile(parfile: dict) -> None:
    """Validate a flags-carrying timing model; require >= 1 free parameter."""
    if not isinstance(parfile, dict):
        raise ValueError("Initial timing model must be a dict")
    n_fit = 0
    for key, value in parfile.items():
        if key == "WAVEEPOCH" or _WAVE_RE.match(key):
            continue
        if not (isinstance(value, dict) and "value" in value and "flag" in value):
            raise ValueError(f"Parameter {key!r} must be a dict with 'value' and 'flag'")
        if not isinstance(value["value"], (int, float, np.floating)):
            raise ValueError(f"Parameter {key!r}: value must be numeric")
        if value["flag"] not in (0, 1):
            raise ValueError(f"Parameter {key!r}: fit flag must be 0 or 1")
        n_fit += value["flag"] == 1
    if n_fit == 0:
        raise ValueError("Template has no free parameters (flag==1). Nothing to optimize.")


def gaussian_nll(y, mu, sigma) -> float:
    """Gaussian negative log-likelihood."""
    r = (y - mu) / sigma
    return 0.5 * np.sum(r**2 + np.log(2.0 * np.pi * sigma**2))


def model_phase_residuals(x_mjd, timmodel: dict, pvec, keys: list[str]) -> np.ndarray:
    """Mean-subtracted model phase residuals for the delta parameters.

    Waves need the FULL F0 (seconds-residual scaling); when fitting waves the
    other wave-independent terms come from the fit (delta) dict.
    """
    fit_dict, full_dict = inject_free_params(timmodel, pvec, keys)
    fit_tm = timing.from_dict(fit_dict)
    t = np.atleast_1d(np.asarray(x_mjd, dtype=np.float64))

    wave_keys = all("wave" in k.lower() for k in keys)
    any_wave = any("wave" in k.lower() for k in keys)

    if wave_keys:
        wave_dict = dict(fit_dict)
        wave_dict["F0"] = full_dict["F0"]
        phases = anchored._host_wave_phase(timing.from_dict(wave_dict), t)
    elif not any_wave:
        phases = (
            anchored._host_taylor_phase(fit_tm, t).astype(np.float64)
            + anchored._host_glitch_phase(fit_tm, t)
            + anchored._host_wave_phase(timing.from_dict(full_dict), t)
        )
    else:
        wave_dict = dict(fit_dict)
        wave_dict["F0"] = full_dict["F0"]
        phases = (
            anchored._host_taylor_phase(fit_tm, t).astype(np.float64)
            + anchored._host_glitch_phase(fit_tm, t)
            + anchored._host_wave_phase(timing.from_dict(wave_dict), t)
        )
    phases = np.asarray(phases, dtype=np.float64)
    return phases - np.mean(phases)


_LINEAR_F_RE = re.compile(r"^F(\d+)$")
_LINEAR_GL_RE = re.compile(r"^(GLPH|GLF0D|GLF0|GLF1|GLF2)_(\S+)$")
_GL_COL = {"GLPH": 0, "GLF0": 1, "GLF1": 2, "GLF2": 3, "GLF0D": 4}


def linear_key_columns(timmodel: dict, keys: list[str]) -> list[int] | None:
    """Delta-fold basis column per free key, or None if the set is not linear.

    F0..F12 map to columns 0..12 and the per-glitch [GLPH, GLF0, GLF1, GLF2,
    GLF0D] amplitudes to the glitch blocks of ``ops/deltafold.py`` in GLEP
    order. Any other key (epochs, GLTD, waves, a glitch suffix with no
    GLEP) returns None, and callers take the exact path.
    """
    from crimp_tpu_torch.ops import deltafold

    gids = [mm.group(1) for k in timmodel if (mm := re.match(r"GLEP_(\S+)$", k))]
    cols: list[int] = []
    for key in keys:
        m = _LINEAR_F_RE.match(key)
        if m:
            idx = int(m.group(1))
            if idx >= timing.N_FREQ_TERMS:
                return None
            cols.append(idx)
            continue
        m = _LINEAR_GL_RE.match(key)
        if m:
            if m.group(2) not in gids:
                return None
            cols.append(timing.N_FREQ_TERMS + deltafold.N_GLITCH_AMP * gids.index(m.group(2))
                        + _GL_COL[m.group(1)])
            continue
        return None
    return cols


def delta_basis(fit_tm, x_mjd, device=None):
    """(N, n_params) delta-fold basis anchored at PEPOCH, on ``device``
    (default cuda), with the fit path's conventions: one anchor and
    ``wave_in_f0=False`` (whitening waves stay frozen at their full values).

    Returns (basis tensor, colmax numpy array of the per-column max |B|).
    """
    from crimp_tpu_torch.ops import deltafold

    t = np.atleast_1d(np.asarray(x_mjd, dtype=np.float64))
    pepoch = float(fit_tm.pepoch)
    delta_sec = np.asarray(
        (np.asarray(t, dtype=np.longdouble) - np.longdouble(pepoch)) * np.longdouble(anchored.SECONDS_PER_DAY),  # graftlint: disable=GL004 (host-side epoch-delta in anchored.py's longdouble convention; only the rounded f64 result reaches the device basis)
        dtype=np.float64,
    )
    fb = deltafold.build_basis(fit_tm, np.asarray([pepoch]), delta_sec, np.zeros(t.size, dtype=np.int64),
                               wave_in_f0=False, device=device)
    return fb.b, fb.colmax


def model_phase_residuals_delta(x_mjd, timmodel: dict, pvec, keys: list[str], cfg: dict | None = None,
                                device=None) -> np.ndarray | None:
    """Delta-fold fast path for ``model_phase_residuals``: ``B @ dp`` as one
    f64 product on ``device`` (default cuda), frozen whitening waves added on
    the host.

    ``cfg`` is ``{"delta_fold": 0/1, "budget": cycles}`` (default off, as in
    the JAX package). Returns None when off, when a free key is not linear
    (epochs, GLTD, waves) or when the error bound exceeds the budget; the
    caller then takes the exact host path.
    """
    from crimp_tpu_torch.ops import deltafold

    t = np.atleast_1d(np.asarray(x_mjd, dtype=np.float64))
    if cfg is None:
        cfg = {"delta_fold": 0, "budget": deltafold.DEFAULT_BUDGET}
    if not cfg["delta_fold"] or not keys:
        return None
    cols = linear_key_columns(timmodel, keys)
    if cols is None:
        return None

    fit_dict, full_dict = inject_free_params(timmodel, pvec, keys)
    # deltas evaluate on the fit dict (base epochs, GLTD zeroed in delta
    # space), waves frozen at their full values
    fit_tm = timing.from_dict(fit_dict)
    dp = np.zeros(deltafold.n_params(fit_tm.n_glitch))
    dp[cols] = np.asarray(pvec, dtype=np.float64)

    b, colmax = delta_basis(fit_tm, t, device=device)
    if deltafold.error_bound_cycles(colmax, dp) > cfg["budget"]:
        return None
    phases = (b @ torch.as_tensor(dp, device=b.device)).cpu().numpy()
    full_tm = timing.from_dict(full_dict)
    if full_tm.n_wave:
        phases = phases + np.asarray(anchored._host_wave_phase(full_tm, t), dtype=np.float64)
    return phases - np.mean(phases)


def make_nll(x, y, y_err, parfile: dict, yaml_init: str | None = None):
    """(nll(pvec), p0, keys, parfile) -- the MLE objective factory."""
    validate_parfile(parfile)
    p0, keys = extract_free_params(parfile, yaml_init)
    y = np.asarray(y, dtype=float)
    y_err = np.asarray(y_err, dtype=float)
    y_centered = y - np.mean(y)

    def nll(pvec):
        mu = model_phase_residuals(x, parfile, pvec, keys)
        return gaussian_nll(y_centered, mu, y_err)

    return nll, p0, keys, parfile


def rms_residual(phaseresid, model_phaseresid) -> float:
    resid = np.asarray(phaseresid) - np.asarray(model_phaseresid)
    return float(np.sqrt(np.mean(resid**2)))


def chi2_fit(phaseresid, model_phaseresid, phase_err, freeparameters) -> dict:
    resid = np.asarray(phaseresid) - np.asarray(model_phaseresid)
    chi2 = float(np.sum(resid**2 / np.asarray(phase_err) ** 2))
    dof = np.size(phaseresid) - freeparameters
    return {"chi2": chi2, "redchi2": chi2 / dof, "dof": dof}
