"""Pulse-profile template families as torch functions on a dataclass.

Port of ``crimp_tpu/models/profiles.py`` (float64 throughout):

- Fourier series on phases in cycles [0,1):
    f(x) = norm + sum_j amp_j*ampShift * cos(j*2pi*x + ph_j - j*phShift)
- wrapped Cauchy (Lorentzian) on phases in radians [0,2pi):
    f(x) = norm + sum_j amp_j*ampShift/(2pi) * sinh(wid_j) /
                  (cosh(wid_j) - cos(x - cen_j - phShift))
- von Mises (wrapped Gaussian) on phases in radians:
    f(x) = norm + sum_j amp_j*ampShift/(2pi*I0(1/wid_j^2)) *
                  exp(cos(x - cen_j - phShift)/wid_j^2)

with a binned Gaussian log-likelihood and the unbinned extended Poisson
log-likelihood (-inf when the normalized model dips non-positive on the
masked events, without generating NaNs). Curves take phases of any
leading shape (..., N); the parameters may carry leading batch dims of
their own (norm (...), amp (..., K)), which broadcast against the phases'
(the batched Nelder-Mead of the readvaryparam fit evaluates one template
per simplex vertex). Components are summed one at a time, so the
working set is (..., N).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, fields, replace

import torch

FOURIER = "fourier"
CAUCHY = "cauchy"
VONMISES = "vonmises"
KINDS = (FOURIER, CAUCHY, VONMISES)


@dataclass(frozen=True)
class ProfileParams:
    """Dense template parameters; ``loc`` is ph_k (Fourier) or cen_k."""

    norm: torch.Tensor  # scalar
    amp: torch.Tensor  # (K,)
    loc: torch.Tensor  # (K,)
    wid: torch.Tensor  # (K,) -- unused (zeros) for Fourier
    ph_shift: torch.Tensor  # scalar
    amp_shift: torch.Tensor  # scalar

    @property
    def n_comp(self) -> int:
        return int(self.amp.shape[-1])

    def replace(self, **kw) -> "ProfileParams":
        return replace(self, **kw)

    def to(self, device) -> "ProfileParams":
        return ProfileParams(**{f.name: getattr(self, f.name).to(device) for f in fields(self)})


def from_template(template: dict, ph_shift: float = 0.0, amp_shift: float = 1.0) -> tuple[str, ProfileParams]:
    """(kind, params) from a template dict as read by io.template (CPU tensors)."""
    kind = template["model"].casefold()
    n = int(template["nbrComp"])
    value = lambda key: float(template[key]["value"]) if isinstance(template[key], dict) else float(template[key])
    t64 = lambda v: torch.tensor(v, dtype=torch.float64)
    amp = t64([value(f"amp_{k}") for k in range(1, n + 1)])
    if kind == FOURIER:
        loc = t64([value(f"ph_{k}") for k in range(1, n + 1)])
        wid = torch.zeros(n, dtype=torch.float64)
    else:
        loc = t64([value(f"cen_{k}") for k in range(1, n + 1)])
        wid = t64([value(f"wid_{k}") for k in range(1, n + 1)])
    params = ProfileParams(
        norm=t64(value("norm")),
        amp=amp,
        loc=loc,
        wid=wid,
        ph_shift=t64(ph_shift),
        amp_shift=t64(amp_shift),
    )
    return kind, params


def to_theta(kind: str, params: ProfileParams) -> dict:
    """Flat reference-style theta dict (for file writers and reports)."""
    theta = {
        "norm": float(params.norm),
        "phShift": float(params.ph_shift),
        "ampShift": float(params.amp_shift),
    }
    amp, loc, wid = (getattr(params, n).detach().cpu().tolist() for n in ("amp", "loc", "wid"))
    for j in range(params.n_comp):
        theta[f"amp_{j + 1}"] = amp[j]
        if kind == FOURIER:
            theta[f"ph_{j + 1}"] = loc[j]
        else:
            theta[f"cen_{j + 1}"] = loc[j]
            theta[f"wid_{j + 1}"] = wid[j]
    return theta


def fourier_curve(params: ProfileParams, x: torch.Tensor) -> torch.Tensor:
    """Fourier-series rate curve at phases x (cycles)."""
    total = None
    for k in range(params.n_comp):
        j = float(k + 1)
        angle = (j * 2 * math.pi) * x + params.loc[..., k, None] - (j * params.ph_shift)[..., None]
        term = (params.amp[..., k] * params.amp_shift)[..., None] * torch.cos(angle)
        total = term if total is None else total + term
    return params.norm[..., None] + total


def cauchy_curve(params: ProfileParams, x: torch.Tensor) -> torch.Tensor:
    """Wrapped-Cauchy rate curve at phases x (radians)."""
    total = None
    for k in range(params.n_comp):
        delta = x - params.loc[..., k, None] - params.ph_shift[..., None]
        wid = params.wid[..., k, None]
        term = ((params.amp[..., k] * params.amp_shift / (2 * math.pi))[..., None]
                * torch.sinh(wid) / (torch.cosh(wid) - torch.cos(delta)))
        total = term if total is None else total + term
    return params.norm[..., None] + total


def vonmises_curve(params: ProfileParams, x: torch.Tensor) -> torch.Tensor:
    """von Mises rate curve at phases x (radians)."""
    total = None
    for k in range(params.n_comp):
        kappa = (1.0 / params.wid[..., k] ** 2)[..., None]
        delta = x - params.loc[..., k, None] - params.ph_shift[..., None]
        term = (params.amp[..., k] * params.amp_shift)[..., None] / (
            2 * math.pi * torch.special.i0(kappa)) * torch.exp(kappa * torch.cos(delta))
        total = term if total is None else total + term
    return params.norm[..., None] + total


_CURVES = {FOURIER: fourier_curve, CAUCHY: cauchy_curve, VONMISES: vonmises_curve}


def curve(kind: str, params: ProfileParams, x: torch.Tensor) -> torch.Tensor:
    return _CURVES[kind](params, x)


def extended_norm_factor(kind: str, params: ProfileParams) -> torch.Tensor:
    """Normalization used by the extended likelihood.

    Fourier normalizes by ``norm``; von Mises / Cauchy by
    2*pi*norm + sum_j amp_j*ampShift.
    """
    if kind == FOURIER:
        return params.norm
    return 2 * math.pi * params.norm + torch.sum(params.amp * params.amp_shift[..., None], dim=-1)


def binned_loglik(kind: str, params: ProfileParams, x, y, y_err) -> torch.Tensor:
    """Gaussian log-likelihood of binned rates y +/- y_err at phases x."""
    model = curve(kind, params, x)
    resid = (y - model) / y_err
    return torch.sum(-0.5 * resid**2 - 0.5 * torch.log(2 * math.pi * y_err**2), dim=-1)


def extended_loglik(kind: str, params: ProfileParams, x: torch.Tensor, exposure, mask=None) -> torch.Tensor:
    """Unbinned extended Poisson log-likelihood of event phases x (..., N).

    ``mask`` marks valid events (padded ragged segments); returns -inf when
    the normalized model dips non-positive anywhere on the masked set.
    """
    model = curve(kind, params, x)
    norm_factor = extended_norm_factor(kind, params)
    normalized = model / norm_factor[..., None]
    logs = torch.log(torch.clamp(normalized, min=1e-300))
    if mask is None:
        n_events = torch.full(x.shape[:-1], float(x.shape[-1]), dtype=x.dtype, device=x.device)
        min_val = torch.amin(normalized, dim=-1)
        log_sum = torch.sum(logs, dim=-1)
    else:
        n_events = torch.sum(mask, dim=-1).to(x.dtype)
        min_val = torch.amin(torch.where(mask, normalized, math.inf), dim=-1)
        log_sum = torch.sum(torch.where(mask, logs, 0.0), dim=-1)

    exposure = torch.as_tensor(exposure, dtype=x.dtype, device=x.device)
    if kind == FOURIER:
        expected = params.norm * exposure
    else:
        expected = norm_factor * exposure / (2 * math.pi)
    value = -expected + n_events * torch.log(expected) + log_sum
    return torch.where(min_val <= 0, -math.inf, value)
