"""The extended log-likelihood of a refit Fourier template, and the control
that stands in for the readvaryparam (``-rv``) fit.

A readvaryparam fit frees the template's flagged parameters as well as the
phase shift, so it reports a refit template (``theta``: the norm, the K
amplitudes, the K phases ph_k, K widths unused by a Fourier template, and
the amplitude scale) beside phShift and its maximum log-likelihood. With
every ph_k free, shifting phShift by d and each ph_k by k d gives the same
model, so phShift and the ph_k are not fixed by the data, and where 150
Nelder-Mead steps stop is no answer to compare. What is fixed is the
likelihood: the reported maximum has to be the likelihood of the reported
template and shift on the interval's events,

    LL = -norm T + N log(norm T) + sum_i log(rate(x_i) / norm),
    rate(x) = norm + sum_k amp_k ampShift cos(2 pi k x + ph_k - k phShift),

minus infinity where a rate is not positive (CRIMP's extended likelihood).
``loglik`` evaluates it in float64 on the reference's own fold.

The control is the reference put in the fit's place one precision step
below the configuration's float64: ``toafit.Fit`` in float32 with the
template held fixed, reported as a refit template (its norm the fitted
norm, the rest the template's).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import toafit


def loglik(x: torch.Tensor, mask: torch.Tensor, exposure: torch.Tensor, ph_shift: torch.Tensor,
           theta: torch.Tensor) -> torch.Tensor:
    """LL (S,) in float64 of rows x (S, N) cycles, mask (S, N), exposure
    (S,) at shifts ph_shift (S,) radians and templates theta (S, 3K + 2)."""
    f64 = torch.float64
    x, exposure, ph_shift, theta = x.to(f64), exposure.to(f64), ph_shift.to(f64), theta.to(f64)
    K = (theta.shape[1] - 2) // 3
    norm, amp, ph = theta[:, 0], theta[:, 1:1 + K] * theta[:, -1:], theta[:, 1 + K:1 + 2 * K]
    j = torch.arange(1, K + 1, dtype=f64, device=x.device)
    rate = norm[:, None].clone()
    for k in range(K):
        rate = rate + amp[:, k, None] * torch.cos((2 * math.pi) * j[k] * x + (ph[:, k] - j[k] * ph_shift)[:, None])
    ratio = rate / norm[:, None]
    n = mask.sum(-1).to(f64)
    expected = norm * exposure
    log_sum = torch.where(mask, torch.log(torch.clamp(ratio, min=1e-300)), 0.0).sum(-1)
    positive = torch.where(mask, ratio, math.inf).amin(-1) > 0
    return torch.where(positive, -expected + n * torch.log(expected) + log_sum, -math.inf)


def template_vector(template: dict, norm: np.ndarray) -> np.ndarray:
    """(S, 3K + 2) refit templates: the fitted norms, the template's
    amplitudes and phases, zero widths, amplitude scale 1."""
    K = len(template["amp"])
    out = np.zeros((len(norm), 3 * K + 2))
    out[:, 0] = norm
    out[:, 1:1 + K] = template["amp"]
    out[:, 1 + K:1 + 2 * K] = template["ph"]
    out[:, -1] = 1.0
    return out


def control_fit(template: dict, x: torch.Tensor, mask: torch.Tensor, exposure: torch.Tensor, ph_shift_res: int,
                dtype=torch.float32) -> dict:
    """The fixed-template fit in ``dtype``, reported as a refit: phShift,
    logLmax and theta."""
    fit = toafit.Fit(template, x, mask, exposure, dtype=dtype)
    out = fit.run(ph_shift_res=ph_shift_res)
    S = x.shape[0]
    rows = torch.arange(S, device=x.device)
    norm = fit.norm_at(rows, out["phShift"])
    return {"phShift": out["phShift"].double().cpu().numpy(), "logLmax": out["logLmax"].double().cpu().numpy(),
            "theta": template_vector(template, norm.double().cpu().numpy())}
