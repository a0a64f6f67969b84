"""Binned maximum-likelihood template fitting (pulse-profile construction).

Port of ``crimp_tpu/ops/templatefit.py``: scipy's L-BFGS-B on the host
drives the Gaussian binned NLL and its gradient, which ``torch.autograd``
computes in f64 on the run's device (``jax.value_and_grad`` in the JAX
package). The problem is tiny (a few parameters, ~100 bins, once per
observation), so a robust host line search beats an on-device optimizer.
Box bounds (norm positivity, von Mises / Cauchy component bounds) map onto
L-BFGS-B's native bound support.

Free/frozen parameters follow the template 'vary' flags: the optimizer
works on the gathered free subvector; frozen entries stay at their inputs.
"""

from __future__ import annotations

import numpy as np
import scipy.optimize
import torch

from crimp_tpu_torch.models.profiles import FOURIER, ProfileParams, binned_loglik, curve
from crimp_tpu_torch.utils.device import resolve_device


def _flatten(params: ProfileParams) -> torch.Tensor:
    return torch.cat([params.norm[None], params.amp, params.loc, params.wid])


def _unflatten(vec: torch.Tensor, template: ProfileParams) -> ProfileParams:
    K = template.n_comp
    return template.replace(
        norm=vec[0],
        amp=vec[1 : 1 + K],
        loc=vec[1 + K : 1 + 2 * K],
        wid=vec[1 + 2 * K : 1 + 3 * K],
    )


def _default_bounds(kind: str, x0: np.ndarray, K: int, max_rate: float):
    """(lo, hi) per flattened parameter, mirroring CRIMP's bounds
    (pulseprofile.py:315,402-406,493-497)."""
    lo = np.full_like(x0, -np.inf)
    hi = np.full_like(x0, np.inf)
    if kind == FOURIER:
        lo[0], hi[0] = 0.0, 1.0e6  # norm
    else:
        lo[0], hi[0] = 0.0, max(max_rate, 1e-6)
        lo[1 : 1 + K] = 0.0  # amps >= 0
        hi[1 : 1 + K] = np.inf
        lo[1 + K : 1 + 2 * K] = 0.0  # centroids in [0, 2pi]
        hi[1 + K : 1 + 2 * K] = 2 * np.pi
        lo[1 + 2 * K :] = 0.0  # widths >= 0
        hi[1 + 2 * K :] = np.inf
    return lo, hi


def fit_binned_template(
    kind: str,
    init: ProfileParams,
    bins: np.ndarray,
    rate: np.ndarray,
    rate_err: np.ndarray,
    vary: np.ndarray | None = None,
    maxiter: int = 2000,
    device=None,
):
    """Fit the binned profile; returns (best ProfileParams, model, stats).

    ``vary`` is a boolean flatten-ordered mask (norm, amps, locs, wids);
    None = all free (widths ignored for Fourier). The NLL and its gradient
    run on ``device`` (default cuda); ``stats["n_eval"]`` counts the
    objective evaluations, each one host round trip.
    """
    dev = resolve_device(device)
    init = init.to(dev)
    x0_t = _flatten(init).detach()
    x0 = x0_t.cpu().numpy()
    K = init.n_comp
    n_params = x0.shape[0]
    if vary is None:
        vary = np.ones(n_params, dtype=bool)
    vary = np.asarray(vary, dtype=bool).copy()
    if kind == FOURIER:
        vary[1 + 2 * K :] = False  # widths unused

    free_idx = np.nonzero(vary)[0]
    lo, hi = _default_bounds(kind, x0, K, float(np.max(rate)))

    t64 = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64), device=dev)
    bins_t, rate_t, err_t = t64(bins), t64(rate), t64(rate_err)
    free_idx_t = torch.as_tensor(free_idx, device=dev)

    def params_at(x_free: torch.Tensor) -> ProfileParams:
        return _unflatten(x0_t.index_put((free_idx_t,), x_free), init)

    def objective(x_free):
        xf = t64(x_free).requires_grad_(True)
        nll = -binned_loglik(kind, params_at(xf), bins_t, rate_t, err_t)
        (grad,) = torch.autograd.grad(nll, xf)
        return float(nll.detach()), grad.cpu().numpy().astype(np.float64)

    result = scipy.optimize.minimize(
        objective,
        x0[free_idx],
        jac=True,
        method="L-BFGS-B",
        bounds=list(zip(lo[free_idx], hi[free_idx])),
        options={"maxiter": maxiter},
    )
    best = params_at(t64(result.x))
    model = curve(kind, best, bins_t).cpu().numpy()
    chi2 = float(np.sum((rate - model) ** 2 / rate_err**2))
    dof = len(rate) - int(vary.sum())
    stats = {"chi2": chi2, "dof": dof, "redchi2": chi2 / dof, "n_eval": int(result.nfev)}
    return best, model, stats
