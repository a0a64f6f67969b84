"""Timing-model fitting from pulse ToAs (CLI: fittoas), exact likelihood.

Port of ``crimp_tpu/pipelines/fit_toas.py`` (workflow of CRIMP's
fit_toas.py:35-457): load a .tim file, convert ToAs to phase residuals
(TRACK -2 + -pn pulse-number tracking, else fold to [-0.5, 0.5)),
optional manual phase-wrap insertion, then fit parameter deltas in phase
space by MLE (scipy Nelder-Mead, or BFGS when waves are free, on the host)
or by ensemble MCMC with YAML box priors; write the patched .par with
statistics, residual plots, and the posterior corner plot.

The MCMC runs on the device: the exact log-probability below scores a
whole half-ensemble at once, the walker axis riding the leading batch axis
of the timing fields (``ops.fold``). With ``mcmc_delta=1`` a linear free
set scores through the delta-basis likelihood (``make_logprob_delta``,
``ops.mcmc.delta_logprob``), and ``delta_fold=1`` takes the post-fit
residuals through one basis product (``fit_utils.model_phase_residuals_delta``).
Left None, both read their knobs (CRIMP_TORCH_MCMC_DELTA,
CRIMP_TORCH_DELTA_FOLD, CRIMP_TORCH_DELTA_FOLD_BUDGET); the JAX package's
defaults are off. The MCMC ladder is the JAX package's: a failure of the
delta-basis run drops to the exact likelihood (``degraded_mcmc_exact_likelihood``),
except a ``KernelError``, which propagates.
"""

from __future__ import annotations

import math
import re
import time
from dataclasses import replace

import numpy as np
import torch

from crimp_tpu_torch import obs, resilience
from crimp_tpu_torch.io import parfile as parfile_io
from crimp_tpu_torch.io import tim as tim_io
from crimp_tpu_torch.io.parfile import get_parameter_value
from crimp_tpu_torch.io.yamlcfg import Prior, load_prior
from crimp_tpu_torch.models import timing
from crimp_tpu_torch.obs import costmodel
from crimp_tpu_torch.ops import autotune, deltafold
from crimp_tpu_torch.ops import fold as fold_ops
from crimp_tpu_torch.ops import mcmc as mcmc_ops
from crimp_tpu_torch.pipelines import fit_utils
from crimp_tpu_torch.resilience import faultinject
from crimp_tpu_torch.utils.device import resolve_device
from crimp_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

_GL_FIELDS = {
    "GLEP": "glep",
    "GLPH": "glph",
    "GLF0": "glf0",
    "GLF1": "glf1",
    "GLF2": "glf2",
    "GLF0D": "glf0d",
    "GLTD": "gltd",
}


# ---------------------------------------------------------------------------
# ToA loading
# ---------------------------------------------------------------------------


def load_toas_for_fit(
    tim_table: dict,
    parfile: dict,
    t_start: float | None = None,
    t_stop: float | None = None,
    t_mjd_phasewrap=None,
    mode: str = "add",
    device=None,
) -> dict:
    """ToAs -> {'ToA', 'phase', 'phase_err_cycle'} columns for fitting."""
    F0 = get_parameter_value(parfile["F0"])
    pt = tim_io.PulseToAs(tim_table)
    pt.time_filter(t_start, t_stop)
    # the order pandas' sort_values gives (numpy's quicksort)
    order = np.argsort(np.asarray(pt.df["pulse_ToA"], dtype=float), kind="quicksort")
    pt.df = tim_io.select_rows(pt.df, order)

    toas = np.asarray(pt.df["pulse_ToA"], dtype=float)
    toa_err = np.asarray(pt.df["pulse_ToA_err"], dtype=float)

    phases, _ = fold_ops.fold_phases(toas, parfile, device=device)
    if (
        "TRACK" in parfile
        and get_parameter_value(parfile["TRACK"]) == -2
        and "pn" in pt.df
    ):
        phases = phases - np.asarray(pt.df["pn"], dtype=float)
        logger.info("Found TRACK -2 and -pn pulse numbers - tracking pulse numbers")
    else:
        phases = ((phases + 0.5) % 1.0) - 0.5
        logger.info("Phase folding between [-0.5, 0.5)")
    phases = phases - np.mean(phases)

    out = {
        "ToA": toas,
        "phase": phases,
        "phase_err_cycle": (toa_err / 1e6) * F0,
    }
    if t_mjd_phasewrap is not None:
        out = add_phasewrap(out, t_mjd_phasewrap, mode=mode)
        out["phase"] = out["phase"] - np.mean(out["phase"])
    return out


def add_phasewrap(toas_to_fit: dict, t_mjd, mode: str = "add") -> dict:
    """Cumulatively shift phases by +/-1 cycle for ToAs past each cut MJD
    (in place; returns the table)."""
    cuts = np.atleast_1d(np.asarray(t_mjd, dtype=float))
    if cuts.size == 0:
        return toas_to_fit
    if mode.lower() == "add":
        sign = 1.0
    elif mode.lower() == "subtract":
        sign = -1.0
    else:
        raise ValueError("mode must be 'add' or 'subtract'.")
    counts = np.searchsorted(np.sort(cuts), np.asarray(toas_to_fit["ToA"], dtype=float), side="right")
    toas_to_fit["phase"] = toas_to_fit["phase"] + sign * counts
    return toas_to_fit


# ---------------------------------------------------------------------------
# Device-side delta-parameterized phase model for the MCMC
# ---------------------------------------------------------------------------


def _delta_model_updates(parfile: dict, keys: list[str]):
    """Map free-parameter keys to TimingParams (field, index) updates."""
    gids = [m.group(1) for k in parfile if (m := re.match(r"GLEP_(\S+)$", k))]
    updates = []
    for key in keys:
        if re.match(r"^F\d+$", key):
            updates.append(("f", int(key[1:])))
        elif (m := re.match(r"^(GLEP|GLPH|GLF0D|GLF0|GLF1|GLF2|GLTD)_(\S+)$", key)):
            updates.append((_GL_FIELDS[m.group(1)], gids.index(m.group(2))))
        elif (m := re.match(r"^WAVE(\d+)_([AB])$", key)):
            updates.append(("wave_a" if m.group(2) == "A" else "wave_b", int(m.group(1)) - 1))
        else:
            raise KeyError(f"cannot fit parameter {key!r} on device")
    return updates


def exact_logprob(theta: torch.Tensor, data: dict) -> torch.Tensor:
    """Exact Gaussian log-probability of the delta parameters, batched.

    ``theta`` is (..., ndim) on the data's device; returns (...,). Each free
    key scatters its column of ``theta`` into a batched copy of its timing
    field, and the phase model runs once for the whole batch. Box priors
    gate the result to -inf outside (lo, hi).
    """
    batch = theta.shape[:-1]
    in_box = torch.all((theta > data["lo"]) & (theta < data["hi"]), dim=-1)
    base = data["base_tm"]
    fields: dict = {}
    for j, (field, idx) in enumerate(data["updates"]):
        if field not in fields:
            arr = getattr(base, field)
            fields[field] = arr.expand(*batch, *arr.shape).clone()
        fields[field][..., idx] = theta[..., j]
    tm = replace(base, **fields)
    x = data["x"]
    if data["any_wave"]:
        # Waves are seconds-residuals scaled by the FULL F0
        # (utilities_fittoas.py:269-293).
        f0_key_idx = data["f0_key_idx"]
        full_f0 = data["full_f0"] - theta[..., f0_key_idx] if f0_key_idx is not None else data["full_f0"]
        wave_f = tm.f.expand(*batch, *tm.f.shape[-1:]).clone()
        wave_f[..., 0] = full_f0
        waves = fold_ops.wave_phase(replace(tm, f=wave_f), x)
        if data["all_wave"]:
            mu = waves
        else:
            mu = fold_ops.taylor_phase(tm, x) + fold_ops.glitch_phase(tm, x) + waves
    else:
        mu = fold_ops.taylor_phase(tm, x) + fold_ops.glitch_phase(tm, x) + data["frozen_waves"]
    mu = mu.expand(*batch, x.shape[-1])
    mu = mu - torch.mean(mu, dim=-1, keepdim=True)
    resid = (data["y"] - mu) / data["yerr"]
    nll = 0.5 * torch.sum(resid**2 + data["log_norm"], dim=-1)
    return torch.where(in_box, -nll, -math.inf)


def make_logprob_parts(parfile: dict, keys: list[str], prior: Prior, x, y, yerr, device=None):
    """(log_prob_fn, data): ``exact_logprob`` and its observations and base
    model as tensors on ``device`` (default cuda)."""
    dev = resolve_device(device)
    fit_dict, full_dict = fit_utils.inject_free_params(parfile, np.zeros(len(keys)), keys)
    t64 = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64), device=dev)

    y_centered = np.asarray(y, dtype=float)
    y_centered = y_centered - y_centered.mean()
    yerr = np.asarray(yerr, dtype=float)
    x_t = t64(x)
    yerr_t = t64(yerr)
    # theta-independent whitening-wave phases (the non-wave-fit branch):
    # computed once here instead of once per proposal
    frozen_waves = fold_ops.wave_phase(timing.from_dict(full_dict).to(dev), x_t)
    data = {
        "lo": t64([prior.bounds.get(k, (-np.inf, np.inf))[0] for k in keys]),
        "hi": t64([prior.bounds.get(k, (-np.inf, np.inf))[1] for k in keys]),
        "x": x_t,
        "y": t64(y_centered),
        "yerr": yerr_t,
        "log_norm": torch.log(2 * math.pi * yerr_t**2),
        "base_tm": timing.from_dict(fit_dict).to(dev),
        "full_f0": t64(float(get_parameter_value(parfile["F0"]))),
        "frozen_waves": frozen_waves,
        "updates": tuple(_delta_model_updates(parfile, keys)),
        "f0_key_idx": keys.index("F0") if "F0" in keys else None,
        "any_wave": any("wave" in k.lower() for k in keys),
        "all_wave": all("wave" in k.lower() for k in keys) and len(keys) > 0,
    }
    return exact_logprob, data


def make_logprob(parfile: dict, keys: list[str], prior: Prior, x, y, yerr, device=None):
    """Batched log-probability over the free-parameter delta vectors."""
    log_prob_fn, data = make_logprob_parts(parfile, keys, prior, x, y, yerr, device=device)

    def log_prob(theta):
        return log_prob_fn(theta, data)

    return log_prob


def make_logprob_delta(parfile: dict, keys: list[str], prior: Prior, x, y, yerr,
                       budget: float = deltafold.DEFAULT_BUDGET, device=None):
    """(data, info) for the delta-basis likelihood ``mcmc.delta_logprob``, or
    (None, info) when the guard refuses the free set.

    Within the linear regime the delta-parameterized model is exactly
    ``mu = B_free @ theta`` against the delta-fold basis of the ToAs
    (``fit_utils.delta_basis``), so a half-ensemble scores as one (walkers x
    ndim) @ (ndim x nToA) product. ``info["reason"]`` says why a set is
    refused: ``nonlinear_free_param`` (epochs, GLTD, waves),
    ``unbounded_prior`` (a free key without a finite box) or
    ``error_bound_exceeds_budget`` (the f64 error bound over the walker box
    extent is above ``budget`` cycles). The tensors lie on ``device``
    (default cuda).
    """
    info: dict = {"eligible": False, "reason": None}
    cols = fit_utils.linear_key_columns(parfile, keys)
    if not keys or cols is None:
        info["reason"] = "nonlinear_free_param"
        return None, info

    lo = np.asarray([prior.bounds.get(k, (-np.inf, np.inf))[0] for k in keys])
    hi = np.asarray([prior.bounds.get(k, (-np.inf, np.inf))[1] for k in keys])
    if not (np.all(np.isfinite(lo)) and np.all(np.isfinite(hi))):
        info["reason"] = "unbounded_prior"
        return None, info

    dev = resolve_device(device)
    fit_dict, full_dict = fit_utils.inject_free_params(parfile, np.zeros(len(keys)), keys)
    fit_tm = timing.from_dict(fit_dict)
    full_tm = timing.from_dict(full_dict)
    t = np.atleast_1d(np.asarray(x, dtype=np.float64))
    b, colmax = fit_utils.delta_basis(fit_tm, t, device=dev)

    # the worst-case |theta| over the prior box: outside it the log-prob is
    # -inf whatever the model, so the box extent bounds every product the
    # sampler trusts
    dp_box = np.zeros(deltafold.n_params(fit_tm.n_glitch))
    dp_box[cols] = np.maximum(np.abs(lo), np.abs(hi))
    bound = deltafold.error_bound_cycles(colmax, dp_box)
    info.update(bound_cycles=bound, budget_cycles=float(budget), nonlinear_sha=deltafold.nonlinear_sha(fit_tm),
                n_toas=int(t.size), ndim=len(keys))
    if bound > budget:
        info["reason"] = "error_bound_exceeds_budget"
        return None, info

    # center the data against the frozen whitening waves, so the likelihood
    # matches the exact path's center(B @ theta + waves)
    y_c = np.asarray(y, dtype=float)
    y_c = y_c - y_c.mean()
    if full_tm.n_wave:
        w = fold_ops.wave_phase(full_tm, torch.as_tensor(t)).numpy()
        y_c = y_c - (w - w.mean())

    info["eligible"] = True
    t64 = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64), device=dev)  # noqa: E731
    data = {
        "basis": b[:, cols].contiguous(),
        "y": t64(y_c),
        "err": t64(yerr),
        "mask": torch.ones(t.size, dtype=torch.float64, device=dev),
        "lo": t64(lo),
        "hi": t64(hi),
    }
    return data, info


def run_mcmc(
    x,
    y,
    yerr,
    init_parfile: dict,
    keys: list[str],
    prior: Prior,
    steps: int = 10000,
    burn: int = 500,
    walkers: int = 32,
    corner_pdf: str | None = None,
    chain_npy: str | None = None,
    flat_npy: str | None = None,
    progress: bool = True,
    seed: int = 0,
    mcmc_delta: int | None = None,
    device=None,
    budget: float | None = None,
    draws: mcmc_ops.Draws | None = None,
):
    """Ensemble-MCMC posterior sampling on ``device`` (default cuda)
    (replaces emcee; CRIMP fit_toas.py:140-202).

    The initial ensemble is drawn as in the JAX package (numpy's
    ``default_rng(seed)``, uniform in the prior box); the sampler's draws
    come from a ``torch.Generator`` seeded from ``seed``, or are ``draws``
    when given (fed random numbers, e.g. the JAX package's). With
    ``mcmc_delta=1`` (None: CRIMP_TORCH_MCMC_DELTA, else off) proposals score
    through the delta-basis likelihood when ``make_logprob_delta`` admits
    the free set within ``budget`` (None: CRIMP_TORCH_DELTA_FOLD_BUDGET, else
    1e-9 cycles); a refused set takes the exact likelihood, as in the JAX
    package (``mcmc_guard_fallbacks``). A failure of the delta-basis run, or
    a NaN in its log-probabilities, steps the ladder to the exact likelihood
    from the same draws; a ``KernelError`` propagates.

    Returns (chain, flat, summaries) as numpy."""
    dev = resolve_device(device)
    if mcmc_delta is None or budget is None:
        cfg = autotune.resolve_mcmc_delta(int(np.shape(x)[0]), device=dev)
        mcmc_delta = cfg["mcmc_delta"] if mcmc_delta is None else mcmc_delta
        budget = cfg["budget"] if budget is None else budget
    rng = np.random.default_rng(seed)
    ndim = len(keys)
    p0 = np.empty((walkers, ndim))
    for i, name in enumerate(keys):
        lo, hi = prior.bounds[name]
        p0[:, i] = rng.uniform(lo, hi, size=walkers)

    def sample(log_prob_fn, lp_data):
        if draws is None:
            chain_t, lps_t = mcmc_ops.ensemble_sample(log_prob_fn, p0, steps, seed, data=lp_data,
                                                      device=dev)
        else:
            fed = mcmc_ops.Draws(*(d.to(dev) for d in draws))
            chain_t, lps_t = mcmc_ops.ensemble_sample_draws(
                log_prob_fn, torch.as_tensor(p0, device=dev), fed, data=lp_data,
                graph_steps=mcmc_ops.GRAPH_STEPS if dev.type == "cuda" else 0)
        return chain_t.cpu().numpy(), lps_t.cpu().numpy()

    obs.counter_add("mcmc_proposals_evaluated", steps * walkers)
    chain = None
    if mcmc_delta:
        lp_data, delta_info = make_logprob_delta(init_parfile, keys, prior, x, y, yerr, budget=budget,
                                                 device=dev)
        if lp_data is None:
            obs.counter_add("mcmc_guard_fallbacks", 1)
            logger.info("delta-basis MCMC refused (%s); using the exact likelihood", delta_info["reason"])
        else:
            try:
                faultinject.fire("mcmc_step")
                with costmodel.kernel_span("mcmc_ensemble_delta"):
                    chain, lps = sample(mcmc_ops.delta_logprob, lp_data)
                costmodel.capture("mcmc_ensemble_delta", None, p0, lp_data, steps, out=chain)
                if np.isnan(lps).any():
                    raise resilience.NonfiniteResultError("delta-basis MCMC produced NaN log-probabilities")
                obs.counter_add("mcmc_delta_path_steps", steps)
            except resilience.KernelError:
                raise
            except Exception as exc:  # MCMC ladder: the delta-basis rung fell
                kind = resilience.classify(exc)
                resilience.record_degradation("mcmc", "exact_likelihood", kind)
                logger.warning("delta-basis MCMC failed (%s); falling back to the exact likelihood",
                               kind.value, exc_info=True)
                chain = None
    if chain is None:
        chain, lps = sample(*make_logprob_parts(init_parfile, keys, prior, x, y, yerr, device=dev))
    if chain_npy:
        np.save(chain_npy, chain)
    flat, flat_lp, summaries = mcmc_ops.summarize_chain(chain, lps, keys, burn=max(0, burn))
    if flat_npy:
        np.save(flat_npy, flat)
    if corner_pdf is not None:
        corner_plot(flat, keys, corner_pdf)
    return chain, flat, summaries


def corner_plot(flat: np.ndarray, labels: list[str], path_stem: str) -> str:
    """Posterior corner plot (own matplotlib implementation): 2-D hist panels
    below the diagonal, 1-D hists on it, with 16/50/84-percentile titles."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    ndim = flat.shape[1]
    fig, axes = plt.subplots(ndim, ndim, figsize=(2.2 * ndim, 2.2 * ndim))
    axes = np.atleast_2d(axes)
    for i in range(ndim):
        for j in range(ndim):
            ax = axes[i, j]
            if j > i:
                ax.axis("off")
                continue
            if i == j:
                ax.hist(flat[:, i], bins=40, color="k", histtype="step")
                q16, q50, q84 = np.percentile(flat[:, i], [16, 50, 84])
                ax.set_title(
                    f"{labels[i]} = {q50:.3g} (+{q84 - q50:.2g}/-{q50 - q16:.2g})",
                    fontsize=8,
                )
                ax.set_yticks([])
            else:
                ax.hist2d(flat[:, j], flat[:, i], bins=40, cmap="Greys")
            if i == ndim - 1:
                ax.set_xlabel(labels[j], fontsize=8)
            if j == 0 and i > 0:
                ax.set_ylabel(labels[i], fontsize=8)
    fig.tight_layout()
    path = path_stem + ".pdf"
    fig.savefig(path, format="pdf", dpi=200)
    plt.close(fig)
    return path


def plot_residuals(toas_pre_fit: dict, phase_residuals_post_fit, plotname=None):
    """Pre-fit residuals + best-fit model, and post-fit (data-model) panel."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axs = plt.subplots(
        2, 1, figsize=(10, 8), sharex=True, gridspec_kw={"height_ratios": [1, 0.7]}
    )
    axs[0].errorbar(
        toas_pre_fit["ToA"], toas_pre_fit["phase"], yerr=toas_pre_fit["phase_err_cycle"],
        color="k", fmt="o", ls="", alpha=0.5, label="Pre-fit residuals",
    )
    axs[0].plot(
        toas_pre_fit["ToA"], phase_residuals_post_fit, "k-", alpha=0.5, label="Best-fit model"
    )
    axs[0].set_ylabel("Residuals (cycle)")
    axs[0].legend()
    axs[1].errorbar(
        toas_pre_fit["ToA"],
        toas_pre_fit["phase"] - phase_residuals_post_fit,
        yerr=toas_pre_fit["phase_err_cycle"],
        color="k", fmt="o", ls="", alpha=0.5, label="Post-fit (data-model) residuals",
    )
    axs[1].axhline(0, color="k")
    axs[1].set_xlabel("Time (MJD)")
    axs[1].set_ylabel("Residuals (cycle)")
    axs[1].legend()
    fig.tight_layout()
    if plotname is None:
        plt.close(fig)
        return None
    fig.savefig(str(plotname) + ".pdf", format="pdf", bbox_inches="tight")
    plt.close(fig)
    return str(plotname) + ".pdf"


# ---------------------------------------------------------------------------
# Orchestration (the CLI body)
# ---------------------------------------------------------------------------


def fit_toas(
    timfile_path: str,
    par_in: str,
    par_out: str,
    t_start: float | None = None,
    t_end: float | None = None,
    t_mjd: list[float] | None = None,
    mode: str = "add",
    init_yaml: str | None = None,
    mcmc: bool = False,
    mcmc_steps: int = 10000,
    mcmc_burn: int = 500,
    mcmc_walkers: int = 32,
    corner_plot_path: str | None = None,
    chain_npy: str | None = None,
    flat_npy: str | None = None,
    best_fit: str = "map",
    residual_plot: str | None = None,
    seed: int = 0,
    device=None,
    mcmc_delta: int | None = None,
    delta_fold: int | None = None,
    budget: float | None = None,
) -> dict:
    """Full fit pipeline; returns {'keys', 'values', 'stats', ...}.

    ``device`` (default cuda) runs the ToA fold and the MCMC; the MLE and
    the post-fit residuals run on the host, as in the JAX package.
    ``mcmc_delta=1`` samples a linear free set with the delta-basis
    likelihood; ``delta_fold=1`` takes the post-fit residuals of a linear
    free set through one basis product on ``device`` (both within
    ``budget`` cycles; None reads the knobs, whose defaults, the JAX
    package's, are off).
    ``mcmc_seconds`` is the wall time of ``run_mcmc`` (None for the MLE).
    """
    dev = resolve_device(device)
    init_par = parfile_io.read_timing_model(par_in)[2]
    F0 = get_parameter_value(init_par["F0"])
    tim_table = tim_io.read_tim(timfile_path, comment="C")
    toas_pre_fit = load_toas_for_fit(tim_table, init_par, t_start, t_end, t_mjd, mode, device=dev)
    delta_fold, budget = deltafold.resolve_delta_fold(
        delta_fold, budget, n_events=len(next(iter(tim_table.values()), ())), device=dev)
    fit_utils.validate_parfile(init_par)

    misc_keys = {
        "START": toas_pre_fit["ToA"].min(),
        "FINISH": toas_pre_fit["ToA"].max(),
    }

    if mcmc:
        keys = fit_utils.list_fit_keys(init_par)
        if init_yaml is None:
            raise ValueError("init_yaml (bounds) is required for the MCMC path")
        prior = load_prior(init_yaml)
        print(f"Running ensemble MCMC (torch stretch-move sampler on {dev})...")
        t0 = time.perf_counter()
        _, flat, summaries = run_mcmc(
            toas_pre_fit["ToA"], toas_pre_fit["phase"], toas_pre_fit["phase_err_cycle"],
            init_par, keys, prior, steps=mcmc_steps, burn=mcmc_burn, walkers=mcmc_walkers,
            corner_pdf=corner_plot_path, chain_npy=chain_npy, flat_npy=flat_npy, seed=seed,
            mcmc_delta=mcmc_delta, device=dev, budget=budget,
        )
        mcmc_seconds = time.perf_counter() - t0
        logger.info("MCMC: %d steps x %d walkers in %.3f s (%.1f steps/s) on %s",
                    mcmc_steps, mcmc_walkers, mcmc_seconds, mcmc_steps / mcmc_seconds, dev)
        print("Posterior summaries (median -/+ 1sigma via 16th/84th percentiles):")
        uncertainties = {}
        for name, s in summaries.items():
            print(f"  {name}: {s['median']:.8e} -{s['minus']:.2e} +{s['plus']:.2e}")
            uncertainties[name] = max(s["minus"], s["plus"])
        best_vec = np.array([summaries[name][best_fit] for name in keys])
        _, full_dict = fit_utils.inject_free_params(init_par, best_vec, keys)
        source_label = f"MCMC (posterior {best_fit})"
    else:
        nll, p0, keys, _ = fit_utils.make_nll(
            toas_pre_fit["ToA"], toas_pre_fit["phase"], toas_pre_fit["phase_err_cycle"],
            init_par, init_yaml,
        )
        from scipy.optimize import minimize

        if any("wave" in k.lower() for k in keys):
            if any("glep_" in k.lower() for k in keys):
                logger.warning(
                    "Fitting glitch epochs and waves simultaneously is discouraged."
                )
            res = minimize(nll, p0, method="BFGS", options={"maxiter": int(1e5)}, tol=1e-16, jac="3-point")
        else:
            res = minimize(nll, p0, method="Nelder-Mead", options={"maxiter": int(1e5)})
        best_vec = res.x
        _, full_dict = fit_utils.inject_free_params(init_par, best_vec, keys)
        uncertainties = None
        source_label = "Maximum Likelihood Estimation"
        mcmc_seconds = None

    # the delta engine serves a linear free set as one basis product; None
    # (off, non-linear set, bound over budget) takes the exact host path
    post_fit = fit_utils.model_phase_residuals_delta(
        toas_pre_fit["ToA"], init_par, best_vec, keys, cfg={"delta_fold": delta_fold, "budget": budget},
        device=dev)
    if post_fit is None:
        post_fit = fit_utils.model_phase_residuals(toas_pre_fit["ToA"], init_par, best_vec, keys)
    if residual_plot is not None:
        suffix = f"_{best_fit}" if mcmc else ""
        plot_residuals(toas_pre_fit, post_fit, residual_plot + suffix)

    parfile_io.patch_par_values(
        par_in, par_out, new_values=full_dict, uncertainties=uncertainties
    )
    print("---------------------------")
    print(f"Wrote new timing model to {par_out} using {source_label} values")

    rms_cycle = fit_utils.rms_residual(toas_pre_fit["phase"], post_fit)
    stats = fit_utils.chi2_fit(
        toas_pre_fit["phase"], post_fit, toas_pre_fit["phase_err_cycle"], len(keys)
    )
    print("Statistics of new best-fit:")
    print(f"RMS residual in cycle = {rms_cycle}")
    print(f"RMS residual in seconds = {rms_cycle / F0} (assuming F0 = {F0})")
    print(f"Chi2 = {stats['chi2']} for {stats['dof']} dof")
    print(f"reduced Chi2 = {stats['redchi2']}")

    parfile_io.patch_statistics(
        par_out,
        par_out,
        {
            "CHI2R": stats["redchi2"],
            "NTOA": len(toas_pre_fit["ToA"]),
            "TRES": rms_cycle / F0 * 1e6,
            "CHI2R_DOF": stats["dof"],
        },
    )
    parfile_io.patch_miscellaneous(par_out, par_out, misc_keys)
    print(f"Appended best-fit statistical properties to {par_out} par file\n")
    return {
        "keys": keys,
        "values": best_vec,
        "full_dict": full_dict,
        "stats": stats,
        "rms_cycle": rms_cycle,
        "toas": toas_pre_fit,
        "post_fit_residuals": post_fit,
        "mcmc_seconds": mcmc_seconds,
    }
