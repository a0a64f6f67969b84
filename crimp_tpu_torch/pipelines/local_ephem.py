"""Local [F0, F1] ephemerides in a sliding window (CLI: localephemerides).

Port of ``crimp_tpu/pipelines/local_ephem.py`` (workflow of CRIMP's
get_local_ephem.py:27-265) on the port's numpy ``.tim`` table: slide a
window (interval_days, jump_days) over the ToAs, truncating at glitch
epochs and resuming after them; per window, build a minimal 14-key timing
model anchored at the window-mid integer-rotation epoch (TRACK -2) and fit
F0/F1 under span-scaled box priors; record F0, F1 +/- err and chi2; finally
detrend F0 by the global F0 + F1 trend and write the tab-separated table
(the layout pandas' ``to_csv`` writes, so ``crimp_tpu``'s
``read_local_ephemerides`` reads it back).

Window discovery is data-dependent host logic. Every window's ensemble run
executes together in ONE batched sampler call on ``device`` (default cuda):
ToAs padded and masked per window, the likelihood ``mcmc.delta_logprob``
against the rank-2 Taylor basis [dt, dt^2/2] of each window.
"""

from __future__ import annotations

import numpy as np
import torch

from crimp_tpu_torch.io import parfile as parfile_io
from crimp_tpu_torch.io import tim as tim_io
from crimp_tpu_torch.models import timing
from crimp_tpu_torch.ops import deltafold
from crimp_tpu_torch.ops import mcmc as mcmc_ops
from crimp_tpu_torch.ops.ephem import integer_rotation_host
from crimp_tpu_torch.pipelines import fit_utils
from crimp_tpu_torch.pipelines.fit_toas import corner_plot, load_toas_for_fit, plot_residuals
from crimp_tpu_torch.utils.device import resolve_device
from crimp_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

FIT_KEYS = ["F0", "F1"]
COLUMNS = ["TOA_MJD_ref", "TOA_MJD_ref_err", "F0", "F0_err", "F1", "F1_err", "CHI2R", "DOF"]


def window_data(windows: list[dict], device) -> dict:
    """The padded, masked batch of all windows for ``mcmc.delta_logprob``,
    as f64 tensors on ``device``."""
    n_max = max(len(w["dt_sec"]) for w in windows)
    n_win = len(windows)
    dt = np.zeros((n_win, n_max))
    y = np.zeros((n_win, n_max))
    err = np.ones((n_win, n_max))
    mask = np.zeros((n_win, n_max))
    lo = np.zeros((n_win, 2))
    hi = np.zeros((n_win, 2))
    for i, w in enumerate(windows):
        n = len(w["dt_sec"])
        dt[i, :n] = w["dt_sec"]
        y[i, :n] = w["phase"]
        err[i, :n] = w["phase_err"]
        mask[i, :n] = 1.0
        lo[i], hi[i] = w["lo"], w["hi"]
    t64 = lambda a: torch.as_tensor(a, dtype=torch.float64, device=device)  # noqa: E731
    return {"basis": t64(deltafold.taylor_basis_seconds(dt, 2)), "y": t64(y), "err": t64(err),
            "mask": t64(mask), "lo": t64(lo), "hi": t64(hi)}


def _fit_windows_batched(windows: list[dict], steps: int, burn: int, walkers: int, debug_with_plots: bool,
                         device, draws: mcmc_ops.Draws | None):
    """One batched ensemble run over all windows; per-window posterior
    summaries in window order."""
    p0 = np.empty((len(windows), walkers, 2))
    for i, w in enumerate(windows):
        rng = np.random.default_rng(w["seed"])
        for d in range(2):
            p0[i, :, d] = rng.uniform(w["lo"][d], w["hi"][d], size=walkers)
    data = window_data(windows, device)
    if draws is None:
        chains, lps = mcmc_ops.ensemble_sample_batch(mcmc_ops.delta_logprob, p0, data, steps, seed=0,
                                                     device=device)
    else:
        fed = mcmc_ops.Draws(*(d.to(device) for d in draws))
        chains, lps = mcmc_ops.ensemble_sample_draws(
            mcmc_ops.delta_logprob, torch.as_tensor(p0, device=device), fed, data=data,
            graph_steps=mcmc_ops.GRAPH_STEPS if device.type == "cuda" else 0)
        chains, lps = chains.movedim(0, 1), lps.movedim(0, 1)
    chains, lps = chains.cpu().numpy(), lps.cpu().numpy()
    out = []
    for i, w in enumerate(windows):
        flat, _, summaries = mcmc_ops.summarize_chain(chains[i], lps[i], FIT_KEYS, burn=max(0, burn))
        if debug_with_plots:
            corner_plot(flat, FIT_KEYS, f"corner_interval_{w['seed']}")
        out.append(summaries)
    return out


def find_windows(toa_table: dict, tm, glitch_epochs, interval_days: float, jump_days: float, t_start: float,
                 t_end: float, min_interval: float, device) -> list[dict]:
    """Slide the window over the ToAs and build each admitted window's local
    model, centered phases and box priors (host logic)."""
    toa = np.asarray(toa_table["pulse_ToA"], dtype=float)
    current_start = t_start
    windows: list[dict] = []
    eps = 1e-5
    while current_start is not None and current_start < t_end:
        valid = toa[toa >= current_start]
        current_start = float(valid.min()) if valid.size else None
        if current_start is None:
            break
        current_end = min(current_start + interval_days, t_end)
        rows = (toa >= current_start) & (toa <= current_end)
        if not rows.any():
            current_start += jump_days
            continue
        current_end = float(toa[rows].max())

        crossing_glitch = next((g for g in glitch_epochs if current_start < g < current_end), None)
        if crossing_glitch is not None:
            rows &= toa <= crossing_glitch
            if not rows.any():
                current_start = crossing_glitch + eps
                continue
            current_end = float(toa[rows].max())

        mid = current_start + (current_end - current_start) / 2
        span_days = current_end - current_start
        if rows.sum() >= 4 and span_days > min_interval:
            anchor = integer_rotation_host(tm, np.atleast_1d(mid))
            mid_anchor = float(anchor["Tmjd_intRotation"][0])
            f0_mid = float(anchor["freq_intRotation"][0])
            f1_mid = float(anchor["freqdot_intRotation"][0])

            # minimal local model: PEPOCH at the anchor; F0, F1 free
            keys13 = ["PEPOCH"] + [f"F{i}" for i in range(13)]
            values = [mid_anchor, f0_mid, f1_mid] + [0.0] * 11
            flags = [0, 1, 1] + [0] * 11
            local_par = {k: {"value": np.float64(v), "flag": f} for k, v, f in zip(keys13, values, flags)}
            local_par["TRACK"] = -2

            span_sec = span_days * 86400.0
            toas_to_fit = load_toas_for_fit(tim_io.select_rows(toa_table, rows), local_par, device=device)
            windows.append({
                "seed": len(windows),
                "mid_anchor": mid_anchor,
                "span_days": span_days,
                "local_par": local_par,
                "toas_to_fit": toas_to_fit,
                "dt_sec": (toas_to_fit["ToA"] - mid_anchor) * 86400.0,
                "phase": toas_to_fit["phase"],  # mean-subtracted by load_toas_for_fit
                "phase_err": toas_to_fit["phase_err_cycle"],
                "lo": np.array([-100 / span_sec, -100 / span_sec**2]),
                "hi": np.array([100 / span_sec, 100 / span_sec**2]),
            })

        if crossing_glitch is not None:
            current_start = crossing_glitch + eps
        else:
            current_start += jump_days
    return windows


def write_table(table: dict, path: str, clobber: bool = False) -> str:
    """Write the table as pandas' ``to_csv(sep="\\t", index=True)`` does: a
    header of an empty index name and the column names, then one line per
    row led by its integer index, floats as their shortest repr."""
    columns = list(table)
    n = len(table[columns[0]]) if columns else 0
    lines = ["\t".join([""] + columns)]
    for i in range(n):
        lines.append("\t".join([str(i)] + [repr(np.asarray(table[c])[i].item()) for c in columns]))
    with open(path, "w" if clobber else "x") as fh:
        fh.write("\n".join(lines) + "\n")
    return path


def generate_local_ephemerides(
    tim_file: str,
    parfile: str,
    interval_days: float = 90.0,
    jump_days: float = 15.0,
    t_start: float | None = None,
    t_end: float | None = None,
    min_interval: float = 45.0,
    debug_with_plots: bool = False,
    outputfile: str | None = "local_ephemerides",
    ephem_plot: str | None = None,
    clobber: bool = False,
    mcmc_steps: int = 1000,
    mcmc_burn: int = 100,
    mcmc_walkers: int = 24,
    device=None,
    draws: mcmc_ops.Draws | None = None,
) -> dict:
    """Sliding-window local F0/F1; returns the detrended table as numpy
    columns (``COLUMNS``; an empty dict when no window qualifies).

    ``device`` (default cuda) runs the ToA folds and the batched sampler.
    ``draws`` feeds the sampler's random numbers, (steps, windows, walkers)
    each, in place of the seeded generator.
    """
    logger.info(
        "\n Running generate_local_ephemerides: tim_file=%s parfile=%s interval_days=%s "
        "jump_days=%s t_start=%s t_end=%s min_interval=%s outputfile=%s",
        tim_file, parfile, interval_days, jump_days, t_start, t_end, min_interval, outputfile,
    )
    dev = resolve_device(device)
    par_values, _, _ = parfile_io.read_timing_model(parfile)
    pepoch_global = par_values["PEPOCH"]
    f0_global = par_values["F0"]
    f1_global = par_values["F1"]
    glitch_epochs = sorted(v for k, v in par_values.items() if k.startswith("GLEP_"))

    toa_table = tim_io.read_tim(tim_file)
    toa = np.asarray(toa_table["pulse_ToA"], dtype=float)
    if t_start is None:
        t_start = float(toa.min())
    if t_end is None:
        t_end = float(toa.max())

    windows = find_windows(toa_table, timing.resolve(parfile), glitch_epochs, interval_days, jump_days, t_start,
                           t_end, min_interval, dev)
    all_summaries = (_fit_windows_batched(windows, mcmc_steps, mcmc_burn, mcmc_walkers, debug_with_plots, dev,
                                          draws) if windows else [])
    records = []
    for w, summaries in zip(windows, all_summaries):
        med_vec = np.array([summaries[k]["median"] for k in FIT_KEYS])
        _, full_dict = fit_utils.inject_free_params(w["local_par"], med_vec, FIT_KEYS)
        toas = w["toas_to_fit"]
        post_fit = fit_utils.model_phase_residuals(toas["ToA"], w["local_par"], med_vec, FIT_KEYS)
        if debug_with_plots:
            plot_residuals(toas, post_fit, plotname=f"residuals_interval_{w['seed']}")
        stats = fit_utils.chi2_fit(toas["phase"], post_fit, toas["phase_err_cycle"], 2)
        records.append([w["mid_anchor"], w["span_days"] / 2.0, full_dict["F0"],
                        max(summaries["F0"]["plus"], summaries["F0"]["minus"]), full_dict["F1"],
                        max(summaries["F1"]["plus"], summaries["F1"]["minus"]), stats["redchi2"], stats["dof"]])

    if not records:
        logger.warning("No interval made the criteria - decrease min_interval and/or increase "
                       "interval_days; returning an empty table")
        return {}

    table = {name: np.asarray([r[j] for r in records]) for j, name in enumerate(COLUMNS)}
    # detrend F0 by the global linear trend (get_local_ephem.py:247-249)
    table["F0"] = table["F0"] - (f0_global + f1_global * ((table["TOA_MJD_ref"] - pepoch_global) * 86400.0))

    if outputfile is not None:
        write_table(table, f"{outputfile}.txt", clobber=clobber)
    if ephem_plot is not None:
        from crimp_tpu_torch.pipelines.plot_local_ephem import plot_local_ephemerides

        plot_local_ephemerides(table, glitch_epochs, ephem_plot)
    return table
