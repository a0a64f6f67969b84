"""Pulse ToA measurement pipeline (CLI: measuretoas) -- the main product.

Port of ``crimp_tpu/pipelines/measure_toas.py`` (workflow of CRIMP's
measureToAs.py:64-251): select the events of every ToA interval, fold
each interval at its own anchor, fit the template by unbinned extended
maximum likelihood with phase shift and normalization free, derive
+/-1-sigma likelihood-profile bounds by 2*pi/phShiftRes stepping, compute
the per-ToA H-test at the local ephemeris frequency and the binned-profile
chi2, then write ToAs.txt, the optional .tim file and the phase-residual
plot. Tables are dicts of numpy columns; matplotlib is imported only when
a plot is asked for.
"""

from __future__ import annotations

import numpy as np

from crimp_tpu_torch.io import template as template_io
from crimp_tpu_torch.io.events import EventFile
from crimp_tpu_torch.io.table import read_columns
from crimp_tpu_torch.models import profiles, timing
from crimp_tpu_torch.ops import anchored, search, toafit
from crimp_tpu_torch.ops.ephem import spin_frequency_host
from crimp_tpu_torch.utils.device import resolve_device
from crimp_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

# the ToA table's columns, in file order
TOA_COLUMNS = [
    "ToA", "ToA_mid", "ToA_start", "ToA_end", "ToA_lenInt", "ToA_exp",
    "nbr_events", "count_rate", "phShift", "phShift_LL", "phShift_UL",
    "Hpower", "redChi2",
]


def measure_toas(
    evtFile: str,
    timMod: str,
    tempModPP: str,
    toagtifile: str,
    eneLow: float = 0.5,
    eneHigh: float = 10.0,
    toaStart: int = 0,
    toaEnd: int | None = None,
    phShiftRes: int = 1000,
    nbrBins: int = 15,
    varyAmps: bool = False,
    readvaryparam: bool = False,
    brutemin: bool = False,
    plotPPs: bool = False,
    plotLLs: bool = False,
    toaFile: str = "ToAs",
    timFile: str | None = None,
    plotResiduals: bool = True,
    device=None,
) -> dict:
    """Measure ToAs for every interval; returns the ToA table (column dict).

    ``device`` (default cuda) runs the fold, the fit and the H-test.
    ``plotResiduals`` writes the phase-residual plot (matplotlib, imported
    only then).
    """
    dev = resolve_device(device)
    logger.info(
        "\n Running measure_toas: evtFile=%s timMod=%s tempModPP=%s toagtifile=%s "
        "eneLow=%s eneHigh=%s toaStart=%s toaEnd=%s phShiftRes=%s nbrBins=%s "
        "varyAmps=%s readvaryparam=%s brutemin=%s toaFile=%s timFile=%s device=%s",
        evtFile, timMod, tempModPP, toagtifile, eneLow, eneHigh, toaStart, toaEnd,
        phShiftRes, nbrBins, varyAmps, readvaryparam, brutemin, toaFile, timFile, dev,
    )
    ef = EventFile(evtFile)
    times_all = ef.build_time_energy_df().filtenergy(eneLow, eneHigh).time_energy_df["TIME"]

    intervals = read_columns(toagtifile)
    n_int = len(intervals["ToA_tstart"])
    toaEnd = n_int if toaEnd is None else toaEnd + 1  # inclusive, like the reference CLI
    idx_list = list(range(toaStart, toaEnd))

    tm = timing.resolve(timMod)
    tpl_dict = template_io.read_template(tempModPP)
    kind, tpl = profiles.from_template(tpl_dict)
    logger.info("\n Using best fit model of template %s to measure ToAs", kind)

    # ---- per-interval event selection + anchored fold --------------------
    starts = intervals["ToA_tstart"]
    ends = intervals["ToA_tend"]
    exposures = intervals["ToA_exposure"]
    times_sorted = bool(np.all(np.diff(times_all) >= 0))
    seg_times = toafit.slice_sorted_intervals(
        times_all, starts[idx_list], ends[idx_list], assume_sorted=times_sorted
    )
    for ii, t_seg in zip(idx_list, seg_times):
        if t_seg.size == 0:
            raise ValueError(f"ToA interval {ii} contains no events")

    seg_sizes = [t.size for t in seg_times]
    seg_phase_list, toa_mids = anchored.fold_segments(tm, seg_times, device=dev)
    if kind in (profiles.CAUCHY, profiles.VONMISES):
        # radians convention for these families
        seg_phase_list = [p * (2 * np.pi) for p in seg_phase_list]

    phases, masks = toafit.pad_segments(seg_phase_list)
    if readvaryparam:
        # General path: free parameters follow the template 'vary' flags;
        # ampShift joins the free set when varyAmps is also requested.
        free_idx, free_lo, free_hi, n_free = toafit.free_param_spec(kind, tpl_dict, vary_amps=varyAmps)
        cfg = toafit.ToAFitConfig(
            kind=kind, ph_shift_res=phShiftRes, nbins=nbrBins,
            free_idx=free_idx, free_lo=free_lo, free_hi=free_hi, n_free=n_free,
            # all-fixed template: only phShift floats, the norm stays put
            fix_norm=not free_idx,
        )
    else:
        # ampShift box bounds per family
        amp_lo, amp_hi = {
            profiles.FOURIER: (0.01, 100.0),
            profiles.CAUCHY: (1e-6, 1e6),
            profiles.VONMISES: (1e-6, 500.0),
        }[kind]
        cfg = toafit.ToAFitConfig(
            kind=kind, ph_shift_res=phShiftRes, nbins=nbrBins,
            vary_amps=varyAmps, amp_lo=amp_lo, amp_hi=amp_hi,
        )
    exp_batch = exposures[toaStart:toaEnd].astype(float)
    if max(seg_sizes) / max(min(seg_sizes), 1) > 4.0:
        # heterogeneous campaign: size-bucketed padding
        results = toafit.fit_toas_bucketed(kind, tpl, seg_phase_list, exp_batch, cfg, device=dev)
    else:
        results = toafit.fit_toas_batch_auto(kind, tpl, phases, masks, exp_batch, cfg, device=dev)

    # ---- per-ToA H-test at the local ephemeris frequency -----------------
    freqs_mid, _ = spin_frequency_host(tm, toa_mids)
    sec_padded = np.zeros_like(phases)
    sec_masks = np.zeros_like(masks)
    for out_i, t_seg in enumerate(seg_times):
        sec_padded[out_i, : t_seg.size] = (t_seg - (t_seg[0] + t_seg[-1]) / 2) * 86400.0
        sec_masks[out_i, : t_seg.size] = True
    h_powers = search.h_power_segments(sec_padded, sec_masks, freqs_mid, nharm=5, device=dev).cpu().numpy()

    # ---- outputs ---------------------------------------------------------
    with open(toaFile + ".txt", "w") as fh:
        fh.write(" \t ".join(TOA_COLUMNS) + "\n")
        for out_i, ii in enumerate(idx_list):
            fh.write(
                f"{ii}\t{toa_mids[out_i]}\t{starts[ii]}\t{ends[ii]}\t"
                f"{intervals['ToA_lenInt'][ii]}\t{exposures[ii]}\t"
                f"{intervals['Events'][ii]}\t{intervals['ct_rate'][ii]}\t"
                f"{results['phShift'][out_i]}\t{results['phShift_LL'][out_i]}\t"
                f"{results['phShift_UL'][out_i]}\t{h_powers[out_i]}\t"
                f"{results['redChi2'][out_i]}\n"
            )
    logger.info("\n Wrote ToA properties to %s.txt", toaFile)

    if plotLLs or plotPPs:
        _diagnostic_plots(kind, tpl, phases, masks, exp_batch, results, cfg, idx_list,
                          plotPPs=plotPPs, plotLLs=plotLLs, device=dev)

    if timFile is not None:
        from crimp_tpu_torch.pipelines.tim_tools import phshift_to_timfile

        phshift_to_timfile(toaFile + ".txt", timMod, timFile, tempModPP=tempModPP)
        logger.info("\n Wrote timfile %s.tim", timFile)

    if plotResiduals:
        plot_phase_residuals(
            toa_mids, results["phShift"], results["phShift_LL"], results["phShift_UL"],
            outFile=toaFile,
        )
        logger.info("\n Created phase residual plot %s_phaseResiduals.pdf", toaFile)

    return read_columns(toaFile + ".txt")


def _diagnostic_plots(kind, tpl, phases, masks, exposures, results, cfg, toa_ids,
                      plotPPs, plotLLs, device="cpu"):
    """Optional per-ToA debug plots (profile + likelihood curve), written to
    the working directory as pp_ToA<i>.pdf and LogL_ToA<i>.pdf."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import torch

    from crimp_tpu_torch.ops.binprofile import bin_phases

    tpl = tpl.to(device)
    f64 = dict(dtype=torch.float64, device=device)
    for out_i, toa_id in enumerate(toa_ids):
        x = phases[out_i][masks[out_i].astype(bool)]
        exposure = exposures[out_i]
        phi_best = results["phShift"][out_i]
        # per-ToA best-fit template (carries the refit shape in
        # readvaryparam mode, where amps/locs/wids may have moved)
        tpl_best = toafit._unflatten_tpl(torch.as_tensor(results["theta_best"][out_i], **f64), tpl)
        if plotLLs:
            span = 40 * (2 * np.pi / cfg.ph_shift_res)
            phis = np.linspace(phi_best - span, phi_best + span, 161)
            ll, _ = toafit.profile_loglik(
                kind, tpl, torch.as_tensor(x, **f64)[None], torch.ones((1, len(x)), dtype=torch.bool, device=device),
                torch.as_tensor([exposure], **f64), torch.as_tensor(phis, **f64)[None], cfg)
            fig, ax = plt.subplots(figsize=(7, 5))
            ax.plot(phis / (2 * np.pi), ll[0].cpu().numpy(), "k.")
            ax.set_xlabel("Phase (cycles)")
            ax.set_ylabel("Log(L)")
            fig.tight_layout()
            fig.savefig(f"LogL_ToA{toa_id}.pdf", format="pdf")
            plt.close(fig)
        if plotPPs:
            binned = bin_phases(x, cfg.nbins)
            per_bin = exposure / cfg.nbins
            rate = binned["ctsBins"] / per_bin
            err = binned["ctsBinsErr"] / per_bin
            centers = binned["ppBins"]
            c_t = torch.as_tensor(centers, **f64)
            # tpl_best already folds norm/ampShift (and any refit shape
            # parameters) into the template, so only the shape term is added
            model_best = float(tpl_best.norm) + toafit.shape_at_shifts(
                kind, tpl_best, c_t, torch.as_tensor([phi_best], **f64))[0].cpu().numpy()
            model_init = results["norm"][out_i] + toafit.shape_at_shifts(
                kind, tpl, c_t, torch.zeros(1, **f64))[0].cpu().numpy()
            cycle = 1.0 if kind == profiles.FOURIER else 2 * np.pi
            c2 = np.concatenate([centers, centers + cycle])
            fig, ax = plt.subplots(figsize=(7, 5))
            ax.errorbar(c2, np.tile(rate, 2), yerr=np.tile(err, 2), fmt="ok", zorder=10)
            ax.step(c2, np.tile(rate, 2), "k+-", where="mid", zorder=10)
            ax.plot(c2, np.tile(model_init, 2), "g-", lw=2, label="Initial template")
            ax.plot(c2, np.tile(model_best, 2), "r-", lw=2, label="After fitting for phase-shift")
            ax.legend()
            ax.set_xlabel("Phase (cycles)")
            ax.set_ylabel("Normalized rate")
            fig.tight_layout()
            fig.savefig(f"pp_ToA{toa_id}.pdf", format="pdf")
            plt.close(fig)


def plot_phase_residuals(toa_mjds, ph_shifts, ph_lls, ph_uls, outFile: str = "") -> str:
    """Phase residuals (cycles) vs MJD with asymmetric 1-sigma bars."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7, 5))
    ax.errorbar(
        toa_mjds,
        np.asarray(ph_shifts) / (2 * np.pi),
        yerr=(np.asarray(ph_lls) / (2 * np.pi), np.asarray(ph_uls) / (2 * np.pi)),
        fmt="ok",
    )
    ax.set_xlabel("Time (MJD)")
    ax.set_ylabel(r"$\Delta\phi$ (cycles)")
    fig.tight_layout()
    path = str(outFile) + "_phaseResiduals.pdf"
    fig.savefig(path, format="pdf")
    plt.close(fig)
    return path


# Reference-named alias (measureToAs.py:64), as in the JAX package.
measureToAs = measure_toas
