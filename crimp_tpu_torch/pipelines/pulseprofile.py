"""Template pulse-profile construction pipeline (CLI: templatepulseprofile).

Port of ``crimp_tpu/pipelines/pulseprofile.py`` (workflow of CRIMP's
pulseprofile.py:57-247): fold events -> binned profile -> binned-ML
template fit (Fourier / von Mises / Cauchy), optional warm start from an
initial template with per-parameter vary flags and fixPhases, chi2
reporting, RMS pulsed flux/fraction with Monte-Carlo uncertainties, PDF
plot, and the template .txt artifact.

The fold runs through the anchored f64 fold and the NLL with its gradient
on the run's device; the L-BFGS-B loop and the Monte-Carlo error draws
stay on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from crimp_tpu_torch.io import template as template_io
from crimp_tpu_torch.io.events import EventFile
from crimp_tpu_torch.models import profiles
from crimp_tpu_torch.ops.anchored import fold_chunked
from crimp_tpu_torch.ops.binprofile import bin_phases
from crimp_tpu_torch.ops.templatefit import fit_binned_template
from crimp_tpu_torch.utils.device import resolve_device
from crimp_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


class PulseProfileFromEventFile:
    """Build and model a pulse profile starting from an event file, with the
    fold and the fit's objective on ``device`` (default cuda)."""

    def __init__(self, evtFile: str, timMod: str, eneLow: float = 0.5, eneHigh: float = 10.0,
                 nbrBins: int = 30, device=None):
        self.evtFile = evtFile
        self.timMod = timMod
        self.eneLow = eneLow
        self.eneHigh = eneHigh
        self.nbrBins = nbrBins
        self.device = resolve_device(device)

    def createpulseprofile(self) -> dict:
        """Fold the event file and bin it into a count-rate profile."""
        ef = EventFile(self.evtFile)
        _, gti = ef.read_gti()
        livetime = np.sum(gti[:, 1] - gti[:, 0]) * 86400.0
        times = ef.build_time_energy_df().filtenergy(self.eneLow, self.eneHigh).time_energy_df["TIME"]
        folded = fold_chunked(times, self.timMod, device=self.device)
        binned = bin_phases(folded, self.nbrBins)
        per_bin_exp = livetime / self.nbrBins
        return {
            "ppBins": binned["ppBins"],
            "ppBinsRange": binned["ppBinsRange"],
            "countRate": binned["ctsBins"] / per_bin_exp,
            "countRateErr": binned["ctsBinsErr"] / per_bin_exp,
        }

    def fitpulseprofile(
        self,
        ppmodel: str = "fourier",
        nbrComp: int = 2,
        initTemplateMod: str | None = None,
        fixPhases: bool = False,
        figure: str | None = None,
        templateFile: str | None = None,
        calcPulsedFraction: bool = False,
    ):
        """Fit the binned profile to a template model.

        Returns (fitResultsDict, bestFitModel, pulsedProperties)."""
        logger.info(
            "\n Running fitpulseprofile: evtFile=%s timMod=%s eneLow=%s eneHigh=%s "
            "nbrBins=%s ppmodel=%s nbrComp=%s initTemplateMod=%s fixPhases=%s "
            "figure=%s templateFile=%s calcPulsedFraction=%s device=%s",
            self.evtFile, self.timMod, self.eneLow, self.eneHigh, self.nbrBins,
            ppmodel, nbrComp, initTemplateMod, fixPhases, figure, templateFile,
            calcPulsedFraction, self.device,
        )
        pulse_profile = self.createpulseprofile()
        rate = pulse_profile["countRate"]
        err = pulse_profile["countRateErr"]

        if initTemplateMod is not None:
            tpl_dict = template_io.read_template(initTemplateMod)
            kind = tpl_dict["model"]
            nbrComp = tpl_dict["nbrComp"]
            _, init = profiles.from_template(tpl_dict)
            vary = [tpl_dict["norm"]["vary"]]
            vary += [tpl_dict[f"amp_{k}"]["vary"] for k in range(1, nbrComp + 1)]
            if kind == profiles.FOURIER:
                loc_vary = [
                    (False if fixPhases else tpl_dict[f"ph_{k}"]["vary"])
                    for k in range(1, nbrComp + 1)
                ]
                wid_vary = [False] * nbrComp
            else:
                loc_vary = [
                    (False if fixPhases else tpl_dict[f"cen_{k}"]["vary"])
                    for k in range(1, nbrComp + 1)
                ]
                wid_vary = [tpl_dict[f"wid_{k}"]["vary"] for k in range(1, nbrComp + 1)]
            vary = np.array(vary + loc_vary + wid_vary, dtype=bool)
        else:
            kind = ppmodel.casefold()
            if kind not in profiles.KINDS:
                raise ValueError(
                    f"model {ppmodel!r} is not supported; fourier, vonmises, cauchy are supported"
                )
            f64 = lambda v: torch.tensor(v, dtype=torch.float64)
            full = lambda v: torch.full((nbrComp,), v, dtype=torch.float64)
            if kind == profiles.FOURIER:
                init = profiles.ProfileParams(
                    norm=f64(float(np.mean(rate))),
                    amp=full(0.1 * float(np.mean(rate))),
                    loc=full(0.0),
                    wid=full(0.0),
                    ph_shift=f64(0.0),
                    amp_shift=f64(1.0),
                )
            else:
                init = profiles.ProfileParams(
                    norm=f64(float(np.min(rate))),
                    amp=full(1.3 * float(np.min(rate))),
                    loc=full(np.pi),
                    wid=full(1.0),
                    ph_shift=f64(0.0),
                    amp_shift=f64(1.0),
                )
            vary = None

        bins = pulse_profile["ppBins"].copy()
        if kind in (profiles.CAUCHY, profiles.VONMISES):
            bins = bins * 2 * np.pi  # radians convention for these families
            pulse_profile["ppBins"] = bins

        best, model, stats = fit_binned_template(kind, init, bins, rate, err, vary, device=self.device)
        fit_results = profiles.to_theta(kind, best)
        fit_results.pop("phShift", None)
        fit_results.pop("ampShift", None)
        fit_results.update(stats)
        fit_results["model"] = kind
        print(
            "Template {} best fit statistics\n chi2 = {} for dof = {}\n Reduced chi2 = {}".format(
                kind, stats["chi2"], stats["dof"], stats["redchi2"]
            )
        )

        if templateFile is not None:
            template_io.write_template(templateFile, fit_results)
            logger.info("\n Created best fit template file : %s.txt", templateFile)

        if calcPulsedFraction and kind == profiles.FOURIER:
            pulsed = calc_pulse_properties(pulse_profile, nbrComp)
            pulsed.update(calc_pulse_properties_uncertainty(pulse_profile, nbrComp))
        else:
            if calcPulsedFraction:
                logger.warning(
                    "Cannot calculate rms pulsed fraction for %s; returning None", kind
                )
            pulsed = None

        if figure is not None:
            plot_pulse_profile(pulse_profile, outFile=figure, fittedModel=model)

        return fit_results, model, pulsed


def calc_pulse_properties(pulse_profile: dict, nbrComp: int) -> dict:
    """RMS pulsed flux / fraction and per-harmonic pulsed fluxes.

    Value parity with CRIMP (pulseprofile.py:594-626), including its quirk
    of subtracting the *squares* of the Fourier-coefficient variances.
    """
    bins = pulse_profile["ppBins"]
    rate = pulse_profile["countRate"]
    err = pulse_profile["countRateErr"]
    N = len(bins)
    k = np.arange(1, nbrComp + 1)[:, None]
    cos_k = np.cos(k * 2 * np.pi * bins[None, :])
    sin_k = np.sin(k * 2 * np.pi * bins[None, :])
    ak = (rate[None, :] * cos_k).sum(axis=1) / N
    bk = (rate[None, :] * sin_k).sum(axis=1) / N
    sak = (err[None, :] ** 2 * cos_k**2).sum(axis=1) / N**2
    sbk = (err[None, :] ** 2 * sin_k**2).sum(axis=1) / N**2
    per_harm = (ak**2 + bk**2) - (sak**2 + sbk**2)
    frms = np.sqrt(per_harm.sum() * 2)
    return {
        "pulsedFlux": frms,
        "pulsedFraction": frms / np.mean(rate),
        "harmonicPulsedFractions": per_harm,
    }


def calc_pulse_properties_uncertainty(
    pulse_profile: dict, nbrComp: int, n_simulations: int = 1000, rng=None
) -> dict:
    """Monte-Carlo uncertainties on the pulsed properties: CRIMP's
    1000-iteration loop (pulseprofile.py:629-664) from one vectorized draw."""
    if rng is None:
        rng = np.random.RandomState()
    rate = pulse_profile["countRate"]
    err = pulse_profile["countRateErr"]
    draws = rng.normal(rate[None, :], err[None, :], size=(n_simulations, len(rate)))
    fluxes = np.empty(n_simulations)
    fractions = np.empty(n_simulations)
    harmonics = np.empty((n_simulations, nbrComp))
    sim_profile = dict(pulse_profile)
    for i in range(n_simulations):  # cheap: nbins-sized numpy ops
        sim_profile["countRate"] = draws[i]
        props = calc_pulse_properties(sim_profile, nbrComp)
        fluxes[i] = props["pulsedFlux"]
        fractions[i] = props["pulsedFraction"]
        harmonics[i] = props["harmonicPulsedFractions"]
    return {
        "pulsedFluxErr": float(np.std(fluxes)),
        "pulsedFractionErr": float(np.std(fractions)),
        "harmonicPulsedFractionsErr": np.std(harmonics, axis=0),
    }


def plot_pulse_profile(pulse_profile: dict, outFile: str = "pulseprof", fittedModel=None) -> str:
    """Two-cycle pulse-profile plot with optional best-fit overlay."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    bins = pulse_profile["ppBins"]
    rate = pulse_profile["countRate"]
    err = pulse_profile["countRateErr"]
    cycle = 2 * np.pi if np.max(bins) > 1 else 1.0
    bins2 = np.concatenate([bins, bins + cycle])
    rate2 = np.concatenate([rate, rate])
    err2 = np.concatenate([err, err])

    fig, ax = plt.subplots(1, figsize=(6, 4))
    ax.step(bins2, rate2, "k+-", where="mid")
    ax.errorbar(bins2, rate2, yerr=err2, fmt="ok")
    if fittedModel is not None:
        ax.plot(bins2, np.concatenate([fittedModel, fittedModel]), "r-", lw=2)
    ax.set_xlabel("Phase (cycles)")
    ax.set_ylabel("Rate (counts/s)")
    fig.tight_layout()
    path = outFile + ".pdf"
    fig.savefig(path, format="pdf")
    plt.close(fig)
    return path
