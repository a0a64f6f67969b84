"""Console entry points of the port: all 12 tools of ``crimp_tpu.cli``, with
its flags, plus ``--device`` (default: cuda, which raises when no card is
present) on every tool but the three in ``HOST_TOOLS``:

    python -m crimp_tpu_torch.cli TOOL [arguments]

TOOL is one of timeintervalsfortoas, templatepulseprofile, measuretoas,
diagnosetoas, addphasecolumn, ephemintegerrotation, phshifttotimfile,
fittoas, localephemerides, pulseprofile_plots, localephemerides_plot,
mergeoverlappingtims. Each tool returns what its pipeline returns.
timeintervalsfortoas, ephemintegerrotation and phshifttotimfile do all their
work on the host (as in the JAX package); they still resolve ``--device``,
so those tools refuse to start on a machine without a card unless asked for
the CPU. diagnosetoas, localephemerides_plot and mergeoverlappingtims only
read and write files, and take no ``--device``.
"""

from __future__ import annotations

import argparse
import sys

from crimp_tpu_torch.utils.device import resolve_device
from crimp_tpu_torch.utils.logging import configure_logging, get_logger, verbosity_to_level


def _bool_flag(parser, *names, help="", default=False):
    parser.add_argument(*names, help=help, default=default, action=argparse.BooleanOptionalAction)


def _add_common(parser, verbosity: bool = True):
    parser.add_argument("--device", help="torch device (default: cuda)", type=str, default=None)
    if verbosity:
        parser.add_argument(
            "-v", "--verbose", action="count", default=0,
            help="WARNING if absent, -v: INFO, -vv: DEBUG",
        )


def _setup_logging(args, logfile_stem: str):
    configure_logging(
        console_level=verbosity_to_level(args.verbose),
        file_path=f"{logfile_stem}.log",
        file_level="INFO",
        force=True,
    )
    get_logger(__name__).info("\nCLI starting")


def timeintervalsfortoas(argv=None):
    parser = argparse.ArgumentParser(
        description="Creating time intervals for individual ToAs - saving info to .txt file"
    )
    parser.add_argument("evtFile", help="Fits event file", type=str)
    parser.add_argument("-tc", "--totCtsEachToA", help="Desired number of counts per ToA", type=int, default=1000)
    parser.add_argument("-wt", "--waitTimeCutoff", help="Do not allow any gap in GTI larger than this (days)", type=float, default=1)
    parser.add_argument("-el", "--eneLow", help="Low energy filter (keV), default=0.5", type=float, default=0.5)
    parser.add_argument("-eh", "--eneHigh", help="High energy filter (keV), default=10", type=float, default=10)
    parser.add_argument("-mc", "--min_counts", help="Merge intervals with fewer counts, default=totCtsEachToA/2", type=int, default=None)
    parser.add_argument("-mw", "--max_wait", help="Merge intervals closer than this (days), default=waitTimeCutoff", type=float, default=None)
    parser.add_argument("-of", "--outputFile", help="Output .txt/.log stem (default=timIntToAs)", type=str, default="timIntToAs")
    _bool_flag(parser, "-ce", "--correxposure", help="Correct exposure/rate for selected FPMs (NICER)")
    _add_common(parser)
    args = parser.parse_args(argv)
    resolve_device(args.device)
    _setup_logging(args, args.outputFile)

    from crimp_tpu_torch.pipelines.intervals import build_time_intervals

    return build_time_intervals(
        args.evtFile, args.totCtsEachToA, args.waitTimeCutoff, args.eneLow, args.eneHigh,
        args.min_counts, args.max_wait, args.outputFile, args.correxposure,
    )


def templatepulseprofile(argv=None):
    parser = argparse.ArgumentParser(description="Build and fit pulse profile from event file")
    parser.add_argument("evtFile", help="Event file", type=str)
    parser.add_argument("timMod", help="Timing model (.par file)", type=str)
    parser.add_argument("-el", "--eneLow", help="lower energy cut, default=0.5 keV", type=float, default=0.5)
    parser.add_argument("-eh", "--eneHigh", help="high energy cut, default=10 keV", type=float, default=10)
    parser.add_argument("-nb", "--nbrBins", help="Number of profile bins, default=15", type=int, default=15)
    parser.add_argument("-pm", "--ppmodel", help="fourier | vonmises | cauchy", type=str, default="fourier")
    parser.add_argument("-nc", "--nbrComp", help="Number of components, default=2", type=int, default=2)
    parser.add_argument("-it", "--initTemplateMod", help="Initial template (overrides ppmodel/nbrComp)", type=str, default=None)
    _bool_flag(parser, "-fp", "--fixPhases", help="Fix phases from initial template")
    parser.add_argument("-fg", "--figure", help="Pulse-profile plot stem ('figure'.pdf)", type=str, default=None)
    parser.add_argument("-tf", "--templateFile", help="Output template .txt stem", type=str, default=None)
    _add_common(parser)
    args = parser.parse_args(argv)
    _setup_logging(args, args.templateFile if args.templateFile else "logfile_buildtemplate")

    from crimp_tpu_torch.pipelines.pulseprofile import PulseProfileFromEventFile

    return PulseProfileFromEventFile(
        args.evtFile, args.timMod, args.eneLow, args.eneHigh, args.nbrBins, device=args.device
    ).fitpulseprofile(
        args.ppmodel, args.nbrComp, args.initTemplateMod, args.fixPhases, args.figure, args.templateFile
    )


def measuretoas(argv=None):
    parser = argparse.ArgumentParser(description="Script to measure ToAs from event file")
    parser.add_argument("evtFile", help="Name of a barycentered event file", type=str)
    parser.add_argument("timMod", help="Timing model, Tempo2 .par file should work", type=str)
    parser.add_argument("tempModPP", help="Template pulse-profile parameters", type=str)
    parser.add_argument("toagtifile", help="ToA interval .txt (from timeintervalsfortoas)", type=str)
    parser.add_argument("-el", "--enelow", help="Low energy filter, default=0.5", type=float, default=0.5)
    parser.add_argument("-eh", "--enehigh", help="High energy filter, default=10", type=float, default=10)
    parser.add_argument("-ts", "--toaStart", help="First ToA index", type=int, default=0)
    parser.add_argument("-te", "--toaEnd", help="Last ToA index (inclusive)", type=int, default=None)
    parser.add_argument("-pr", "--phShiftRes", help="Error-scan resolution 2*pi/res, default=1000", type=int, default=1000)
    parser.add_argument("-nb", "--nbrBins", help="Profile bins for chi2, default=15", type=int, default=15)
    _bool_flag(parser, "-va", "--varyAmps", help="Vary pulsed fraction (not shape)")
    _bool_flag(parser, "-rv", "--readvaryparam", help="Read per-parameter vary flags from template")
    _bool_flag(parser, "-bm", "--brutemin", help="Global BRUTE minimization first")
    _bool_flag(parser, "-pp", "--plotPPs", help="Create per-ToA pulse profile plots")
    _bool_flag(parser, "-ll", "--plotLLs", help="Create per-ToA log-likelihood plots")
    _bool_flag(parser, "-rp", "--plotResiduals", help="Write the phase-residual plot (matplotlib)", default=True)
    parser.add_argument("-tf", "--toaFile", help="Output ToA file stem (default=ToAs)", type=str, default="ToAs")
    parser.add_argument("-mf", "--timFile", help="Output .tim stem (default=None)", type=str, default=None)
    _add_common(parser)
    args = parser.parse_args(argv)
    _setup_logging(args, args.toaFile)

    from crimp_tpu_torch.pipelines.measure_toas import measure_toas

    return measure_toas(
        args.evtFile, args.timMod, args.tempModPP, args.toagtifile, args.enelow, args.enehigh,
        args.toaStart, args.toaEnd, args.phShiftRes, args.nbrBins, args.varyAmps,
        args.readvaryparam, args.brutemin, args.plotPPs, args.plotLLs, args.toaFile, args.timFile,
        plotResiduals=args.plotResiduals, device=args.device,
    )


def addphasecolumn(argv=None):
    parser = argparse.ArgumentParser(description="Create and append event file with Phase column")
    parser.add_argument("evtFile", help="Name of (X-ray) fits event file", type=str)
    parser.add_argument("timMod", help="Timing model for phase folding (.par)", type=str)
    parser.add_argument("-ne", "--nonBaryEvtFile", help="Non-barycentered sibling file", type=str, default=None)
    _add_common(parser, verbosity=False)
    args = parser.parse_args(argv)

    from crimp_tpu_torch.io.events import EventFile

    return EventFile(args.evtFile).add_phase_column(args.timMod, args.nonBaryEvtFile, device=args.device)


def ephemintegerrotation(argv=None):
    parser = argparse.ArgumentParser(
        description="Earliest MJD (with frequency and phase) giving an integer number of rotations"
    )
    parser.add_argument("tMJD", help="Time in MJD", type=float)
    parser.add_argument("timMod", help="Timing model (.par)", type=str)
    _bool_flag(parser, "-po", "--printOutput", help="Print output")
    _add_common(parser, verbosity=False)
    args = parser.parse_args(argv)
    resolve_device(args.device)

    from crimp_tpu_torch.ops.ephem import ephem_integer_rotation

    return ephem_integer_rotation(args.tMJD, args.timMod, args.printOutput)


def phshifttotimfile(argv=None):
    parser = argparse.ArgumentParser(description="Convert a phase-shift text file into a .tim file")
    parser.add_argument("ToAs", help="Phase-shift .txt from measuretoas", type=str)
    parser.add_argument("timMod", help=".par timing model", type=str)
    parser.add_argument("-tf", "--timfile", help="Output .tim stem (default=residuals)", type=str, default="residuals")
    parser.add_argument("-tp", "--tempModPP", help="Template name recorded per ToA", type=str, default="ppTemplateMod")
    parser.add_argument("-in", "--inst", help="Instrument flag keyword (default=Xray)", type=str, default="Xray")
    _bool_flag(parser, "-ap", "--addpn", help="Add pulse numbering")
    _bool_flag(parser, "-cl", "--clobber", help="Override .tim file")
    _add_common(parser, verbosity=False)
    args = parser.parse_args(argv)
    resolve_device(args.device)

    from crimp_tpu_torch.pipelines.tim_tools import phshift_to_timfile

    return phshift_to_timfile(args.ToAs, args.timMod, args.timfile, args.tempModPP, args.inst,
                              args.addpn, args.clobber)


def fittoas(argv=None):
    parser = argparse.ArgumentParser(description="Script to fit ToAs to a timing model")
    parser.add_argument("timfile_path", help="path to .tim file", type=str)
    parser.add_argument("parfile", help="Initial timing .par file with fit flags", type=str)
    parser.add_argument("newparfile", help="New post-fit .par file", type=str)
    parser.add_argument("-ts", "--t_start", type=float, default=None, help="Start time for fit (MJD)")
    parser.add_argument("-te", "--t_end", type=float, default=None, help="End time for fit (MJD)")
    parser.add_argument("-tm", "--t_mjd", type=float, nargs="+", default=None, help="Phase-wrap MJDs (cumulative)")
    parser.add_argument("-md", "--mode", choices=["add", "subtract"], default="add", help="Wrap direction")
    parser.add_argument("-iy", "--init_yaml", type=str, help="YAML of initial guesses and/or bounds")
    _bool_flag(parser, "-mc", "--mcmc", help="Sample posteriors with the ensemble MCMC")
    parser.add_argument("-st", "--mcmc-steps", type=int, default=10000, help="MCMC steps (default=10000)")
    parser.add_argument("-bu", "--mcmc-burn", type=int, default=500, help="Burn-in discarded (default=500)")
    parser.add_argument("-wa", "--mcmc-walkers", type=int, default=32, help="Walkers (default=32)")
    parser.add_argument("-cp", "--corner_plot", type=str, default=None, help="Corner plot PDF stem")
    parser.add_argument("-ch", "--chain-npy", type=str, default=None, help="Save full chain .npy")
    parser.add_argument("-fl", "--flat-npy", type=str, default=None, help="Save flat chain .npy")
    parser.add_argument("-bf", "--best_fit", choices=["median", "map"], type=str, default="map")
    parser.add_argument("-rp", "--residual_plot", help="Pre/post-fit residual plot stem", type=str, default=None)
    _add_common(parser, verbosity=False)
    args = parser.parse_args(argv)

    from crimp_tpu_torch.pipelines.fit_toas import fit_toas

    return fit_toas(
        args.timfile_path, args.parfile, args.newparfile,
        t_start=args.t_start, t_end=args.t_end, t_mjd=args.t_mjd, mode=args.mode,
        init_yaml=args.init_yaml, mcmc=args.mcmc, mcmc_steps=args.mcmc_steps,
        mcmc_burn=args.mcmc_burn, mcmc_walkers=args.mcmc_walkers,
        corner_plot_path=args.corner_plot, chain_npy=args.chain_npy, flat_npy=args.flat_npy,
        best_fit=args.best_fit, residual_plot=args.residual_plot, device=args.device,
    )


def diagnosetoas(argv=None):
    parser = argparse.ArgumentParser(description="Script to create a diagnostic plot of ToAs")
    parser.add_argument("ToAs", help="Text file of phase shifts (from measuretoas)", type=str)
    parser.add_argument("-of", "--outputFile", help="Output HTML stem (default=ToADiagnosticsPlot)", type=str, default="ToADiagnosticsPlot")
    args = parser.parse_args(argv)

    from crimp_tpu_torch.pipelines.diagnose import diagnose_toas

    return diagnose_toas(args.ToAs, args.outputFile)


def localephemerides(argv=None):
    parser = argparse.ArgumentParser(description="Generate local [F0, F1] ephemerides in a moving-average fashion")
    parser.add_argument("timfile", help=".tim TOA file", type=str)
    parser.add_argument("parfile", help="A tempo2 .par file", type=str)
    parser.add_argument("-id", "--interval_days", help="Window length (days)", type=float, default=90.0)
    parser.add_argument("-jd", "--jump_days", help="Window shift (days)", type=float, default=15.0)
    parser.add_argument("-ts", "--t_start", help="Start from (MJD)", type=float, default=None)
    parser.add_argument("-te", "--t_end", help="Stop at (MJD)", type=float, default=None)
    parser.add_argument("-mi", "--min_interval", help="Minimum ToA span per window (days)", type=float, default=45)
    _bool_flag(parser, "-dp", "--debug_with_plots", help="Per-window residual + corner plots")
    parser.add_argument("-of", "--outputfile", help="Output table stem (default=local_ephemerides)", type=str, default="local_ephemerides")
    parser.add_argument("-ep", "--ephem_plot", help="Ephemerides plot stem (default=None)", type=str, default=None)
    _bool_flag(parser, "-cl", "--clobber", help="Override output table")
    _add_common(parser)
    args = parser.parse_args(argv)
    resolve_device(args.device)
    _setup_logging(args, args.outputfile if args.outputfile else "local_ephemerides")

    from crimp_tpu_torch.pipelines.local_ephem import generate_local_ephemerides

    return generate_local_ephemerides(
        args.timfile, args.parfile, args.interval_days, args.jump_days,
        args.t_start, args.t_end, args.min_interval, args.debug_with_plots,
        args.outputfile, args.ephem_plot, args.clobber, device=args.device,
    )


def pulseprofile_plots(argv=None):
    parser = argparse.ArgumentParser(description="YAML-driven pulse-profile visualization suite")
    parser.add_argument("eventfile", help="Event file", type=str)
    parser.add_argument("parfile", help="A tempo2 .par file", type=str)
    parser.add_argument("yamlconfig", help="YAML listing plots to generate", type=str)
    parser.add_argument("-el", "--enelow", help="Low energy filter, default=0.3", type=float, default=0.3)
    parser.add_argument("-eh", "--enehigh", help="High energy filter, default=10", type=float, default=10)
    parser.add_argument("-ts", "--tstart", help="Events from tstart (MJD)", type=float, default=40000)
    parser.add_argument("-te", "--tend", help="Events before tend (MJD)", type=float, default=70000)
    parser.add_argument("-op", "--outputplot", help="Output plot stem", type=str, default=None)
    _add_common(parser, verbosity=False)
    args = parser.parse_args(argv)
    resolve_device(args.device)

    from crimp_tpu_torch.pipelines.plots import prep_for_plotting, run_plots_from_yaml

    df, _ = prep_for_plotting(args.eventfile, args.parfile, args.enelow, args.enehigh, args.tstart, args.tend,
                              device=args.device)
    return run_plots_from_yaml(args.yamlconfig, df)


def localephemerides_plot(argv=None):
    parser = argparse.ArgumentParser(description="Plot local ephemerides")
    parser.add_argument("localephem", help=".txt local-ephemerides table", type=str)
    parser.add_argument("-ts", "--t_start", help="Start from (MJD)", type=float, default=None)
    parser.add_argument("-te", "--t_end", help="Stop at (MJD)", type=float, default=None)
    parser.add_argument("-gl", "--glitches", help="Glitch MJD markers", type=float, nargs="+", default=None)
    parser.add_argument("-ep", "--ephem_plot", help="Output plot stem (default=None)", type=str, default=None)
    args = parser.parse_args(argv)

    from crimp_tpu_torch.pipelines.plot_local_ephem import plot_local_ephemerides, read_local_ephemerides

    table = read_local_ephemerides(args.localephem, args.t_start, args.t_end)
    return plot_local_ephemerides(table, glitches=args.glitches, plotname=args.ephem_plot)


def mergeoverlappingtims(argv=None):
    parser = argparse.ArgumentParser(
        description="Merge .tim files with pulse numbers (-pn) using overlapping TOAs as anchors."
    )
    parser.add_argument("timfiles", nargs="+", help=".tim files, or .txt list files of .tim names", type=str)
    parser.add_argument("-ot", "--outputtim", help="Output prefix <outputtim>.tim (default=all_merged)", type=str, default="all_merged")
    _bool_flag(parser, "-cl", "--clobber", help="Override output .tim file")
    args = parser.parse_args(argv)

    from crimp_tpu_torch.pipelines.merge_tim import merge_tim_files, write_merged_tim

    merged = merge_tim_files(args.timfiles)
    write_merged_tim(merged, args.outputtim, clobber=args.clobber)
    return merged


_COMMANDS = {
    f.__name__: f
    for f in (timeintervalsfortoas, templatepulseprofile, measuretoas, diagnosetoas, addphasecolumn,
              ephemintegerrotation, phshifttotimfile, fittoas, localephemerides, pulseprofile_plots,
              localephemerides_plot, mergeoverlappingtims)
}
# the tools that read and write files only, with no --device
HOST_TOOLS = ("diagnosetoas", "localephemerides_plot", "mergeoverlappingtims")


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in _COMMANDS:
        raise SystemExit(f"usage: python -m crimp_tpu_torch.cli {{{','.join(_COMMANDS)}}} ...")
    _COMMANDS[argv[0]](argv[1:])


if __name__ == "__main__":
    main()
