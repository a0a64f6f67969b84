"""Console entry points of the port: ``measuretoas`` (flags mirror
``crimp_tpu.cli.measuretoas``), plus ``--device``.

    python -m crimp_tpu_torch.cli measuretoas EVT PAR TEMPLATE INTERVALS [flags]
"""

from __future__ import annotations

import argparse
import sys

from crimp_tpu_torch.utils.logging import configure_logging, get_logger, verbosity_to_level


def _bool_flag(parser, *names, help="", default=False):
    parser.add_argument(*names, help=help, default=default, action=argparse.BooleanOptionalAction)


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
    parser.add_argument("--device", help="torch device (default: cuda)", type=str, default=None)
    parser.add_argument(
        "-v", "--verbose", action="count", default=0,
        help="WARNING if absent, -v: INFO, -vv: DEBUG",
    )
    args = parser.parse_args(argv)
    configure_logging(
        console_level=verbosity_to_level(args.verbose),
        file_path=f"{args.toaFile}.log",
        file_level="INFO",
        force=True,
    )
    get_logger(__name__).info("\nCLI starting")

    from crimp_tpu_torch.pipelines.measure_toas import measure_toas

    measure_toas(
        args.evtFile, args.timMod, args.tempModPP, args.toagtifile, args.enelow, args.enehigh,
        args.toaStart, args.toaEnd, args.phShiftRes, args.nbrBins, args.varyAmps,
        args.readvaryparam, args.brutemin, args.plotPPs, args.plotLLs, args.toaFile, args.timFile,
        plotResiduals=args.plotResiduals, device=args.device,
    )


_COMMANDS = {"measuretoas": measuretoas}


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in _COMMANDS:
        raise SystemExit(f"usage: python -m crimp_tpu_torch.cli {{{','.join(_COMMANDS)}}} ...")
    _COMMANDS[argv[0]](argv[1:])


if __name__ == "__main__":
    main()
