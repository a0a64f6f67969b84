"""Synthetic modulated event-list generator (test fixture).

The port's numpy copy of ``crimp_tpu/pipelines/simulate.py`` (CRIMP's
simulatemodulatedlc.py:19-96): a sinusoidal profile sampled in phase bins,
Poisson counts per bin, uniform rotation assignment, plus Poisson uniform
background; returns event times with and without background, bit for bit
the JAX package's for the same ``RandomState``."""

from __future__ import annotations

import numpy as np


def simulate_modulated_lc(
    freq: float,
    srcrate: float = 1.0,
    exposure: float = 10000.0,
    pulsedfraction: float = 0.2,
    bgrrate: float = 0.05,
    resolution: float = 0.073,
    nbrPhaseBins: int | None = None,
    rng: np.random.RandomState | None = None,
) -> dict:
    """Simulate a sinusoidally modulated light curve.

    Returns {'assigned_t_wBgr', 'assigned_t_nobgr'}: sorted event times (s)
    with and without background.
    """
    if rng is None:
        rng = np.random.RandomState()

    n_rotations = int(exposure * freq)
    exposure_norm = n_rotations / freq

    amp = np.sqrt(2) * pulsedfraction * srcrate
    if amp > srcrate:
        raise ValueError("RMS pulsed fraction cannot be larger than 1/sqrt(2)")

    if nbrPhaseBins is None:
        nbrPhaseBins = int(np.floor(1 / (resolution * freq)))
    if nbrPhaseBins < 4:
        raise ValueError(
            "nbrPhaseBins is very small; increase time resolution or set it manually"
        )

    bin_phases = np.linspace(0, 1, nbrPhaseBins, endpoint=False)
    # peak mid-cycle (cos shifted by pi), counts per phase bin over the run
    expected = (srcrate + amp * np.cos(2 * np.pi * bin_phases + np.pi)) * (
        exposure_norm / nbrPhaseBins
    )

    chunks = []
    for k in range(nbrPhaseBins):
        n_events = rng.poisson(expected[k])
        rotation = rng.uniform(0, n_rotations, n_events).astype(int)
        within = rng.uniform(bin_phases[k], bin_phases[k] + 1 / nbrPhaseBins, n_events)
        chunks.append(rotation + within)
    phases = np.sort(np.concatenate(chunks)) if chunks else np.zeros(0)

    t_nobgr = np.sort(phases / freq)
    n_bkg = rng.poisson(bgrrate * exposure_norm)
    t_bkg = np.sort(rng.uniform(0, exposure_norm, n_bkg))
    t_wbgr = np.sort(np.concatenate([t_nobgr, t_bkg]))
    return {"assigned_t_wBgr": t_wbgr, "assigned_t_nobgr": t_nobgr}


# Reference-named alias (simulatemodulatedlc.py:19).
simulatemodulatedlc = simulate_modulated_lc


def main(argv=None):
    """Module-level entry (simulatemodulatedlc.py:99; not a console script):
    ``python -m crimp_tpu_torch.pipelines.simulate FREQ [options]``."""
    import argparse

    parser = argparse.ArgumentParser(
        description="Simulate a sinusoidally modulated event list"
    )
    parser.add_argument("freq", help="Signal frequency (Hz)", type=float)
    parser.add_argument("-sr", "--srcrate", help="Source count rate (cts/s), default=1", type=float, default=1.0)
    parser.add_argument("-ex", "--exposure", help="Exposure (s), default=10000", type=float, default=10000.0)
    parser.add_argument("-pf", "--pulsedfraction", help="RMS pulsed fraction, default=0.2", type=float, default=0.2)
    parser.add_argument("-bg", "--bgrrate", help="Background rate (cts/s), default=0.05", type=float, default=0.05)
    parser.add_argument("-rs", "--resolution", help="Time resolution (s), default=0.073", type=float, default=0.073)
    parser.add_argument("-nb", "--nbrPhaseBins", help="Phase bins (default: from resolution)", type=int, default=None)
    parser.add_argument("-of", "--outputfile", help="Output .txt stem (time column)", type=str, default="simulatedlc")
    args = parser.parse_args(argv)

    sim = simulate_modulated_lc(
        args.freq, args.srcrate, args.exposure, args.pulsedfraction, args.bgrrate,
        args.resolution, args.nbrPhaseBins,
    )
    np.savetxt(args.outputfile + ".txt", sim["assigned_t_wBgr"])
    print(
        f"Simulated {len(sim['assigned_t_nobgr'])} source + "
        f"{len(sim['assigned_t_wBgr']) - len(sim['assigned_t_nobgr'])} background events "
        f"-> {args.outputfile}.txt"
    )


if __name__ == "__main__":
    main()
