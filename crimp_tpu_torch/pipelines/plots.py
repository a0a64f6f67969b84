"""Pulse-profile visualization suite (CLI: pulseprofile_plots).

Port of ``crimp_tpu/pipelines/plots.py`` (plot registry of CRIMP's
plot_pps.py:19-583): a YAML config lists plots by type (folded profile
"pp", phase-energy map "phase_energy", phase-time map "phase_time", time x
energy grid of profiles "pp_grid", before/after-epoch comparison
"before_after") applied to an energy/time-filtered, phase-folded event
table (numpy columns), plus the GTI clipping helper. The fold runs on the
device through ``anchored.fold_chunked``; the YAML goes through
``io/yamlcfg``; matplotlib is imported when a plot is drawn.
"""

from __future__ import annotations

import numpy as np

from crimp_tpu_torch.io.events import EventFile
from crimp_tpu_torch.io.yamlcfg import load_yaml
from crimp_tpu_torch.ops.anchored import fold_chunked
from crimp_tpu_torch.ops.binprofile import bin_phases


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def prep_for_plotting(eventfile: str, parfile: str, enelow=0.0, enehigh=100.0, t_start=None, t_end=None,
                      device=None):
    """Filtered (energy/time) event table with a 'foldedphases' column,
    folded on ``device`` (default cuda), plus the window-clipped GTI list."""
    ef = EventFile(eventfile)
    df = ef.build_time_energy_df().filtenergy(eneLow=enelow, eneHigh=enehigh).filttime(t_start, t_end).time_energy_df
    _, gti = ef.read_gti()
    gti = update_gti(gti, t_start, t_end)
    df = dict(df)
    df["foldedphases"] = fold_chunked(df["TIME"], parfile, device=device)
    return df, gti


def update_gti(gti: np.ndarray, tstart, tend) -> np.ndarray:
    """Clip the GTI list to [tstart, tend] (plot_pps.py:44-74 semantics)."""
    if tstart is not None:
        gti = gti[gti[:, 1] > tstart]
        if len(gti) and tstart > gti[0, 0]:
            gti = gti.copy()
            gti[0, 0] = tstart
    if tend is not None:
        gti = gti[gti[:, 0] < tend]
        if len(gti) and tend < gti[-1, -1]:
            gti = gti.copy()
            gti[-1, -1] = tend
    return gti


def _two_cycles(bins, *arrays):
    cycle = 2 * np.pi if np.max(bins) > 1 else 1.0
    out = [np.append(bins, bins + cycle)]
    out.extend(np.append(a, a) for a in arrays)
    return out


def _save_or_show(fig, plotname):
    plt = _plt()
    if plotname is None:
        plt.show()
    else:
        fig.savefig(str(plotname) + ".pdf", format="pdf", dpi=300, bbox_inches="tight")
        plt.close(fig)


def plotting_pp(df, nbrbins: int = 100, plotname: str | None = None):
    """Mean-normalized folded pulse profile over two cycles."""
    binned = bin_phases(df["foldedphases"], nbrbins)
    rate = binned["ctsBins"] / binned["ctsBins"].mean()
    err = binned["ctsBinsErr"] / binned["ctsBins"].mean()
    x, y, yerr = _two_cycles(binned["ppBins"], rate, err)
    fig, ax = _plt().subplots(1, figsize=(12, 6))
    ax.errorbar(x, y, yerr=yerr, fmt="ok", zorder=10)
    ax.step(x, y, "k+-", where="mid", zorder=10)
    ax.set_xlim(0.0, 2 * (2 * np.pi if np.max(binned["ppBins"]) > 1 else 1))
    ax.set_xlabel("Phase (cycles)")
    ax.set_ylabel("Normalized rate")
    fig.tight_layout()
    _save_or_show(fig, plotname)


def _row_minmax_image(x, y, x_edges, y_edges):
    """histogram2d transposed, each row min-max scaled (NaN where flat)."""
    H, xe, ye = np.histogram2d(x, y, bins=[x_edges, y_edges])
    img = H.T
    lo = img.min(axis=1, keepdims=True)
    hi = img.max(axis=1, keepdims=True)
    return img, lo, hi, xe, ye


def plotting_phase_energy(df, nphasebins: int = 64, nenergybins: int = 24, smooth_sigma=0.5, plotname=None):
    """Phase-energy map: per-energy-row min-max-normalized count image."""
    from scipy.ndimage import gaussian_filter

    phases = np.asarray(df["foldedphases"])
    energies = np.asarray(df["PI"])
    phase_edges = np.linspace(0.0, 1.0, nphasebins + 1)
    energy_edges = np.logspace(np.log10(np.nanmin(energies)), np.log10(np.nanmax(energies)), nenergybins + 1)
    img, lo, hi, xe, ye = _row_minmax_image(phases, energies, phase_edges, energy_edges)
    img = (img - lo) / (hi - lo)
    if smooth_sigma is not None:
        sigma = tuple(smooth_sigma) if isinstance(smooth_sigma, list) else smooth_sigma
        img = gaussian_filter(img, sigma=sigma, mode="nearest")
    fig, ax = _plt().subplots(1, figsize=(12, 6))
    pcm = ax.pcolormesh(xe, ye, img, shading="auto")
    ax.set_yscale("log")
    ax.set_xlabel("Phase (cycles)")
    ax.set_ylabel("Energy")
    fig.colorbar(pcm, ax=ax, label="Min-Max scaling")
    fig.tight_layout()
    _save_or_show(fig, plotname)


def plotting_phase_time(df, nphasebins: int = 32, ntimebins: int = 12, smooth_sigma=0.5, plotname=None):
    """Phase-time map: histogram2d, per-row min-max scaling, NaN-weighted
    smoothing (the reference's algorithm and defaults, plot_pps.py:196-271)."""
    from scipy.ndimage import gaussian_filter

    phases = np.asarray(df["foldedphases"])
    times = np.asarray(df["TIME"])
    phase_edges = np.linspace(0.0, 1.0, nphasebins + 1)
    time_edges = np.linspace(np.nanmin(times), np.nanmax(times), ntimebins + 1)
    img, lo, hi, xe, ye = _row_minmax_image(phases, times, phase_edges, time_edges)
    denom = hi - lo
    rate = np.full_like(img, np.nan, dtype=float)
    np.divide(img - lo, denom, out=rate, where=denom != 0)
    if smooth_sigma is not None:
        sigma = tuple(smooth_sigma) if isinstance(smooth_sigma, list) else smooth_sigma
        finite = np.isfinite(rate)
        data = gaussian_filter(np.where(finite, rate, 0.0), sigma=sigma, mode="nearest")
        weight = gaussian_filter(finite.astype(float), sigma=sigma, mode="nearest")
        with np.errstate(invalid="ignore", divide="ignore"):
            rate = np.where(weight > 0, data / weight, np.nan)
    fig, ax = _plt().subplots(1, figsize=(12, 6))
    pcm = ax.pcolormesh(xe, ye, rate, shading="auto")
    ax.set_xlabel("Phase (cycles)")
    ax.set_ylabel("Time (MJD)")
    fig.colorbar(pcm, ax=ax, label="Min-Max scaling")
    fig.tight_layout()
    _save_or_show(fig, plotname)


def _normalized_profile(phases, nbrbins):
    """(x, y, yerr, norm) over two cycles, or None for an empty selection."""
    if not phases.size:
        return None
    binned = bin_phases(phases, int(nbrbins))
    counts = binned["ctsBins"].astype(float)
    if counts.mean() <= 0:
        return None
    norm = counts / counts.mean()
    x, y, yerr = _two_cycles(binned["ppBins"], norm, binned["ctsBinsErr"] / counts.mean())
    return x, y, yerr, norm


def _y_range(norms):
    if not norms:
        return 0.85, 1.15
    y_lo, y_hi = min(n.min() for n in norms), max(n.max() for n in norms)
    pad = 0.05 * (y_hi - y_lo if y_hi > y_lo else 0.3)
    return max(0.0, y_lo - pad), y_hi + pad


def plotting_pp_grid(df, n_timebins: int = 6, n_energybins: int = 6, nbrbins=(20, 24, 24, 24, 20, 16),
                     plotname=None):
    """Grid of mean-normalized profiles: rows = time bins, cols = energy bins."""
    phases = np.asarray(df["foldedphases"])
    times = np.asarray(df["TIME"])
    energies = np.asarray(df["PI"])
    time_edges = np.linspace(np.nanmin(times), np.nanmax(times), n_timebins + 1)
    e_min = max(np.nanmin(energies), np.nextafter(0, 1))
    energy_edges = np.logspace(np.log10(e_min), np.log10(np.nanmax(energies)), n_energybins + 1)
    if np.isscalar(nbrbins):
        bins_per_col = [int(nbrbins)] * n_energybins
    else:
        bins_per_col = list(nbrbins)
        if len(bins_per_col) != n_energybins:
            raise ValueError("nbrbins length must equal n_energybins")

    fig, axes = _plt().subplots(n_timebins, n_energybins, figsize=(3.8 * n_energybins, 2.9 * n_timebins),
                                squeeze=False)
    panels = {}
    for i in range(n_timebins):
        for j in range(n_energybins):
            sel = ((times >= time_edges[i]) & (times < time_edges[i + 1])
                   & (energies >= energy_edges[j]) & (energies < energy_edges[j + 1]))
            panels[i, j] = _normalized_profile(phases[sel], bins_per_col[j])
    y_lo, y_hi = _y_range([p[3] for p in panels.values() if p is not None])

    for (i, j), panel in panels.items():
        ax = axes[i, j]
        if panel is None:
            ax.set_visible(False)
            continue
        x, y, yerr, _ = panel
        ax.errorbar(x, y, yerr=yerr, fmt="ok", zorder=10)
        ax.step(x, y, "k+-", where="mid", zorder=10)
        ax.set_xlim(0.0, np.max(x))
        ax.set_ylim(y_lo, y_hi)
        if i == n_timebins - 1:
            ax.set_xlabel("Phase (cycles)")
        else:
            ax.set_xticklabels([])
        if j == 0:
            ax.set_ylabel("Norm. rate")
        else:
            ax.set_yticklabels([])
        if i == 0:
            ax.set_title(f"{energy_edges[j]:.2g} - {energy_edges[j+1]:.2g} keV", fontsize=12)
        if j == n_energybins - 1:
            twin = ax.twinx()
            twin.set_ylabel(f"{int(time_edges[i])} - {int(time_edges[i+1])} MJD", rotation=270, labelpad=14)
            twin.set_yticks([])
    fig.subplots_adjust(wspace=0.02, hspace=0.02)
    _save_or_show(fig, plotname)


def plotting_pp_before_after(df, t_mjd: float, days_window=7, nbrbins: int = 48, plotname=None):
    """Two stacked profiles around t_mjd: [t-w, t] on top, [t, t+w] below."""
    phases = np.asarray(df["foldedphases"])
    times = np.asarray(df["TIME"])
    if isinstance(days_window, (list, tuple)):
        if len(days_window) != 2:
            raise ValueError("days_window must be a scalar or a (pre, post) pair")
        pre, post = map(float, days_window)
    else:
        pre = post = float(days_window)
    windows = [(t_mjd - pre, t_mjd), (t_mjd, t_mjd + post)]

    fig, axes = _plt().subplots(2, 1, figsize=(8, 6), squeeze=False)
    panels = [_normalized_profile(phases[(times >= t0) & (times <= t1)], nbrbins) for t0, t1 in windows]
    y_lo, y_hi = _y_range([p[3] for p in panels if p is not None])
    for row, (panel, (t0, t1)) in enumerate(zip(panels, windows)):
        ax = axes[row, 0]
        if panel is None:
            ax.set_visible(False)
            continue
        x, y, yerr, _ = panel
        ax.errorbar(x, y, yerr=yerr, fmt="ok", zorder=10)
        ax.step(x, y, "k+-", where="mid", zorder=10)
        ax.set_xlim(0.0, np.max(x))
        ax.set_ylim(y_lo, y_hi)
        ax.set_ylabel("Normalized rate")
        ax.set_title(f"{int(t0)} - {int(t1)} MJD", fontsize=12)
        if row == 1:
            ax.set_xlabel("Phase (cycles)")
        else:
            ax.set_xticklabels([])
    fig.tight_layout()
    _save_or_show(fig, plotname)


PLOT_REGISTRY = {
    "pp": plotting_pp,
    "phase_energy": plotting_phase_energy,
    "phase_time": plotting_phase_time,
    "pp_grid": plotting_pp_grid,
    "before_after": plotting_pp_before_after,
}


def run_plots_from_yaml(config_path: str, df) -> list[str]:
    """Run the plots listed in a YAML config, each item {type: <registry key>,
    params: {kwargs}}; returns the types that ran."""
    plots = load_yaml(config_path).get("plots", [])
    if not isinstance(plots, list):
        raise ValueError("YAML must contain a top-level 'plots' list.")
    ran = []
    for i, item in enumerate(plots, 1):
        if not isinstance(item, dict):
            print(f"[WARN] plots[{i}] is not a mapping; skipping")
            continue
        fn = PLOT_REGISTRY.get(item.get("type"))
        if fn is None:
            print(f"[WARN] Unknown plot type {item.get('type')!r}; skipping")
            continue
        try:
            fn(df, **(item.get("params") or {}))
            ran.append(item["type"])
        except TypeError as exc:
            print(f"[WARN] Failed to run plot {item.get('type')!r}: {exc}")
    return ran
