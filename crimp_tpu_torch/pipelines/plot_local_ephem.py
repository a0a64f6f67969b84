"""Local-ephemerides table reading and plotting (CLI: localephemerides_plot).

Port of ``crimp_tpu/pipelines/plot_local_ephem.py`` (CRIMP's
plot_local_ephem.py:10-107) without pandas: read the whitespace table into
numpy columns, filter by time, then stacked F0/F1 panels against MJD with
x/y error bars and dashed glitch-epoch markers. matplotlib is imported when
a plot is drawn.
"""

from __future__ import annotations

import numpy as np


def _column(tokens: list[str]) -> np.ndarray:
    """int64 when every cell is an integer literal, else float64."""
    try:
        return np.asarray([int(v) for v in tokens], dtype=np.int64)
    except ValueError:
        return np.asarray([float(v) for v in tokens], dtype=np.float64)


def read_local_ephemerides(localephem: str, t_start: float | None = None, t_end: float | None = None) -> dict:
    """The table as ``{column: array}``, as ``pd.read_csv(sep=r"\\s+",
    comment="#")`` reads it: a header of names, rows that may lead with an
    index (dropped, as pandas takes it for the index), ``#`` comments."""
    rows = []
    with open(localephem) as fh:
        for raw in fh:
            line = raw.split("#", 1)[0].strip()
            if line:
                rows.append(line.split())
    header, body = rows[0], rows[1:]
    if body and len(body[0]) == len(header) + 1:
        body = [r[1:] for r in body]
    table = {name: _column([r[j] for r in body]) for j, name in enumerate(header)}
    toa = table["TOA_MJD_ref"]
    lo = toa.min() if t_start is None else t_start
    hi = toa.max() if t_end is None else t_end
    keep = (toa >= lo) & (toa <= hi)
    return {name: col[keep] for name, col in table.items()}


def plot_local_ephemerides(local_df: dict, glitches=None, plotname=None):
    """Stacked F0 / F1 error-bar panels with optional glitch markers; writes
    ``<plotname>.pdf`` and returns its path (None without a name)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axs = plt.subplots(2, 1, figsize=(10, 8), sharex=True)
    for ax, f_col, err_col, label in (
        (axs[0], "F0", "F0_err", "Frequency (Hz)"),
        (axs[1], "F1", "F1_err", r"$\dot{F}$ (Hz s$^{-1}$)"),
    ):
        ax.errorbar(
            local_df["TOA_MJD_ref"], local_df[f_col],
            xerr=local_df["TOA_MJD_ref_err"], yerr=local_df[err_col],
            fmt="o", color="k", ecolor="gray", elinewidth=1.5, capsize=2,
            markersize=6, alpha=0.7,
        )
        ax.ticklabel_format(style="sci", axis="y", scilimits=(0, 0))
        ax.set_ylabel(label)
        ax.grid(True, linestyle="--", alpha=0.3)
        if glitches:
            for g in glitches:
                ax.axvline(g, color="red", linestyle="--", linewidth=1.5, alpha=0.7)
    axs[1].set_xlabel("Time (MJD)")
    fig.tight_layout()
    if plotname is None:
        plt.close(fig)
        return None
    fig.savefig(str(plotname) + ".pdf", format="pdf", dpi=300, bbox_inches="tight")
    plt.close(fig)
    return str(plotname) + ".pdf"
