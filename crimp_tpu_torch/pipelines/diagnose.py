"""ToA diagnostics dashboard (CLI: diagnosetoas).

Port of ``crimp_tpu/pipelines/diagnose.py`` (layout of CRIMP's
diagnoseToAs.py:22-109) on the port's numpy ToA table: 7 rows (interval
length, exposure, counts, count rate, H-power, reduced chi2, phase shifts
with symmetric errors) x 2 columns (vs ToA index, vs MJD), written as an
HTML file. plotly is imported when the dashboard is drawn, as in the JAX
package; without it the dashboard is a self-contained page of inline SVG
panels with hover readouts.
"""

from __future__ import annotations

import html

import numpy as np

from crimp_tpu_torch.io.table import read_columns

ROWS = [
    ("ToA_lenInt", "ToA interval length (days)"),
    ("ToA_exp", "ToA exposure (seconds)"),
    ("nbr_events", "Number of counts"),
    ("count_rate", "Count rate (/s)"),
    ("Hpower", "H-test power"),
    ("redChi2", "Reduced Chi2"),
    ("phShift", "Phase Shifts"),
]


def diagnose_toas(ToAs: str, outputFile: str = "ToADiagnosticsPlot") -> dict:
    """Write ``<outputFile>.html``; returns the ToA table (numpy columns)."""
    table = read_columns(ToAs)
    try:
        _plotly_dashboard(table, ToAs, outputFile)
    except ImportError:
        _fallback_dashboard(table, ToAs, outputFile)
    return table


def _phase_err(table: dict) -> np.ndarray:
    return np.hypot(table["phShift_LL"], table["phShift_UL"]) / np.sqrt(2)


def _plotly_dashboard(table: dict, source: str, outputFile: str) -> None:
    from plotly.subplots import make_subplots
    import plotly.graph_objects as go

    err = _phase_err(table)
    fig = make_subplots(rows=7, cols=2, shared_xaxes=True, shared_yaxes=True,
                        horizontal_spacing=0.02, vertical_spacing=0.02)
    for col, x in ((1, table["ToA"]), (2, table["ToA_mid"])):
        for row, (key, label) in enumerate(ROWS, start=1):
            kwargs = {}
            if key == "phShift":
                kwargs["error_y"] = dict(type="data", array=err, visible=True)
            fig.add_trace(go.Scatter(x=x, y=table[key], mode="markers", **kwargs), row=row, col=col)
            if col == 1:
                fig.update_yaxes(title_text=label, row=row, col=1)
    fig.update_xaxes(title_text="ToA number", row=7, col=1)
    fig.update_xaxes(title_text="Days (MJD)", row=7, col=2)
    fig.update_layout(height=1600, width=1600, showlegend=False,
                      title_text="ToA properties for file " + source, font=dict(size=14))
    fig.write_html(outputFile + ".html")


def _svg_panel(x, y, yerr, xlabel, ylabel, width=700, height=190) -> str:
    """One scatter panel as inline SVG with hover titles."""
    x = np.asarray(x, dtype=float)
    y = np.asarray(y, dtype=float)
    pad_l, pad_r, pad_t, pad_b = 70, 10, 8, 28
    x_lo, x_hi = np.nanmin(x), np.nanmax(x)
    y_vals = y if yerr is None else np.concatenate([y - yerr, y + yerr])
    y_lo, y_hi = np.nanmin(y_vals), np.nanmax(y_vals)
    x_span = (x_hi - x_lo) or 1.0
    y_span = (y_hi - y_lo) or 1.0

    def sx(v):
        return pad_l + (v - x_lo) / x_span * (width - pad_l - pad_r)

    def sy(v):
        return height - pad_b - (v - y_lo) / y_span * (height - pad_t - pad_b)

    parts = [f'<svg width="{width}" height="{height}" style="background:#fff;border:1px solid #ccc">']
    parts.append(
        f'<text x="4" y="{height/2:.0f}" font-size="10" transform="rotate(-90 10,{height/2:.0f})" '
        f'text-anchor="middle">{html.escape(ylabel)}</text>'
    )
    parts.append(
        f'<text x="{(pad_l+width)/2:.0f}" y="{height-6}" font-size="10" text-anchor="middle">'
        f'{html.escape(xlabel)}</text>'
    )
    for tick in np.linspace(y_lo, y_hi, 4):
        parts.append(f'<text x="{pad_l-4}" y="{sy(tick)+3:.1f}" font-size="9" text-anchor="end">{tick:.4g}</text>')
    for tick in np.linspace(x_lo, x_hi, 6):
        parts.append(
            f'<text x="{sx(tick):.1f}" y="{height-pad_b+12}" font-size="9" text-anchor="middle">{tick:.6g}</text>'
        )
    for i in range(len(x)):
        cx, cy = sx(x[i]), sy(y[i])
        if yerr is not None:
            parts.append(
                f'<line x1="{cx:.1f}" y1="{sy(y[i]-yerr[i]):.1f}" x2="{cx:.1f}" y2="{sy(y[i]+yerr[i]):.1f}" '
                'stroke="#888"/>'
            )
        parts.append(
            f'<circle cx="{cx:.1f}" cy="{cy:.1f}" r="3" fill="#1f77b4"><title>x={x[i]:.8g}, y={y[i]:.8g}'
            '</title></circle>'
        )
    parts.append("</svg>")
    return "".join(parts)


def _fallback_dashboard(table: dict, source: str, outputFile: str) -> None:
    err = _phase_err(table)
    cells = []
    for key, label in ROWS:
        yerr = err if key == "phShift" else None
        cells.append(
            "<tr><td>"
            + _svg_panel(table["ToA"], table[key], yerr, "ToA number", label)
            + "</td><td>"
            + _svg_panel(table["ToA_mid"], table[key], yerr, "Days (MJD)", label)
            + "</td></tr>"
        )
    page = (
        "<!DOCTYPE html><html><head><meta charset='utf-8'>"
        "<title>ToA diagnostics</title></head><body>"
        f"<h2>ToA properties for file {html.escape(source)}</h2>"
        "<table>" + "".join(cells) + "</table></body></html>"
    )
    with open(outputFile + ".html", "w") as fh:
        fh.write(page)


# Reference-named alias (diagnoseToAs.py:22).
diagnoseToAs = diagnose_toas
