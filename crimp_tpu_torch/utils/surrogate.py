"""The north-star workload: a synthetic merged campaign and one timed pass.

``build_surrogate`` is the port's own copy of ``bench.py::build_surrogate``
(same sampler and seed handling, built on the port's host functions):
``events_per_toa`` events per committed ToA interval, drawn from the
template profile and placed on the timing model's phase. ``north_star``
runs the repository's north-star path once: the 2-D (nu, nudot) Z^2 scan
over every event, then the anchored fold, the batched ToA fit, the per-ToA
H-test and the .tim conversion over the intervals, timing each stage.
"""

from __future__ import annotations

import os
import tempfile
import time

import numpy as np

from crimp_tpu_torch.io import template as template_io
from crimp_tpu_torch.io import tim as tim_io
from crimp_tpu_torch.io.table import read_columns
from crimp_tpu_torch.models import profiles, timing
from crimp_tpu_torch.ops import anchored, search, toafit
from crimp_tpu_torch.ops.ephem import spin_frequency_host
from crimp_tpu_torch.pipelines.tim_tools import toas_to_tim_table
from crimp_tpu_torch.utils.device import resolve_device, synchronize


def build_surrogate(par_path: str, intervals_path: str, template_path: str,
                    events_per_toa: int = 10000, seed: int = 7):
    """(sorted event MJDs, interval column dict) shaped to the intervals."""
    rng = np.random.RandomState(seed)
    intervals = read_columns(intervals_path)
    tm = timing.resolve(par_path)
    _, tpl = profiles.from_template(template_io.read_template(template_path))

    amp = tpl.amp.numpy()
    loc = tpl.loc.numpy()
    norm = float(tpl.norm)

    def profile_rate(p):
        j = np.arange(1, len(amp) + 1)[:, None]
        return norm + np.sum(amp[:, None] * np.cos(j * 2 * np.pi * p[None, :] + loc[:, None]), axis=0)

    # inverse-CDF sampler for the template pdf
    grid = np.linspace(0, 1, 4097)
    pdf = np.clip(profile_rate(grid), 0.0, None)  # fitted profiles can dip <0
    cdf = np.concatenate([[0.0], np.cumsum((pdf[1:] + pdf[:-1]) / 2)])
    cdf /= cdf[-1]

    all_times = []
    for t_start, t_end in zip(intervals["ToA_tstart"], intervals["ToA_tend"]):
        t_mid = (t_start + t_end) / 2
        phases = np.interp(rng.uniform(0, 1, events_per_toa), cdf, grid)
        # invert the (locally linear) phase model around the window mid
        f_mid, _ = spin_frequency_host(tm, np.atleast_1d(t_mid))
        f_mid = float(f_mid[0])
        phi_mid = float(anchored.host_total_phase(tm, np.atleast_1d(t_mid))[0])
        frac_mid = phi_mid - np.floor(phi_mid)
        span_cycles = (t_end - t_start) * 86400.0 * f_mid
        k = rng.randint(int(-span_cycles / 2), max(int(span_cycles / 2), 1), events_per_toa)
        t = t_mid + ((k + phases - frac_mid) / f_mid) / 86400.0
        all_times.append(t[(t >= t_start) & (t <= t_end)])
    return np.sort(np.concatenate(all_times)), intervals


def slice_intervals(times: np.ndarray, starts, ends) -> list[np.ndarray]:
    """Segments of the (sorted) surrogate per interval."""
    return toafit.slice_sorted_intervals(times, starts, ends, assume_sorted=True)


def north_star(par_path: str, template_path: str, times: np.ndarray, intervals: dict,
               n_freq: int = 2500, n_fdot: int = 40, ph_shift_res: int = 1000,
               device=None) -> dict:
    """One pass of the north-star path; returns the scan rows, the fit
    columns and the wall time of each stage (seconds, the card synchronized
    before every clock read)."""
    dev = resolve_device(device)
    tm = timing.resolve(par_path)
    kind, tpl = profiles.from_template(template_io.read_template(template_path))
    sec = (times - times.mean()) * 86400.0
    freqs = np.linspace(0.1430, 0.1436, n_freq)
    log_fdots = np.linspace(-14.5, -13.5, n_fdot)  # log10 |nudot|, spin-down
    starts, ends = intervals["ToA_tstart"], intervals["ToA_tend"]
    exposures = intervals["ToA_exposure"].astype(float)
    stages: dict[str, float] = {}

    def clock():
        synchronize(dev)
        return time.perf_counter()

    t_all = t0 = clock()
    rows, _ = search.PeriodSearch(sec, freqs, 2, device=dev).twod_ztest(log_fdots)
    t1 = clock()
    stages["z2_scan"] = t1 - t0

    seg_times = slice_intervals(times, starts, ends)
    seg_phases, toa_mids = anchored.fold_segments(tm, seg_times, device=dev)
    phases, masks = toafit.pad_segments(seg_phases)
    t2 = clock()
    stages["fold"] = t2 - t1

    cfg = toafit.ToAFitConfig(kind=kind, ph_shift_res=ph_shift_res, nbins=15)
    fit = toafit.fit_toas_batch(kind, tpl, phases, masks, exposures, cfg, device=dev)
    fit = {k: v.cpu().numpy() for k, v in fit.items()}
    t3 = clock()
    stages["fit"] = t3 - t2

    freqs_mid, _ = spin_frequency_host(tm, toa_mids)
    sec_seg = np.zeros_like(phases)
    for i, t_seg in enumerate(seg_times):
        sec_seg[i, : t_seg.size] = (t_seg - (t_seg[0] + t_seg[-1]) / 2) * 86400.0
    fit["Hpower"] = search.h_power_segments(sec_seg, masks, freqs_mid, nharm=5, device=dev).cpu().numpy()
    t4 = clock()
    stages["htest"] = t4 - t3

    table = toas_to_tim_table(toa_mids, fit["phShift"], fit["phShift_LL"], fit["phShift_UL"],
                              tm, tempModPP=os.path.basename(template_path))
    with tempfile.TemporaryDirectory() as tmp:
        tim_io.write_tim(os.path.join(tmp, "north_star"), table)
    t5 = clock()
    stages["tim"] = t5 - t4
    stages["total"] = t5 - t_all
    return {"rows": rows, "fit": fit, "tim": table, "stages": stages}
