"""The plain reference of one north-star campaign pass over one event set.

From the event times (MJD), the ToA intervals, the ``.par`` model and the
template it works out again, independently of the program: each interval's
events and folded phases (longdouble phase of every event), the ToA fit
(``toafit.Fit``), each interval's H-test at the model frequency at its
anchor, the ``.tim`` ToAs (the integer-rotation epoch plus the phase shift)
and Z^2 at the grid trials asked for. ``fit_dtype`` and ``z2_dtype`` set
the precisions: float64 and float64 for the reference, one step below the
configuration's (float32 fit, bfloat16 trig) for the control.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import timing, toafit, z2


def segments(times: np.ndarray, starts: np.ndarray, ends: np.ndarray) -> list[np.ndarray]:
    """Each interval's events: sorted times within [start, end] inclusive."""
    lo = np.searchsorted(times, starts, side="left")
    hi = np.searchsorted(times, ends, side="right")
    return [times[a:b] for a, b in zip(lo, hi)]


def fit_intervals(par: dict, template: dict, segs: list[np.ndarray], exposure: np.ndarray, ph_shift_res: int,
                  device, dtype=torch.float64) -> dict:
    """The ToA fit of every interval, as numpy columns, plus each
    interval's anchor (the middle of its events' span)."""
    n_max = max(s.size for s in segs)
    x = np.zeros((len(segs), n_max))
    mask = np.zeros((len(segs), n_max), dtype=bool)
    for i, s in enumerate(segs):
        x[i, : s.size] = timing.folded(par, s)
        mask[i, : s.size] = True
    fit = toafit.Fit(template, torch.as_tensor(x, device=device), torch.as_tensor(mask, device=device),
                     torch.as_tensor(exposure, dtype=torch.float64, device=device), dtype=dtype)
    out = {k: (v.double().cpu().numpy() if isinstance(v, torch.Tensor) else v)
           for k, v in fit.run(ph_shift_res=ph_shift_res).items()}
    out["anchor"] = np.array([(s[-1] - s[0]) / 2 + s[0] for s in segs])
    return out


def htest(par: dict, segs: list[np.ndarray], anchors: np.ndarray, nharm: int, device,
          dtype=torch.float64) -> np.ndarray:
    """Each interval's H-test power at the model frequency at its anchor."""
    rows = [torch.as_tensor((s - (s[0] + s[-1]) / 2) * timing.SECONDS_PER_DAY, device=device) for s in segs]
    freqs = torch.as_tensor(timing.frequency(par, anchors), device=device)
    return z2.h_rows(rows, freqs, nharm, dtype).cpu().numpy()


def tim_toas(par: dict, anchors: np.ndarray, ph_shift: np.ndarray) -> np.ndarray:
    """The .tim ToAs (MJD): each anchor's integer-rotation epoch plus the
    phase shift in time at that epoch's frequency."""
    epoch, freq = timing.integer_rotation(par, anchors)
    return epoch + (ph_shift / (2 * math.pi) / freq) / timing.SECONDS_PER_DAY


def campaign(par: dict, template: dict, times: np.ndarray, intervals: dict, trials: tuple[np.ndarray, np.ndarray],
             nharm: int, htest_nharm: int, ph_shift_res: int, device,
             fit_dtype=torch.float64, z2_dtype=torch.float64) -> dict:
    """Every answer of one pass: fit columns, H-powers, .tim ToAs, and Z^2
    at ``trials`` (freqs, fdots) over all events, times in seconds from
    their mean."""
    segs = segments(times, intervals["ToA_tstart"], intervals["ToA_tend"])
    out = fit_intervals(par, template, segs, intervals["ToA_exposure"], ph_shift_res, device, fit_dtype)
    out["Hpower"] = htest(par, segs, out["anchor"], htest_nharm, device, z2_dtype)
    out["toa"] = tim_toas(par, out["anchor"], out["phShift"])
    out["z2"] = z2_search(times, trials, nharm, device, z2_dtype)
    return out


def z2_search(times: np.ndarray, trials: tuple[np.ndarray, np.ndarray], nharm: int, device,
              dtype=torch.float64) -> np.ndarray:
    """Z^2 at the trials over event times given in MJD."""
    sec = torch.as_tensor((times - times.mean()) * timing.SECONDS_PER_DAY, device=device)
    return z2_seconds(sec, trials, nharm, device, dtype)


def z2_seconds(sec: torch.Tensor, trials: tuple[np.ndarray, np.ndarray], nharm: int, device,
               dtype=torch.float64) -> np.ndarray:
    """Z^2 at the trials over event times given in seconds."""
    f, fd = (torch.as_tensor(np.asarray(a, dtype=np.float64), device=device) for a in trials)
    return z2.z2_trials(sec, f, fd, nharm, dtype).cpu().numpy()
