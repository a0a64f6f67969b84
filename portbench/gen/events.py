"""Event sets drawn from the seed: a pulsar's photons on its timing model.

The benchmark's frozen sampler, after the program's surrogate builder
(``build_surrogate``): each ToA interval gets the number of events the
configuration gives it (``interval_counts``) whose phases are drawn from
the Fourier template's pulse profile
(inverse CDF on a 4097-point grid) and placed on the ``.par`` phase by
inverting the model linearly about the interval's midpoint. Two changes,
so that every seed does the same work: the pulse number k is drawn only
from whole cycles that lie inside the interval, so no event is clipped and
each interval holds exactly its count; and the draws
run on the device in a few large calls (``torch.Generator`` seeded from
``--seed`` and the set's index), with only the per-interval constants
worked out on the host in longdouble.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import timing

CDF_POINTS = 4097


def profile_cdf(template: dict) -> tuple[np.ndarray, np.ndarray]:
    """(grid, cdf) of the template's rate over one cycle, clipped at 0."""
    grid = np.linspace(0.0, 1.0, CDF_POINTS)
    j = np.arange(1, len(template["amp"]) + 1)[:, None]
    rate = template["norm"] + np.sum(template["amp"][:, None]
                                     * np.cos(2 * np.pi * j * grid[None, :] + template["ph"][:, None]), axis=0)
    pdf = np.clip(rate, 0.0, None)
    cdf = np.concatenate([[0.0], np.cumsum((pdf[1:] + pdf[:-1]) / 2)])
    return grid, cdf / cdf[-1]


def interval_counts(column: np.ndarray, total: int | None = None) -> np.ndarray:
    """Events an interval: the configuration's column of counts as it
    stands, or scaled to ``total`` events in all (largest remainders
    rounded up, so the counts sum to ``total`` exactly)."""
    column = np.asarray(column, dtype=np.float64)
    if total is None:
        return np.rint(column).astype(np.int64)
    share = column * (int(total) / column.sum())
    counts = np.floor(share).astype(np.int64)
    extra = int(total) - int(counts.sum())
    counts[np.argsort(counts - share, kind="stable")[:extra]] += 1
    return counts


def interval_plan(par: dict, starts: np.ndarray, ends: np.ndarray) -> dict:
    """Per interval: the midpoint, the spin frequency and fractional phase
    there, and the inclusive range of pulse numbers k whose whole cycle
    (k + phase - frac in [k - 1, k + 1)) lies inside [start, end]."""
    mid = (starts + ends) / 2
    f_mid = timing.frequency(par, mid)
    frac_mid = timing.folded(par, mid)
    half = (ends - mid) * timing.SECONDS_PER_DAY * f_mid
    k_lo = np.ceil(-half) + 1
    k_hi = np.floor(half) - 1
    if np.any(k_hi < k_lo):
        raise ValueError("an interval is shorter than three spin cycles")
    return {"mid": mid, "f_mid": f_mid, "frac_mid": frac_mid, "k_lo": k_lo, "k_hi": k_hi}


def set_seed(seed: int, set_index: int) -> int:
    """A generator seed for event set ``set_index`` of run seed ``seed``
    (any whole number; Python's integers do not wrap)."""
    return (int(seed) * 1_000_003 + int(set_index)) % (2**63 - 1)


def draw_times(plan: dict, cdf: tuple[np.ndarray, np.ndarray], counts: np.ndarray, seed: int,
               set_index: int, device) -> torch.Tensor:
    """Sorted event times (MJD, float64) on ``device``: interval after
    interval, ``counts[i]`` in interval i."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(set_seed(seed, set_index))
    f64 = dict(dtype=torch.float64, device=dev)
    counts_t = torch.as_tensor(np.asarray(counts, dtype=np.int64), device=dev)
    n = int(counts_t.sum())
    grid_t, cdf_t = (torch.as_tensor(a, **f64) for a in cdf)
    u = torch.rand(n, generator=gen, **f64)
    hi = torch.searchsorted(cdf_t, u, right=True).clamp(1, grid_t.numel() - 1)
    lo = hi - 1
    width = cdf_t[hi] - cdf_t[lo]
    frac = torch.where(width > 0, (u - cdf_t[lo]) / torch.where(width > 0, width, 1.0), 0.0)
    ph = grid_t[lo] + frac * (grid_t[hi] - grid_t[lo])
    idx = torch.arange(counts_t.numel(), device=dev).repeat_interleave(counts_t)
    col = {k: torch.as_tensor(v, **f64)[idx] for k, v in plan.items()}
    span = col["k_hi"] - col["k_lo"] + 1
    k = col["k_lo"] + torch.floor(torch.rand(n, generator=gen, **f64) * span).clamp_max(span - 1)
    t = col["mid"] + ((k + ph - col["frac_mid"]) / col["f_mid"]) / timing.SECONDS_PER_DAY
    return torch.sort(t).values


def seconds_since_mean(times_mjd: np.ndarray) -> np.ndarray:
    """Event times in seconds from their mean, as a search user hands them
    to a periodicity search."""
    return (times_mjd - times_mjd.mean()) * timing.SECONDS_PER_DAY

