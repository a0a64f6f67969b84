"""Periodicity searches: Z^2_n, H-test, and the 2-D (nu, nudot) Z^2 grid.

Port of the part of ``crimp_tpu/ops/search.py`` that the north-star path
runs. Statistic parity with the reference (periodsearch.py:57-125):

  Z^2_n(f)  = (2/N) * sum_{k=1..n} [ (sum_i cos k*theta_i)^2 + (sum_i sin k*theta_i)^2 ]
  H(f)      = max_m ( cumsum_m Z^2 terms - 4*(m-1) )
  2-D grid  : theta_i = 2*pi*(f*(t_i-t0) + 0.5*fdot*(t_i-t0)^2), the nudot
              axis given as log10 magnitudes and applied as -10^x
              (spin-down only); t0 = (t[0]+t[-1])/2.

Uniform trial grids go through the Z^2 tile kernel (``ops/z2_grid.py``:
CUDA on the card, its plain twin on the CPU): f64-reduced per-tile and
per-fdot rows, f32 polynomial trig, Chebyshev harmonics. The general
blockwise kernels for non-uniform grids, the streamed and factorized paths
and the 3-D cube are later work: such requests raise NotImplementedError.
So does nharm > 20, the limit of the JAX fast path.

``h_power_segments`` (the per-ToA H-test) is plain torch: the phase f*t in
f64, reduced mod 1, then hardware f32 sin/cos and the Chebyshev recurrence.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from crimp_tpu_torch.ops import fasttrig, z2_grid
from crimp_tpu_torch.utils.device import resolve_device

# The f32 inner sweep's error grows ~linearly in harmonic number; 20 is
# the conventional H-test maximum and the JAX fast-path limit.
GRID_FASTPATH_MAX_NHARM = 20


def chebyshev_weighted_sums(cos1, sin1, weights, nharm: int):
    """Weighted per-harmonic trig sums (nharm, ...) in the input dtype.

    Harmonic k comes from the Chebyshev recurrence cos(k t) = 2 cos t
    cos((k-1) t) - cos((k-2) t) (and its sine twin), so only the k=1
    sin/cos pair is ever evaluated; summation is over the trailing axis.
    """
    cos_km1, sin_km1 = cos1, sin1
    cos_km2 = torch.ones_like(cos1)
    sin_km2 = torch.zeros_like(sin1)
    c_list = [torch.sum(weights * cos1, dim=-1)]
    s_list = [torch.sum(weights * sin1, dim=-1)]
    for _ in range(1, nharm):
        cos_k = 2 * cos1 * cos_km1 - cos_km2
        sin_k = 2 * cos1 * sin_km1 - sin_km2
        c_list.append(torch.sum(weights * cos_k, dim=-1))
        s_list.append(torch.sum(weights * sin_k, dim=-1))
        cos_km2, sin_km2 = cos_km1, sin_km1
        cos_km1, sin_km1 = cos_k, sin_k
    return torch.stack(c_list), torch.stack(s_list)


def _harmonic_sums_cycles(phase_cycles, weights, nharm: int):
    """(C_k, S_k) for k=1..nharm where C_k = sum_i w_i cos(2 pi k phi_i).

    ``phase_cycles``: (..., B) model phase in cycles (f64); the fractional
    part is taken in f64, then hardware f32 sin/cos and the per-row sums
    run in f32. Returns f64 tensors of shape (nharm, ...).
    """
    theta = (2 * math.pi) * fasttrig.centered_frac(phase_cycles).to(torch.float32)
    c_sums, s_sums = chebyshev_weighted_sums(torch.cos(theta), torch.sin(theta),
                                             weights.to(torch.float32), nharm)
    return c_sums.to(torch.float64), s_sums.to(torch.float64)


def z2_from_sums(c_sum, s_sum, n_events):
    """Z^2 per harmonic from trig sums: (nharm, ...) -> (nharm, ...)."""
    return (c_sum**2 + s_sum**2) * (2.0 / n_events)


def uniform_grid(freqs: np.ndarray, rtol: float = 1e-12):
    """(f0, df) if ``freqs`` is a uniform grid, else None (host helper)."""
    f = np.asarray(freqs, dtype=np.float64)
    if f.ndim != 1 or f.size < 3:
        return None
    df = (f[-1] - f[0]) / (f.size - 1)
    if df == 0:
        return None
    recon = f[0] + df * np.arange(f.size)
    scale = max(abs(f[0]), abs(f[-1]))
    if np.max(np.abs(recon - f)) > rtol * scale:
        return None
    return float(f[0]), float(df)


def _check_nharm(nharm: int) -> None:
    if nharm > GRID_FASTPATH_MAX_NHARM:
        raise NotImplementedError(
            f"nharm={nharm} > {GRID_FASTPATH_MAX_NHARM} needs the general "
            "exact-phase kernels, which are not ported yet"
        )
    if nharm < 1:
        raise ValueError(f"nharm must be >= 1, got {nharm}")


def harmonic_sums_2d_grid(times, f0: float, df: float, n_freq: int, fdots, nharm: int,
                          device=None):
    """f64 trig sums (n_fdot, nharm, n_freq) each over the (fdot x uniform
    frequency) grid, through the Z^2 tile kernel. ``fdots`` are signed Hz/s;
    times are f64 seconds, pre-centered by the caller."""
    _check_nharm(nharm)
    dev = resolve_device(device)
    t = torch.as_tensor(np.asarray(times, dtype=np.float64)).to(dev)
    half_fd = torch.as_tensor(0.5 * np.asarray(fdots, dtype=np.float64).reshape(-1)).to(dev)
    n_tiles = -(-int(n_freq) // z2_grid.TRIAL_TILE)
    cs = z2_grid.z2_tile_sums(t, f0, df, half_fd, n_tiles, nharm).to(torch.float64)
    # (2, n_fdot, n_tiles, nharm, T) -> (2, n_fdot, nharm, n_tiles*T)[..., :n_freq]
    cs = cs.permute(0, 1, 3, 2, 4).reshape(2, half_fd.shape[0], nharm, -1)[..., :n_freq]
    return cs[0], cs[1], t.shape[0]


def z2_power_2d_grid(times, f0: float, df: float, n_freq: int, fdots, nharm: int = 2,
                     device=None) -> torch.Tensor:
    """Z^2_n over the (fdot x uniform-frequency) grid -> (n_fdot, n_freq) f64."""
    c, s, n = harmonic_sums_2d_grid(times, f0, df, n_freq, fdots, nharm, device)
    return torch.sum(z2_from_sums(c, s, n), dim=1)


def z2_power_grid(times, f0: float, df: float, n_freq: int, nharm: int = 2,
                  device=None) -> torch.Tensor:
    """Z^2_n over the uniform grid f0 + j*df -> (n_freq,) f64."""
    return z2_power_2d_grid(times, f0, df, n_freq, [0.0], nharm, device)[0]


def h_power_grid(times, f0: float, df: float, n_freq: int, nharm: int = 20,
                 device=None) -> torch.Tensor:
    """H-test over the uniform grid f0 + j*df -> (n_freq,) f64."""
    c, s, n = harmonic_sums_2d_grid(times, f0, df, n_freq, [0.0], nharm, device)
    z2_cum = torch.cumsum(z2_from_sums(c[0], s[0], n), dim=0)
    penalties = 4.0 * torch.arange(nharm, dtype=torch.float64, device=z2_cum.device)[:, None]
    return torch.amax(z2_cum - penalties, dim=0)


def h_power_segments(times, masks, freqs, nharm: int = 5, device=None) -> torch.Tensor:
    """H-test power per segment at its own frequency: times (S, N) pre-centered
    seconds (padded), masks (S, N) validity, freqs (S,). Backs the per-ToA
    H-test of the ToA pipeline. Returns (S,) f64."""
    dev = resolve_device(device)
    t = torch.as_tensor(np.asarray(times, dtype=np.float64)).to(dev)
    m = torch.as_tensor(np.asarray(masks)).to(dev).to(torch.float64)
    f = torch.as_tensor(np.asarray(freqs, dtype=np.float64)).to(dev)
    c, s = _harmonic_sums_cycles(f[:, None] * t, m, nharm)  # (nharm, S)
    z2_cum = torch.cumsum(z2_from_sums(c, s, torch.sum(m, dim=-1)), dim=0)
    return torch.amax(z2_cum - 4.0 * torch.arange(nharm, dtype=torch.float64, device=dev)[:, None], dim=0)


class PeriodSearch:
    """Reference-compatible search API (periodsearch.py:20-125) on the card.

    ``time`` in seconds; trials are centered on t0 = (time[0]+time[-1])/2.
    Uniform trial grids run through the Z^2 tile kernel on ``device``
    (default cuda).
    """

    def __init__(self, time, freq, nbrHarm: int = 2, device=None):
        self.time = np.asarray(time, dtype=np.float64)
        self.freq = np.asarray(freq, dtype=np.float64)
        self.nbrHarm = int(nbrHarm)
        self.t0 = (self.time[0] + self.time[-1]) / 2
        self.device = resolve_device(device)

    def _grid(self):
        grid = uniform_grid(self.freq)
        if grid is None:
            raise NotImplementedError(
                "non-uniform trial grids need the general blockwise kernels, "
                "which are not ported yet"
            )
        return grid

    def _centered(self) -> np.ndarray:
        return self.time - self.t0

    def ztest(self) -> np.ndarray:
        f0, df = self._grid()
        return z2_power_grid(self._centered(), f0, df, len(self.freq), self.nbrHarm,
                             device=self.device).cpu().numpy()

    def htest(self) -> np.ndarray:
        f0, df = self._grid()
        return h_power_grid(self._centered(), f0, df, len(self.freq), self.nbrHarm,
                            device=self.device).cpu().numpy()

    def twod_ztest(self, freq_dot):
        """2-D Z^2 on a (log10 |nudot|) grid, spin-down sign enforced.

        Returns (array of rows [freq, log10_fdot, z2], column dict) with the
        reference's row ordering: outer loop fdot, inner loop freq.
        """
        log_fdots = np.asarray(freq_dot, dtype=np.float64)
        signed = -(10.0**log_fdots)
        f0, df = self._grid()
        power = z2_power_2d_grid(self._centered(), f0, df, len(self.freq), signed,
                                 self.nbrHarm, device=self.device).cpu().numpy()
        rows = np.column_stack(
            [
                np.tile(self.freq, len(log_fdots)),
                np.repeat(log_fdots, len(self.freq)),
                power.reshape(-1),
            ]
        )
        table = {"Freq": rows[:, 0], "Freq_dot": rows[:, 1], "Z2pow": rows[:, 2]}
        return rows, table
