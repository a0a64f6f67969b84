"""Plain Z^2_n and H-test powers, for the trials and rows a run samples.

Z^2_n of N events at a trial (nu, nudot) is (2/N) sum_{k<=n} (C_k^2 + S_k^2)
with C_k = sum_i cos(2 pi k phi_i), S_k = sum_i sin(2 pi k phi_i) and
phi_i = nu t_i + nudot t_i^2 / 2, the times centred on the middle of their
span (CRIMP's ``periodsearch.py``). The H-test is max over m <= n of the
cumulative Z^2_m - 4 (m - 1). The phase is formed and reduced mod 1 in
float64; each harmonic's cos and sin then come straight from that reduced
phase (no recurrence), summed in float64. ``dtype`` below float64 rounds
each cos and sin to it and accumulates in float32: the control a lower
precision is held against.
"""

from __future__ import annotations

import math

import torch

_F64 = torch.float64


def _harmonic_sums(frac: torch.Tensor, nharm: int, dtype: torch.dtype):
    """(nharm, ...) sums over the last axis of cos and sin of 2 pi k frac."""
    acc = _F64 if dtype == _F64 else torch.float32
    c_sums, s_sums = [], []
    for k in range(1, nharm + 1):
        ang = (2 * math.pi * k) * frac
        c, s = torch.cos(ang), torch.sin(ang)
        if dtype != _F64:
            c, s = c.to(dtype), s.to(dtype)
        c_sums.append(c.to(acc).sum(-1).to(_F64))
        s_sums.append(s.to(acc).sum(-1).to(_F64))
    return torch.stack(c_sums), torch.stack(s_sums)


def centred(sec: torch.Tensor) -> torch.Tensor:
    """Times centred on the middle of their (sorted) span."""
    return sec - (sec[0] + sec[-1]) / 2


def z2_trials(sec: torch.Tensor, freqs: torch.Tensor, fdots: torch.Tensor, nharm: int,
              dtype: torch.dtype = _F64, pairs_per_block: int = 1 << 25) -> torch.Tensor:
    """Z^2_n at each trial (freqs[i], fdots[i]) over float64 times ``sec``
    (seconds, sorted); float64 result."""
    t = centred(sec.to(_F64))
    n = t.numel()
    block = max(1, pairs_per_block // max(n, 1))
    out = []
    for lo in range(0, freqs.numel(), block):
        f = freqs[lo:lo + block, None].to(_F64)
        fd = fdots[lo:lo + block, None].to(_F64)
        ph = f * t + 0.5 * fd * t * t
        frac = ph - torch.floor(ph)
        c, s = _harmonic_sums(frac, nharm, dtype)
        out.append(torch.sum(c * c + s * s, dim=0) * (2.0 / n))
    return torch.cat(out)


def h_rows(sec_rows: list[torch.Tensor], freqs: torch.Tensor, nharm: int, dtype: torch.dtype = _F64) -> torch.Tensor:
    """H-test power of each row of event times (seconds, already centred)
    at that row's frequency, no frequency derivative."""
    out = []
    for t, f in zip(sec_rows, freqs):
        ph = f.to(_F64) * t.to(_F64)
        frac = ph - torch.floor(ph)
        c, s = _harmonic_sums(frac, nharm, dtype)
        z = torch.cumsum((c * c + s * s) * (2.0 / t.numel()), dim=0)
        out.append(torch.max(z - 4.0 * torch.arange(nharm, dtype=_F64, device=z.device)))
    return torch.stack(out)
