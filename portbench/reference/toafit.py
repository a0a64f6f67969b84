"""Plain unbinned maximum-likelihood ToA fit (CRIMP's ``measureToAs``).

For each ToA interval's folded phases x_i (cycles) and exposure T, the
Fourier template's shape at a phase shift phi is
s_i(phi) = sum_k amp_k cos(2 pi k x_i + ph_k - k phi), and the extended
log-likelihood with the norm A re-optimised at each shift is

    LL(phi) = max_A  -A T + N log T + sum_i log(A + s_i(phi)),

A kept in [0.01 norm, 500] and above -min_i s_i. The fit, as the program
and CRIMP define it:

1. a brute grid of ``n_brute`` shifts over [-pi, pi], its first maximum phi0;
2. a golden-section search of ``refine_iters`` rounds on
   [phi0 - h, phi0 + h], h the grid step, whose better final point is the
   ToA's phShift and its LL the maximum;
3. the 1-sigma bounds: stepping phi by 2 pi / ``ph_shift_res`` away from
   phShift on each side until LL drops by more than chi2_1(0.6827) / 2;
   the bound is (k* + 1) step + step / 2 for the first such step k*
   (saturating at half a turn).

The norm solve is 20 Newton steps on dLL/dA = sum_i 1/(A + s_i) - T,
clamped to the box each step. Everything runs in ``dtype`` (float64, as
the configuration states; float32 for the control), in plain torch over
(rows, shifts, events) blocks. ``loop_shifts`` counts the error-scan shifts
evaluated past the first window, and ``loop_events`` the events of their
rows summed over them (the roofline counts need both).
"""

from __future__ import annotations

import math

import numpy as np
import torch

CHI2_1SIG_HALF = 0.4999320306186937  # 0.5 * chi2.ppf(0.6827, df=1)
PHI = (5.0**0.5 - 1) / 2
NEWTON_ITERS = 20
NORM_LO_FRAC = 0.01
NORM_HI = 500.0
DENSE_WINDOW = 32
ERR_CHUNK = 32


class Fit:
    """The fit of S rows of folded phases x (S, N) with masks (S, N) and
    exposures (S,), all tensors on one device."""

    def __init__(self, template: dict, x: torch.Tensor, mask: torch.Tensor, exposure: torch.Tensor,
                 dtype: torch.dtype = torch.float64, pairs_per_block: int = 1 << 23):
        kw = dict(dtype=dtype, device=x.device)
        self.dtype = dtype
        self.x = x.to(dtype)
        self.mask = mask
        self.T = exposure.to(dtype)
        self.n = mask.sum(-1).to(dtype)
        self.amp = torch.as_tensor(template["amp"], **kw)
        self.ph = torch.as_tensor(template["ph"], **kw)
        self.j = torch.arange(1, self.amp.numel() + 1, **kw)
        self.lo = NORM_LO_FRAC * float(template["norm"])
        self.pairs_per_block = pairs_per_block
        self.evaluations = 0  # (row, shift) profile evaluations made

    def _shape(self, x, phis):
        """s (R, P, N) for rows' events x (R, N) at shifts phis (R, P)."""
        ang = (2 * math.pi) * self.j * x[:, None, :, None] + self.ph - self.j * phis[:, :, None, None]
        return torch.sum(self.amp * torch.cos(ang), dim=-1)

    def _block(self, x, mask, T, n, phis):
        s = self._shape(x, phis)
        m = mask[:, None, :]
        big = torch.tensor(math.inf, dtype=self.dtype, device=x.device)
        min_s = torch.where(m, s, big).amin(-1)
        floor = torch.clamp(-min_s * (1 + 1e-9) + 1e-12, min=self.lo)
        a = torch.minimum(torch.maximum((n / T)[:, None].expand_as(floor), floor), torch.full_like(floor, NORM_HI))
        for _ in range(NEWTON_ITERS):
            inv = torch.where(m, 1.0 / (a[..., None] + s), 0.0)
            g = inv.sum(-1) - T[:, None]
            gp = -(inv * inv).sum(-1)
            a = torch.clamp(torch.maximum(a - g / gp, floor), max=NORM_HI)
        vals = a[..., None] + s
        positive = torch.where(m, vals, big).amin(-1) > 0
        log_sum = torch.where(m, torch.log(torch.clamp(vals, min=1e-300 if self.dtype == torch.float64 else 1e-38)),
                              0.0).sum(-1)
        ll = -a * T[:, None] + (n * torch.log(T))[:, None] + log_sum
        return torch.where(positive, ll, -big), a

    def profile(self, rows: torch.Tensor, phis: torch.Tensor) -> torch.Tensor:
        """LL (R, P) of ``rows`` at shifts ``phis`` (R, P)."""
        phis = phis.to(self.dtype)
        R, P = phis.shape
        self.evaluations += R * P
        per = max(1, self.pairs_per_block // max(self.x.shape[1] * R, 1))
        x, mask, T, n = self.x[rows], self.mask[rows], self.T[rows], self.n[rows]
        return torch.cat([self._block(x, mask, T, n, phis[:, lo:lo + per])[0] for lo in range(0, P, per)], dim=1)

    def norm_at(self, rows: torch.Tensor, phis: torch.Tensor) -> torch.Tensor:
        """The fitted norm A (R,) of ``rows`` at one shift each."""
        return self._block(self.x[rows], self.mask[rows], self.T[rows], self.n[rows], phis.to(self.dtype)[:, None])[1][:, 0]

    def run(self, n_brute: int = 128, refine_iters: int = 25, ph_shift_res: int = 1000) -> dict:
        S = self.x.shape[0]
        dev = self.x.device
        rows = torch.arange(S, device=dev)
        grid = torch.as_tensor(np.linspace(-math.pi, math.pi, n_brute), dtype=self.dtype, device=dev)
        ll = self.profile(rows, grid.expand(S, n_brute))
        phi0 = grid[torch.argmax(ll, dim=1)]
        h = 2 * math.pi / (n_brute - 1)
        phi, ll_max = self._golden(rows, phi0 - h, phi0 + h, refine_iters)
        lo, hi, loop_shifts, loop_events = self._bounds(phi, ll_max, ph_shift_res)
        return {"phShift": phi, "phShift_LL": lo, "phShift_UL": hi, "logLmax": ll_max,
                "loop_shifts": loop_shifts, "loop_events": loop_events}

    def _golden(self, rows, a, b, iters):
        def f(x):
            return self.profile(rows, x[:, None])[:, 0]

        x1 = b - PHI * (b - a)
        x2 = a + PHI * (b - a)
        f1, f2 = f(x1), f(x2)
        for _ in range(iters):
            keep_left = f1 > f2
            a, b = torch.where(keep_left, a, x1), torch.where(keep_left, x2, b)
            x1 = b - PHI * (b - a)
            x2 = a + PHI * (b - a)
            f1, f2 = f(x1), f(x2)
        return torch.where(f1 > f2, x1, x2), torch.maximum(f1, f2)

    def _bounds(self, phi, ll_max, ph_shift_res):
        """Each side's first step whose LL drop passes the threshold: the
        first DENSE_WINDOW steps of every row at once, then ERR_CHUNK steps
        at a time for the rows still inside."""
        S = phi.shape[0]
        dev = phi.device
        step = 2 * math.pi / ph_shift_res
        max_k = ph_shift_res // 2
        loop_shifts, loop_events = 0, 0.0
        out = []
        for sign in (-1.0, 1.0):
            kstop = torch.full((S,), max_k + 1, dtype=torch.long, device=dev)
            found = torch.zeros(S, dtype=torch.bool, device=dev)
            k0 = 0
            width = min(DENSE_WINDOW, max_k)
            rows = torch.arange(S, device=dev)
            while rows.numel():
                ks = k0 + 1 + torch.arange(width, device=dev)
                phis = phi[rows, None] + sign * ks.to(self.dtype) * step
                crossed = ((ll_max[rows, None] - self.profile(rows, phis)) > CHI2_1SIG_HALF) & (ks <= max_k)
                if k0:
                    loop_shifts += rows.numel() * width
                    loop_events += float(self.n[rows].sum()) * width
                hit = crossed.any(-1)
                first = ks[torch.argmax(crossed.to(torch.uint8), dim=-1)]
                kstop[rows[hit]] = first[hit] + 1
                found[rows[hit]] = True
                k0 += width
                width = ERR_CHUNK
                rows = torch.nonzero(~found & (k0 < max_k)).flatten()
            out.append(kstop.to(self.dtype) * step + step / 2)
        return out[0], out[1], loop_shifts, loop_events
