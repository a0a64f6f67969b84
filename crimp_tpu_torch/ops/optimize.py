"""Batched optimizers for the fitting engines.

Port of ``crimp_tpu/ops/optimize.py``. ``vmap`` becomes leading batch
dimensions: every routine works on independent problems stacked along the
leading axes and keeps each problem's arithmetic identical to a lone run.

- ``golden_section``: 1-D bounded maximization (log-likelihood profiles);
- ``nelder_mead``: fixed-iteration simplex minimization;
- ``bounded_transform``: min/max <-> unbounded sigmoid reparameterization.
"""

from __future__ import annotations

import torch

PHI = (5.0**0.5 - 1) / 2  # golden ratio conjugate


def golden_section(fn, lo, hi, iters: int = 60, maximize: bool = True):
    """Golden-section search on [lo, hi]; returns (x_best, f_best).

    ``fn`` maps a batch of scalars (any shape) to objective values of the
    same shape; lo/hi carry that batch shape.
    """
    sign = 1.0 if maximize else -1.0

    def value(x):
        return sign * fn(x)

    a, b = lo, hi
    x1 = hi - PHI * (hi - lo)
    x2 = lo + PHI * (hi - lo)
    f1, f2 = value(x1), value(x2)
    for _ in range(iters):
        shrink_right = f1 > f2  # keep [a, x2]
        a, b = torch.where(shrink_right, a, x1), torch.where(shrink_right, x2, b)
        x1 = b - PHI * (b - a)
        x2 = a + PHI * (b - a)
        f1, f2 = value(x1), value(x2)
    x_best = torch.where(f1 > f2, x1, x2)
    return x_best, sign * torch.maximum(f1, f2)


def nelder_mead(fn, x0: torch.Tensor, init_scale=0.1, iters: int = 200):
    """Fixed-iteration Nelder-Mead minimization of ``fn`` from ``x0``.

    ``x0`` is (..., n) for a batch of independent problems; ``fn`` maps
    points (..., m, n) to values (..., m) for any m. Branch-free: each step
    evaluates the reflect/expand/contract candidates and selects per problem,
    with a conditional shrink. Returns (x_best (..., n), f_best (...)).
    """
    n = x0.shape[-1]
    eye = torch.eye(n, dtype=x0.dtype, device=x0.device)
    simplex = torch.cat([x0[..., None, :], x0[..., None, :] + eye * init_scale], dim=-2)
    fvals = fn(simplex)
    for _ in range(iters):
        order = torch.argsort(fvals, dim=-1, stable=True)
        simplex = torch.gather(simplex, -2, order[..., None].expand_as(simplex))
        fvals = torch.gather(fvals, -1, order)
        best_f, worst_f, second_worst_f = fvals[..., 0], fvals[..., -1], fvals[..., -2]
        centroid = torch.mean(simplex[..., :-1, :], dim=-2)
        direction = centroid - simplex[..., -1, :]

        cands = torch.stack([
            centroid + direction,        # reflect
            centroid + 2.0 * direction,  # expand
            centroid + 0.5 * direction,  # outside contraction
            centroid - 0.5 * direction,  # inside contraction
        ], dim=-2)
        f_c = fn(cands)
        x_reflect, x_expand, x_out, x_in = cands.unbind(-2)
        f_reflect, f_expand, f_out, f_in = f_c.unbind(-1)

        use_expand = (f_reflect < best_f) & (f_expand < f_reflect)
        use_reflect = (~use_expand) & (f_reflect < second_worst_f)
        use_out = (~use_expand) & (~use_reflect) & (f_reflect < worst_f) & (f_out <= f_reflect)
        use_in = (~use_expand) & (~use_reflect) & (~use_out) & (f_in < worst_f)
        shrink = ~(use_expand | use_reflect | use_out | use_in)

        candidate = torch.where(
            use_expand[..., None], x_expand,
            torch.where(use_reflect[..., None], x_reflect,
                        torch.where(use_out[..., None], x_out, x_in)),
        )
        f_candidate = torch.where(
            use_expand, f_expand,
            torch.where(use_reflect, f_reflect, torch.where(use_out, f_out, f_in)),
        )
        replaced = torch.cat([simplex[..., :-1, :], candidate[..., None, :]], dim=-2)
        replaced_f = torch.cat([fvals[..., :-1], f_candidate[..., None]], dim=-1)
        shrunk = simplex[..., :1, :] + 0.5 * (simplex - simplex[..., :1, :])
        shrunk_f = fn(shrunk)

        simplex = torch.where(shrink[..., None, None], shrunk, replaced)
        fvals = torch.where(shrink[..., None], shrunk_f, replaced_f)
    i_best = torch.argmin(fvals, dim=-1, keepdim=True)
    x_best = torch.gather(simplex, -2, i_best[..., None].expand(*simplex.shape[:-2], 1, n))[..., 0, :]
    return x_best, torch.gather(fvals, -1, i_best)[..., 0]


class bounded_transform:
    """Box-bound reparameterization: x = lo + (hi-lo)*sigmoid(u)."""

    def __init__(self, lo, hi):
        self.lo = torch.as_tensor(lo, dtype=torch.float64)
        self.hi = torch.as_tensor(hi, dtype=torch.float64)

    def to_bounded(self, u):
        return self.lo.to(u.device) + (self.hi - self.lo).to(u.device) * torch.sigmoid(u)

    def to_unbounded(self, x):
        lo, hi = self.lo.to(x.device), self.hi.to(x.device)
        frac = torch.clamp((x - lo) / (hi - lo), 1e-12, 1 - 1e-12)
        return torch.log(frac) - torch.log1p(-frac)
