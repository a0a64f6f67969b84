"""Batched optimizers for the fitting engines.

Port of ``crimp_tpu/ops/optimize.py``. ``vmap`` becomes leading batch
dimensions: every routine works on independent problems stacked along the
leading axes and keeps each problem's arithmetic identical to a lone run.

- ``golden_section``: 1-D bounded maximization (log-likelihood profiles);
- ``nelder_mead``: fixed-iteration simplex minimization, optionally
  recording every step's sort, values and decision (K6's trace codes);
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


def nelder_mead(fn, x0: torch.Tensor, init_scale=0.1, iters: int = 200, trace: list | None = None):
    """Fixed-iteration Nelder-Mead minimization of ``fn`` from ``x0``.

    ``x0`` is (..., n) for a batch of independent problems; ``fn`` maps
    points (..., m, n) to values (..., m) for any m. Branch-free: each step
    evaluates the reflect/expand/contract candidates and selects per problem,
    with a conditional shrink. The centroid is ``centroid``'s fixed order
    (JAX's ``jnp.mean`` to rounding). The vertices' stable sort is the order
    of K6's insertion sort (``csrc/toafit_general.cu``). ``trace``, a list,
    gets one dict a step: ``order`` (..., n + 1) the sort, ``fvals`` the
    sorted values, ``f_c`` (..., 4) the candidates' values, ``step`` (...)
    the decision coded as K6's trace (0 expand, 1 reflect, 2 outside, 3
    inside contraction, 4 shrink) and ``reads`` (...) the candidate values
    the decision read (``candidate_reads``). Returns (x_best (..., n),
    f_best (...)).
    """
    n = x0.shape[-1]
    eye = torch.eye(n, dtype=x0.dtype, device=x0.device)
    simplex = torch.cat([x0[..., None, :], x0[..., None, :] + eye * init_scale], dim=-2)
    fvals = fn(simplex)
    for _ in range(iters):
        order = torch.argsort(fvals, dim=-1, stable=True)
        simplex = torch.gather(simplex, -2, order[..., None].expand_as(simplex))
        fvals = torch.gather(fvals, -1, order)
        cands = _candidates(simplex)
        f_c = fn(cands)
        x_reflect, x_expand, x_out, x_in = cands.unbind(-2)
        f_reflect, f_expand, f_out, f_in = f_c.unbind(-1)
        use_expand, use_reflect, use_out, use_in, shrink = _decide(fvals, f_c)
        if trace is not None:
            step = torch.where(use_expand, 0, torch.where(use_reflect, 1, torch.where(
                use_out, 2, torch.where(use_in, 3, 4))))
            trace.append({"order": order, "fvals": fvals, "f_c": f_c, "step": step,
                          "reads": candidate_reads(fvals, f_c)})

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


def centroid(simplex: torch.Tensor) -> torch.Tensor:
    """Centroid of all vertices but the last of (..., n + 1, n) sorted
    simplices, in a fixed order: ((v_0 + v_1) + ... + v_{n-1}) * (1 / n),
    the same bits on every device and in K6."""
    n = simplex.shape[-1]
    total = simplex[..., 0, :]
    for i in range(1, n):
        total = total + simplex[..., i, :]
    return total * (1.0 / n)


def _candidates(simplex: torch.Tensor) -> torch.Tensor:
    """(..., 4, n): reflect, expand, outside and inside contraction of the
    worst (last) vertex of sorted simplices through their centroid."""
    c = centroid(simplex)
    direction = c - simplex[..., -1, :]
    return torch.stack([c + direction, c + 2.0 * direction, c + 0.5 * direction, c - 0.5 * direction], dim=-2)


def _decide(fvals: torch.Tensor, f_c: torch.Tensor):
    """The decision tree on sorted values (..., n + 1) and the candidates'
    (..., 4): (use_expand, use_reflect, use_out, use_in, shrink)."""
    best_f, worst_f, second_worst_f = fvals[..., 0], fvals[..., -1], fvals[..., -2]
    f_reflect, f_expand, f_out, f_in = f_c.unbind(-1)
    use_expand = (f_reflect < best_f) & (f_expand < f_reflect)
    use_reflect = (~use_expand) & (f_reflect < second_worst_f)
    use_out = (~use_expand) & (~use_reflect) & (f_reflect < worst_f) & (f_out <= f_reflect)
    use_in = (~use_expand) & (~use_reflect) & (~use_out) & (f_in < worst_f)
    shrink = ~(use_expand | use_reflect | use_out | use_in)
    return use_expand, use_reflect, use_out, use_in, shrink


def candidate_reads(fvals: torch.Tensor, f_c: torch.Tensor) -> torch.Tensor:
    """The candidate values ``_decide``'s tree reads, as a lazy Nelder-Mead
    evaluates them: f_reflect; f_expand where f_reflect beats the best;
    past the reflect, f_out where f_reflect beats the worst and f_in where
    the outside contraction is not taken. (...) int64, 1 to 3."""
    use_expand, use_reflect, use_out, _, _ = _decide(fvals, f_c)
    past = ~(use_expand | use_reflect)
    f_reflect = f_c[..., 0]
    return (1 + (f_reflect < fvals[..., 0]).long() + (past & (f_reflect < fvals[..., -1])).long()
            + (past & ~use_out).long())


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
