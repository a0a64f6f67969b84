"""K5, the ToA fit's profile kernel: f64 operations and bytes of a fit.

Frozen from the program's ``obs/costmodel.k5_counts`` and
``k5_golden_counts`` as they stood when the benchmark was defined. One
profile evaluation of a (row, phase shift) over a row's masked events
costs, per masked event, f64 operations counted one each (an add, a multiply, a
comparison, a division, an exp, a log and a cos: a true lower bound, since
on the card each of the last four is several instructions):

- the Fourier shape term, 2K products and 2K sums: 4K;
- the masked minimum: 1;
- the norm solve, 20 Newton steps of 5 (A + s, its inverse, the square,
  two sums);
- the log-likelihood: 6 (A + b s as 2, the minimum, the clamp, log, sum).

The per-row work that does not scale with the shifts (the events'
harmonic coefficients) is left out. Bytes of a sweep over S rows and P
shifts: the phases (8) and mask (1) of every masked event, the exposures,
the shifts, the template, and LL, A and b written. Rows hold different
numbers of events, so every count sums over the rows' own.

A fit of S rows evaluates, as the plain algorithm does on these inputs:
the brute grid (S x n_brute), the golden-section refine (S x (2 + 2 x
refine_iters), each a one-shift sweep), the first error window (S x 2 x
32) and the error-scan shifts past it (which the reference counts).
"""

NEWTON_ITERS = 20
DENSE_WINDOW = 32


def ops_per_event(n_comp: int) -> int:
    return 4 * n_comp + 1 + 5 * NEWTON_ITERS + 6


def sweep_counts(row_events, n_phis: float, n_comp: int) -> dict:
    """One sweep of every row at ``n_phis`` shifts; ``row_events`` the
    rows' (masked) event counts."""
    S, P, E = float(len(row_events)), float(n_phis), float(sum(row_events))
    return {"flops": P * E * ops_per_event(n_comp),
            "bytes": E * 9 + S * 8 + S * P * 8 + 8 * (3 * n_comp + 2) + 3 * S * P * 8,
            "dtype": "f64"}


def fit_counts(row_events, n_comp: int, n_brute: int, refine_iters: int, loop_shifts: float,
               loop_events: float) -> dict:
    """Every K5 evaluation of one fit; ``loop_shifts`` the (row, shift)
    pairs the error scan evaluated past its first window, ``loop_events``
    the events those pairs' rows hold, summed over the pairs."""
    parts = [sweep_counts(row_events, n_brute, n_comp),
             sweep_counts(row_events, 1, n_comp)]
    parts[1] = {k: (v * (2 + 2 * refine_iters) if k != "dtype" else v) for k, v in parts[1].items()}
    parts.append(sweep_counts(row_events, 2 * DENSE_WINDOW, n_comp))
    parts.append({"flops": float(loop_events) * ops_per_event(n_comp),
                  "bytes": float(loop_events) * 9 + float(loop_shifts) * 4 * 8})
    return {"flops": sum(p["flops"] for p in parts), "bytes": sum(p["bytes"] for p in parts), "dtype": "f64"}
