"""K6, the readvaryparam fit's Nelder-Mead kernels: a lower bound on the
f64 operations and bytes of one ``-rv`` fit.

Each (row, phase) problem is a bounded Nelder-Mead of ``nm_iters`` steps
over the F free template parameters. The plain algorithm evaluates the
F + 1 vertices of the starting simplex and then, each step, at least one
point (the reflection); expansions, contractions and shrinks add more,
as the data decide. So F + 1 + nm_iters evaluations a problem is the
fewest any run makes, and the count is a lower bound: the share of the
roofline it gives cannot pass the true one. One evaluation of a
Fourier template over a row's masked event costs, counted one each, 5K +
6 f64 operations: K products a_k C_k, K products b_k S_k and their 2K - 1
sums with the norm, the division by the norm, the log, the sum, the
masked minimum, the comparison and the add of the next term (the events'
harmonic pairs, once a row, and the per-vertex (a_k, b_k) are left out).

A fit of S rows solves, as the plain algorithm does on these inputs:
``n_brute`` problems a row (the brute grid), 2 + 2 ``refine_iters`` (the
golden section's points), and 2 ``dense_window`` (the error scan's first
window; the later passes, which the data decide, are left out). Bytes: a
launch of each of the three reads every masked event's phase and mask
(9 bytes) at least once.
"""


def ops_per_event(n_comp: int) -> int:
    return 5 * n_comp + 6


def fit_counts(row_events, n_comp: int, n_free: int, nm_iters: int, n_brute: int, refine_iters: int,
               dense_window: int) -> dict:
    """The lower bound over one fit of rows holding ``row_events`` events."""
    events = float(sum(row_events))
    problems = n_brute + 2 + 2 * refine_iters + 2 * dense_window
    evaluations = n_free + 1 + nm_iters
    return {"flops": events * problems * evaluations * ops_per_event(n_comp), "bytes": 3 * 9 * events,
            "dtype": "f64"}
