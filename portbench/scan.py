"""The (nu, log10 |nudot|) trial grid a configuration's ``scan`` states.

Rows of a 2-D scan run as CRIMP's ``twod_ztest`` orders them: the outer
loop over nudot, the inner over nu, nudot applied as -10**x (spin-down).
``check_indices`` picks the trials the check compares.
"""

from __future__ import annotations

import numpy as np


def axes(scan: dict) -> tuple[np.ndarray, np.ndarray]:
    """(frequencies in Hz, log10 |nudot|)."""
    return (np.linspace(scan["freq_lo"], scan["freq_hi"], scan["n_freq"]),
            np.linspace(scan["log_fdot_lo"], scan["log_fdot_hi"], scan["n_fdot"]))


def n_trials(scan: dict) -> int:
    return int(scan["n_freq"]) * int(scan["n_fdot"])


def trials(scan: dict, index: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(nu, nudot) of the grid's rows ``index``."""
    freqs, log_fdots = axes(scan)
    index = np.asarray(index)
    return freqs[index % scan["n_freq"]], -(10.0 ** log_fdots[index // scan["n_freq"]])


def check_indices(scan: dict, seed: int, set_index: int, n_sets: int, n_random: int, stride: int,
                  edge_rows: int) -> np.ndarray:
    """The grid rows the check compares for event set ``set_index`` of
    ``n_sets``, drawn from the seed. Blocks are runs of ``stride``
    frequencies in one nudot row (a tiling by ``stride`` or a multiple of
    it has its tiles' edges among theirs), the last block ragged. Every
    set takes: every nudot row's first and last trial (the grid's edges);
    the first and last trial of every block in ``edge_rows`` nudot rows
    spread over the grid (other rows for each set); one trial at random in
    each block whose block and row numbers sum to ``set_index`` modulo
    ``n_sets``, so the sets together take one in every block of every row;
    every trial of the last block in one row; and ``n_random`` distinct
    trials at random."""
    n_freq, n_fdot = int(scan["n_freq"]), int(scan["n_fdot"])
    rng = np.random.default_rng([int(seed) % 2**63, 7, int(set_index)])
    rows = np.arange(n_fdot)
    picks = [rows * n_freq, rows * n_freq + n_freq - 1]
    starts = np.arange(0, n_freq, int(stride))
    ends = np.minimum(starts + int(stride), n_freq) - 1
    spread = -(-n_fdot // int(edge_rows))
    for q in range(int(edge_rows)):
        row = (np.arange(starts.size) + q * spread + int(set_index)) % n_fdot
        picks += [row * n_freq + starts, row * n_freq + ends]
    block, row = np.meshgrid(np.arange(starts.size), rows, indexing="ij")
    mine = (block + row) % int(n_sets) == int(set_index) % int(n_sets)
    block, row = block[mine], row[mine]
    offset = np.floor(rng.random(block.size) * (ends[block] - starts[block] + 1)).astype(np.int64)
    picks.append(row * n_freq + starts[block] + offset)
    picks.append(int(rng.integers(n_fdot)) * n_freq + np.arange(starts[-1], n_freq))
    picks.append(rng.choice(n_trials(scan), size=min(int(n_random), n_trials(scan)), replace=False))
    return np.unique(np.concatenate(picks))
