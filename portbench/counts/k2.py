"""K2, the uniform-grid Z^2 kernel: f32 operations and bytes of one scan.

Frozen from the program's ``z2_grid.flops_per_pair`` as it stood when the
benchmark was defined: the fewest f32 operations K2's algorithm spends per
(trial, event) pair, a fused multiply-add counted as 2. With R the
consecutive trials a thread owns (8 at nharm <= 2, 4 at <= 5, else 2):

- every trial: the first harmonic's two sums 2, 2 cos 1, and 6 for each
  further harmonic (two recurrences as FMAs, two sums): 3 + 6 (nharm - 1);
- the rotation to the next trial (two products, two FMAs) 6, for R - 1 of
  R trials;
- the start angle once for R trials: the phase's multiply and add 2, the
  f32 centred fraction 3, the polynomial sin/cos 24;
- once an event and 256-trial tile row: the f32 add of the base 1 and the
  rotation pair's sin/cos 24, shared by a block's R pairs.

So 17.89 at nharm 2. Bytes: the f64 event times, one f64 coefficient a
nudot row, and the f32 sums written (2 x nharm a trial, the tiles padded
to 256 frequencies).
"""

TRIAL_TILE = 256


def trials_per_thread(nharm: int) -> int:
    return 8 if nharm <= 2 else (4 if nharm <= 5 else 2)


def flops_per_pair(nharm: int) -> float:
    r = trials_per_thread(nharm)
    return 3 + 6 * (nharm - 1) + (6 * (r - 1) + 29) / r + (1 + 24 / r) / TRIAL_TILE


def scan_counts(n_events: int, n_freq: int, n_rows: int, nharm: int) -> dict:
    """One 2-D scan of ``n_freq`` frequencies by ``n_rows`` nudot rows."""
    n_tiles = -(-int(n_freq) // TRIAL_TILE)
    out_bytes = 4 * 2 * n_rows * n_tiles * nharm * TRIAL_TILE
    return {"flops": float(n_freq) * n_rows * n_events * flops_per_pair(nharm),
            "bytes": float(8 * n_events + 8 * n_rows + out_bytes), "dtype": "f32"}
