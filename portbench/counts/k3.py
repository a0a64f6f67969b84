"""K3, the general-grid Z^2 kernel: f32 operations and bytes of one scan.

Frozen from the program's ``z2_general.ops_per_pair`` (f32 trig, the
polynomial sin/cos, no derivative term) as it stood when the
``blind_1e7.nonuniform`` cell was defined: the fewest operations K3's
algorithm spends per (trial, event) pair, a fused multiply-add counted as 2.

- f32: the cast of the reduced phase 1, the polynomial sin/cos 24, the
  first harmonic's two sums 2 and 2 cos 1, and 6 for each further harmonic
  (two recurrences as FMAs, two sums): 28 + 6 (nharm - 1), 34 at nharm 2;
- f64: the product f*t 1 and the centred fraction 3 (floor, subtract,
  conditional subtract), 4 a pair.

The f32 part binds: at nharm 2 a pair's 34 f32 operations take 34 / 67e12
s at the card's f32 peak, its 4 f64 ones 4 / 34e12 s at the f64 peak,
under a quarter of that (10^12 pairs: 0.507 s against 0.118 s). Bytes:
the f64 event times and trial frequencies, one f64 coefficient a row, and
the f64 sums written (C and S for each harmonic of each trial).
"""

def ops_per_pair(nharm: int) -> float:
    """f32 operations a pair."""
    return 28 + 6 * (nharm - 1)


def scan_counts(n_events: int, n_freq: int, n_rows: int, nharm: int) -> dict:
    """One scan of ``n_freq`` frequencies by ``n_rows`` derivative rows."""
    n_trials = int(n_freq) * int(n_rows)
    return {"flops": float(n_trials) * n_events * ops_per_pair(nharm),
            "bytes": float(8 * n_events + 8 * n_freq + 8 * n_rows + 2 * nharm * n_trials * 8), "dtype": "f32"}
