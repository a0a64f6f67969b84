"""The shared A/B measurement workload.

Port of ``crimp_tpu/utils/benchwork.py``: the launch-plan tuner
(``ops/autotune.tune``) and any A/B of the search kernels measure the same
problem, 8e5 events x 1e5 trials on a uniform grid around the
1E 2259+586 spin frequency (seed 7), best of N timed runs after one warm-up,
with the card synchronized before every clock read.
"""

from __future__ import annotations

import time

import numpy as np
import torch

AB_N_EVENTS = 800_000
AB_N_TRIALS = 100_000
AB_SEED = 7


def ab_workload(n_events: int = AB_N_EVENTS, n_trials: int = AB_N_TRIALS, seed: int = AB_SEED):
    """(sec, freqs, f0, df): the canonical A/B scan problem (host arrays)."""
    from crimp_tpu_torch.ops import search

    rng = np.random.RandomState(seed)
    sec = np.sort(rng.uniform(-4e5, 4e5, n_events))
    freqs = np.linspace(0.1430, 0.1436, n_trials)
    f0, df = search.uniform_grid(freqs)
    return sec, freqs, f0, df


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def best_rate(fn, n_trials: int, repeats: int = 3, device="cpu") -> float:
    """trials/s from the best of ``repeats`` timed runs after one warm-up;
    the card is synchronized before each clock read."""
    fn()
    _sync(device)
    best = np.inf
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        _sync(device)
        best = min(best, time.perf_counter() - t0)
    return n_trials / best


def candidate_rate(kernel: str, sec, freqs, f0, df, n_trials: int, nharm: int, event_block: int,
                   trial_block: int, poly: bool, repeats: int = 3, device="cuda") -> float:
    """trials/s of ONE (event_block, trial_block) launch plan on the A/B
    problem, the measurement the tuner ranks with. "grid" times K2's 1-D
    sums, "grid3d" the cube over a small (fdot, fddot) cross (cube trials/s),
    "general" K3, "grid_mxu" the factorized path; for K2 and K3 the pair is
    (split length, the kernel's trial tile)."""
    from crimp_tpu_torch.ops import autotune, search

    dev = torch.device(device)
    if kernel in ("grid", "grid3d", "general") and trial_block != autotune.fixed_trial_block(kernel):
        raise ValueError(f"{kernel}: the trial tile is fixed at {autotune.fixed_trial_block(kernel)}, "
                         f"not {trial_block}")
    times = torch.as_tensor(np.asarray(sec, dtype=np.float64)).to(dev)
    if kernel == "grid":
        fn = lambda: search.harmonic_sums_2d_grid(  # noqa: E731
            times, float(f0), float(df), int(n_trials), [0.0], nharm, poly=poly, mxu=False,
            per_split=int(event_block), device=dev)
    elif kernel == "grid_mxu":
        fn = lambda: search.harmonic_sums_uniform_mxu(  # noqa: E731
            times, float(f0), float(df), int(n_trials), nharm, event_block=int(event_block),
            trial_block=int(trial_block), poly=poly, device=dev)
    elif kernel == "grid3d":
        fdots = [-9.2e-14, -9.3e-14, -9.4e-14, -9.5e-14]
        fddots = [-1e-20, 1e-20]
        n_freq = max(int(trial_block), int(n_trials) // 8)
        fn = lambda: search.harmonic_sums_3d_grid(  # noqa: E731
            times, float(f0), float(df), n_freq, fdots, fddots, nharm, poly=poly, mxu=False,
            per_split=int(event_block), device=dev)
        return best_rate(fn, n_freq * 4 * 2, repeats=repeats, device=dev)
    elif kernel == "general":
        freqs_dev = torch.as_tensor(np.asarray(freqs, dtype=np.float64)).to(dev)
        fn = lambda: search.general_harmonic_sums(  # noqa: E731
            times, freqs_dev, nharm=nharm, poly=poly, per_split=int(event_block), device=dev)
    else:
        raise ValueError(f"unknown kernel variant {kernel!r}")
    return best_rate(fn, int(n_trials), repeats=repeats, device=dev)
