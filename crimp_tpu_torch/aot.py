"""Warm-up: build and first-launch the hot kernels before a timed window.

Port of ``crimp_tpu/aot.py``. JAX lowers and compiles each jitted kernel
ahead of time; the port's equivalent is the work a first call pays:

- the nvcc build of every hand kernel (``z2_grid.build``, reused from the
  build directory when the sources have not changed);
- one launch of K2 at the real shapes under the resolved launch plan, for
  each trig path asked (and of K3 where asked: ``general=True``, or an
  nharm K2 cannot take), which loads the module and its instantiations;
- the MCMC's CUDA-graph capture at its shapes;
- one call of the batched ToA fit at its shapes (K5's profile sweeps on
  the card).

``warmup`` returns JAX's report: ``targets`` (name -> {"s": seconds} or
{"error": ...}), ``total_s`` and ``counters`` (what was compiled:
``utils/profiling.compile_counters`` deltas). A target that fails records
its error and the rest go on, except a ``resilience.KernelError`` (no nvcc,
a failed build, a launch's CUDA error), which propagates.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from crimp_tpu_torch import resilience
from crimp_tpu_torch.utils.device import resolve_device, synchronize
from crimp_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


def _target(report: dict, name: str, dev: torch.device, fn, *args, **kwargs) -> None:
    """Run one warm-up target to completion; record its seconds or error."""
    t0 = time.perf_counter()
    try:
        fn(*args, **kwargs)
        synchronize(dev)
        report["targets"][name] = {"s": round(time.perf_counter() - t0, 3)}
    except resilience.KernelError:
        raise
    except Exception as exc:  # graftlint: disable=GL006 (warmup is pre-run: a failed build or launch means the kernel pays its cost at first use; the error string is the report, there is no retry/degradation decision to feed)
        report["targets"][name] = {"error": f"{type(exc).__name__}: {str(exc)[:200]}"}
        logger.warning("warmup target %s failed: %s", name, exc)


def warmup(n_events: int, n_trials: int, nharm: int = 2, n_fdot: int = 0, n_freq_2d: int | None = None,
           poly: bool | None = None, toa: dict | None = None, mcmc: dict | bool | None = None,
           general: bool = False, device=None) -> dict:
    """Build and first-launch the hot kernels for the given problem shapes.

    - K2's 1-D sums at (n_events, n_trials), under ``autotune``'s plan;
      ``poly=None`` warms both trig paths;
    - K2's (f, fdot) grid when ``n_fdot`` > 0 (``n_freq_2d`` frequencies,
      default ``n_trials``);
    - K3 at (n_events, n_trials) with ``general`` or nharm above K2's 20;
    - the batched ToA fit when ``toa`` is given: a dict with ``tpl``
      (ProfileParams), ``n_segments``, ``n_events_max`` and optionally
      ``kind``/``cfg``;
    - the ensemble MCMC when ``mcmc`` is given: True for 32 walkers, 3
      dimensions, 500 steps on a standard normal, or a dict with
      ``walkers``/``ndim``/``steps``/``log_prob_fn``; on the card its blocks
      of steps are captured as a CUDA graph.

    Off the card (``device="cpu"``) there is nothing to build: the targets
    run the plain twins. Returns {"targets", "total_s", "counters"}.
    """
    from crimp_tpu_torch.ops import search, z2_grid
    from crimp_tpu_torch.utils import profiling

    dev = resolve_device(device)
    before = profiling.compile_counters()
    report: dict = {"targets": {}}
    t_start = time.perf_counter()
    if dev.type == "cuda":
        _target(report, "nvcc_build", dev, z2_grid.build)

    rng = np.random.RandomState(0)
    times = torch.as_tensor(np.sort(rng.uniform(-4e5, 4e5, int(n_events)))).to(dev)
    f0, df = 0.143, 6e-9
    poly_paths = (True, False) if poly is None else (bool(poly),)
    if nharm <= z2_grid.MAX_NHARM:
        for p in poly_paths:
            _target(report, f"z2_tile_sums[poly={int(p)}]", dev, search.harmonic_sums_2d_grid, times, f0, df,
                    int(n_trials), [0.0], int(nharm), poly=p, mxu=False, device=dev)
        if n_fdot:
            nf2 = int(n_freq_2d if n_freq_2d is not None else n_trials)
            fdots = -np.geomspace(1e-14, 1e-13, int(n_fdot))
            for p in poly_paths:
                _target(report, f"z2_tile_sums_2d[poly={int(p)}]", dev, search.harmonic_sums_2d_grid, times,
                        f0, df, nf2, fdots, int(nharm), poly=p, mxu=False, device=dev)
    if general or nharm > z2_grid.MAX_NHARM:
        freqs = f0 + df * np.arange(int(n_trials))
        for p in poly_paths:
            _target(report, f"general_sums[poly={int(p)}]", dev, search.general_harmonic_sums, times, freqs,
                    nharm=int(nharm), poly=p, device=dev)

    if toa is not None:
        from crimp_tpu_torch.ops import toafit

        kind = toa.get("kind", toafit.ToAFitConfig().kind)
        cfg = toafit.resolve_runtime_cfg(toa.get("cfg", toafit.ToAFitConfig(kind=kind)),
                                         int(toa["n_segments"]), int(toa["n_events_max"]), device=dev)
        s, n = int(toa["n_segments"]), int(toa["n_events_max"])
        _target(report, "fit_toas_batch", dev, toafit.fit_toas_batch, kind, toa["tpl"], rng.uniform(0, 1, (s, n)),
                np.ones((s, n), dtype=bool), np.full(s, float(n)), cfg, device=dev)

    if mcmc:
        from crimp_tpu_torch.ops import mcmc as mcmc_ops

        spec = mcmc if isinstance(mcmc, dict) else {}
        walkers, ndim = int(spec.get("walkers", 32)), int(spec.get("ndim", 3))
        steps = int(spec.get("steps", 500))
        log_prob_fn = spec.get("log_prob_fn", lambda p: -0.5 * torch.sum(p * p, dim=-1))
        _target(report, "ensemble_sample", dev, mcmc_ops.ensemble_sample, log_prob_fn,
                rng.standard_normal((walkers, ndim)), steps, data=spec.get("data"), device=dev)

    after = profiling.compile_counters()
    report["total_s"] = round(time.perf_counter() - t_start, 3)
    report["counters"] = {k: round(after[k] - before[k], 4) if isinstance(after[k], float) else after[k] - before[k]
                          for k in after}
    n_ok = sum(1 for t in report["targets"].values() if "s" in t)
    logger.info("warmup: %d/%d targets in %.2fs (%d nvcc builds, %d graph captures)", n_ok,
                len(report["targets"]), report["total_s"], report["counters"]["nvcc_builds"],
                report["counters"]["graph_captures"])
    return report
