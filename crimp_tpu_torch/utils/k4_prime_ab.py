"""K4's primed spans against raw primed launches, at several spin lengths.

    python -m crimp_tpu_torch.utils.k4_prime_ab [--cycles 100000 2000000] [--folds 20] [--reps 3] [--out FILE]

Run from the root of the repository on a machine with a CUDA card and the
CUDA toolkit. It builds the kernels, makes chip_smoke.py phase 10's K4
operands (the north-star surrogate, 84 x 10 000 events, seed 7, P 13, a
spin-only move of F0 and F1) and, for each spin length (``PRIME_CYCLES``)
and repetition, times K4 three ways, ``--folds`` times each:

- ``engine``: the span of each delta fold's refold
  (``anchored.fold_segments(delta_fold=1)`` under
  ``profiling.primed_launches()``), as phase 10's roofline row reads it;
  the host works for ~20 ms between two of them;
- ``raw``: one C launch between two CUDA events behind the same spin, the
  card synchronized before and after, as phase 10's own figure;
- ``raw_gap``: the same after the host has slept as long as a fold takes.

It prints each set's sorted ms, its mean and the mean's share of K4's bytes
bound (B·E·(P+2)·8 bytes at 3.35 TB/s). The last line is the JSON record.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

PAR = os.path.join("tests", "data", "1e2259.par")
TEMPLATE = os.path.join("tests", "data", "1e2259_template.txt")
INTERVALS = os.path.join("tests", "data", "timIntToAs_1e2259.txt")
SPIN_UPDATE = {"F0": 3e-10, "F1": 2e-17}  # chip_smoke.py phase 7's spin-only move
PEAK_HBM_BYTES = 3.35e12


def _operands(torch):
    """Phase 10's K4 operands: the segments, the two timing models and the
    product (folded, basis, dp) of one refold."""
    from crimp_tpu_torch.io.parfile import read_timing_model
    from crimp_tpu_torch.ops import anchored, deltafold
    from crimp_tpu_torch.utils import surrogate

    times, intervals = surrogate.build_surrogate(PAR, INTERVALS, TEMPLATE, events_per_toa=10000, seed=7)
    segs = surrogate.slice_intervals(times, intervals["ToA_tstart"], intervals["ToA_tend"])
    base = read_timing_model(PAR)[0]
    sizes = [s.size for s in segs]
    idx = np.repeat(np.arange(len(segs)), sizes)
    t_ref = np.asarray([(s[-1] - s[0]) / 2 + s[0] for s in segs])
    delta = anchored.anchor_deltas(np.concatenate(segs), t_ref, idx)
    ph, _ = anchored.fold_segments(base, segs, device="cuda")
    basis = deltafold.build_basis(base, t_ref, delta, idx, device="cuda").b
    dp = torch.zeros(basis.shape[1], dtype=torch.float64, device="cuda")
    dp[:2] = torch.tensor([SPIN_UPDATE["F0"], SPIN_UPDATE["F1"]], dtype=torch.float64)
    moved = {**base, **{k: base[k] + dv for k, dv in SPIN_UPDATE.items()}}
    return segs, base, moved, (torch.as_tensor(np.concatenate(ph), device="cuda"), basis, dp)


def _summary(ms: list[float], bound_ms: float) -> dict:
    v = np.asarray(ms)
    return {"sorted_ms": [float(x) for x in np.sort(v)], "median_ms": float(np.median(v)),
            "mean_ms": float(v.mean()), "pct_of_bound": 100.0 * bound_ms / float(v.mean())}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cycles", type=int, nargs="+", default=[100_000, 2_000_000])
    parser.add_argument("--folds", type=int, default=20)
    parser.add_argument("--reps", type=int, default=3)
    parser.add_argument("--out", default=None, help="also write the JSON record here")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("k4_prime_ab: needs a CUDA card", file=sys.stderr)
        return 2
    os.environ.update({"CRIMP_TORCH_OBS": "1", "CRIMP_TORCH_OBS_DIR": tempfile.mkdtemp(prefix="k4_prime_ab_"),
                       "CRIMP_TORCH_OBS_COST": "1"})
    from crimp_tpu_torch import obs
    from crimp_tpu_torch.ops import anchored, deltafold, z2_grid
    from crimp_tpu_torch.utils import profiling

    z2_grid.build()
    segs, base, moved, (folded, basis, dp) = _operands(torch)
    out = torch.empty_like(folded)
    lib = deltafold._lib()
    args_c = (folded.data_ptr(), basis.data_ptr(), dp.data_ptr(), out.data_ptr(), 1, folded.shape[0],
              basis.shape[1], torch.cuda.current_stream().cuda_stream)
    bound_ms = basis.shape[0] * (basis.shape[1] + 2) * 8 / PEAK_HBM_BYTES * 1e3
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()

    def raw(gap_s: float) -> list[float]:
        ms = []
        for _ in range(args.folds):
            time.sleep(gap_s)
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            torch.cuda._sleep(profiling.PRIME_CYCLES)
            start.record()
            rc = lib.deltafold_refold(*args_c)
            stop.record()
            torch.cuda.synchronize()
            if rc != 0:
                raise RuntimeError(f"deltafold_refold returned {rc}")
            ms.append(start.elapsed_time(stop))
        return ms

    record = {"card": card, "bound_ms": bound_ms, "folds": args.folds, "runs": []}
    keep = profiling.PRIME_CYCLES
    try:
        with obs.run("k4_prime_ab"):
            for rep in range(args.reps):
                for cycles in args.cycles:
                    profiling.PRIME_CYCLES = cycles
                    deltafold.clear_cache()
                    anchored.fold_segments(base, segs, device="cuda", delta_fold=1, cache_tag="k4_prime_ab")
                    profiling.reset_kernel_times()
                    host = []
                    with profiling.primed_launches():
                        for _ in range(args.folds):
                            t0 = time.perf_counter()
                            anchored.fold_segments(moved, segs, device="cuda", delta_fold=1,
                                                   cache_tag="k4_prime_ab")
                            host.append(time.perf_counter() - t0)
                            if deltafold.last_fold_info()["mode"] != "delta":
                                raise RuntimeError("a fold did not refold")
                    deltafold.clear_cache()
                    engine = [s * 1e3 for s in profiling.kernel_times()["delta_refold"]]
                    fold_s = float(np.median(host))
                    row = {"rep": rep, "cycles": cycles, "fold_host_ms": fold_s * 1e3,
                           "engine": _summary(engine, bound_ms), "raw": _summary(raw(0.0), bound_ms),
                           "raw_gap": _summary(raw(fold_s), bound_ms)}
                    record["runs"].append(row)
                    print(f"rep {rep}, {cycles} cycles ({card}): " + ", ".join(
                        f"{k} mean {row[k]['mean_ms']:.4f} ms ({row[k]['pct_of_bound']:.2f}%), "
                        f"range {row[k]['sorted_ms'][0]:.4f}-{row[k]['sorted_ms'][-1]:.4f}"
                        for k in ("engine", "raw", "raw_gap")), flush=True)
    finally:
        profiling.PRIME_CYCLES = keep
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(record, fh, indent=1)
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
