"""K5 on the card: its block width, timed at the ToA fit's sweep shapes.

    python -m crimp_tpu_torch.utils.k5_ab [--out FILE] [--reps N]

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit. It compiles ``csrc/toafit.cu`` once for each block width of
``WIDTHS`` (the source's ``THREADS`` replaced, the build's flags,
``build/k5_ab/``), all nvcc processes started together, and prints each
build's registers, stack frame and spill bytes. Then, on the north star's
fit shape (84 rows x 10 000 uniform phases, seed 7, the bundled Fourier
template, exposure 10 000 / 17), for the Newton and the joint (A, b) norm
solves and 128 (the brute grid), 64 (the dense error window) and 1 (a
golden-section point) phases, it times with CUDA events:

- each width's raw launch (the operands computed once, as a fit does),
  in turns from the widest to the narrowest and back, the mean of the two;
- the wrapper ``toafit.profile_sweep`` (the shipped width, the per-sweep
  operands included), and ``toafit.sweep_events`` alone;

and checks each width's (LL, A, b) against the wrapper's within K5's twin
tolerances (LL rtol 1e-12, A and b rtol 1e-10). Each row carries the f64
bound of ``obs/costmodel.py::k5_counts``. ``--out`` writes JSON.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import time

import numpy as np
import torch

from crimp_tpu_torch.io import template as template_io
from crimp_tpu_torch.models import profiles
from crimp_tpu_torch.obs import costmodel
from crimp_tpu_torch.ops import toafit, z2_grid

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TEMPLATE = os.path.join(REPO, "tests", "data", "1e2259_template.txt")
PEAK_F64_FLOPS = 34e12  # H100 SXM at 700 W, outside the tensor cores
WIDTHS = (256, 512, 1024)
PHIS = (128, 64, 1)
ROWS, EVENTS = 84, 10000


def build_widths(out_dir: str) -> dict:
    """{width: ctypes library} of csrc/toafit.cu at each block width."""
    src = z2_grid.SOURCES["toafit"].read_text()
    line = re.search(r"constexpr int THREADS = \d+;", src).group(0)
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for width in WIDTHS:
        path = os.path.join(out_dir, f"toafit_{width}.cu")
        with open(path, "w") as fh:
            fh.write(src.replace(line, f"constexpr int THREADS = {width};"))
        lib = os.path.join(out_dir, f"libtoafit_{width}.so")
        procs[width] = (lib, subprocess.Popen([z2_grid._nvcc(), *z2_grid.NVCC_FLAGS, "-o", lib, path],
                                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for width, (path, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc toafit.cu at {width} threads failed:\n{log}")
        for e in z2_grid.ptxas_entries(log):
            print(f"{width} threads: {e['registers']} registers, {e['stack']} B stack, {e['spill']} B spill",
                  flush=True)
        lib = ctypes.CDLL(path)
        vp, ci, cd = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        lib.toafit_profile.argtypes = [vp] * 10 + [ci, ci, ctypes.c_longlong, ci, ci, ci, ci,
                                                   cd, cd, cd, ci, vp, vp, vp, vp]
        lib.toafit_profile.restype = ci
        libs[width] = lib
    return libs


def event_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps calls, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=None)
    parser.add_argument("--reps", type=int, default=10)
    args = parser.parse_args(argv)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    libs = build_widths(os.path.join(REPO, "build", "k5_ab"))
    dev = torch.device("cuda")
    kind, tpl = profiles.from_template(template_io.read_template(TEMPLATE))
    tpl = tpl.to(dev)
    x = torch.as_tensor(np.random.RandomState(7).uniform(0, 1, (ROWS, EVENTS)), device=dev)
    mask = torch.ones(ROWS, EVENTS, dtype=torch.bool, device=dev)
    exposure = torch.full((ROWS,), EVENTS / 17.0, dtype=torch.float64, device=dev)
    rows = []
    for mode, cfg in (("newton", toafit.ToAFitConfig()), ("joint", toafit.ToAFitConfig(vary_amps=True))):
        events = toafit.sweep_events(kind, tpl, x, cfg)
        for n_phis in PHIS:
            phis = torch.as_tensor(np.tile(np.linspace(-np.pi, np.pi, n_phis), (ROWS, 1)), device=dev)
            j = torch.arange(1, tpl.n_comp + 1, dtype=torch.float64, device=dev)
            cosj, sinj = torch.cos(j * phis[..., None]), torch.sin(j * phis[..., None])
            want = toafit.profile_sweep(kind, tpl, x, mask, exposure, phis, cfg)
            row = {"mode": mode, "phis": n_phis, "card": card,
                   "wrapper_ms": event_ms(lambda: toafit.profile_sweep(kind, tpl, x, mask, exposure, phis, cfg),
                                          args.reps),
                   "sweep_events_ms": event_ms(lambda: toafit.sweep_events(kind, tpl, x, cfg), args.reps)}
            c = costmodel.k5_counts(ROWS, n_phis, EVENTS, tpl.n_comp, kind, toafit.norm_mode(cfg), cfg.newton_iters)
            row["bound_ms"] = c["flops"] / PEAK_F64_FLOPS * 1e3
            times = {w: [] for w in WIDTHS}
            for order in (WIDTHS[::-1], WIDTHS):
                for width in order:
                    out = [torch.empty(ROWS, n_phis, dtype=torch.float64, device=dev) for _ in range(3)]

                    def launch(lib=libs[width], out=out):
                        rc = lib.toafit_profile(
                            x.data_ptr(), mask.data_ptr(), exposure.data_ptr(), phis.data_ptr(), cosj.data_ptr(),
                            sinj.data_ptr(), events["ev_c"].data_ptr(), events["ev_s"].data_ptr(), None,
                            events["row"].data_ptr(), ROWS, n_phis, EVENTS, tpl.n_comp, 0, toafit.norm_mode(cfg),
                            cfg.newton_iters, cfg.norm_hi, cfg.amp_lo, cfg.amp_hi, 0, out[0].data_ptr(),
                            out[1].data_ptr(), out[2].data_ptr(), torch.cuda.current_stream().cuda_stream)
                        if rc != 0:
                            raise RuntimeError(f"toafit_profile at {width} threads: CUDA error {rc}")

                    times[width].append(event_ms(launch, args.reps))
                    ll, ll_w = out[0], want[0]
                    ok = bool(torch.all(torch.abs(ll - ll_w) <= 1e-12 * torch.abs(ll_w))) and all(
                        bool(torch.all(torch.abs(g - w) <= 1e-10 * torch.abs(w))) for g, w in zip(out[1:], want[1:]))
                    if not ok:
                        raise RuntimeError(f"{width} threads, {mode}, P {n_phis}: beyond the twin tolerances")
            row.update({f"t{w}_ms": float(np.mean(times[w])) for w in WIDTHS})
            rows.append(row)
            print(f"{mode} P {n_phis}: " + ", ".join(f"{w} threads {row[f't{w}_ms']:.4f} ms" for w in WIDTHS)
                  + f"; wrapper {row['wrapper_ms']:.4f} ms (sweep_events {row['sweep_events_ms']:.4f} ms); "
                  f"bound {row['bound_ms']:.4f} ms", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump({"card": card, "time": time.time(), "rows": rows}, fh, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
