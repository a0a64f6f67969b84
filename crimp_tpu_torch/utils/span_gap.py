"""Where the wall of one ``harmonic_sums_2d_grid`` call goes outside its
K2 kernel span.

    python -m crimp_tpu_torch.utils.span_gap [--events N] [--trials M] [--reps R] [--micro N] [--out FILE]

Run from the repository root on a machine with a CUDA card. At N events x
M trials (default 8e5 x 1e5, nharm 2, the shape of the card test
``test_k2_event_span_within_five_percent_of_synchronized_wall``), after one
warm-up, inside an obs run as that test:

- R calls as the test makes them: the synchronized host wall of the call
  and its ``grid_sums_2d`` span (the CUDA events round K2's launch);
- R calls with every step of the call and each hand-kernel launch window
  stamped on the host clock, without synchronizing: where in the call's
  wall each one starts and ends (the timeline);
- R calls with every step of the call wrapped: the card synchronized
  before and after each, its host time, and CUDA events round each step
  that launches work (the K2 wrapper, ``tiles_to_freqs``). The steps:
  ``as_f64``, ``poly_trig_enabled``, ``resolve_grid_mxu``,
  ``row_coeffs``, ``autotune.resolve_blocks``, ``z2_grid.z2_tile_sums``
  (the span's launch with its wrapper's host work), ``costmodel.capture``
  and ``tiles_to_freqs``.

``--micro N`` times each host step (and its pieces) alone N times.
``--out`` writes the means as JSON.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import tempfile
import time

import numpy as np
import torch

from crimp_tpu_torch.obs import costmodel
from crimp_tpu_torch.ops import autotune, fasttrig, search, z2_grid
from crimp_tpu_torch.utils import profiling

# (module, attribute) of each step, in call order
STEPS = ((search, "as_f64"), (fasttrig, "poly_trig_enabled"), (search, "resolve_grid_mxu"),
         (search, "row_coeffs"), (autotune, "resolve_blocks"), (z2_grid, "z2_tile_sums"),
         (costmodel, "capture"), (search, "tiles_to_freqs"))
LAUNCHING = {"z2_tile_sums", "tiles_to_freqs"}


@contextlib.contextmanager
def wrapped_steps(host: dict, device: dict):
    """Every STEPS entry timed: host seconds (card synchronized round it)
    into host[name], CUDA-event ms into device[name] for LAUNCHING."""
    saved = []
    for mod, name in STEPS:
        real = getattr(mod, name)

        def timed(*a, _real=real, _name=name, **kw):
            torch.cuda.synchronize()
            ev = None
            if _name in LAUNCHING:
                ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                ev[0].record()
            t0 = time.perf_counter()
            out = _real(*a, **kw)
            if ev is not None:
                ev[1].record()
            torch.cuda.synchronize()
            host[_name].append(time.perf_counter() - t0)
            if ev is not None:
                device[_name].append(ev[0].elapsed_time(ev[1]) / 1e3)
            return out

        saved.append((mod, name, real))
        setattr(mod, name, timed)
    try:
        yield
    finally:
        for mod, name, real in saved:
            setattr(mod, name, real)


def micro(t, n_trials: int, reps: int) -> dict:
    """Mean host microseconds of each host step of the call and of the
    pieces they are made of, each run ``reps`` times alone (no
    synchronization), inside an obs run."""
    from crimp_tpu_torch import knobs, obs
    from crimp_tpu_torch.utils.device import resolve_device

    dev, n = t.device, t.shape[0]
    steps = {
        "as_f64": lambda: search.as_f64(t, dev),
        "poly_trig_enabled": lambda: fasttrig.poly_trig_enabled(None, dev),
        "resolve_grid_mxu": lambda: search.resolve_grid_mxu(None, None, None, n, n_trials, True, False, device=dev),
        "row_coeffs": lambda: search.row_coeffs([0.0], None, dev),
        "resolve_blocks": lambda: autotune.resolve_blocks("grid", n, n_trials, True, n_rows=1, nharm=2, device=dev),
        "_load_cache": autotune._load_cache,
        "device_fingerprint": lambda: autotune.device_fingerprint(dev),
        "static_defaults": lambda: autotune.static_defaults("grid", n, n_trials, n_rows=1, nharm=2, poly=True,
                                                            device=dev),
        "counter_add": lambda: obs.counter_add("grid_trials", 0),
        "knobs.raw": lambda: knobs.raw("CRIMP_TORCH_GRID_MXU"),
        "autotune_mode": autotune.autotune_mode,
        "cache_path": autotune.cache_path,
        "resolve_device": lambda: resolve_device(dev),
    }
    out = {}
    with obs.run("span_micro"):
        for name, fn in steps.items():
            fn()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            out[name] = (time.perf_counter() - t0) * 1e6 / reps
            print(f"micro {name}: {out[name]:.1f} us a call", flush=True)
    return out


@contextlib.contextmanager
def timeline(marks: list):
    """Host timestamps (no synchronization) of every STEPS entry's start
    and end and of each hand-kernel launch window's entry, appended to
    ``marks`` as (name, t_start, t_end)."""
    saved = []
    for mod, name in STEPS + ((profiling, "launch_window"),):
        real = getattr(mod, name)
        if name == "launch_window":
            @contextlib.contextmanager
            def stamped(*a, _real=real, **kw):
                t0 = time.perf_counter()
                with _real(*a, **kw):
                    marks.append(("launch_window", t0, time.perf_counter()))
                    yield
        else:
            def stamped(*a, _real=real, _name=name, **kw):
                t0 = time.perf_counter()
                out = _real(*a, **kw)
                marks.append((_name, t0, time.perf_counter()))
                return out
        saved.append((mod, name, real))
        setattr(mod, name, stamped)
    try:
        yield
    finally:
        for mod, name, real in saved:
            setattr(mod, name, real)


def main(argv=None) -> int:
    from crimp_tpu_torch import obs

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--events", type=int, default=800000)
    parser.add_argument("--trials", type=int, default=100000)
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--out", default=None)
    parser.add_argument("--micro", type=int, default=0, help="time each host step N times alone, in an obs run")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("span_gap needs a CUDA card")
    dev = torch.device("cuda")
    rng = np.random.RandomState(3)  # the card test's pulsed events: 20 000 s, a 0.25 Hz signal, centred
    t = rng.uniform(0.0, 20000.0, 3 * args.events)
    t = np.sort(t[rng.uniform(0.0, 1.3, t.size) < 1.0 + 0.3 * np.cos(2 * np.pi * 0.25 * t)][:args.events])
    t = torch.as_tensor(t - (t[0] + t[-1]) / 2, device=dev)
    freqs = np.linspace(0.2490, 0.2510, args.trials)
    f0, df = search.uniform_grid(freqs)

    def call():
        return search.harmonic_sums_2d_grid(t, f0, df, freqs.size, [0.0], 2, device=dev)

    def timed_call(label):
        with obs.run(label):
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        doc = json.load(open(obs.last_manifest_path()))
        (span,) = [s for s in doc["spans"] if s["name"] == "grid_sums_2d"]
        return t0, wall, span["dur_s"]

    res = {"events": args.events, "trials": args.trials, "plain": [], "steps": {}, "timeline": []}
    with tempfile.TemporaryDirectory(prefix="span_gap_") as tmp:
        os.environ["CRIMP_TORCH_OBS"] = "1"
        os.environ["CRIMP_TORCH_OBS_DIR"] = tmp
        call()
        torch.cuda.synchronize()
        for _ in range(args.reps):
            _, wall, span = timed_call("span")
            res["plain"].append({"wall_s": wall, "span_s": span})
        for _ in range(args.reps):
            marks = []
            with timeline(marks):
                t0, wall, span = timed_call("span_timeline")
            res["timeline"].append({"wall_s": wall, "span_s": span,
                                    "marks": [(name, a - t0, b - t0) for name, a, b in marks]})
        host, device = collections.defaultdict(list), collections.defaultdict(list)
        walls = []
        with wrapped_steps(host, device):
            for _ in range(args.reps):
                walls.append(timed_call("span_steps")[1])
        if args.micro:
            res["micro_us"] = micro(t, freqs.size, args.micro)
    for mod, name in STEPS:
        res["steps"][name] = {"host_ms": 1e3 * float(np.mean(host[name])) if host[name] else None,
                              "calls_a_run": len(host[name]) / args.reps,
                              "device_ms": 1e3 * float(np.mean(device[name])) if device[name] else None}
    res["wrapped_wall_ms"] = 1e3 * float(np.mean(walls))
    for p in res["plain"]:
        print(f"call: wall {1e3 * p['wall_s']:.3f} ms, span {1e3 * p['span_s']:.3f} ms, outside "
              f"{1e3 * (p['wall_s'] - p['span_s']):.3f} ms ({100 * (p['wall_s'] - p['span_s']) / p['wall_s']:.2f}%)",
              flush=True)
    for p in res["timeline"]:
        print(f"timeline (host ms from the call's start, no synchronization; wall {1e3 * p['wall_s']:.3f}, span "
              f"{1e3 * p['span_s']:.3f}): " + ", ".join(f"{n} {1e3 * a:.3f}-{1e3 * b:.3f}" for n, a, b in p["marks"]),
              flush=True)
    for name, st in res["steps"].items():
        if st["host_ms"] is None:
            print(f"step {name}: not called", flush=True)
            continue
        print(f"step {name}: host {st['host_ms']:.3f} ms a call, card synchronized round it "
              f"(x{st['calls_a_run']:.0f} a run)"
              + (f", device {st['device_ms']:.3f} ms" if st["device_ms"] is not None else ""), flush=True)
    print(f"wrapped call's wall {res['wrapped_wall_ms']:.3f} ms", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(res, fh, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
