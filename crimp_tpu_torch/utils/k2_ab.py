"""K2 on the card: its time against an earlier version of its source and
under three launch plans, its build report, and its inner loop's SASS per
(trial, event) pair.

    python -m crimp_tpu_torch.utils.k2_ab [--parent SRC.cu] [--out FILE] [--reps N]

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit. It builds the kernels (``z2_grid.build()``) and, with
``--parent``, an earlier ``z2_grid.cu`` with the same flags (the same C
entry point ``z2_grid_sums``, which both versions keep). It prints:

- each ``z2_tile_kernel`` instantiation's registers, stack frame and spill
  bytes (``-Xptxas -v``), for the new source and the parent;
- the instructions a (trial, event) pair of the event loop of
  ``z2_tile_kernel<2, false, true>`` (the north star's), by pipe, from
  ``cuobjdump -sass``: of the backward-branch loops that load from shared
  memory and take an f32 floor (one an event), the one with the fewest
  instructions an event, less any loop nested in it; its instructions over
  its events times the trials a thread owns (``trials_per_thread``; 1 for a
  parent without register blocks);
- K2 alone, CUDA events, at ``SHAPES`` on the 839 259-event north-star
  surrogate: the north star (2500 nu x 40 nudot, nharm 2, polynomial), the
  cube (25 000 nu x 2 nudot x 2 nuddot) and the exact 2-D grid in sincosf
  mode (12 500 nu x 8 nudot), each timed in turns parent / new / new /
  parent, the parent under the static plan it shipped with
  (``legacy_n_split``), the new kernel under ``default_per_split``; at the
  north-star shape also the new kernel under the former plan and at the
  2^17 split, in turns; the factorized torch path (``mxu=True``, full f32,
  reseed 16) at the sincosf shape, the nearest torch computation of that
  grid. Each beside its bound at the new count (``flops_per_pair``) and the
  direct form's (``flops_per_pair_direct``), with the largest |dZ2|
  against the parent, and, both at the former plan's split, the share of
  trials at register-block starts (j = 0 mod R) whose sums are the
  parent's bits; the SM clock while the new kernel runs and the issue rate
  that the SASS count implies.

``--out`` writes everything as JSON (and the SASS listings beside it).
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import math
import os
import re
import subprocess

import numpy as np
import torch

from crimp_tpu_torch.ops import search, z2_grid
from crimp_tpu_torch.utils import k3_ab

REPO = k3_ab.REPO
PEAK_F32_FLOPS = k3_ab.PEAK_F32_FLOPS
PEAK_HBM_BYTES = k3_ab.PEAK_HBM_BYTES
SPLIT_2E17 = 1 << 17

# name: (n_freq, signed fdots, fddots or None, nharm, poly)
SHAPES = {
    "north_star": (2500, -(10.0 ** np.linspace(-14.5, -13.5, 40)), None, 2, True),
    "cube": (25000, -(10.0 ** np.linspace(-14.5, -13.5, 2)), np.linspace(-1e-20, 1e-20, 2), 2, True),
    "sincosf_12500x8": (12500, -(10.0 ** np.linspace(-14.5, -13.5, 8)), None, 2, False),
}


def legacy_n_split(n_blocks: int, n_chunks: int, device: torch.device) -> int:
    """K2's static plan before the rotation kernel: about four blocks of 256
    threads a SM over ``n_blocks`` (tile, row) blocks, never more splits
    than chunks."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(n_chunks, math.ceil(4 * sms / n_blocks)))


def legacy_per_split(n_events: int, n_pairs: int, device: torch.device) -> int:
    n_chunks = -(-n_events // z2_grid.EVENT_CHUNK)
    return -(-n_chunks // legacy_n_split(n_pairs, n_chunks, device)) * z2_grid.EVENT_CHUNK


def kernel_label(mangled: str) -> str | None:
    """z2_tile_kernel<NH, ext, poly> from a mangled name."""
    m = re.search(r"z2_tile_kernelILi(\d+)ELb([01])ELb([01])E", mangled)
    if not m:
        return None
    return f"z2_tile_kernel<{m.group(1)},{bool(int(m.group(2)))},{bool(int(m.group(3)))}>"


def build_parent(src: str) -> tuple[str, str]:
    out_dir = os.path.join(REPO, "build", "k2_parent")
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, "libz2_grid_parent.so")
    proc = subprocess.run([k3_ab._tool("nvcc"), *z2_grid.NVCC_FLAGS, "-o", out, src], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc of {src} failed:\n{proc.stdout}{proc.stderr}")
    return out, proc.stdout + proc.stderr


def bind(path: str):
    lib = ctypes.CDLL(path)
    vp, ci, cd = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.z2_grid_sums.argtypes = [vp, ci, cd, cd, cd, vp, ci, vp, ci, vp, ci, ci, ci, ci, ci, ci, vp, vp, vp]
    lib.z2_grid_sums.restype = ci
    return lib


def build_report(log: str) -> dict:
    return {kernel_label(e["name"]): {k: e[k] for k in ("registers", "stack", "spill")}
            for e in z2_grid.ptxas_entries(log) if kernel_label(e["name"])}


def loop_counts(instrs: list, trials_per_thread: int) -> dict:
    """Per-pair counts by pipe of the event loop (see the module note)."""
    loops = [(k3_ab._branch_target(args), addr) for addr, op, args in instrs
             if op.split(".")[0] == "BRA" and (k3_ab._branch_target(args) or addr + 1) <= addr]
    if not loops:
        return {}

    def own(r):
        nested = [o for o in loops if o != r and r[0] <= o[0] and o[1] <= r[1]]
        return [op for a, op, _ in instrs
                if r[0] <= a <= r[1] and not any(lo <= a <= hi for lo, hi in nested)]

    def floors(ops):
        return sum(1 for op in ops if op.startswith("FRND") and ".F64" not in op)

    candidates = [own(r) for r in loops]
    candidates = [ops for ops in candidates if floors(ops) and any(op.startswith("LDS") for op in ops)]
    if not candidates:
        return {}
    # the event loop spends the fewest instructions an event; the chunk loop
    # around it (staging, the tail event, the chunk sums) spends more
    ops = min(candidates, key=lambda o: len(o) / floors(o))
    events = floors(ops)
    pairs = events * trials_per_thread
    by_pipe, by_op = collections.Counter(), collections.Counter()
    for op in ops:
        base = op.split(".")[0]
        pipe = next((name for name, bases in k3_ab.PIPES if base in bases), "integer, branch, other")
        if base == "FRND" and ".F64" not in op:
            pipe = "f32"
        by_pipe[pipe] += 1
        by_op[op] += 1
    return {"events_per_iteration": events, "trials_per_thread": trials_per_thread,
            "pairs_per_iteration": pairs, "instructions": len(ops),
            "per_pair": {k: v / pairs for k, v in sorted(by_pipe.items())},
            "per_pair_total": len(ops) / pairs, "opcodes": dict(by_op.most_common())}


def sums(lib, t, f0, df, hf, sf, n_tiles: int, nharm: int, poly: bool, per_split: int) -> torch.Tensor:
    """(2, n_fddot, n_fdot, n_tiles, nharm, 256) sums from ``lib``'s
    z2_grid_sums at the split length ``per_split``."""
    n, n_fdot = t.shape[0], hf.shape[0]
    n_fddot = 1 if sf is None else sf.shape[0]
    n_split = -(-n // per_split)
    shape = (2, n_fddot, n_fdot, n_tiles, nharm, z2_grid.TRIAL_TILE)
    out = torch.empty(shape, dtype=torch.float32, device=t.device)
    partial = torch.empty((n_split,) + shape, dtype=torch.float32, device=t.device) if n_split > 1 else out
    rc = lib.z2_grid_sums(t.data_ptr(), n, float(f0), float(z2_grid.TRIAL_TILE * df), float(df), hf.data_ptr(),
                          n_fdot, None if sf is None else sf.data_ptr(), n_fddot, None, n_tiles, 0, nharm,
                          int(poly), n_split, per_split, partial.data_ptr(), out.data_ptr(), z2_grid.stream_of(t))
    z2_grid.check_launch(rc, "z2_grid_sums")
    return out


def z2_of(cs: torch.Tensor, n_events: int) -> np.ndarray:
    return ((cs[0].double() ** 2 + cs[1].double() ** 2) * (2.0 / n_events)).sum(dim=-2).reshape(-1).cpu().numpy()


def bounds_ms(n_trials: int, n_events: int, nharm: int, out_bytes: int) -> dict:
    nbytes = 8 * n_events + out_bytes
    return {"new count": max(n_trials * n_events * z2_grid.flops_per_pair(nharm) / PEAK_F32_FLOPS,
                             nbytes / PEAK_HBM_BYTES) * 1e3,
            "direct form": max(n_trials * n_events * z2_grid.flops_per_pair_direct(nharm) / PEAK_F32_FLOPS,
                               nbytes / PEAK_HBM_BYTES) * 1e3}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", default=None,
                        help="an earlier z2_grid.cu (or its prebuilt .so) to time beside K2")
    parser.add_argument("--out", default=None, help="write the results as JSON here")
    parser.add_argument("--reps", type=int, default=5)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k2_ab needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    res = {"card": card}
    paths = z2_grid.build(force=True)
    res["build"] = build_report(z2_grid.BUILD_INFO["z2_grid"]["log"])
    libs = {"new": str(paths["z2_grid"])}
    parent = None
    if args.parent:
        ppath, plog = (args.parent, "") if args.parent.endswith(".so") else build_parent(args.parent)
        libs["parent"] = ppath
        res["parent_build"] = build_report(plog)
        parent = bind(ppath)
    for which in ("build", "parent_build"):
        for label, v in res.get(which, {}).items():
            print(f"{which} {label}: {v['registers']} registers, stack {v['stack']} B, spill {v['spill']} B")
    res["sass"] = {}
    for which, lib_path in libs.items():
        for name, instrs in k3_ab.sass_functions(lib_path).items():
            if kernel_label(name) != "z2_tile_kernel<2,False,True>":
                continue
            counts = loop_counts(instrs, z2_grid.trials_per_thread(2) if which == "new" else 1)
            res["sass"][which] = counts
            print(f"SASS {which} z2_tile_kernel<2,false,true> event loop: {counts.get('events_per_iteration')} "
                  f"events x {counts.get('trials_per_thread')} trials an iteration, "
                  f"{counts.get('per_pair_total', 0):.2f} instructions a pair: "
                  + ", ".join(f"{k} {v:.3f}" for k, v in counts.get("per_pair", {}).items()), flush=True)
            print(f"  opcodes: {counts.get('opcodes')}")
            if args.out:
                with open(os.path.splitext(args.out)[0] + f".sass_{which}.txt", "w") as fh:
                    fh.writelines(f"/*{a:04x}*/ {op} {ops}\n" for a, op, ops in instrs)

    dev = torch.device("cuda")
    t = k3_ab.surrogate_times(dev)
    n_ev = int(t.shape[0])
    new_lib = z2_grid._lib()
    res["shapes"] = {}
    for name, (n_freq, fdots, fddots, nharm, poly) in SHAPES.items():
        freqs = np.linspace(0.1430, 0.1436, n_freq)
        f0, df = search.uniform_grid(freqs)
        hf = torch.as_tensor(0.5 * fdots, device=dev)
        sf = None if fddots is None else torch.as_tensor(fddots / 6.0, device=dev)
        n_tiles = -(-n_freq // z2_grid.TRIAL_TILE)
        n_pairs = n_tiles * hf.shape[0] * (1 if sf is None else sf.shape[0])
        plans = {"new plan": z2_grid.default_per_split(n_ev, n_pairs, dev, nharm, poly),
                 "former plan": legacy_per_split(n_ev, n_pairs, dev), "2^17": SPLIT_2E17}
        run = lambda lib, plan: sums(lib, t, f0, df, hf, sf, n_tiles, nharm, poly, plans[plan])  # noqa: E731
        ms = lambda lib, plan: k3_ab.cuda_ms(lambda: run(lib, plan), args.reps)  # noqa: E731
        turns = [("parent", "former plan"), ("new", "new plan"), ("new", "new plan"), ("parent", "former plan")]
        if name == "north_star":
            turns[2:2] = [("new", "former plan"), ("new", "2^17"), ("new", "2^17"), ("new", "former plan")]
        if parent is None:
            turns = [turn for turn in turns if turn[0] == "new"]
        timed = collections.defaultdict(list)
        for which, plan in turns:
            timed[f"{which} @ {plan}"].append(ms(parent if which == "parent" else new_lib, plan))
        n_trials = n_freq * n_pairs // n_tiles
        out_bytes = 4 * 2 * n_pairs * nharm * z2_grid.TRIAL_TILE
        row = {"trials": n_trials, "events": n_ev, "nharm": nharm, "poly": poly, "per_split": plans,
               "ms": dict(timed), "bounds_ms": bounds_ms(n_trials, n_ev, nharm, out_bytes)}
        zn = run(new_lib, "new plan")
        if parent is not None:
            zp = run(parent, "former plan")
            row["max_dz2_vs_parent"] = float(np.max(np.abs(z2_of(zn, n_ev) - z2_of(zp, n_ev))))
            r_block = z2_grid.trials_per_thread(nharm)
            same = run(new_lib, "former plan")
            row["block_starts_bitwise_parent"] = float(torch.mean(
                (same[..., ::r_block] == zp[..., ::r_block]).all(dim=-2).all(dim=0).double()))
        if name == "sincosf_12500x8":
            cen = t.cpu().numpy()
            fact = lambda: search.z2_power_2d_grid(cen, f0, df, n_freq, fdots, nharm, device=dev,  # noqa: E731
                                                   mxu=True, poly=False, reseed=16)
            row["factorized_torch_ms"] = k3_ab.cuda_ms(fact, args.reps)
        clock_ms, clocks = k3_ab.sm_clock_mhz(lambda: run(new_lib, "new plan"), max(args.reps, 10))
        row["clock_window_ms"], row["sm_clock_mhz"] = clock_ms, clocks
        if name == "north_star" and clocks and "new" in res["sass"]:
            mhz = float(np.median(clocks))
            schedulers = 4 * torch.cuda.get_device_properties(dev).multi_processor_count
            warp_pairs = n_trials * n_ev / 32 / schedulers
            row["cycles_per_warp_pair"] = clock_ms * 1e-3 * mhz * 1e6 / warp_pairs
            row["issue_efficiency"] = res["sass"]["new"]["per_pair_total"] / row["cycles_per_warp_pair"]
        res["shapes"][name] = row
        print(f"shape {name}: {n_trials} trials x {n_ev} events, nharm {nharm}, "
              f"{'polynomial' if poly else 'sincosf'}; plans {plans}; ms "
              + "; ".join(f"{k} " + " / ".join(f"{v:.3f}" for v in vs) for k, vs in timed.items())
              + "; bound " + ", ".join(f"{k} {v:.2f} ms" for k, v in row["bounds_ms"].items())
              + (f"; factorized torch {row['factorized_torch_ms']:.3f} ms" if "factorized_torch_ms" in row else "")
              + (f"; max |dZ2| vs parent {row['max_dz2_vs_parent']:.3g}, block starts bitwise the parent "
                 f"{100 * row['block_starts_bitwise_parent']:.1f}%" if parent is not None else "")
              + (f"; SM clock median {np.median(clocks):.0f} MHz" if clocks else "")
              + (f", {row['cycles_per_warp_pair']:.2f} cycles a warp of pairs a scheduler, issue efficiency "
                 f"{100 * row['issue_efficiency']:.1f}%" if "issue_efficiency" in row else ""), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(res, fh, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
