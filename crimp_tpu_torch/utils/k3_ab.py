"""K3 on the card: its time against an earlier version of its source and
against K2's split heuristic, its build report, and its inner loop's SASS
counted by pipe.

    python -m crimp_tpu_torch.utils.k3_ab [--parent SRC.cu] [--out FILE] [--reps N]

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit. It builds the kernels (``z2_grid.build()``) and, with
``--parent``, an earlier ``z2_general.cu`` with the same flags (its
``z2_general_sums`` has the C interface of PR 3/4, without the pass
counter; it is planned with K2's split heuristic, as that version was). It
prints:

- each ``general_kernel`` instantiation's registers, stack frame and spill
  bytes (``-Xptxas -v``);
- the per-pair instruction counts of the event loop of
  ``general_kernel<float, true, 2>`` by pipe, from ``cuobjdump -sass``: of
  the backward-branch loops that load from shared memory and convert f64
  to f32 (once per pair), the one with the fewest instructions a pair,
  less any loop nested in it (the pass re-advance, idle at k0 = 0);
- K3 alone, CUDA events, at ``SHAPES`` on the 839 259-event north-star
  surrogate: (a) 1e5 geometric trials, nharm 2, polynomial sin/cos; (b) 1e4
  trials, nharm 25, polynomial (the H-test shape); (c) as (a) with f32
  sincosf. Each beside its bound (``shape_bounds``), timed in turns:
  parent, K3 as ``general_sums`` plans it (``plan_splits``), the same
  kernel split by K2's former heuristic (``k2_ab.legacy_n_split``, twice),
  K3 again, parent; the
  Z^2 of each against K3's; the SM clock (``nvidia-smi``, sampled every
  50 ms) while K3 runs, and the warp-instruction issue rate that the SASS
  count and that clock imply. ``--out`` writes everything as JSON.

chip_smoke.py's phase 6 times the same shapes (and the plain twin) with
the same ``SHAPES`` and ``shape_bounds``.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import os
import re
import shutil
import subprocess
import time

import numpy as np
import torch

from crimp_tpu_torch.ops import search, z2_general, z2_grid

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DATA = os.path.join(REPO, "tests", "data")
PEAK_F32_FLOPS = 67e12  # H100 SXM at 700 W, outside the tensor cores
PEAK_F64_FLOPS = 34e12
PEAK_HBM_BYTES = 3.35e12

PIPES = (("f32", ("FFMA", "FMUL", "FADD", "FSETP", "FSEL", "FMNMX")),
         ("f64", ("DMUL", "DADD", "DFMA", "DSETP", "DMNMX")),
         ("f64 round", ("FRND",)), ("conversion", ("F2F", "F2I", "I2F")),
         ("shared load", ("LDS",)), ("global", ("LDG", "STG")))


def kernel_label(mangled: str) -> str | None:
    """general_kernel<float|double, poly, NH> from a mangled name."""
    m = re.search(r"general_kernelI([fd])Lb([01])ELi(\d+)E", mangled)
    if not m:
        return None
    return f"general_kernel<{'float' if m.group(1) == 'f' else 'double'},{bool(int(m.group(2)))},{m.group(3)}>"


def _tool(name: str) -> str:
    found = shutil.which(name)
    return found if found else f"/usr/local/cuda/bin/{name}"


def sass_functions(lib_path: str) -> dict:
    """{mangled name: [(address, opcode with modifiers, operand text)]}."""
    text = subprocess.run([_tool("cuobjdump"), "-sass", lib_path], capture_output=True, text=True,
                          check=True).stdout
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)\s*([^;]*);", line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2), m.group(3)))
    return funcs


def _branch_target(operands: str):
    m = re.search(r"0x([0-9a-f]+)", operands)
    return int(m.group(1), 16) if m else None


def loop_counts(instrs: list) -> dict:
    """Per-pair counts by pipe of the event loop (see the module note)."""
    loops = []
    for addr, op, args in instrs:
        if op.split(".")[0] == "BRA":
            tgt = _branch_target(args)
            if tgt is not None and tgt <= addr:
                loops.append((tgt, addr))
    if not loops:
        return {}

    def body(lo, hi, skip=()):
        return [(a, op) for a, op, _ in instrs
                if lo <= a <= hi and not any(s_lo <= a <= s_hi for s_lo, s_hi in skip)]

    def own(r):  # the loop's instructions without those of loops nested in it
        return body(*r, [o for o in loops if o != r and r[0] <= o[0] and o[1] <= r[1]])

    def is_event_loop(r):
        ops = [op for _, op in own(r)]
        return any(op.startswith("F2F.F32.F64") for op in ops) and any(op.startswith("LDS") for op in ops)

    candidates = [own(r) for r in loops if is_event_loop(r)]
    if not candidates:
        return {}
    # the main loop spends the fewest instructions a pair; the tail, the
    # derivative rows and the re-advance spend more
    ops = min(candidates, key=lambda o: len(o) / sum(op.startswith("F2F.F32.F64") for _, op in o))
    n_pairs = max(1, sum(1 for _, op in ops if op.startswith("F2F.F32.F64")))
    by_pipe = collections.Counter()
    by_op = collections.Counter()
    for _, op in ops:
        base = op.split(".")[0]
        pipe = next((name for name, bases in PIPES if base in bases), "integer, branch, other")
        if base == "FRND" and ".F64" not in op:
            pipe = "f32"
        by_pipe[pipe] += 1
        by_op[op] += 1
    return {"pairs_per_iteration": n_pairs, "instructions": len(ops),
            "per_pair": {k: v / n_pairs for k, v in sorted(by_pipe.items())},
            "per_pair_total": len(ops) / n_pairs, "opcodes": dict(by_op.most_common())}


def build_parent(src: str) -> tuple[str, str]:
    out_dir = os.path.join(REPO, "build", "k3_parent")
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, "libz2_general_parent.so")
    proc = subprocess.run([_tool("nvcc"), *z2_grid.NVCC_FLAGS, "-o", out, src], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc of {src} failed:\n{proc.stdout}{proc.stderr}")
    return out, proc.stdout + proc.stderr


def split_for_sums(lib, times, freqs, nharm, poly, trials_per_block, extra=()):
    """K3 from ``lib`` with the event split of K2's former heuristic (``k2_ab.legacy_n_split``)
    over blocks of ``trials_per_block`` trials, as the PR 3/4 wrapper planned it;
    ``extra`` ends the C call (the new entry point's pass counter)."""
    n, n_freq = times.shape[0], freqs.shape[0]
    z = torch.zeros(1, dtype=torch.float64, device=times.device)
    n_chunks = -(-n // 1024)
    from crimp_tpu_torch.utils.k2_ab import legacy_n_split

    n_split = legacy_n_split(-(-n_freq // trials_per_block), n_chunks, times.device)
    per_split = -(-n_chunks // n_split) * 1024
    n_split = -(-n // per_split)
    shape = (2, 1, 1, nharm, n_freq)
    out = torch.empty(shape, dtype=torch.float64, device=times.device)
    partial = torch.empty((n_split,) + shape, dtype=torch.float64, device=times.device) if n_split > 1 else out
    rc = lib.z2_general_sums(times.data_ptr(), n, freqs.data_ptr(), n_freq, z.data_ptr(), 1, z.data_ptr(), 1,
                             nharm, 0, int(poly), n_split, per_split, partial.data_ptr(), out.data_ptr(),
                             z2_grid.stream_of(times), *extra)
    z2_grid.check_launch(rc, "z2_general_sums")
    return out


def _bind_parent(path: str):
    lib = ctypes.CDLL(path)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.z2_general_sums.argtypes = [vp, ci, vp, ci, vp, ci, vp, ci, ci, ci, ci, ci, ci, vp, vp, vp]
    lib.z2_general_sums.restype = ci
    return lib


def sm_clock_mhz(fn, reps: int) -> tuple[float, list]:
    """Mean CUDA-event ms of fn over reps launches, with nvidia-smi's SM clock
    (MHz) sampled every 50 ms meanwhile."""
    proc = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits",
                             "-lms", "50"], stdout=subprocess.PIPE, text=True)
    try:
        time.sleep(0.1)
        ms = cuda_ms(fn, reps)
    finally:
        proc.terminate()
        out, _ = proc.communicate(timeout=10)
    clocks = [float(v) for v in out.split() if v.replace(".", "").isdigit()]
    return ms, clocks


def cuda_ms(fn, reps: int) -> float:
    fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def z2_of(cs, n_events: int) -> np.ndarray:
    return ((cs[0] ** 2 + cs[1] ** 2) * (2.0 / n_events)).sum(dim=-2).reshape(-1).cpu().numpy()


def surrogate_times(device) -> torch.Tensor:
    from crimp_tpu_torch.utils import surrogate

    times, _ = surrogate.build_surrogate(os.path.join(DATA, "1e2259.par"),
                                         os.path.join(DATA, "timIntToAs_1e2259.txt"),
                                         os.path.join(DATA, "1e2259_template.txt"),
                                         events_per_toa=10000, seed=7)
    sec = (times - times.mean()) * 86400.0
    cen = search.PeriodSearch(sec, np.linspace(0.1430, 0.1436, 8), 2, device=device)._centered()
    return torch.as_tensor(cen, device=device)


SHAPES = {  # name: (trial grid, nharm, poly), on the 839 259-event north-star surrogate
    "a": (lambda: np.geomspace(0.1430, 0.1436, 100000), 2, True),
    "b": (lambda: np.linspace(0.1430, 0.1436, 10000), 25, True),
    "c": (lambda: np.geomspace(0.1430, 0.1436, 100000), 2, False),
}


def shape_bounds(n_trials: int, n_events: int, nharm: int, poly: bool) -> dict:
    """K3's least time at a shape, ms, by each thing that could set it: its
    f32 operations at the f32 peak, its f64 operations (none an FMA, so each
    takes a whole FMA slot, of which the card has PEAK_F64_FLOPS / 2 a
    second), and the bytes of events, trials and f64 sums. The bound is the
    largest."""
    f64_ops, f32_ops = z2_general.ops_per_pair(nharm, torch.float32, poly=poly)
    pairs = n_trials * n_events
    return {"f32 operations": pairs * f32_ops / PEAK_F32_FLOPS * 1e3,
            "f64 operations": pairs * f64_ops / (PEAK_F64_FLOPS / 2) * 1e3,
            "bytes": (8 * n_events + 8 * n_trials + 2 * nharm * n_trials * 8) / PEAK_HBM_BYTES * 1e3}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", default=None,
                        help="an earlier z2_general.cu (or its prebuilt .so) to time beside K3")
    parser.add_argument("--out", default=None, help="write the results as JSON here")
    parser.add_argument("--reps", type=int, default=3)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k3_ab needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    res = {"card": card}
    paths = z2_grid.build(force=True)
    res["build"] = {}
    for e in z2_grid.ptxas_entries(z2_grid.BUILD_INFO["z2_general"]["log"]):
        label = kernel_label(e["name"])
        if label:
            res["build"][label] = {k: e[k] for k in ("registers", "stack", "spill")}
    worst = [f"{k}: {v}" for k, v in res["build"].items() if v["stack"] or v["spill"]]
    print(f"K3 build: {len(res['build'])} instantiations, registers "
          f"{min(v['registers'] for v in res['build'].values())}-{max(v['registers'] for v in res['build'].values())}; "
          f"stack or spill: {worst if worst else 'none'}", flush=True)
    for k, v in res["build"].items():
        print(f"  {k}: {v}")
    res["sass"] = {}
    libs = {"new": str(paths["z2_general"])}
    parent = None
    if args.parent:
        ppath, plog = (args.parent, "") if args.parent.endswith(".so") else build_parent(args.parent)
        libs["parent"] = ppath
        res["parent_build"] = {kernel_label(e["name"]): {k: e[k] for k in ("registers", "stack", "spill")}
                               for e in z2_grid.ptxas_entries(plog) if kernel_label(e["name"])}
        parent = _bind_parent(ppath)
    dumps = ("general_kernel<float,True,2>", "general_kernel<float,False,2>", "general_kernel<float,True,25>")
    for which, lib_path in libs.items():
        for name, instrs in sass_functions(lib_path).items():
            label = kernel_label(name)
            if label == dumps[0]:
                counts = loop_counts(instrs)
                res["sass"][which] = counts
                print(f"SASS {which} general_kernel<float,true,2> event loop: {counts.get('pairs_per_iteration')} "
                      f"pairs/iteration, {counts.get('per_pair_total', 0):.2f} instructions per pair: "
                      + ", ".join(f"{k} {v:.3f}" for k, v in counts.get("per_pair", {}).items()), flush=True)
                print(f"  opcodes: {counts.get('opcodes')}")
            if label in dumps and args.out:
                tag = re.sub(r"\W+", "_", label)
                with open(os.path.splitext(args.out)[0] + f".sass_{which}_{tag}.txt", "w") as fh:
                    fh.writelines(f"/*{a:04x}*/ {op} {ops}\n" for a, op, ops in instrs)

    dev = torch.device("cuda")
    t = surrogate_times(dev)
    n_ev = t.shape[0]
    z = torch.zeros(1, dtype=torch.float64, device=dev)
    res["shapes"] = {}
    for name, (grid, nharm, poly) in SHAPES.items():
        freqs = torch.as_tensor(grid(), device=dev)
        trials, _ = z2_general._occupancy(dev, nharm, 0, int(poly))
        new = lambda: z2_general.general_sums(t, freqs, z, z, nharm, torch.float32, poly)  # noqa: E731
        # the same kernel, split as K2's heuristic would split it
        k2_split = lambda: split_for_sums(z2_general._lib(), t, freqs, nharm, poly, trials,  # noqa: E731
                                          extra=(None,))
        bounds = shape_bounds(freqs.shape[0], n_ev, nharm, poly)
        by = max(bounds, key=bounds.get)
        row = {"trials": freqs.shape[0], "events": n_ev, "nharm": nharm, "poly": poly,
               "bound_ms": bounds[by], "bound_by": by, "bounds_ms": bounds}
        old = ((lambda: split_for_sums(parent, t, freqs, nharm, poly, 256))  # noqa: E731
               if parent is not None else None)
        p1 = cuda_ms(old, args.reps) if old else None
        n1 = cuda_ms(new, args.reps)
        s1 = cuda_ms(k2_split, args.reps)
        s2 = cuda_ms(k2_split, args.reps)
        n2 = cuda_ms(new, args.reps)
        row.update(ms=[n1, n2], n_split_for_ms=[s1, s2], plan=dict(z2_general.LAST_PLAN))
        zn = z2_of(new(), n_ev)
        row["max_dz2_vs_n_split_for"] = float(np.max(np.abs(zn - z2_of(k2_split(), n_ev))))
        if old:
            row["parent_ms"] = [p1, cuda_ms(old, args.reps)]
            row["max_dz2_vs_parent"] = float(np.max(np.abs(zn - z2_of(old(), n_ev))))
        clock_ms, clocks = sm_clock_mhz(new, max(args.reps, 10))
        row["clock_window_ms"], row["sm_clock_mhz"] = clock_ms, clocks
        if name == "a" and clocks and "new" in res["sass"]:
            mhz = float(np.median(clocks))
            warp_pairs = freqs.shape[0] * n_ev / 32 / (4 * torch.cuda.get_device_properties(dev).multi_processor_count)
            cycles = clock_ms * 1e-3 * mhz * 1e6 / warp_pairs
            row["cycles_per_warp_pair"] = cycles
            row["issue_efficiency"] = res["sass"]["new"]["per_pair_total"] / cycles
        row["share_of_bound"] = row["bound_ms"] / min(row["ms"])
        res["shapes"][name] = row
        print(f"shape ({name}) {freqs.shape[0]} trials nharm {nharm} poly={poly}: K3 "
              + " / ".join(f"{v:.3f}" for v in row["ms"]) + f" ms (plan {row['plan']}), bound "
              f"{row['bound_ms']:.2f} ms ({by}; {100 * row['share_of_bound']:.1f}% of bound); the same kernel "
              "split by K2's former heuristic " + " / ".join(f"{v:.3f}" for v in row["n_split_for_ms"]) + " ms"
              + (", parent " + " / ".join(f"{v:.3f}" for v in row["parent_ms"]) + " ms" if old else "")
              + (f"; SM clock median {np.median(clocks):.0f} MHz over {len(clocks)} samples" if clocks else "")
              + (f", {row['cycles_per_warp_pair']:.1f} cycles per warp of pairs per scheduler, issue "
                 f"efficiency {100 * row['issue_efficiency']:.1f}%" if "issue_efficiency" in row else "")
              + "; max |dZ2| " + ", ".join(f"{k[8:]} {v:.3g}" for k, v in row.items() if k.startswith("max_dz2")),
              flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(res, fh, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
