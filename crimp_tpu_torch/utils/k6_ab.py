"""K6 on the card: its build report, its evaluation loop's SASS counted by
pipe, and its Nelder-Mead launches timed, against an earlier version of
its source.

    python -m crimp_tpu_torch.utils.k6_ab [--parent SRC.cu] [--source SRC.cu] [--out FILE] [--reps N]

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit. It builds K6's source with ``z2_grid.NVCC_FLAGS`` and, with
``--parent``, an earlier ``toafit_general.cu`` with the same flags, one
``nvcc`` each, all at once, into ``build/k6_ab/`` (``--source`` puts another source in the repository's
place as the new one, and then K6's twin is not expected to hold its
bits). Either source may have the one-problem-a-block C interface (no
``group`` argument) or the grouped one (``group``
after ``iters``, ``toafit_general_max_group``); the binding follows the
symbols the library exports. It prints:

- each kernel's registers, stack frame and spill bytes (``-Xptxas -v``);
- the evaluation loop's instructions per vertex-event by pipe (DFMA, DADD,
  DMUL, MUFU, ...), from ``cuobjdump -sass`` of a counting build of each
  source with the family fixed to Fourier and K to 6 (``p.kind`` -> 0,
  ``p.n_comp`` -> 6: every component loop unrolls): of the backward-branch
  loops that load an event's phase (``LDG.E.64``, one an event) and take
  reciprocals (``MUFU.RCP64H``: two a vertex-event, the division's and the
  libdevice ``log``'s), each one's own instructions over its vertex-events,
  and its local loads and stores (spills). The libdevice ``cos``, ``sin``
  and ``log`` fast paths are inline in that count; their slow paths (and
  the division's) are subroutines outside the loop (``CALL``, counted
  apart);
- on the north star's fit shape (84 rows x 10 000 uniform phases, seed 7,
  the bundled Fourier template with its 13 ``vary`` parameters free,
  ``nm_iters`` 150): raw ``toafit_general_nm`` launches at 128 (the brute
  grid), 64 (the dense error window) and 1 (a golden-section point)
  phases, timed with CUDA events in turns parent / new / new / parent,
  each beside ``obs/costmodel.py::k6_counts``' bound (the evaluations its
  decisions read), checked bit for bit against the parent in LL, vectors,
  shrinks, reads and the per-step trace, and against the twin
  (``general_profile_reference`` on the card: all rows at one phase, rows
  0, 41 and 83 at 128 and 64);
- for a grouped source, the new kernel at every group size G above 1
  (``general_sweep.GROUPS``, the phases a block takes side by side) at
  128 and 64 phases, each bitwise the default launch;
- the readvaryparam fit's golden-section refine at that shape (25
  iterations on the brute grid's best phase +- one grid step, then the
  profile at the optimum): the chain of 2 + 2 refine_iters one-phase
  launches under ``optimize.golden_section`` and, where the source has
  ``toafit_general_golden``, its one launch, timed in turns chain / one /
  one / chain and held bit for bit to the chain in phi_best, ll_max and
  the vector at the optimum; one P 1 launch (G 1) and one P 2 launch
  (G 2) timed alone, a round's cost one point a launch and both side by
  side; the one launch beside ``k6_golden_counts``' bound.

``--out`` writes everything as JSON.
"""

from __future__ import annotations

import argparse
import collections
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
from crimp_tpu_torch.ops import general_sweep, optimize, toafit, z2_grid
from crimp_tpu_torch.utils.k3_ab import _tool, sass_functions
from crimp_tpu_torch.utils.k5_ab import PIPES, _loops, _own, bound_ms, event_ms

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TEMPLATE = os.path.join(REPO, "tests", "data", "1e2259_template.txt")
OUT_DIR = os.path.join(REPO, "build", "k6_ab")
SHAPE = (84, 10000)  # rows x events a row: the north star's fit
PHIS = (128, 64, 1)
GROUPS = general_sweep.GROUPS[1:]
TWIN_ROWS = (0, 41, 83)  # rows held to the twin where all of them would take too long
NM_ITERS = 150
N_BRUTE = 128  # the fit's brute grid: the golden bracket is its best phase +- one step


def _pipe(op: str) -> str:
    base = op.split(".")[0]
    if base == "CALL":
        return "call"
    return next((name for name, bases in PIPES if base in bases), "other")


def counting_source(text: str) -> str:
    """The source with the family fixed to Fourier, K to 6 and every
    component loop unrolled."""
    return (text.replace("p.kind", "0").replace("p.n_comp", "6")
            .replace("for (int k = 0; k < K; ++k)", "_Pragma(\"unroll\") for (int k = 0; k < K; ++k)"))


def build(sources: dict) -> dict:
    """{tag: (library path, -Xptxas -v log)} for {tag: source path}, one
    nvcc a source, all started together."""
    os.makedirs(OUT_DIR, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for tag, src in sources.items():
        out = os.path.join(OUT_DIR, f"libk6_{tag}.so")
        procs[tag] = (subprocess.Popen([_tool("nvcc"), *z2_grid.NVCC_FLAGS, "-o", out, src], stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True), out)
    built = {}
    for tag, (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc of {sources[tag]} failed:\n{log}")
        built[tag] = (out, log)
        print(f"nvcc {tag}: done {time.perf_counter() - t0:.1f} s after the start", flush=True)
    return built


def counting_build(tag: str, src: str) -> str:
    path = os.path.join(OUT_DIR, f"toafit_general_{tag}_count.cu")
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(src) as fh, open(path, "w") as out:
        out.write(counting_source(fh.read()))
    return path


def event_loops(instrs: list) -> list:
    """Per evaluation loop (see the module note): its divisions (vertices
    an event), phase loads (events an iteration), and own instructions per
    vertex-event by pipe."""
    loops = _loops(instrs)
    out = []
    for loop in loops:
        ops = _own(instrs, loop, loops)
        n_rcp = sum(op.startswith("MUFU.RCP64H") for op in ops)
        n_x = sum(op.startswith("LDG.E.64") for op in ops)
        if n_rcp >= 2 and n_x:
            n_ve = n_rcp // 2  # a vertex-event: its division and its log, a reciprocal each
            per = collections.Counter(_pipe(op) for op in ops)
            out.append({"vertices": n_ve // n_x, "events_per_iteration": n_x,
                        "instructions_per_vertex_event": len(ops) / n_ve,
                        "per_vertex_event": {k: v / n_ve for k, v in sorted(per.items())},
                        "local_memory": per_local(ops)})
    return sorted(out, key=lambda e: -e["vertices"])


def per_local(ops: list) -> int:
    """Spill traffic in a loop: its local loads and stores."""
    return sum(op.split(".")[0] in ("LDL", "STL") for op in ops)


def sass_report(lib_path: str) -> dict:
    """{kernel: [evaluation loops]} of the counting build's nm and eval kernels."""
    out = {}
    for name, instrs in sass_functions(lib_path).items():
        m = re.search(r"(nm_kernel|eval_kernel)(?:ILi(\d+)E)?", name)
        if m:
            label = m.group(1) + (f"<{m.group(2)}>" if m.group(2) else "")
            out[label] = event_loops(instrs)
    return out


def ptxas(log: str) -> dict:
    return {e["name"]: {k: e[k] for k in ("registers", "stack", "spill")} for e in z2_grid.ptxas_entries(log)}


class K6Lib:
    """A toafit_general library: ``nm(...)`` launches its Nelder-Mead once."""

    def __init__(self, path: str):
        self.lib = lib = ctypes.CDLL(path)
        vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        self.grouped = hasattr(lib, "toafit_general_max_group")
        if self.grouped:
            lib.toafit_general_max_group.argtypes = [ci]
            lib.toafit_general_max_group.restype = ci
        lib.toafit_general_nm.argtypes = ([vp] * 9 + [ci, ci, cl, ci, ci, ci, ci] + ([ci] if self.grouped else [])
                                          + [vp] * 6)
        lib.toafit_general_nm.restype = ci
        self.has_golden = hasattr(lib, "toafit_general_golden")
        if self.has_golden:
            lib.toafit_general_golden.argtypes = general_sweep.GOLDEN_ARGTYPES
            lib.toafit_general_golden.restype = ci

    def golden(self, kind, tpl, x, mask, exposure, lo, hi, cfg):
        """One toafit_general_golden launch: (phi_best, ll_max, vec_best,
        shrinks, reads)."""
        return general_sweep._launch_golden(kind, tpl, x, mask, exposure, lo, hi, cfg, lib=self.lib)

    def nm(self, kind, tpl, x, mask, exposure, phis, cfg, group: int | None = None, trace: bool = False):
        S, P = phis.shape
        D = 3 * tpl.n_comp + 2
        pk = general_sweep.pack(tpl, cfg, S, None, x.device)
        ll = torch.empty((S, P), dtype=torch.float64, device=x.device)
        vec = torch.empty((S, P, D), dtype=torch.float64, device=x.device)
        shrinks = torch.zeros((S, P), dtype=torch.int32, device=x.device)
        reads = torch.zeros((S, P), dtype=torch.int32, device=x.device)
        steps = torch.empty((S, P, cfg.nm_iters), dtype=torch.int8, device=x.device) if trace else None
        grp = ()
        if self.grouped:
            grp = (general_sweep.group_for(P, len(cfg.free_idx), self.lib) if group is None else group,)
        rc = self.lib.toafit_general_nm(*general_sweep._args(pk, x, mask, exposure, phis), pk["u0"].data_ptr(), S, P,
                                        x.shape[1], tpl.n_comp, 0, len(cfg.free_idx), cfg.nm_iters, *grp,
                                        ll.data_ptr(), vec.data_ptr(), shrinks.data_ptr(), reads.data_ptr(),
                                        None if steps is None else steps.data_ptr(), z2_grid.stream_of(x))
        z2_grid.check_launch(rc, "toafit_general_nm")
        return ll, vec, shrinks, reads, steps

    def group(self, P: int, F: int):
        return general_sweep.group_for(P, F, self.lib) if self.grouped else 1


def bitwise(a, b) -> bool:
    return all(torch.equal(u, v) for u, v in zip(a, b) if u is not None)


def operands(dev):
    rows, n_ev = SHAPE
    x = torch.as_tensor(np.random.RandomState(7).uniform(0, 1, (rows, n_ev)), device=dev)
    mask = torch.ones(rows, n_ev, dtype=torch.bool, device=dev)
    exposure = torch.full((rows,), n_ev / 17.0, dtype=torch.float64, device=dev)
    return x, mask, exposure


def golden_part(new: K6Lib, kind, tpl, cfg, x, mask, exposure, reps: int) -> dict:
    """The golden-section refine as the chain and as the one launch (module
    note), timed in turns."""
    rows, n_ev = x.shape
    F = len(cfg.free_idx)
    grid = torch.as_tensor(np.linspace(-np.pi, np.pi, N_BRUTE), device=x.device)
    brute = new.nm(kind, tpl, x, mask, exposure, grid.expand(rows, N_BRUTE).contiguous(), cfg)[0]
    phi0 = grid[torch.argmax(brute, dim=1)]
    step = 2 * np.pi / (N_BRUTE - 1)
    lo, hi = (phi0 - step).contiguous(), (phi0 + step).contiguous()

    def at(phis, group):
        return new.nm(kind, tpl, x, mask, exposure, phis.contiguous(), cfg, group=group)

    def chain():
        phi, ll = optimize.golden_section(lambda p: at(p[:, None], 1)[0][:, 0], lo, hi, iters=cfg.refine_iters)
        return phi, ll, at(phi[:, None], 1)[1][:, 0]

    arms = {"chain": chain}
    if new.has_golden:
        arms["one launch"] = lambda: new.golden(kind, tpl, x, mask, exposure, lo, hi, cfg)
    want = chain()
    out = {"rows": rows, "events": n_ev, "refine_iters": cfg.refine_iters, "bitwise_chain": {}}
    for name, fn in arms.items():
        got = fn()
        out["bitwise_chain"][name] = all(torch.equal(a, b) for a, b in zip(got[:3], want))
    out["ms"] = {name: [] for name in arms}
    for name in list(arms) + list(reversed(arms)):
        out["ms"][name].append(event_ms(arms[name], reps))
    out["launch_ms"] = {"P1 G1": event_ms(lambda: at(lo[:, None], 1), 4 * reps),
                        "P2 G2": event_ms(lambda: at(torch.stack([lo, hi], dim=1), 2), 4 * reps)}
    out["ms_per_round"] = {name: min(ms) / (1 + cfg.refine_iters) for name, ms in out["ms"].items()}
    if new.has_golden:
        got = new.golden(kind, tpl, x, mask, exposure, lo, hi, cfg)
        counts = costmodel.k6_golden_counts(rows, float(n_ev), tpl.n_comp, kind, F, cfg.refine_iters,
                                            float(got[4].sum()), float(got[3].sum()))
        out["bound_ms"] = bound_ms(counts)
    print(f"golden refine ({rows} x {n_ev}, {F} free, {cfg.refine_iters} iterations): "
          + "; ".join(f"{name} " + " / ".join(f"{v:.3f}" for v in ms) + " ms" for name, ms in out["ms"].items())
          + "; a round " + ", ".join(f"{k} {v:.3f} ms" for k, v in out["ms_per_round"].items())
          + "; one launch alone: " + ", ".join(f"{k} {v:.3f} ms" for k, v in out["launch_ms"].items())
          + (f"; bound {out['bound_ms']:.4f} ms ({100 * out['bound_ms'] / min(out['ms']['one launch']):.2f}%)"
             if "bound_ms" in out else "")
          + "; bitwise the chain: " + ", ".join(f"{k} {v}" for k, v in out["bitwise_chain"].items()),
          flush=True)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", default=None, help="an earlier toafit_general.cu to time beside K6")
    parser.add_argument("--source", default=None, help="a toafit_general.cu to take for the repository's")
    parser.add_argument("--out", default=None, help="write the results as JSON here")
    parser.add_argument("--reps", type=int, default=3)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k6_ab needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    res = {"card": card, "time": time.time()}
    src = args.source or str(z2_grid.SOURCES["toafit_general"])
    sources = {"new": src, "new_count": counting_build("new", src)}
    if args.parent:
        sources["parent"] = args.parent
        sources["parent_count"] = counting_build("parent", args.parent)
    built = build(sources)
    new_path, new_log = built["new"]
    res["source"] = src
    res["build"] = {"new": ptxas(new_log)}
    if args.parent:
        res["build"]["parent"] = ptxas(built["parent"][1])
    for which, entries in res["build"].items():
        for name, e in entries.items():
            print(f"ptxas {which} {name}: {e['registers']} registers, {e['stack']} B stack, {e['spill']} B spill",
                  flush=True)
    res["sass"] = {which: sass_report(built[f"{which}_count"][0]) for which in ("new", "parent")
                   if f"{which}_count" in built}
    for which, kernels in res["sass"].items():
        for kname, loops in kernels.items():
            for lp in loops:
                print(f"SASS {which} {kname}, Fourier K 6, loop of {lp['vertices']} vertices x "
                      f"{lp['events_per_iteration']} events: {lp['instructions_per_vertex_event']:.2f} instructions a "
                      "vertex-event: " + ", ".join(f"{k} {v:.2f}" for k, v in lp["per_vertex_event"].items())
                      + f"; {lp['local_memory']} local loads and stores in the loop", flush=True)

    dev = torch.device("cuda")
    tpl_dict = template_io.read_template(TEMPLATE)
    kind, tpl = profiles.from_template(tpl_dict)
    idx, lo, hi, n_free = toafit.free_param_spec(kind, tpl_dict)
    cfg = toafit.ToAFitConfig(kind=kind, free_idx=idx, free_lo=lo, free_hi=hi, n_free=n_free, nm_iters=NM_ITERS)
    tpl = tpl.to(dev)
    new = K6Lib(new_path)
    old = K6Lib(built["parent"][0]) if args.parent else None
    x, mask, exposure = operands(dev)
    rows, n_ev = SHAPE
    F = len(idx)
    res["launches"] = []
    for P in PHIS:
        phis = torch.as_tensor(np.tile(np.linspace(-np.pi, np.pi, P) if P > 1 else [0.3], (rows, 1)), device=dev)
        call = (kind, tpl, x, mask, exposure, phis, cfg)
        got = new.nm(*call, trace=True)
        torch.cuda.synchronize()
        row = {"phis": P, "rows": rows, "events": n_ev, "group": new.group(P, F),
               "reads": float(got[3].sum()), "shrinks": float(got[2].sum())}
        counts = costmodel.k6_counts(rows, P, float(n_ev), tpl.n_comp, kind, F, row["reads"], row["shrinks"])
        row["bound_ms"] = bound_ms(counts)
        row["reads_a_step"] = row["reads"] / (rows * P * NM_ITERS)
        twin_rows = list(range(rows)) if P == 1 else list(TWIN_ROWS)
        sub = (x[twin_rows], mask[twin_rows], exposure[twin_rows], phis[twin_rows].contiguous())
        ll_t, vec_t = general_sweep.general_profile_reference(kind, tpl, *sub, cfg)
        row["bitwise_twin"] = bool(torch.equal(got[0][twin_rows], ll_t) and torch.equal(got[1][twin_rows], vec_t))
        row["twin_rows"] = len(twin_rows)
        if old is not None:
            want = old.nm(*call, trace=True)
            row["bitwise_parent"] = bitwise(got, want)
            reps = 1 if P > 1 else args.reps
            p1 = event_ms(lambda: old.nm(*call), reps)
        reps = 1 if (P > 1 and not new.grouped) else args.reps
        row["ms"] = [event_ms(lambda: new.nm(*call), reps), event_ms(lambda: new.nm(*call), reps)]
        if old is not None:
            row["parent_ms"] = [p1, event_ms(lambda: old.nm(*call), 1 if P > 1 else args.reps)]
        row["share_of_bound"] = row["bound_ms"] / min(row["ms"])
        if new.grouped and P > 1:
            row["by_group"] = {}
            for g in GROUPS:
                if g > P or g > general_sweep.group_for(1 << 30, F, new.lib, preferred=max(GROUPS)):
                    continue
                alt = new.nm(*call, group=g, trace=True)
                ms = event_ms(lambda: new.nm(*call, group=g), args.reps)
                row["by_group"][g] = {"ms": ms, "bitwise_default": bitwise(alt, got)}
        res["launches"].append(row)
        print(f"K6 {rows} x {P} phases x {n_ev} events, {F} free, G {row['group']}: "
              + " / ".join(f"{v:.3f}" for v in row["ms"]) + " ms"
              + (", parent " + " / ".join(f"{v:.3f}" for v in row["parent_ms"]) + " ms" if old else "")
              + f"; bound {row['bound_ms']:.4f} ms ({100 * row['share_of_bound']:.2f}%), "
              f"{row['reads_a_step']:.3f} reads a step, {row['shrinks']:.0f} shrink steps; bitwise the twin on "
              f"{row['twin_rows']} rows: {row['bitwise_twin']}"
              + (f"; bitwise the parent (LL, vectors, shrinks, reads, trace): {row['bitwise_parent']}" if old else "")
              + ("; by G: " + ", ".join(f"{g}: {v['ms']:.3f} ms{'' if v['bitwise_default'] else ' NOT bitwise'}"
                                        for g, v in row["by_group"].items()) if "by_group" in row else ""),
              flush=True)
    res["golden"] = golden_part(new, kind, tpl, cfg, x, mask, exposure, max(1, args.reps // 2))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(res, fh, indent=1)
    if not all(res["golden"]["bitwise_chain"].values()):
        print("golden refine: NOT bitwise the chain", flush=True)
        return 1
    bad = [r["phis"] for r in res["launches"] if not (r["bitwise_twin"] or args.source)
           or not r.get("bitwise_parent", True)
           or not all(v["bitwise_default"] for v in r.get("by_group", {}).values())]
    if bad:
        print(f"NOT bitwise at P {bad}", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
