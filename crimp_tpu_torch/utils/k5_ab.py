"""K5 on the card: its build report, its Newton pass's SASS counted by pipe,
its sweeps and its golden-section refine timed, against an earlier version
of its source.

    python -m crimp_tpu_torch.utils.k5_ab [--parent SRC.cu] [--out FILE] [--reps N]

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit. It builds the kernels (``z2_grid.build()``) and, with
``--parent``, an earlier ``toafit.cu`` with the same flags into
``build/k5_ab/`` (a sweep-only K5 from before the golden-section refine
joined it, whose ``toafit_profile`` also takes the (S, P, K) cos(j phi)
and sin(j phi) operands, made here with torch as its wrapper made them).
It prints:

- each kernel's registers, stack frame and spill bytes (``-Xptxas -v``);
- the Newton pass on A of the shared-memory sweep, from ``cuobjdump
  -sass``: of the backward-branch loops that read the shape term from
  shared memory and take a reciprocal (``MUFU.RCP64H``) with at most five
  f64 adds an event (the joint pass has six), inside a loop (the Newton
  steps; the log-sum pass after them is in none), the one with the most
  events an iteration (the unrolled body), its instructions per event by
  pipe (DFMA, DADD, DMUL, MUFU, ...), and the pass's own instructions
  outside its event loops (the block reduction with its barriers, the
  Newton update) by pipe. The parent's sweep branches on the shape term's
  place inside its event loops, so its count comes from a second build of
  it whose ``s_at`` reads shared memory only (``PARENT_SMEM_ONLY``), the
  path a row in shared memory takes; in both builds the division's or the
  reciprocal's slow path is a subroutine outside the loop;
- on the north star's fit shape (84 rows x 10 000 uniform phases, seed 7,
  the bundled Fourier template, exposure 10 000 / 17), Newton on A: the
  sweeps at 128 (the brute grid), 64 (the dense error window) and 1 (a
  golden-section point) phases, raw launches timed with CUDA events in
  turns, parent / K5 / K5 / parent, each beside its f64 bound
  (``obs/costmodel.py::k5_counts``) and checked against the twin's
  tolerances (LL rtol 1e-12, A and b rtol 1e-10) and for bits against the
  parent;
- the golden-section refine at that shape and at BASELINE's config 4
  shape (500 x 2000): one ``toafit_golden`` launch against the chain it
  replaced (``golden_refine_reference`` over one-phase ``profile_sweep``
  launches: 2 + 2 refine_iters sweeps with ``golden_section``'s torch
  bookkeeping, then the nuisance sweep), bitwise, both timed with CUDA
  events round the whole call and by the host clock (card synchronized),
  in turns chain / launch / launch / chain, beside ``k5_golden_counts``'
  bound; with ``--parent`` also the parent's chain.

``--out`` writes everything as JSON.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import functools
import json
import os
import subprocess
import time

import numpy as np
import torch

from crimp_tpu_torch.io import template as template_io
from crimp_tpu_torch.models import profiles
from crimp_tpu_torch.obs import costmodel
from crimp_tpu_torch.ops import toafit, z2_grid
from crimp_tpu_torch.utils.k3_ab import _branch_target, _tool, sass_functions

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TEMPLATE = os.path.join(REPO, "tests", "data", "1e2259_template.txt")
PEAK_F64_FLOPS = 34e12  # H100 SXM at 700 W, outside the tensor cores
PEAK_HBM_BYTES = 3.35e12
PHIS = (128, 64, 1)
SHAPES = {"north star": (84, 10000), "config 4": (500, 2000)}  # (rows, events a row)
PIPES = (("DFMA", ("DFMA",)), ("DADD", ("DADD",)), ("DMUL", ("DMUL",)), ("MUFU", ("MUFU",)),
         ("BAR", ("BAR",)), ("f64 other", ("DSETP", "DMNMX")), ("select", ("SEL", "FSEL")),
         ("shared load", ("LDS",)), ("global load", ("LDG",)), ("shuffle", ("SHFL",)))


def _pipe(op: str) -> str:
    base = op.split(".")[0]
    return next((name for name, bases in PIPES if base in bases), "other")


def _loops(instrs: list) -> list:
    """(first, last) addresses of each backward-branch loop."""
    out = []
    for addr, op, args in instrs:
        if op.split(".")[0] == "BRA":
            tgt = _branch_target(args)
            if tgt is not None and tgt <= addr:
                out.append((tgt, addr))
    return out


def _own(instrs: list, loop: tuple, loops: list) -> list:
    """Opcodes of ``loop`` without those of the loops nested in it."""
    inner = [o for o in loops if o != loop and loop[0] <= o[0] and o[1] <= loop[1]]
    return [op for a, op, _ in instrs
            if loop[0] <= a <= loop[1] and not any(lo <= a <= hi for lo, hi in inner)]


def newton_pass_counts(instrs: list, n_events: int = 10000, threads: int = 512) -> dict:
    """The Newton pass on A of a shared-memory sweep, by pipe (see the module
    note): per event of its event loop, the pass's own instructions outside
    its event loops, and the pass at ``n_events`` a row."""
    loops = _loops(instrs)
    cands = []
    for loop in loops:
        ops = _own(instrs, loop, loops)
        n_rcp = sum(op.startswith("MUFU.RCP64H") for op in ops)
        nested = any(o != loop and o[0] <= loop[0] and loop[1] <= o[1] for o in loops)
        if n_rcp and nested and any(op.startswith("LDS") for op in ops) \
                and sum(op.startswith("DADD") for op in ops) <= 5 * n_rcp:
            cands.append((n_rcp, -len(ops), loop, ops))
    if not cands:
        return {}
    n_rcp, _, loop, ops = max(cands)
    outer = [o for o in loops if o != loop and o[0] <= loop[0] and loop[1] <= o[1]]
    per_event = collections.Counter(_pipe(op) for op in ops)
    out = {"events_per_iteration": n_rcp, "instructions_per_event": len(ops) / n_rcp,
           "per_event": {k: v / n_rcp for k, v in sorted(per_event.items())}}
    if outer:
        pass_loop = min(outer, key=lambda o: o[1] - o[0])
        own = _own(instrs, pass_loop, loops)
        per_pass = collections.Counter(_pipe(op) for op in own)
        per_thread = -(-n_events // threads)
        out.update(pass_own_instructions=len(own), pass_own={k: v for k, v in sorted(per_pass.items())},
                   events_per_thread=per_thread,
                   pass_total={k: per_event.get(k, 0) / n_rcp * per_thread + per_pass.get(k, 0)
                               for k in sorted(set(per_event) | set(per_pass))})
    return out


def sass_report(lib_path: str, kernel_tag: str) -> dict:
    """Newton pass counts of the first kernel whose mangled name holds
    ``kernel_tag`` (the shared-memory sweep)."""
    for name, instrs in sass_functions(lib_path).items():
        if kernel_tag in name:
            return {"kernel": name, **newton_pass_counts(instrs)}
    return {}


# the parent's shape-term accessor, and the shared-memory path alone (its SASS count)
PARENT_S_AT = "auto s_at = [&](long long i) { return p.s_in_smem ? s_val[i] : shape_term(p, c, r, i, phi); };"
PARENT_SMEM_ONLY = "auto s_at = [&](long long i) { return s_val[i]; };"


def build_parent(src: str) -> tuple[str, str, str | None]:
    """The parent's library and -Xptxas -v report, and its shared-memory-only
    build for the SASS count (None when the source has no such accessor);
    both nvcc processes run together."""
    out_dir = os.path.join(REPO, "build", "k5_ab")
    os.makedirs(out_dir, exist_ok=True)
    text = open(src).read()
    jobs = {"parent": (src, os.path.join(out_dir, "libtoafit_parent.so"))}
    if PARENT_S_AT in text:
        smem_src = os.path.join(out_dir, "toafit_parent_smem_only.cu")
        with open(smem_src, "w") as fh:
            fh.write(text.replace(PARENT_S_AT, PARENT_SMEM_ONLY))
        jobs["smem"] = (smem_src, os.path.join(out_dir, "libtoafit_parent_smem_only.so"))
    procs = {k: subprocess.Popen([_tool("nvcc"), *z2_grid.NVCC_FLAGS, "-o", out, path], stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True) for k, (path, out) in jobs.items()}
    logs = {}
    for k, proc in procs.items():
        logs[k], _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc of {jobs[k][0]} failed:\n{logs[k]}")
    return jobs["parent"][1], logs["parent"], jobs["smem"][1] if "smem" in jobs else None


def parent_sweep(lib):
    """The parent's ``toafit_profile`` as a ``profile_sweep``: (LL, A, b)."""
    def sweep(kind, tpl, x, mask, exposure, phis, cfg, events):
        S, N = x.shape
        P = phis.shape[1]
        j = torch.arange(1, tpl.n_comp + 1, dtype=torch.float64, device=x.device)
        cosj, sinj = torch.cos(j * phis[..., None]), torch.sin(j * phis[..., None])
        out = [torch.empty(S, P, dtype=torch.float64, device=x.device) for _ in range(3)]
        rc = lib.toafit_profile(x.data_ptr(), mask.data_ptr(), exposure.data_ptr(), phis.data_ptr(),
                                cosj.data_ptr(), sinj.data_ptr(), events["ev_c"].data_ptr(),
                                events["ev_s"].data_ptr(), None, events["row"].data_ptr(), S, P, N, tpl.n_comp,
                                0, toafit.norm_mode(cfg), cfg.newton_iters, cfg.norm_hi, cfg.amp_lo, cfg.amp_hi,
                                int(cfg.mxu_bf16 == 1), *(t.data_ptr() for t in out), z2_grid.stream_of(x))
        z2_grid.check_launch(rc, "parent toafit_profile")
        return tuple(out)
    return sweep


def bind_parent(path: str):
    lib = ctypes.CDLL(path)
    vp, ci, cd = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.toafit_profile.argtypes = [vp] * 10 + [ci, ci, ctypes.c_longlong, ci, ci, ci, ci, cd, cd, cd, ci,
                                               vp, vp, vp, vp]
    lib.toafit_profile.restype = ci
    return lib


def event_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps calls (CUDA events round them all),
    after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def host_ms(fn, reps: int) -> float:
    """Mean host wall of fn() with the card synchronized, over reps calls."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def within_twin(got, want) -> bool:
    ll, ll_w = got[0], want[0]
    fin = torch.isfinite(ll_w)
    return bool(torch.equal(torch.isfinite(ll), fin)) and bool(
        torch.all(torch.abs(ll[fin] - ll_w[fin]) <= 1e-12 * torch.abs(ll_w[fin]))) and all(
        bool(torch.all(torch.abs(g - w) <= 1e-10 * torch.abs(w))) for g, w in zip(got[1:], want[1:]))


def bound_ms(counts: dict) -> float:
    return max(counts["flops"] / PEAK_F64_FLOPS, counts["bytes_accessed"] / PEAK_HBM_BYTES) * 1e3


def operands(rows: int, n_events: int, dev, kind, tpl, cfg):
    x = torch.as_tensor(np.random.RandomState(7).uniform(0, 1, (rows, n_events)), device=dev)
    mask = torch.ones(rows, n_events, dtype=torch.bool, device=dev)
    exposure = torch.full((rows,), n_events / 17.0, dtype=torch.float64, device=dev)
    return x, mask, exposure, toafit.sweep_events(kind, tpl, x, cfg)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", default=None, help="an earlier toafit.cu (or its built .so) to time beside K5")
    parser.add_argument("--out", default=None, help="write the results as JSON here")
    parser.add_argument("--reps", type=int, default=10)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k5_ab needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    res = {"card": card, "time": time.time()}
    paths = z2_grid.build(force=True)
    res["build"] = {e["name"]: {k: e[k] for k in ("registers", "stack", "spill")}
                    for e in z2_grid.ptxas_entries(z2_grid.BUILD_INFO["toafit"]["log"])}
    libs = {"k5": (str(paths["toafit"]), "profile_kernelILb1E")}
    parent = None
    if args.parent:
        ppath, plog, psmem = (args.parent, "", None) if args.parent.endswith(".so") else build_parent(args.parent)
        res["parent_build"] = {e["name"]: {k: e[k] for k in ("registers", "stack", "spill")}
                               for e in z2_grid.ptxas_entries(plog)}
        libs["parent"] = (psmem or ppath, "profile_kernel")
        parent = bind_parent(ppath)
    for which in ("build", "parent_build"):
        for name, e in res.get(which, {}).items():
            print(f"{which} {name}: {e['registers']} registers, {e['stack']} B stack, {e['spill']} B spill",
                  flush=True)
    res["sass"] = {}
    for which, (path, tag) in libs.items():
        res["sass"][which] = counts = sass_report(path, tag)
        print(f"SASS {which} Newton pass ({counts.get('kernel')}): {counts.get('events_per_iteration')} events an "
              f"iteration, {counts.get('instructions_per_event', 0):.2f} instructions an event: "
              + ", ".join(f"{k} {v:.2f}" for k, v in counts.get("per_event", {}).items())
              + f"; the pass's own {counts.get('pass_own_instructions')}: {counts.get('pass_own')}; a pass at "
              f"10 000 events ({counts.get('events_per_thread')} a thread): "
              + ", ".join(f"{k} {v:.1f}" for k, v in counts.get("pass_total", {}).items()), flush=True)

    dev = torch.device("cuda")
    kind, tpl = profiles.from_template(template_io.read_template(TEMPLATE))
    tpl = tpl.to(dev)
    cfg = toafit.ToAFitConfig(kind=kind)
    k5_sweep = toafit._launch_profile
    old_sweep = parent_sweep(parent) if parent is not None else None
    rows, n_ev = SHAPES["north star"]
    x, mask, exposure, events = operands(rows, n_ev, dev, kind, tpl, cfg)
    res["sweeps"] = []
    for n_phis in PHIS:
        phis = torch.as_tensor(np.tile(np.linspace(-np.pi, np.pi, n_phis), (rows, 1)), device=dev)
        call = (kind, tpl, x, mask, exposure, phis, cfg, events)
        got = k5_sweep(*call)
        want = toafit.profile_sweep_reference(*call[:-1])
        row = {"phis": n_phis, "rows": rows, "events": n_ev, "within_twin": within_twin(got, want),
               "bound_ms": bound_ms(costmodel.k5_counts(rows, n_phis, n_ev, tpl.n_comp, kind,
                                                        toafit.norm_mode(cfg), cfg.newton_iters))}
        if not row["within_twin"]:
            raise RuntimeError(f"K5 P {n_phis}: beyond the twin tolerances")
        if old_sweep is not None:
            old = old_sweep(*call)
            row["bitwise_parent"] = all(torch.equal(a, b) for a, b in zip(got, old))
            row["max_abs_vs_parent"] = max(float(torch.max(torch.abs(a - b)[torch.isfinite(a) & torch.isfinite(b)]))
                                           for a, b in zip(got, old))
            p1 = event_ms(lambda: old_sweep(*call), args.reps)
        n1 = event_ms(lambda: k5_sweep(*call), args.reps)
        n2 = event_ms(lambda: k5_sweep(*call), args.reps)
        row["ms"] = [n1, n2]
        if old_sweep is not None:
            row["parent_ms"] = [p1, event_ms(lambda: old_sweep(*call), args.reps)]
        row["share_of_bound"] = row["bound_ms"] / min(row["ms"])
        res["sweeps"].append(row)
        print(f"sweep {rows} x {n_phis} phases x {n_ev} events: K5 " + " / ".join(f"{v:.4f}" for v in row["ms"])
              + " ms" + (", parent " + " / ".join(f"{v:.4f}" for v in row["parent_ms"]) + " ms" if old_sweep else "")
              + f"; bound {row['bound_ms']:.4f} ms ({100 * row['share_of_bound']:.2f}%)"
              + (f"; bitwise the parent: {row['bitwise_parent']} (max |d| {row['max_abs_vs_parent']:.3g})"
                 if old_sweep else ""), flush=True)

    res["golden"] = []
    for label, (rows, n_ev) in SHAPES.items():
        x, mask, exposure, events = operands(rows, n_ev, dev, kind, tpl, cfg)
        brute = toafit.profile_sweep(kind, tpl, x, mask, exposure, torch.as_tensor(
            np.tile(np.linspace(-np.pi, np.pi, cfg.n_brute), (rows, 1)), device=dev), cfg, events=events)[0]
        phi0 = torch.as_tensor(np.linspace(-np.pi, np.pi, cfg.n_brute), device=dev)[torch.argmax(brute, dim=1)]
        step = 2 * np.pi / (cfg.n_brute - 1)
        lo, hi = phi0 - step, phi0 + step
        golden = lambda: toafit.golden_refine(kind, tpl, x, mask, exposure, lo, hi, cfg, events)  # noqa: E731
        chains = {"chain": lambda: toafit.golden_refine_reference(  # noqa: E731
            kind, tpl, x, mask, exposure, lo, hi, cfg, sweep=functools.partial(toafit.profile_sweep, events=events))}
        if old_sweep is not None:
            chains["parent chain"] = lambda: toafit.golden_refine_reference(  # noqa: E731
                kind, tpl, x, mask, exposure, lo, hi, cfg, sweep=functools.partial(old_sweep, events=events))
        got = golden()
        row = {"shape": label, "rows": rows, "events": n_ev, "refine_iters": cfg.refine_iters,
               "bound_ms": bound_ms(costmodel.k5_golden_counts(rows, n_ev, tpl.n_comp, kind, toafit.norm_mode(cfg),
                                                               cfg.newton_iters, cfg.refine_iters))}
        for name, fn in chains.items():
            want = fn()
            row[f"bitwise_{name.replace(' ', '_')}"] = all(torch.equal(a, b) for a, b in zip(got, want))
        if not row["bitwise_chain"]:
            raise RuntimeError(f"golden launch at {label}: not bitwise the chain of one-phase K5 sweeps")
        reps = max(2, args.reps // 2)
        for name, fn in chains.items():
            row[f"{name} ms"] = [event_ms(fn, reps)]
            row[f"{name} host ms"] = [host_ms(fn, reps)]
        row["ms"] = [event_ms(golden, reps), event_ms(golden, reps)]
        row["host ms"] = [host_ms(golden, reps)]
        for name, fn in reversed(list(chains.items())):
            row[f"{name} ms"].append(event_ms(fn, reps))
            row[f"{name} host ms"].append(host_ms(fn, reps))
        res["golden"].append(row)
        print(f"golden refine at {label} ({rows} x {n_ev}, {cfg.refine_iters} iterations): one launch "
              + " / ".join(f"{v:.4f}" for v in row["ms"]) + f" ms (host {row['host ms'][0]:.3f} ms); "
              + "; ".join(f"{name} " + " / ".join(f"{v:.4f}" for v in row[f"{name} ms"]) + " ms (host "
                          + " / ".join(f"{v:.3f}" for v in row[f"{name} host ms"]) + " ms)" for name in chains)
              + f"; bound {row['bound_ms']:.4f} ms ({100 * row['bound_ms'] / min(row['ms']):.2f}%); bitwise: "
              + ", ".join(f"{k[8:]} {v}" for k, v in row.items() if k.startswith("bitwise_")), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(res, fh, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
