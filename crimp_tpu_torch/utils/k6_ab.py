"""K6 on the card: its build report, its evaluation loop's SASS counted by
pipe, and its Nelder-Mead launches timed, against an earlier version of
its source.

    python -m crimp_tpu_torch.utils.k6_ab [--parent SRC.cu] [--source SRC.cu] [--out FILE] [--reps N]
                                          [--probe] [--stage-u U1,U2,U4 ...]
    python -m crimp_tpu_torch.utils.k6_ab --groups [--sets N] [--reps N] [--out FILE]
    python -m crimp_tpu_torch.utils.k6_ab --plans [--reps N] [--out FILE]

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit. It builds K6's source with ``z2_grid.NVCC_FLAGS`` and, with
``--parent``, an earlier ``toafit_general.cu`` with the same flags, one
``nvcc`` each, all at once, into ``build/k6_ab/`` (``--source`` puts another source in the repository's
place as the new one, and then K6's twin is not expected to hold its
bits). Either source may have the one-problem-a-block C interface (no
``group`` argument) or the grouped one (``group``
after ``iters``, ``toafit_general_max_group``); the binding follows the
symbols the library exports. It prints:

- each kernel's registers, stack frame and spill bytes (``-Xptxas -v``),
  and ``nm_kernel<1, 2, 4>``'s resident blocks an SM: the new build's
  from ``toafit_general_nm_blocks`` at its launch without a stage and at
  the planned stage on the north star's rows, the parent's from its
  registers (``blocks_by_registers``);
- whether ``nm_kernel<1, 2, 4>``, ``eval_kernel`` and ``golden_kernel``
  compile to the parent's SASS instruction for instruction;
- the evaluation loop's instructions per vertex-event by pipe (DFMA, DADD,
  DMUL, MUFU, ...), from ``cuobjdump -sass`` of a counting build of each
  source with the family fixed to Fourier and K to 6 (``p.kind`` -> 0,
  ``p.n_comp`` -> 6: every component loop unrolls): of the backward-branch
  loops that load an event (its phase, ``LDG.E.64``, or in the golden
  kernel's staged loop its mask byte from shared memory, ``LDS.U8``: one an
  event) and take reciprocals (``MUFU.RCP64H``: two a vertex-event, the
  division's and the libdevice ``log``'s), each one's own instructions over
  its vertex-events, and its local loads and stores (spills). The
  libdevice ``cos``, ``sin`` and ``log`` fast paths are inline in that
  count; their slow paths (and the division's) are subroutines outside the
  loop (``CALL``, counted apart);
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
- ``nm_kernel<4>`` on the north star's rows (below) at 128 phases (the
  brute grid) and 64 (a dense window round the brute grid's best phase):
  a source that stages its first harmonic pairs (``nm_stage``'s plan)
  and at n_stage 0, and the parent's, timed in turns and reversed, each
  bitwise the staged launch in LL, vectors, shrinks, reads and the trace,
  with the staged share of the events;
- the readvaryparam fit's golden-section refine (25 iterations on the
  brute grid's best phase +- one grid step, then the profile at the
  optimum) at that shape and on the north star's rows (phase 14's
  operands: the surrogate's 84 folded segments of 10 000 events): the chain
  of 2 + 2 refine_iters one-phase launches under
  ``optimize.golden_section`` and the one ``toafit_general_golden``
  launch, with its first harmonic pairs staged (the plan,
  ``general_sweep.golden_stage_events``) and not (n_stage 0), the
  parent's launch and each ``--stage-u`` variant (the staged loop's U at
  1, 2 and 4 vertices a walk, ``StagedPairs``), timed in turns and reversed
  and held bit for bit to the chain in phi_best, ll_max and the vector at
  the optimum; one P 1 launch (G 1) and one P 2 launch (G 2) timed alone;
  the one launch beside ``k6_golden_counts``' bound;
- with ``--probe``, a round attributed: a probe build of each source
  (``probe_source``: ``clock64()`` stamps in thread 0 of every block around
  a walk's vertex transform, event loop, warp sums, warp 0's tree and its
  barriers, and a pass's bookkeeping, ``advance`` and barriers, each part's
  cycles added per block) runs the golden launch and ``nm_kernel<4>`` at 84
  x 128 on the north star's rows (a staging source staged and at n_stage
  0, whose event loops differ by the pair's formation alone); the shares
  of a block's cycles, the cycles a round, pass and walk, and the share of
  the event loop's cycles a walk the stage takes off.

``--groups`` runs alone instead (no build of its own, no parent): the
readvaryparam fit (``toafit.fit_segment`` on the card, the defaults, the
template's 13 ``vary`` parameters free) on the campaign's rows (the
interval table's ``Events`` column, 5 136 to 14 897 events, from the
surrogate, ``campaign_operands``) of ``--sets`` event sets, in its row
groups (``toafit._row_groups``' plan) and in one group, in turns one /
grouped / grouped / one ``--reps`` times a set: the wall ms of a fit with
the card synchronized, the groups chosen and the model's ms of both
schedules (``general_sweep.schedule_ms``), the card's SMs and stream
priority range, and whether every returned column is the one-group fit's
bit for bit.

``--plans`` runs alone instead: the same fit at each G from 1 to
``general_sweep.MAX_ROW_GROUPS`` pinned (the rows longest first, cut as
``plan_row_groups`` cuts them; G 1 the batch as it stands), in turns 1..4,
4..1 ``--reps`` times, on three row sets: the campaign's rows (seed 7),
phase 14's 84 rows of 10 000 events, and those rows taken in turn to 132
rows (one an SM). For each set: the G the plan takes, the wall ms of each
G (median), the model's ms of each, and whether every G's columns are G
1's bit for bit.

``--out`` writes everything as JSON.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import ctypes
import json
import os
import re
import subprocess
import time

import numpy as np
import torch

from crimp_tpu_torch.io import template as template_io
from crimp_tpu_torch.io.table import read_columns
from crimp_tpu_torch.models import profiles, timing
from crimp_tpu_torch.obs import costmodel
from crimp_tpu_torch.ops import anchored, general_sweep, optimize, toafit, z2_grid
from crimp_tpu_torch.utils import surrogate
from crimp_tpu_torch.utils.k3_ab import _tool, sass_functions
from crimp_tpu_torch.utils.k5_ab import PIPES, _loops, _own, bound_ms, event_ms

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TEMPLATE = os.path.join(REPO, "tests", "data", "1e2259_template.txt")
PAR = os.path.join(REPO, "tests", "data", "1e2259.par")
INTERVALS = os.path.join(REPO, "tests", "data", "timIntToAs_1e2259.txt")
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


# the probe build's parts of a block's time (cycles) and counts, by index
PROBE_PARTS = ("vertex transform", "transform barriers", "event loop", "warp sums", "barrier after the loop",
               "warp 0's tree and value", "walk's last barrier", "pass bookkeeping", "advance",
               "barrier after advance", "walks", "passes", "block", "vertices", "before the first pass", "rounds")
PROBE_COUNTS = ("walks", "passes", "vertices", "rounds")
PROBE_BLOCKS = 8192
_PROBE_HEAD = r"""
// clock64() probe (utils/k6_ab.py): thread 0 of each block adds the cycles of its parts
#define K6P_PARTS %d
#define K6P_BLOCKS %d
__device__ unsigned long long k6p_acc[K6P_BLOCKS * K6P_PARTS];
__device__ __forceinline__ long long k6p_now() {
  long long t;
  asm volatile("mov.u64 %%0, %%%%clock64;" : "=l"(t)::"memory");
  return t;
}
__device__ __forceinline__ void k6p_add(int part, long long v) {
  if (threadIdx.x == 0 && blockIdx.x < K6P_BLOCKS)
    atomicAdd(&k6p_acc[blockIdx.x * K6P_PARTS + part], static_cast<unsigned long long>(v));
}
#define K6P_MARK(part) do { const long long k6p_s = k6p_now(); k6p_add(part, k6p_s - k6p_t); k6p_t = k6p_s; } while (0)
#define K6P_BAR(work, bar) do { K6P_MARK(work); __syncthreads(); K6P_MARK(bar); } while (0)
""" % (len(PROBE_PARTS), PROBE_BLOCKS)
_PROBE_TAIL = """
extern "C" int k6_probe_reset() {
  void* acc = nullptr;
  const cudaError_t e = cudaGetSymbolAddress(&acc, k6p_acc);
  return static_cast<int>(e != cudaSuccess ? e : cudaMemset(acc, 0, sizeof(k6p_acc)));
}
extern "C" int k6_probe_read(unsigned long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, k6p_acc, sizeof(k6p_acc)));
}
"""
# (text, its stamped form): each text once in the source, staged or not
_PROBE_STAMPS = (
    ("  const int tid = threadIdx.x;\n  // 1. the flattened vectors",
     "  const int tid = threadIdx.x;\n  long long k6p_t = k6p_now();\n  k6p_add(10, 1);\n  k6p_add(13, nv);\n"
     "  // 1. the flattened vectors"),
    ("sh.vphi[g] = phase(g);\n  __syncthreads();", "sh.vphi[g] = phase(g);\n  K6P_BAR(0, 1);"),
    ("  __syncthreads();\n\n  // 4. one walk over the events", "  K6P_BAR(0, 1);\n\n  // 4. one walk over the events"),
    ("\n  // 5. the block's sums and minimums", "\n  K6P_MARK(2);\n  // 5. the block's sums and minimums"),
    ("      sh.red[WALK + g][warp] = lmin[g];\n    }\n  }\n  __syncthreads();",
     "      sh.red[WALK + g][warp] = lmin[g];\n    }\n  }\n  K6P_BAR(3, 4);"),
    ("  __syncthreads();\n}\n\n// Evaluate n vertices", "  K6P_BAR(5, 6);\n}\n\n// Evaluate n vertices"),
    ("  for (;;) {\n    // the pass's vertices",
     "  for (;;) {\n    long long k6p_t = k6p_now();\n    k6p_add(11, 1);\n    // the pass's vertices"),
    ("    __syncthreads();\n    if (total == 0) break;", "    K6P_BAR(7, 7);\n    if (total == 0) break;"),
    ("    if (warp < G && sh.prob[warp].stage != ST_DONE)\n      advance(",
     "    k6p_t = k6p_now();\n    if (warp < G && sh.prob[warp].stage != ST_DONE)\n      advance("),
    ("trace_row(warp), iters, trace);\n    __syncthreads();", "trace_row(warp), iters, trace);\n    K6P_BAR(8, 9);"),
    ("  const long long r = blockIdx.x;\n  const int F = p.n_free, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;",
     "  const long long r = blockIdx.x;\n  const long long k6p_k0 = k6p_now();\n"
     "  const int F = p.n_free, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;"),
    ("  for (int round = 0;; ++round) {\n",
     "  k6p_add(14, k6p_now() - k6p_k0);\n  for (int round = 0;; ++round) {\n    k6p_add(15, 1);\n"),
    ("gs.best[w], vec_out + r * (3 * p.n_comp + 2));\n}",
     "gs.best[w], vec_out + r * (3 * p.n_comp + 2));\n  k6p_add(12, k6p_now() - k6p_k0);\n}"),
    ("  const int n_act = P - q0 < G ? static_cast<int>(P - q0) : G;\n",
     "  const int n_act = P - q0 < G ? static_cast<int>(P - q0) : G;\n  const long long k6p_k0 = k6p_now();\n"),
    ("  run_problems<G>(\n", "  k6p_add(14, k6p_now() - k6p_k0);\n  run_problems<G>(\n"),
    ("vec_out[b * D + sh.fidx[d]] = __dadd_rn(sh.lo[d], __dmul_rn(sh.span[d], sig));\n    }\n  }\n}",
     "vec_out[b * D + sh.fidx[d]] = __dadd_rn(sh.lo[d], __dmul_rn(sh.span[d], sig));\n    }\n  }\n"
     "  k6p_add(12, k6p_now() - k6p_k0);\n}"),
)


def probe_source(text: str) -> str:
    """The source with ``clock64()`` stamps (module note): thread 0 of every
    block adds each part's cycles to ``k6p_acc`` (block, part), read by the
    added C entries ``k6_probe_reset`` and ``k6_probe_read``. Raises where
    the source lacks a stamped text."""
    for old, new in _PROBE_STAMPS:
        if text.count(old) != 1:
            raise ValueError(f"probe_source: {old!r} is in the source {text.count(old)} times, not once")
        text = text.replace(old, new)
    head = "#include <math_constants.h>\n"
    return text.replace(head, head + _PROBE_HEAD, 1) + _PROBE_TAIL


def stage_u_source(text: str, u: tuple) -> str:
    """The source with the golden kernel's staged loop taking U events a
    thread a step at 1, 2 and 4 vertices a walk from ``u``."""
    pattern = r"static constexpr int U1 = \d+, U2 = \d+, U4 = \d+;"
    if len(re.findall(pattern, text)) != 1 or any(4 % v for v in u):
        raise ValueError(f"stage_u_source: no single StagedPairs U line, or a U in {u} that does not divide 4")
    return re.sub(pattern, "static constexpr int U1 = %d, U2 = %d, U4 = %d;" % tuple(u), text)


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


def derived(tag: str, src: str, transform, kind: str = "count") -> str:
    """``src`` through ``transform``, written to build/k6_ab/ for nvcc."""
    path = os.path.join(OUT_DIR, f"toafit_general_{tag}_{kind}.cu")
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(src) as fh, open(path, "w") as out:
        out.write(transform(fh.read()))
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
        n_x = sum(op.startswith("LDG.E.64") for op in ops) or sum(op.startswith("LDS.U8") for op in ops)
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
    """{kernel: [evaluation loops]} of the counting build's nm, eval and
    golden kernels."""
    return {label: event_loops(instrs) for label, instrs in kernel_sass(lib_path).items()}


def kernel_sass(lib_path: str) -> dict:
    """{nm_kernel<G> / eval_kernel / golden_kernel: its SASS} of a library."""
    out = {}
    for name, instrs in sass_functions(lib_path).items():
        label = kernel_label(name)
        if label:
            out[label] = instrs
    return out


def same_sass(lib_a: str, lib_b: str) -> dict:
    """{kernel: whether both libraries compile it to the same instructions
    (opcodes and operands in order)} for the nm, eval and golden kernels."""
    a, b = kernel_sass(lib_a), kernel_sass(lib_b)
    return {k: [i[1:] for i in a[k]] == [i[1:] for i in b.get(k, [])] for k in sorted(a)}


def ptxas(log: str) -> dict:
    return {e["name"]: {k: e[k] for k in ("registers", "stack", "spill")} for e in z2_grid.ptxas_entries(log)}


def kernel_label(name: str) -> str | None:
    """nm_kernel<G>, eval_kernel or golden_kernel for a mangled name."""
    m = re.search(r"(nm_kernel|eval_kernel|golden_kernel)(?:ILi(\d+)E)?", name)
    return m.group(1) + (f"<{m.group(2)}>" if m.group(2) else "") if m else None


def blocks_by_registers(registers: int) -> int:
    """Resident 512-thread blocks an SM that ``registers`` a thread allow
    (65 536 registers an SM, allocated 8 a thread at a time)."""
    return 65536 // (general_sweep.THREADS * (-(-max(registers, 1) // 8) * 8))


STAGE_ARG = general_sweep.STAGE_ARG  # n_stage's place in the golden and nm entries' arguments


def residency(new_lib, built: dict, n_free: int) -> dict:
    """nm_kernel<1, 2, 4>'s resident blocks an SM: the new build's at n_stage
    0 and at the largest stage its room takes (``toafit_general_nm_blocks``),
    and each build's by its registers."""
    out = {}
    for g in general_sweep.GROUPS:
        row = {}
        for which, (_, log) in built.items():
            regs = [e["registers"] for n, e in ptxas(log).items() if kernel_label(n) == f"nm_kernel<{g}>"]
            if regs:
                row[f"{which} by registers"] = blocks_by_registers(regs[0])
        if new_lib.nm_staged:
            most = 0 if g == 1 else general_sweep.stage_events(g, n_free, 1 << 40,
                                                               new_lib.lib.toafit_general_nm_room())
            blocks = new_lib.lib.toafit_general_nm_blocks
            row["new at n_stage 0"] = blocks(g, general_sweep.nm_bytes(g, n_free, 0))
            row["new at the largest stage"] = blocks(g, general_sweep.nm_bytes(g, n_free, most))
            row["largest stage"] = most
        out[f"nm_kernel<{g}>"] = row
        print(f"resident blocks an SM, nm_kernel<{g}>: " + ", ".join(f"{k} {v}" for k, v in row.items()), flush=True)
    return out


def nm_stage_part(new: "K6Lib", old, kind, tpl, cfg, x, mask, exposure, reps: int) -> dict:
    """nm_kernel<4> on the north star's rows at the brute grid (84 x 128) and
    a dense window of 64 phases round its best phase: staged, at n_stage 0
    and the parent's, timed in turns and reversed, each held bit for bit to
    the staged launch in all five outputs (module note)."""
    rows, n_ev = x.shape
    F = len(cfg.free_idx)
    brute = brute_grid(x.device, rows)
    best = brute[0][torch.argmax(new.nm(kind, tpl, x, mask, exposure, brute, cfg)[0], dim=1)]
    dense = (best[:, None] + (2 * np.pi / 1000) * (torch.arange(64, device=x.device) - 32)).contiguous()
    out = {}
    for label, phis in ((f"{rows} x 128", brute), (f"{rows} x 64", dense)):
        stage = new.stage(kind, phis.shape[1], F, n_ev)
        arms = {"staged": lambda trace=False, phis=phis: new.nm(kind, tpl, x, mask, exposure, phis, cfg, trace=trace),
                "n_stage 0": lambda trace=False, phis=phis: new.nm(kind, tpl, x, mask, exposure, phis, cfg,
                                                                   trace=trace, stage=0)}
        if old is not None:
            arms["parent"] = lambda trace=False, phis=phis: old.nm(kind, tpl, x, mask, exposure, phis, cfg, trace=trace)
        ref = arms["staged"](trace=True)
        row = {"group": new.group(phis.shape[1], F), "n_stage": stage,
               "staged_share": float(mask[:, :stage].sum()) / float(mask.sum()),
               "bitwise_staged": {name: bitwise(fn(trace=True), ref) for name, fn in arms.items()},
               "ms": {name: [] for name in arms}}
        for name in list(arms) + list(reversed(arms)):
            row["ms"][name].append(event_ms(arms[name], reps))
        out[label] = row
        print(f"nm_kernel<{row['group']}> on the north star's rows, {label} phases, n_stage {stage} (staged share "
              f"{row['staged_share']:.4f}): " + "; ".join(f"{k} " + " / ".join(f"{v:.3f}" for v in ms) + " ms"
                                                      for k, ms in row["ms"].items())
              + "; bitwise the staged launch: " + ", ".join(f"{k} {v}" for k, v in row["bitwise_staged"].items()),
              flush=True)
    return out


class _Unstaged:
    """A K6 library from before the staged pair, called as a staged one: its
    golden entry takes no n_stage and it has no room to plan one."""

    def __init__(self, lib):
        self.lib = lib

    def __getattr__(self, name):
        return getattr(self.lib, name)

    @staticmethod
    def toafit_general_golden_room():
        return 1 << 40

    def toafit_general_golden(self, *args):
        return self.lib.toafit_general_golden(*args[:STAGE_ARG], *args[STAGE_ARG + 1:])


class K6Lib:
    """A toafit_general library: ``nm(...)`` launches its Nelder-Mead once."""

    def __init__(self, path: str):
        self.lib = lib = ctypes.CDLL(path)
        vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        self.grouped = hasattr(lib, "toafit_general_max_group")
        if self.grouped:
            lib.toafit_general_max_group.argtypes = [ci]
            lib.toafit_general_max_group.restype = ci
        self.nm_staged = hasattr(lib, "toafit_general_nm_room")
        if self.nm_staged:
            lib.toafit_general_nm.argtypes = general_sweep.NM_ARGTYPES
            lib.toafit_general_nm_room.argtypes = []
            lib.toafit_general_nm_room.restype = cl
            lib.toafit_general_nm_blocks.argtypes = [ci, cl]
            lib.toafit_general_nm_blocks.restype = ci
        else:
            lib.toafit_general_nm.argtypes = ([vp] * 9 + [ci, ci, cl, ci, ci, ci, ci]
                                              + ([ci] if self.grouped else []) + [vp] * 6)
        lib.toafit_general_nm.restype = ci
        self.has_golden = hasattr(lib, "toafit_general_golden")
        self.staged = hasattr(lib, "toafit_general_golden_room")
        if self.has_golden:
            args = list(general_sweep.GOLDEN_ARGTYPES)
            if self.staged:
                lib.toafit_general_golden_room.argtypes = []
                lib.toafit_general_golden_room.restype = cl
            else:
                del args[STAGE_ARG]
            lib.toafit_general_golden.argtypes = args
            lib.toafit_general_golden.restype = ci
        self.probe = hasattr(lib, "k6_probe_read")
        if self.probe:
            lib.k6_probe_reset.restype = lib.k6_probe_read.restype = ci
            lib.k6_probe_read.argtypes = [vp]

    def golden(self, kind, tpl, x, mask, exposure, lo, hi, cfg, stage: int | None = None):
        """One toafit_general_golden launch: (phi_best, ll_max, vec_best,
        shrinks, reads); ``stage`` pins n_stage (the staged source's)."""
        lib = self.lib if self.staged else _Unstaged(self.lib)
        return general_sweep._launch_golden(kind, tpl, x, mask, exposure, lo, hi, cfg, lib=lib, stage=stage)

    def probed(self, fn, n_blocks: int) -> np.ndarray:
        """fn()'s probe sums, (n_blocks, len(PROBE_PARTS)) uint64."""
        z2_grid.check_launch(self.lib.k6_probe_reset(), "k6_probe_reset")
        fn()
        torch.cuda.synchronize()
        acc = np.zeros(PROBE_BLOCKS * len(PROBE_PARTS), dtype=np.uint64)
        z2_grid.check_launch(self.lib.k6_probe_read(acc.ctypes.data), "k6_probe_read")
        return acc.reshape(PROBE_BLOCKS, -1)[:n_blocks]

    def stage(self, kind, P: int, F: int, n_events: int, group: int | None = None) -> int:
        """The n_stage a Nelder-Mead launch plans (0 for a source that does
        not stage it)."""
        if not self.nm_staged:
            return 0
        return general_sweep.nm_stage(kind, self.group(P, F) if group is None else group, F, n_events, self.lib)

    def nm(self, kind, tpl, x, mask, exposure, phis, cfg, group: int | None = None, trace: bool = False,
           stage: int | None = None):
        """One toafit_general_nm launch: (LL, vectors, shrinks, reads, trace);
        ``stage`` pins n_stage (None: the plan) on a source that stages it."""
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
        if self.nm_staged:
            grp += (self.stage(kind, P, len(cfg.free_idx), x.shape[1], grp[0]) if stage is None else stage,)
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


def north_star_operands(dev):
    """Phase 14's rows: the surrogate's 84 segments of 10 000 events (seed 7)
    folded on the card and padded, with their exposures."""
    times, intervals = surrogate.build_surrogate(PAR, INTERVALS, TEMPLATE, events_per_toa=10000, seed=7)
    segs = surrogate.slice_intervals(times, intervals["ToA_tstart"], intervals["ToA_tend"])
    seg_phases, _ = anchored.fold_segments(timing.resolve(PAR), segs, device=dev)
    phases, masks = toafit.pad_segments(seg_phases)
    return (torch.as_tensor(phases, device=dev), torch.as_tensor(masks, device=dev),
            torch.as_tensor(intervals["ToA_exposure"].astype(float), device=dev))


def brute_grid(dev, rows: int) -> torch.Tensor:
    return torch.as_tensor(np.linspace(-np.pi, np.pi, N_BRUTE), device=dev).expand(rows, N_BRUTE).contiguous()


def bracket(lib: K6Lib, kind, tpl, cfg, x, mask, exposure):
    """The fit's golden bracket: the brute grid's best phase +- one step."""
    grid = brute_grid(x.device, x.shape[0])
    phi0 = grid[0][torch.argmax(lib.nm(kind, tpl, x, mask, exposure, grid, cfg)[0], dim=1)]
    step = 2 * np.pi / (N_BRUTE - 1)
    return (phi0 - step).contiguous(), (phi0 + step).contiguous()


def golden_part(new: K6Lib, arms: dict, kind, tpl, cfg, x, mask, exposure, reps: int, label: str) -> dict:
    """The golden-section refine as the chain of one-phase launches and as
    each arm's one launch (``arms``: {name: fn(lo, hi) -> its outputs}, the
    first the staged launch), timed in turns and reversed, each held to the
    chain in phi_best, ll_max and the vector and to the first arm in all
    five outputs (module note)."""
    rows, n_ev = x.shape
    F = len(cfg.free_idx)
    lo, hi = bracket(new, kind, tpl, cfg, x, mask, exposure)

    def at(phis, group):
        return new.nm(kind, tpl, x, mask, exposure, phis.contiguous(), cfg, group=group)

    def chain():
        phi, ll = optimize.golden_section(lambda p: at(p[:, None], 1)[0][:, 0], lo, hi, iters=cfg.refine_iters)
        return phi, ll, at(phi[:, None], 1)[1][:, 0]

    fns = {"chain": chain, **{name: (lambda fn=fn: fn(lo, hi)) for name, fn in arms.items()}}
    want = chain()
    first = next(iter(arms))
    ref = fns[first]()
    out = {"operands": label, "rows": rows, "events": n_ev, "refine_iters": cfg.refine_iters,
           "bitwise_chain": {}, "bitwise_first": {}}
    for name in arms:
        got = fns[name]()
        out["bitwise_chain"][name] = all(torch.equal(a, b) for a, b in zip(got[:3], want))
        out["bitwise_first"][name] = all(torch.equal(a, b) for a, b in zip(got, ref))
    out["ms"] = {name: [] for name in fns}
    for name in list(fns) + list(reversed(fns)):
        out["ms"][name].append(event_ms(fns[name], reps))
    out["launch_ms"] = {"P1 G1": event_ms(lambda: at(lo[:, None], 1), 4 * reps),
                        "P2 G2": event_ms(lambda: at(torch.stack([lo, hi], dim=1), 2), 4 * reps)}
    out["ms_per_round"] = {name: min(ms) / (1 + cfg.refine_iters) for name, ms in out["ms"].items()}
    counts = costmodel.k6_golden_counts(rows, float(mask.sum()) / rows, tpl.n_comp, kind, F, cfg.refine_iters,
                                        float(ref[4].sum()), float(ref[3].sum()))
    out["bound_ms"] = bound_ms(counts)
    print(f"golden refine, {label} ({rows} x {n_ev}, {F} free, {cfg.refine_iters} iterations): "
          + "; ".join(f"{name} " + " / ".join(f"{v:.3f}" for v in ms) + " ms" for name, ms in out["ms"].items())
          + "; a round " + ", ".join(f"{k} {v:.3f} ms" for k, v in out["ms_per_round"].items())
          + "; one launch alone: " + ", ".join(f"{k} {v:.3f} ms" for k, v in out["launch_ms"].items())
          + f"; bound {out['bound_ms']:.4f} ms ({100 * out['bound_ms'] / min(out['ms'][first]):.2f}% of {first})"
          + "; bitwise the chain: " + ", ".join(f"{k} {v}" for k, v in out["bitwise_chain"].items())
          + f"; bitwise {first} in all five outputs: " + ", ".join(f"{k} {v}" for k, v in out["bitwise_first"].items()),
          flush=True)
    return out


def probe_summary(acc: np.ndarray, ms: float) -> dict:
    """A probed launch's parts (module note): cycles a block, each timed
    part's share of them, the counts, cycles a pass and a walk, and the SM
    clock the slowest block gives over the launch's ms (one wave)."""
    tot = acc.sum(axis=0).astype(float)
    n = acc.shape[0]
    k = {name: i for i, name in enumerate(PROBE_PARTS)}
    timed = [p for p in PROBE_PARTS if p not in PROBE_COUNTS and p != "block"]
    out = {"blocks": n, "launch_ms": ms, "cycles_a_block": tot[k["block"]] / n,
           "ghz": float(acc[:, k["block"]].max()) / (ms * 1e6),
           "counts_a_block": {c: tot[k[c]] / n for c in PROBE_COUNTS},
           "share": {p: tot[k[p]] / tot[k["block"]] for p in timed},
           "cycles_a_pass": {p: tot[k[p]] / max(tot[k["passes"]], 1.0) for p in timed},
           "cycles_a_walk": {p: tot[k[p]] / max(tot[k["walks"]], 1.0) for p in PROBE_PARTS[:7]}}
    out["share"]["rest"] = 1.0 - sum(out["share"].values())
    return out


def probe_part(libs: dict, kind, tpl, cfg, x, mask, exposure, lo, hi, reps: int) -> dict:
    """Each probe build's golden launch on the north star's rows (a staged
    source staged and at n_stage 0) and nm_kernel<4> at 84 x 128."""
    rows = x.shape[0]
    grid = brute_grid(x.device, rows)
    out = {}
    for tag, lib in libs.items():
        runs = {"golden": lambda: lib.golden(kind, tpl, x, mask, exposure, lo, hi, cfg)}
        if lib.staged:
            runs["golden n_stage 0"] = lambda: lib.golden(kind, tpl, x, mask, exposure, lo, hi, cfg, stage=0)
        runs["nm<4> 84 x 128"] = lambda: lib.nm(kind, tpl, x, mask, exposure, grid, cfg, group=4)
        if lib.nm_staged:
            runs["nm<4> 84 x 128 n_stage 0"] = lambda: lib.nm(kind, tpl, x, mask, exposure, grid, cfg, group=4,
                                                              stage=0)
        for name, fn in runs.items():
            blocks = rows * (N_BRUTE // 4) if name.startswith("nm") else rows
            ms = event_ms(fn, reps)
            res = out.setdefault(tag, {})[name] = probe_summary(lib.probed(fn, blocks), ms)
            c = res["counts_a_block"]
            print(f"probe {tag} {name}: {ms:.3f} ms, {res['cycles_a_block']:.6g} cycles a block "
                  f"({res['ghz']:.3f} GHz by the slowest block over the launch), {c['rounds']:.0f} rounds, "
                  f"{c['passes']:.1f} passes, {c['walks']:.1f} walks, {c['vertices'] / max(c['walks'], 1):.3f} "
                  "vertices a walk; shares " + ", ".join(f"{p} {100 * v:.2f}%" for p, v in res["share"].items())
                  + "; cycles a pass " + ", ".join(f"{p} {v:.0f}" for p, v in res["cycles_a_pass"].items()),
                  flush=True)
        for arm in ("golden", "nm<4> 84 x 128"):
            if f"{arm} n_stage 0" in out[tag]:
                a, b = (out[tag][n]["cycles_a_walk"]["event loop"] for n in (f"{arm} n_stage 0", arm))
                out[tag].setdefault("pair_share_of_event_loop", {})[arm] = (a - b) / a
                print(f"probe {tag}: the staged pair takes {100 * (a - b) / a:.2f}% off the {arm} event loop "
                      f"({a:.0f} -> {b:.0f} cycles a walk)", flush=True)
    return out


def campaign_operands(dev, seed: int):
    """The campaign's rows: the surrogate (``seed``) with more events an
    interval than its table's ``Events`` column gives, each interval's
    folded phases cut to that count, padded on the card, with the
    exposures and each row's events (host)."""
    intervals = read_columns(INTERVALS)
    counts = np.rint(intervals["Events"]).astype(int)
    times, _ = surrogate.build_surrogate(PAR, INTERVALS, TEMPLATE, events_per_toa=int(counts.max()) + 2000, seed=seed)
    segs = surrogate.slice_intervals(times, intervals["ToA_tstart"], intervals["ToA_tend"])
    seg_phases, _ = anchored.fold_segments(timing.resolve(PAR), segs, device=dev)
    if any(len(p) < n for p, n in zip(seg_phases, counts)):
        raise RuntimeError("the surrogate drew fewer events than an interval's count")
    phases, masks = toafit.pad_segments([p[:n] for p, n in zip(seg_phases, counts)])
    return (torch.as_tensor(phases, device=dev), torch.as_tensor(masks, device=dev),
            torch.as_tensor(intervals["ToA_exposure"].astype(float), device=dev), masks.sum(axis=1))


@contextlib.contextmanager
def pinned(groups):
    """The readvaryparam fit in ``groups`` (None: one group)."""
    planned = toafit._row_groups
    toafit._row_groups = lambda *args, **kwargs: groups
    try:
        yield
    finally:
        toafit._row_groups = planned


def groups_part(sets: int, reps: int) -> dict:
    """The readvaryparam fit in its row groups against one group (``--groups``)."""
    dev = torch.device("cuda")
    tpl_dict = template_io.read_template(TEMPLATE)
    kind, tpl = profiles.from_template(tpl_dict)
    idx, lo, hi, n_free = toafit.free_param_spec(kind, tpl_dict)
    cfg = toafit.ToAFitConfig(kind=kind, free_idx=idx, free_lo=lo, free_hi=hi, n_free=n_free)
    tpl = tpl.to(dev)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    res = {"sms": n_sm, "priority_range": list(torch.cuda.Stream.priority_range()), "sets": []}
    print(f"{n_sm} SMs, stream priorities {res['priority_range']}", flush=True)
    for k in range(sets):
        x, mask, exposure, row_events = campaign_operands(dev, 7 + k)

        def fit():
            out = toafit.fit_segment(kind, tpl, x, mask, exposure, cfg, row_events)
            torch.cuda.synchronize()
            return out

        def wall(grouped: bool) -> float:
            t0 = time.perf_counter()
            if grouped:
                fit()
            else:
                with pinned(None):
                    fit()
            return 1e3 * (time.perf_counter() - t0)

        groups = toafit._row_groups(x, mask, cfg, row_events) or [np.arange(x.shape[0])]
        grouped = fit()
        with pinned(None):
            one = fit()
        ms = {"one": [], "grouped": []}
        for _ in range(reps):
            for arm in ("one", "grouped", "grouped", "one"):
                ms[arm].append(wall(arm == "grouped"))
        model = {"one": general_sweep.schedule_ms([row_events.tolist()], n_sm),
                 "grouped": general_sweep.schedule_ms([row_events[g].tolist() for g in groups], n_sm)}
        same = {key: bool(torch.equal(torch.nan_to_num(grouped[key]), torch.nan_to_num(one[key]))
                          and torch.equal(torch.isnan(grouped[key]), torch.isnan(one[key])))
                for key in one}
        row = {"seed": 7 + k, "groups": [len(g) for g in groups], "group_events": [int(row_events[g].sum()) for g in groups],
               "ms": ms, "model_ms": model, "bitwise": same,
               "loop_iters": int(one["errScanLoopIters"].sum())}
        res["sets"].append(row)
        print(f"set {k}: G {len(groups)} {row['groups']}; one group "
              + " / ".join(f"{v:.1f}" for v in ms["one"]) + " ms, grouped "
              + " / ".join(f"{v:.1f}" for v in ms["grouped"])
              + f" ms (model {model['one']:.1f} / {model['grouped']:.1f}); bitwise every column: "
              + str(all(same.values())) + ("" if all(same.values()) else f" {same}"), flush=True)
    return res


def plans_part(reps: int) -> dict:
    """The readvaryparam fit at every pinned G on three row sets (``--plans``)."""
    dev = torch.device("cuda")
    tpl_dict = template_io.read_template(TEMPLATE)
    kind, tpl = profiles.from_template(tpl_dict)
    idx, lo, hi, n_free = toafit.free_param_spec(kind, tpl_dict)
    cfg = toafit.ToAFitConfig(kind=kind, free_idx=idx, free_lo=lo, free_hi=hi, n_free=n_free)
    tpl = tpl.to(dev)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    x84, mask84, exposure84 = north_star_operands(dev)
    tiled = torch.arange(132, device=dev) % x84.shape[0]
    sets = {"campaign": campaign_operands(dev, 7),
            "uniform 84": (x84, mask84, exposure84, mask84.sum(dim=1).cpu().numpy()),
            "uniform 132": (x84[tiled], mask84[tiled], exposure84[tiled], mask84[tiled].sum(dim=1).cpu().numpy())}
    res = {"sms": n_sm, "priority_range": list(torch.cuda.Stream.priority_range()), "sets": {}}
    gs = range(1, general_sweep.MAX_ROW_GROUPS + 1)
    for label, (x, mask, exposure, row_events) in sets.items():
        order = np.argsort(-row_events, kind="stable")
        arms = {g: None if g == 1 else np.array_split(order, g) for g in gs}

        def fit(g):
            with pinned(arms[g]):
                out = toafit.fit_segment(kind, tpl, x, mask, exposure, cfg, row_events)
            torch.cuda.synchronize()
            return out

        planned = toafit._row_groups(x, mask, cfg, row_events)
        first = {g: fit(g) for g in gs}
        same = {g: all(torch.equal(torch.nan_to_num(first[g][k]), torch.nan_to_num(first[1][k]))
                       and torch.equal(torch.isnan(first[g][k]), torch.isnan(first[1][k])) for k in first[1])
                for g in gs}
        ms = {g: [] for g in gs}
        for _ in range(reps):
            for g in [*gs, *reversed(gs)]:
                t0 = time.perf_counter()
                fit(g)
                ms[g].append(1e3 * (time.perf_counter() - t0))
        model = {g: general_sweep.schedule_ms([row_events.tolist()] if arms[g] is None
                                              else [row_events[a].tolist() for a in arms[g]], n_sm) for g in gs}
        row = {"rows": int(x.shape[0]), "plan": 1 if planned is None else len(planned), "ms": ms,
               "median_ms": {g: float(np.median(v)) for g, v in ms.items()}, "model_ms": model, "bitwise": same}
        res["sets"][label] = row
        print(f"{label} ({row['rows']} rows): plan G {row['plan']}; "
              + "; ".join(f"G {g} {row['median_ms'][g]:.1f} ms (model {model[g]:.1f})" for g in gs)
              + f"; bitwise G 1: {same}", flush=True)
    return res


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", default=None, help="an earlier toafit_general.cu to time beside K6")
    parser.add_argument("--source", default=None, help="a toafit_general.cu to take for the repository's")
    parser.add_argument("--out", default=None, help="write the results as JSON here")
    parser.add_argument("--reps", type=int, default=3)
    parser.add_argument("--probe", action="store_true", help="attribute a golden round with clock64() stamps")
    parser.add_argument("--stage-u", nargs="*", default=[], metavar="U1,U2,U4",
                        help="time the staged golden loop at these U (events a thread a step at 1, 2, 4 vertices)")
    parser.add_argument("--groups", action="store_true",
                        help="only the readvaryparam fit in its row groups against one group")
    parser.add_argument("--sets", type=int, default=4, help="event sets of --groups")
    parser.add_argument("--plans", action="store_true",
                        help="only the readvaryparam fit at every pinned G on three row sets")
    args = parser.parse_args(argv)
    stage_us = [tuple(int(v) for v in u.split(",")) for u in args.stage_u]
    if not torch.cuda.is_available():
        raise SystemExit("k6_ab needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    res = {"card": card, "time": time.time()}
    if args.groups or args.plans:
        if args.groups:
            res["groups"] = groups_part(args.sets, args.reps)
        if args.plans:
            res["plans"] = plans_part(args.reps)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "w") as fh:
                json.dump(res, fh, indent=1)
        rows = [*res.get("groups", {}).get("sets", []), *res.get("plans", {}).get("sets", {}).values()]
        return 0 if all(all(row["bitwise"].values()) for row in rows) else 1
    src = args.source or str(z2_grid.SOURCES["toafit_general"])
    sources = {"new": src, "new_count": derived("new", src, counting_source)}
    if args.parent:
        sources["parent"] = args.parent
        sources["parent_count"] = derived("parent", args.parent, counting_source)
    if args.probe:
        sources.update({f"{tag}_probe": derived(tag, path, probe_source, "probe")
                        for tag, path in (("new", src), ("parent", args.parent)) if path})
    variant_names = {"u" + "".join(map(str, u)): "U " + "/".join(map(str, u)) for u in stage_us}
    for u in stage_us:
        tag = "u" + "".join(map(str, u))
        sources[tag] = derived(tag, src, lambda text, u=u: stage_u_source(text, u), "stage_u")
    built = build(sources)
    new_path, new_log = built["new"]
    res["source"] = src
    res["build"] = {"new": ptxas(new_log)}
    if args.parent:
        res["build"]["parent"] = ptxas(built["parent"][1])
    for tag, name in variant_names.items():
        res["build"][name] = {k: v for k, v in ptxas(built[tag][1]).items() if "golden_kernel" in k}
    for which, entries in res["build"].items():
        for name, e in entries.items():
            print(f"ptxas {which} {name}: {e['registers']} registers, {e['stack']} B stack, {e['spill']} B spill",
                  flush=True)
    if args.parent:
        res["same_sass_as_parent"] = same_sass(new_path, built["parent"][0])
        print("SASS of the new build against the parent's, instruction for instruction: "
              + ", ".join(f"{k} {'same' if v else 'DIFFERENT'}" for k, v in res["same_sass_as_parent"].items()),
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
    variants = {name: K6Lib(built[tag][0]) for tag, name in variant_names.items()}

    def arms(ops):
        a = {"staged" if new.staged else "one launch": lambda lo, hi: new.golden(kind, tpl, *ops, lo, hi, cfg)}
        if new.staged:
            a["n_stage 0"] = lambda lo, hi: new.golden(kind, tpl, *ops, lo, hi, cfg, stage=0)
        if old is not None:
            a["parent"] = lambda lo, hi: old.golden(kind, tpl, *ops, lo, hi, cfg)
        for name, lib in variants.items():
            a[name] = lambda lo, hi, lib=lib: lib.golden(kind, tpl, *ops, lo, hi, cfg)
        return a

    ns = north_star_operands(dev)
    res["residency"] = residency(new, {k: v for k, v in built.items() if k in ("new", "parent")}, F)
    res["nm_stage"] = nm_stage_part(new, old, kind, tpl, cfg, *ns, args.reps)
    reps = max(1, args.reps // 2)
    res["golden"] = {label: golden_part(new, arms(ops), kind, tpl, cfg, *ops, reps, label)
                     for label, ops in (("uniform rows", (x, mask, exposure)), ("north-star rows", ns))}
    if args.probe:
        lo, hi = bracket(new, kind, tpl, cfg, *ns)
        res["probe"] = probe_part({tag: K6Lib(built[f"{tag}_probe"][0]) for tag in ("new", "parent")
                                   if f"{tag}_probe" in built}, kind, tpl, cfg, *ns, lo, hi, reps)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(res, fh, indent=1)
    if not all(v for g in res["golden"].values() for key in ("bitwise_chain", "bitwise_first")
               for v in g[key].values()):
        print("golden refine: NOT bitwise the chain or the staged launch", flush=True)
        return 1
    if not all(v for row in res["nm_stage"].values() for v in row["bitwise_staged"].values()):
        print("nm_kernel on the north star's rows: NOT bitwise the staged launch", flush=True)
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
