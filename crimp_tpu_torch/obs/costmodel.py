"""Cost-model capture: FLOPs and bytes per kernel call.

Port of ``crimp_tpu/obs/costmodel.py``. The flight recorder knows how long
a kernel ran; this module records how much work the call represents, so
:mod:`crimp_tpu_torch.obs.roofline` can turn the kernel spans' device time
into achieved FLOP/s, bytes/s and a share of the card's roofline. XLA's
``cost_analysis`` has no torch counterpart, so the counts come from:

- **the hand kernels' own formulas**, the ones ``PERF.md``'s bounds use:
  K2 ``z2_grid.flops_per_pair`` per (trial, event) pair (:func:`k2_counts`),
  K3 the f32 operations of ``z2_general.ops_per_pair`` (:func:`k3_counts`),
  K4 B*E*(P + 2)*8 bytes (:func:`k4_counts`), K5 the f64 operations of a
  profile sweep (:func:`k5_counts`; its golden-section refine, the
  one-phase sweeps it evaluates, :func:`k5_golden_counts`; held to the f64
  peak through the row's ``flops_dtype``), K6 the f64 operations of the
  readvaryparam Nelder-Mead's evaluations that the data's decisions need
  (:func:`k6_counts`, the same peak; its golden-section refine, the
  one-phase problems it runs, :func:`k6_golden_counts`); bytes count each input read once and each output written once;
- **the tensors themselves** for ``argument_bytes`` and ``output_bytes``;
- **``torch.utils.flop_counter.FlopCounterMode``** for torch code, by
  running the function once on ``meta`` tensors (no data, no card work);
  where that is not possible (or counts nothing: the counter sees matrix
  products only) the FLOPs stay null and the row is partial, as JAX allows.

Contracts, as in the JAX package:

- **Disabled is free.** With no active obs run :func:`capture` returns
  after one check; ``CRIMP_TORCH_OBS_COST=0`` disables capture while obs
  stays on (malformed raises). :func:`kernel_span` is a no-op without a run.
- **Repeat shapes cost nothing.** Rows are cached per fingerprint (kernel,
  platform, argument shapes/dtypes/statics, numeric-mode knobs): in
  process first, then under ``cost|`` keys of the autotune cache file.
- **Never raises, never recomputes on the card.** Any failure degrades to
  no row, counted in ``costmodel_capture_errors``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import logging

import numpy as np
import torch

from crimp_tpu_torch import knobs
from crimp_tpu_torch.obs import core as obs_core

logger = logging.getLogger("crimp_tpu_torch.obs.costmodel")

_MEM_CACHE: dict[str, dict] = {}


def cost_capture_on() -> bool:
    """Whether CRIMP_TORCH_OBS_COST asks for capture (default on; malformed raises)."""
    return knobs.env_onoff("CRIMP_TORCH_OBS_COST") is not False


@contextlib.contextmanager
def kernel_span(name: str):
    """The kernel span of a capture site: ``utils/profiling.timed(name)``
    (device time from CUDA events on the card) inside an active run, free
    otherwise."""
    if obs_core.active() is None:
        yield
        return
    from crimp_tpu_torch.utils import profiling

    with profiling.timed(name):
        yield


def _platform_peek() -> str:
    """``backend|device kind`` of a card some other code brought up, else
    ``cpu|cpu``; capture never initializes the card."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        return f"cuda|{torch.cuda.get_device_name(torch.cuda.current_device())}"
    return "cpu|cpu"


def _leaves(tree) -> list:
    """Flatten tuples, lists, dicts, NamedTuples and dataclasses."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree, key=str) for leaf in ([k] + _leaves(tree[k]))]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _leaves(v)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [type(tree).__name__] + _leaves([getattr(tree, f.name) for f in dataclasses.fields(tree)])
    return [tree]


def _leaf_sig(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return f"{leaf.dtype}[{','.join(map(str, leaf.shape))}]@{leaf.device.type}"
    if isinstance(leaf, np.ndarray):
        return f"np.{leaf.dtype}[{','.join(map(str, leaf.shape))}]"
    if isinstance(leaf, (bool, int, float, complex, str, bytes, type(None), torch.dtype)):
        return repr(leaf)
    return type(leaf).__name__


def _numeric_knob_sig() -> str:
    """Set numeric-mode knobs, so a mode flip never aliases a cached row."""
    return ";".join(f"{name}={knobs.raw(name)}" for name in sorted(knobs.REGISTRY)
                    if knobs.REGISTRY[name].numeric and knobs.raw(name))


def _plan_sig(plan) -> str:
    """Fingerprint token of a registry sharding plan: its rule, the mesh's
    shape and its card count, so a sharded row never aliases the unsharded
    one, nor a mesh of other cards."""
    if plan is None:
        return ""
    mesh = plan.mesh
    cards = mesh.cards() if hasattr(mesh, "cards") else None
    return ("plan:" + plan.rule.kernel + ";" + ",".join(f"{a}={mesh.shape[a]}" for a in mesh.axis_names)
            + f";cards={cards}")


def fingerprint(name: str, args: tuple, kwargs: dict, plan=None) -> str:
    """``cost|<platform>|<device kind>|<kernel>|<sha>``: the disk-cache key."""
    body = "|".join(([_plan_sig(plan)] if plan is not None else []) + [_numeric_knob_sig()]
                    + [_leaf_sig(leaf) for leaf in _leaves((args, kwargs))])
    sha = hashlib.sha1(body.encode()).hexdigest()[:16]
    return f"cost|{_platform_peek()}|{name}|{sha}"


def tensor_bytes(tree) -> int:
    """Bytes of every tensor and array leaf of ``tree``."""
    total = 0
    for leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
        elif isinstance(leaf, np.ndarray):
            total += leaf.nbytes
    return total


def _to_meta(tree):
    if isinstance(tree, torch.Tensor):
        return torch.empty(tree.shape, dtype=tree.dtype, device="meta")
    if isinstance(tree, dict):
        return {k: _to_meta(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_to_meta(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_meta(v) for v in tree)
    return tree


def meta_flops(fn, args: tuple, kwargs: dict) -> float | None:
    """FLOPs ``FlopCounterMode`` counts for ``fn`` on ``meta`` copies of the
    tensor arguments (matrix products only), or None when the function
    cannot run on meta tensors or counts nothing."""
    from torch.utils.flop_counter import FlopCounterMode

    try:
        with FlopCounterMode(display=False) as counter:
            fn(*_to_meta(args), **_to_meta(kwargs))
        total = counter.get_total_flops()
    except Exception:  # graftlint: disable=GL006 (telemetry guard: a data-dependent branch or a host copy cannot run on meta tensors; the row's FLOPs degrade to None)
        return None
    return float(total) if total > 0 else None


def analyze(fn, args: tuple, kwargs: dict, counts=None, out=None, plan=None) -> dict:
    """The cost row of one call: FLOPs and bytes from ``counts`` (the hand
    kernels' formulas) or a meta run of ``fn`` (torch code; None skips it),
    argument and output bytes from the tensors.

    With a registry ``plan`` (``parallel/registry.KernelSharding``) the
    counts are per shard, as JAX's per-device rows, and the row carries
    ``devices`` (the shard count), ``cards`` (the distinct devices under
    them: several shards may share one card), ``sharded``, ``reduce_axes``
    and the per-shard ``collective_bytes`` of the kernel's cross-shard
    reduce, split into ``collective_bytes_ici`` (within a process) and
    ``collective_bytes_dcn`` (across processes), over the global outputs
    ``out``."""
    from crimp_tpu_torch.parallel import multihost

    row: dict = {"flops": None, "bytes_accessed": None, "transcendentals": None,
                 "argument_bytes": tensor_bytes((args, kwargs)),
                 "output_bytes": tensor_bytes(out) if out is not None else None,
                 "temp_bytes": None, "peak_bytes": None, "generated_code_bytes": None,
                 "devices": 1, "sharded": False, "flops_source": None}
    if counts is not None:
        counts = counts() if callable(counts) else counts
        for field in ("flops", "bytes_accessed", "transcendentals"):
            if isinstance(counts.get(field), (int, float)):
                row[field] = float(counts[field])
        if counts.get("flops_dtype"):
            # the peak the roofline holds these operations to (PEAKS' flops_<dtype>)
            row["flops_dtype"] = str(counts["flops_dtype"])
        row["flops_source"] = "formula"
    elif fn is not None:
        row["flops"] = meta_flops(fn, args, kwargs)
        row["flops_source"] = "flop_counter" if row["flops"] is not None else None
    if plan is not None:
        row["devices"] = int(plan.device_count())
        row["cards"] = int(plan.mesh.cards()) if hasattr(plan.mesh, "cards") else row["devices"]
        row["sharded"] = row["devices"] > 1
        row["reduce_axes"] = list(plan.rule.reduce_axes)
        split = plan.collective_bytes_split(list(out) if isinstance(out, (list, tuple)) else [out])
        row["collective_bytes"] = float(split["ici"] + split["dcn"])
        row["collective_bytes_ici"] = float(split["ici"])
        row["collective_bytes_dcn"] = float(split["dcn"])
    row["process_index"], row["process_count"] = multihost.process_identity()
    return row


def capture(name: str, fn, *args, counts=None, out=None, plan=None, **kwargs) -> dict | None:
    """Record the cost row of one kernel call under span name ``name``.

    Call sites invoke this right after the call with the same arguments;
    ``counts`` (keyword-only: a dict, or a callable returning one, of
    ``flops``/``bytes_accessed``) gives a hand kernel's counts, ``out`` the
    call's result (its bytes), ``plan`` the registry plan of a sharded
    call. Returns the row (also recorded on the active run), or None: no
    active run, capture off, or a failure."""
    if obs_core.active() is None or not cost_capture_on():
        return None
    try:
        key = fingerprint(name, args, kwargs, plan=plan)
        row = _MEM_CACHE.get(key)
        cache = "mem"
        if row is None:
            row = _disk_get(key)
            cache = "disk"
        if row is None:
            row = analyze(fn, args, kwargs, counts=counts, out=out, plan=plan)
            cache = "miss"
            _disk_put(key, row)
        _MEM_CACHE[key] = row
        out_row = dict(row)
        out_row["fingerprint"] = key
        out_row["cache"] = cache
        span = obs_core.current_span_name()
        if span:
            out_row["span"] = span
        obs_core.record_cost(name, out_row)
        obs_core.counter_add("costmodel_rows")
        return out_row
    except Exception as exc:  # graftlint: disable=GL006 (telemetry guard: cost capture degrades to no-row; obs cannot import resilience without a cycle)
        logger.debug("cost capture failed for %s: %s", name, exc)
        obs_core.counter_add("costmodel_capture_errors")
        return None


# -- the hand kernels' counts ----------------------------------------------------


def k2_counts(n_events: int, n_freq: int, n_rows: int, nharm: int, out, weights=None) -> dict:
    """K2: ``flops_per_pair(nharm)`` f32 FLOPs per (trial, event) pair over
    the grid's trials (frequencies x rows); bytes: the f64 event times (and
    f32 weights), one f64 coefficient per row, the f32 sums written."""
    from crimp_tpu_torch.ops import z2_grid

    nbytes = 8 * n_events + 8 * n_rows + tensor_bytes(out)
    if weights is not None:
        nbytes += 4 * n_events
    return {"flops": float(n_freq) * n_rows * n_events * z2_grid.flops_per_pair(nharm),
            "bytes_accessed": float(nbytes)}


def k3_counts(n_events: int, n_freq: int, n_rows: int, nharm: int, trig_dtype=torch.float32,
              poly: bool = False, has_d: bool = False) -> dict:
    """K3: the f32 operations of ``ops_per_pair`` per pair (all of them
    with f64 trig), as in ``utils/k3_ab.shape_bounds``; bytes: events,
    trials and the f64 sums."""
    from crimp_tpu_torch.ops import z2_general

    f64_ops, f32_ops = z2_general.ops_per_pair(nharm, trig_dtype, poly=poly, has_d=has_d)
    ops = f32_ops if trig_dtype == torch.float32 else f64_ops
    n_trials = n_freq * n_rows
    return {"flops": float(n_trials) * n_events * ops,
            "bytes_accessed": float(8 * n_events + 8 * n_freq + 8 * n_rows + 2 * nharm * n_trials * 8)}


def k4_counts(n_rows: int, n_events: int, n_params: int) -> dict:
    """K4: B*E*(P + 2)*8 bytes (phases and basis read, phases written) and
    2*B*E*P f64 FLOPs (one FMA per basis element)."""
    return {"flops": 2.0 * n_rows * n_events * n_params,
            "bytes_accessed": 8.0 * n_rows * n_events * (n_params + 2)}


# f64 operations per (row, phase, masked event) of a K5 sweep, by part
K5_SHAPE_OPS = {"fourier": lambda k: 4 * k, "vonmises": lambda k: 7 * k, "cauchy": lambda k: 6 * k}
K5_NEWTON_OPS = 5  # a + s, 1 / (a + s), its square, two sums
K5_JOINT_OPS = 12  # a + b s (2), 1 / (.), inv s, three products, five sums
K5_LL_OPS = 6  # a + b s (2), the minimum, the clamp, log, the sum


def k5_ops_per_event(n_comp: int, kind: str, mode: int, newton_iters: int, bf16: bool = False) -> int:
    """f64 operations of one K5 sweep per (row, phase, masked event): the
    shape term (Fourier 2K products and 2K sums; von Mises per component two
    differences, cos, a product, exp, a product and a sum; Cauchy two
    differences, cos, a difference, a division and a sum; none in f64 for a
    bf16 Fourier sweep, whose shape runs in f32), the masked minimum (1),
    the norm solve (mode 0: ``newton_iters`` steps of 5; mode 1:
    ``2 * newton_iters`` steps of 12; mode 2: none) and the log-sum (6)."""
    shape = 0 if (bf16 and kind == "fourier") else K5_SHAPE_OPS[kind](int(n_comp))
    solve = {0: K5_NEWTON_OPS * newton_iters, 1: K5_JOINT_OPS * 2 * newton_iters, 2: 0}[int(mode)]
    return shape + 1 + solve + K5_LL_OPS


def k5_counts(n_rows: int, n_phis: int, n_events: float, n_comp: int, kind: str, mode: int,
              newton_iters: int, bf16: bool = False) -> dict:
    """K5, one profile sweep over S = ``n_rows`` segment rows x P =
    ``n_phis`` phases, ``n_events`` the masked events a row (the mean for
    ragged rows: the work is what the data needs, not the padding).

    Operations: ``k5_ops_per_event`` per (row, phase, event), f64. The
    convention: an add, a multiply, a comparison, a division, an exp, a log
    and a cos each count as ONE operation (a multiply-add as two), so the
    bound at the 34 TFLOP/s f64 peak is a true lower bound: on the card a
    division, exp, log or cos is a sequence of several f64 instructions.
    The per-row work that does not scale with P (the Fourier per-event
    coefficients) is left out. Bytes: the phases (8) and mask (1) of every
    event, exposure, the phases' grid and the template read once, and LL,
    A and b written: S N 9 + S 8 + S P 8 + 3 S P 8."""
    S, P = float(n_rows), float(n_phis)
    ops = S * P * float(n_events) * k5_ops_per_event(n_comp, kind, mode, newton_iters, bf16)
    nbytes = S * float(n_events) * 9 + S * 8 + S * P * 8 + 8 * (3 * n_comp + 2) + 3 * S * P * 8
    return {"flops": ops, "bytes_accessed": nbytes, "flops_dtype": "f64"}


def k5_golden_counts(n_rows: int, n_events: float, n_comp: int, kind: str, mode: int, newton_iters: int,
                     refine_iters: int, bf16: bool = False) -> dict:
    """K5's golden-section refine over S = ``n_rows`` rows, one launch: the
    work of the 2 + 2 ``refine_iters`` one-phase sweeps it evaluates, each
    counted as ``k5_counts(S, 1, ...)`` (operations and bytes), as the chain
    of one-phase launches it replaces was charged."""
    one = k5_counts(n_rows, 1, n_events, n_comp, kind, mode, newton_iters, bf16)
    evals = 2 + 2 * int(refine_iters)
    return {"flops": evals * one["flops"], "bytes_accessed": evals * one["bytes_accessed"], "flops_dtype": "f64"}


# f64 operations per (problem, evaluation, masked event) of K6, by family:
# per component the angle (Fourier: + loc, - j phi; vM and Cauchy: x - cen,
# - phi), cos, the term (Fourier: a product; vM: kappa cos, exp, a product;
# Cauchy: cosh(wid) - cos, a division) and its sum. The Fourier j 2 pi x
# does not depend on the vertex or the phase: one operation a (row, masked
# event, component), charged once (K6_FOURIER_EVENT_OPS)
K6_COMP_OPS = {"fourier": 5, "vonmises": 7, "cauchy": 6}
K6_FOURIER_EVENT_OPS = 1  # j 2 pi x, a component
K6_EVENT_OPS = 6  # norm + the sum, / norm factor, the clamp, log, the minimum, the log-sum


def k6_ops_per_event(n_comp: int, kind: str) -> int:
    """f64 operations of one K6 evaluation per masked event."""
    return K6_COMP_OPS[kind] * int(n_comp) + K6_EVENT_OPS


def k6_counts(n_rows: int, n_phis: int, n_events: float, n_comp: int, kind: str, n_free: int, n_reads: float,
              n_shrinks: float) -> dict:
    """K6, the bounded Nelder-Mead of S = ``n_rows`` rows x P = ``n_phis``
    phases, ``n_events`` the masked events a row (the mean for ragged rows),
    F = ``n_free`` free parameters. The evaluations are those the data
    needs: F + 1 for every problem's initial simplex, ``n_reads`` the
    candidate values all problems' decision trees read (the kernel's
    ``reads`` output: 1 to 3 a step, where K6 evaluates 4) and F for each of
    the ``n_shrinks`` shrink steps (its ``shrinks``); each
    ``k6_ops_per_event`` operations per event, a cos, exp, log or division
    counted as one (as ``k5_counts``), and for Fourier j 2 pi x once a (row,
    event, component). The per-vertex work (the transform, i0, the
    constants) and the simplex's bookkeeping do not scale with the events
    and are left out. Bytes: the phases (8) and mask (1) of every event,
    exposure, the phases' grid and the starts read once, the LL, vectors
    and the two counts written."""
    S, P = float(n_rows), float(n_phis)
    D = 3 * int(n_comp) + 2
    evals = S * P * (n_free + 1) + float(n_reads) + float(n_free) * float(n_shrinks)
    ops = evals * float(n_events) * k6_ops_per_event(n_comp, kind)
    if kind == "fourier":
        ops += S * float(n_events) * int(n_comp) * K6_FOURIER_EVENT_OPS
    nbytes = S * float(n_events) * 9 + S * 8 + S * P * 8 + S * n_free * 8 + 8 * D + S * P * (8 + 8 * D + 8)
    return {"flops": ops, "bytes_accessed": nbytes, "flops_dtype": "f64", "evaluations": evals}


def k6_golden_counts(n_rows: int, n_events: float, n_comp: int, kind: str, n_free: int, refine_iters: int,
                     n_reads: float, n_shrinks: float) -> dict:
    """K6's golden-section refine over S = ``n_rows`` rows, one launch: the
    evaluations of its 2 + 2 ``refine_iters`` one-phase problems a row, as
    ``k6_counts`` counts a launch of S rows x that many phases, ``n_reads``
    and ``n_shrinks`` the launch's sums over all of them; for Fourier the
    j 2 pi x term once a (row, event, component), since it does not depend
    on the phase. Bytes: the launch's own, each input read once (the phases
    and mask of every event, exposure, the bracket, the starts, the
    template) and phi_best, ll_max, the vectors and the two counts
    written."""
    counts = k6_counts(n_rows, 2 + 2 * int(refine_iters), n_events, n_comp, kind, n_free, n_reads, n_shrinks)
    S, D = float(n_rows), 3 * int(n_comp) + 2
    nbytes = S * float(n_events) * 9 + S * 8 + 2 * S * 8 + S * n_free * 8 + 8 * D + S * (8 + 8 + 8 * D + 4 + 4)
    return {**counts, "bytes_accessed": nbytes}


# -- disk tier (the autotune cache file, "cost|" keys) -----------------------------


def _disk_get(key: str) -> dict | None:
    from crimp_tpu_torch.ops import autotune

    entry = autotune._load_cache().get(key)
    if not isinstance(entry, dict):
        return None
    return {k: v for k, v in entry.items() if k not in ("fingerprint", "cache", "span")}


def _disk_put(key: str, row: dict) -> None:
    from crimp_tpu_torch.ops import autotune

    try:
        autotune._store_entry(key, row)
    except OSError:
        # a read-only or full cache dir: the in-process cache still dedups
        logger.debug("cost cache store failed for %s", key)


def reset_mem_cache() -> None:
    """Test hook: forget every in-process row."""
    _MEM_CACHE.clear()
