"""Batched unbinned maximum-likelihood ToA extraction.

Port of ``crimp_tpu/ops/toafit.py``. For all three template families the
extended log-likelihood at fixed shape is

    LL(phi, A) = -A*T + sum_i m_i log(A + s_i(phi)) + const(T, N)

which is strictly concave in the norm A, so the inner "re-optimize the
norm" solve is a safeguarded Newton iteration vectorized across the whole
phase grid, and the profile likelihood over phShift is one dense sweep.

The JAX package vmaps ``fit_segment`` over ToA segments; here the segment
axis is a leading batch dimension S of every tensor ((S, N) phases,
(S, P) phase grids). The error scan's batched ``while_loop`` becomes a
loop that runs while any segment is still active, updating only the active
segments, so each segment's result equals a lone run of that segment.

Every fixed-shape profile sweep (the shape term, the norm solve and the
log-likelihood over (S, P) phases) goes through ``profile_sweep``: on a
CUDA tensor one launch of K5 (``csrc/toafit.cu``), which keeps the
per-event values on the chip and sums each row's events in a fixed order,
so a row's results do not depend on the rows beside it or on its padding;
on a CPU tensor its plain twin ``profile_sweep_reference``, the same
arithmetic in torch ops over (S, P, N) temporaries (``fori_loop`` a Python
loop, event sums ``torch.sum``). The golden-section refine with the
nuisance solve at its optimum goes through ``golden_refine``: on a CUDA
tensor one launch of K5's ``toafit_golden`` (a cluster of two blocks a
row, exchanging each round's evaluations), bitwise the chain of one-phase
sweeps it replaces; on a CPU tensor ``golden_refine_reference``
(``golden_section`` over the twin). ``LAUNCHES["profile_sweep"]`` and
``LAUNCHES["golden_refine"]`` count the calls that launched K5's two entry
points. A fit on the card sweeps its whole brute grid in one launch,
refines in one more and computes K5's phase-independent operands once
(``sweep_events``); ``brute_chunk`` bounds only the twin's temporaries.
Everything is float64, so TF32 cannot enter the Fourier sweep.

Error bars keep the reference's stepping semantics (step = 2*pi/phShiftRes;
first step k* whose LL drop exceeds chi2_1(0.6827)/2; reported bound =
(k*+1)*step + step/2), with the dense first window of W steps per side.

The readvaryparam general path (``cfg.free_idx``) refits every flagged
template parameter per phase by a fixed-iteration bounded Nelder-Mead,
batched over (segment, phase), through ``ops/general_sweep.py``: on a
CUDA tensor one launch of K6 (``csrc/toafit_general.cu``) a profile, every
(segment, phase) problem's whole Nelder-Mead (the brute grid in one launch,
the dense window in one, one a pass of the error scan),
``general_sweep.LAUNCHES["general_sweep"]`` counting them, and the whole
golden-section refine with the refit vector at its optimum in one launch of
K6's ``toafit_general_golden`` (``general_sweep.general_golden``,
``LAUNCHES["general_golden"]``), bitwise the chain of one-phase launches
it replaces; on a CPU tensor the twins ``general_profile_reference`` and
``general_golden_reference``. A free_idx fit launches no K5. In golden
mode its brute grid, refine and dense window are a chain of K6 launches a
row group (``_general_chains``): on a card the rows longest first, in the
groups ``general_sweep.plan_row_groups`` models fastest, each group's chain
on a stream of its own, so one group's golden refine, a block a row, shares
the SMs with the other groups' sweeps; every row keeps its bits.

``cfg.mxu_bf16 == 1`` runs the Fourier profile sweep's two contractions
on bf16-rounded operands with f32 accumulation (in K5 on the card; in the
twin a plain ``torch.matmul``); off by default. The host
wrappers fill the auto (-1) knobs through ``autotune.resolve_toafit``
(``resolve_runtime_cfg``). ``fit_toas_batch_auto`` shards the segment
axis over a segment mesh when the job has several devices of the call's
type (``parallel.mesh``; ``CRIMP_TORCH_SHARD=0`` opts out), or over the mesh
its caller passes.
"""

from __future__ import annotations

import contextlib
import ctypes
import math
import threading
from dataclasses import fields
from typing import NamedTuple

import numpy as np
import torch

from crimp_tpu_torch import obs, resilience
from crimp_tpu_torch.models.profiles import CAUCHY, FOURIER, VONMISES, ProfileParams
from crimp_tpu_torch.obs import costmodel
from crimp_tpu_torch.obs import names as spans
from crimp_tpu_torch.ops.optimize import golden_section
from crimp_tpu_torch.ops import general_sweep, reduce
from crimp_tpu_torch.utils import profiling
from crimp_tpu_torch.utils.device import resolve_device

# 0.5 * chi2.ppf(0.6827, df=1): the 1-sigma likelihood-profile drop.
CHI2_1SIG_HALF = 0.4999320306186937

# Default first-window width (steps per side) of the dense error scan.
DENSE_WINDOW_DEFAULT = 32

_F64 = torch.float64


class ToAFitConfig(NamedTuple):
    """Static configuration for the batched ToA fit (JAX defaults)."""

    kind: str = FOURIER
    ph_shift_res: int = 1000  # error-scan resolution: step = 2*pi/res
    n_brute: int = 128  # coarse global grid over the phShift range
    brute_chunk: int = 64  # brute phases a twin sweep takes (memory bound); K5 sweeps them all at once
    newton_iters: int = 20  # inner norm solve (concave, quadratic conv.)
    refine_iters: int = 25  # golden-section refine of the grid optimum
    refine_mode: str = "golden"  # "golden" | "grid"
    refine_rounds: int = 4
    refine_grid: int = 33
    err_chunk: int = 32  # error-scan steps per fallback-loop pass
    nbins: int = 15  # binned-profile chi2 reporting
    norm_lo_frac: float = 0.01  # norm lower bound = frac * template norm
    norm_hi: float = 500.0  # norm upper bound
    vary_amps: bool = False  # free ampShift (3-parameter fit)
    amp_lo: float = 0.01
    amp_hi: float = 100.0
    free_idx: tuple = ()  # readvaryparam general path: flattened-vector indices
    free_lo: tuple = ()
    free_hi: tuple = ()
    nm_iters: int = 150
    n_free: int = -1  # chi2 dof override (-1 = auto: 2 + vary_amps)
    fix_norm: bool = False  # pin the norm at the template value
    err_dense_window: int = -1  # -1 = DENSE_WINDOW_DEFAULT; 0 = loop only
    # bf16 profile sweeps, tri-state: -1 = auto (off unless the host
    # wrappers resolve CRIMP_TORCH_MXU_BF16 or a cached verdict), 0 = exact
    # f64 products, 1 = bf16 operands with f32 accumulation (Fourier
    # sweep only; the binned-chi2 report stays exact)
    mxu_bf16: int = -1


def _phase_range(kind: str) -> float:
    # phShift in [-pi, pi] for Fourier, [-1.5pi, 1.5pi] for vm/cauchy
    return math.pi if kind == FOURIER else 1.5 * math.pi


# ---------------------------------------------------------------------------
# Shape term s_i(phi) (template minus baseline, ampShift folded in)
# ---------------------------------------------------------------------------


def _fourier_event_coeffs(tpl: ProfileParams, x: torch.Tensor):
    """Per-event harmonic coefficients: s_i(phi) = C_i.cos(j phi)+S_i.sin(j phi)."""
    j = torch.arange(1, tpl.n_comp + 1, dtype=x.dtype, device=x.device)
    theta = (2 * math.pi * j) * x[..., None] + tpl.loc[..., None, :]  # (..., N, K)
    amp = (tpl.amp * tpl.amp_shift[..., None])[..., None, :]
    return amp * torch.cos(theta), amp * torch.sin(theta)


def _bf16_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b on bf16-rounded operands with an f32 result: a product of two
    bf16 values is exact in f32, so an f32 matrix product at full precision
    (TF32 pinned off for the call) is the f32-accumulated bf16 product."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        return a.to(torch.bfloat16).to(torch.float32) @ b.to(torch.bfloat16).to(torch.float32)
    finally:
        torch.set_float32_matmul_precision(prev)


def shape_at_shifts(kind: str, tpl: ProfileParams, x: torch.Tensor, phis: torch.Tensor,
                    bf16: bool = False) -> torch.Tensor:
    """s(x_i; phi) for all (phi, event) pairs: x (..., N), phis (..., P)
    -> (..., P, N), leading dims broadcast (the template may carry them
    too: one refit template per segment in readvaryparam mode). ``bf16``
    (Fourier only) runs the (P, K) x (K, N) products on bf16 operands with
    f32 accumulation; the trig factors and per-event coefficients are exact,
    so the only rounding is the K-term contraction."""
    if kind == FOURIER:
        C, S = _fourier_event_coeffs(tpl, x)  # (..., N, K)
        j = torch.arange(1, tpl.n_comp + 1, dtype=x.dtype, device=x.device)
        cosj = torch.cos(j * phis[..., None])  # (..., P, K)
        sinj = torch.sin(j * phis[..., None])
        if bf16:
            return (_bf16_matmul(cosj, C.transpose(-1, -2))
                    + _bf16_matmul(sinj, S.transpose(-1, -2))).to(x.dtype)
        return cosj @ C.transpose(-1, -2) + sinj @ S.transpose(-1, -2)

    total = None
    b = lambda v: v[..., None, None]  # per-template scalar against (P, N)
    for k in range(tpl.n_comp):
        amp, cen, wid = b(tpl.amp[..., k]), b(tpl.loc[..., k]), b(tpl.wid[..., k])
        amp_shift = b(tpl.amp_shift)
        delta = x[..., None, :] - cen - phis[..., :, None]  # (..., P, N)
        if kind == CAUCHY:
            term = (amp * amp_shift / (2 * math.pi)) * torch.sinh(wid) / (
                torch.cosh(wid) - torch.cos(delta)
            )
        else:  # VONMISES
            kappa = 1.0 / wid**2
            term = (
                amp * amp_shift / (2 * math.pi * torch.special.i0(kappa))
                * torch.exp(kappa * torch.cos(delta))
            )
        total = term if total is None else total + term
    return total


# ---------------------------------------------------------------------------
# Inner norm solve + profile likelihood (segments S, grid points P, events N)
# ---------------------------------------------------------------------------


def _clip(x, lo, hi):
    """jnp.clip semantics, min(max(x, lo), hi); a Python-number bound stays a
    scalar argument (no host-to-device copy per call)."""
    x = torch.maximum(x, lo) if isinstance(lo, torch.Tensor) else x.clamp_min(lo)
    return torch.minimum(x, hi) if isinstance(hi, torch.Tensor) else x.clamp_max(hi)


def _masked_min(s: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.amin(torch.where(mask[..., None, :], s, math.inf), dim=-1)


def _optimal_norm(s, mask, exposure, n_events, lo, hi, iters: int):
    """Concave inner solve: A with sum_i m_i/(A+s_i) = T, clamped to [lo,hi].

    s: (S, P, N); mask (S, N); exposure, n_events (S,); returns A (S, P).
    """
    feasible_lo = torch.maximum(lo, -_masked_min(s, mask) * (1 + 1e-9) + 1e-12)
    a = _clip((n_events / exposure)[:, None].expand_as(feasible_lo), feasible_lo, hi)
    m = mask[:, None, :]
    for _ in range(iters):
        inv = torch.where(m, 1.0 / (a[..., None] + s), 0.0)
        g = reduce.event_sum(inv) - exposure[:, None]
        gp = -reduce.event_sum(inv**2)
        a = _clip(a - g / gp, feasible_lo, hi)
    return a


def _amp_total(tpl: ProfileParams) -> torch.Tensor:
    """sum_j amp_j * ampShift per template: 0-d, or (S,) for per-row templates."""
    return torch.sum(tpl.amp * tpl.amp_shift[..., None], dim=-1)


def _per_row(x: torch.Tensor) -> torch.Tensor:
    """A template scalar against (S, P) grids: (1,) or, per row, (S, 1)."""
    return x[..., None]


def _optimal_norm_amp(kind, tpl, s, mask, exposure, n_events, cfg: ToAFitConfig):
    """Joint concave inner solve for (A, b) = (norm, ampShift), per grid point:
    a projected 2x2 Newton ascent on LL(A, b). s: (S, P, N) -> (A, b) (S, P)."""
    q0 = _per_row(_amp_total(tpl))
    c_b = 0.0 if kind == FOURIER else q0 / (2 * math.pi)

    a_lo = _per_row(cfg.norm_lo_frac * tpl.norm)
    a_hi = cfg.norm_hi
    b_lo, b_hi = cfg.amp_lo, cfg.amp_hi
    min_s = _masked_min(s, mask)

    def feasible_a_lo(b):
        # keep A + b*s_i > 0 for every masked event
        return torch.maximum(a_lo, -b * min_s * (1 + 1e-9) + 1e-12)

    ones = torch.ones_like(min_s)
    a = _clip((n_events / exposure)[:, None] * ones, feasible_a_lo(ones), a_hi)
    b = ones
    m = mask[:, None, :]
    T = exposure[:, None]
    for _ in range(2 * cfg.newton_iters):
        inv = torch.where(m, 1.0 / (a[..., None] + b[..., None] * s), 0.0)
        inv_s = inv * s
        g_a = reduce.event_sum(inv) - T
        g_b = reduce.event_sum(inv_s) - c_b * T
        h_aa = -reduce.event_sum(inv**2)
        h_ab = -reduce.event_sum(inv * inv_s)
        h_bb = -reduce.event_sum(inv_s**2)
        det = h_aa * h_bb - h_ab**2
        # Damped fallback when the Hessian is near-singular (flat shape):
        # a 1-D Newton step on A alone, regularizer ADDED to -h_aa >= 0.
        safe = torch.abs(det) > 1e-30
        det = torch.where(safe, det, 1.0)
        da = torch.where(safe, -(h_bb * g_a - h_ab * g_b) / det, g_a / (-h_aa + 1e-30))
        db = torch.where(safe, -(-h_ab * g_a + h_aa * g_b) / det, 0.0)
        b = _clip(b + db, b_lo, b_hi)
        a = _clip(a + da, feasible_a_lo(b), a_hi)
    return a, b


def _loglik_at(kind, tpl, s, a, b, mask, exposure, n_events):
    """Extended LL given shape values s (S,P,N), norms a (S,P), ampShifts b (S,P)."""
    vals = a[..., None] + b[..., None] * s
    m = mask[:, None, :]
    positive = torch.amin(torch.where(m, vals, math.inf), dim=-1) > 0
    log_sum = reduce.event_sum(torch.where(m, torch.log(torch.clamp(vals, min=1e-300)), 0.0))
    T = exposure[:, None]
    if kind == FOURIER:
        const = (n_events * torch.log(exposure))[:, None]
        ll = -a * T + const + log_sum
    else:
        q = _per_row(_amp_total(tpl)) * b
        const = (n_events * torch.log(exposure / (2 * math.pi)))[:, None] - q * T / (2 * math.pi)
        ll = -a * T + const + log_sum
    return torch.where(positive, ll, -math.inf)


def profile_sweep_reference(kind, tpl, x, mask, exposure, phis, cfg: ToAFitConfig):
    """Plain twin of K5: the fixed-shape profile sweep (LL, A*, b*), each
    (S, P), in torch ops: the shape term over (S, P, N), the norm solve of
    ``cfg`` (Newton on A, the joint (A, b) solve with ``cfg.vary_amps``, or
    the template's norm with ``cfg.fix_norm``) and the log-likelihood. Its
    (S, P, N) temporaries are what ``fit_segment``'s ``brute_chunk`` bounds."""
    n_events = torch.sum(mask, dim=-1).to(x.dtype)
    s = shape_at_shifts(kind, tpl, x, phis, bf16=cfg.mxu_bf16 == 1)
    if cfg.vary_amps:
        a, b = _optimal_norm_amp(kind, tpl, s, mask, exposure, n_events, cfg)
    elif cfg.fix_norm:
        a = _per_row(tpl.norm) * torch.ones(s.shape[:-1], dtype=x.dtype, device=x.device)
        b = torch.ones_like(a)
    else:
        lo = _per_row(cfg.norm_lo_frac * tpl.norm)
        a = _optimal_norm(s, mask, exposure, n_events, lo, cfg.norm_hi, cfg.newton_iters)
        b = torch.ones_like(a)
    return _loglik_at(kind, tpl, s, a, b, mask, exposure, n_events), a, b


# ---------------------------------------------------------------------------
# K5: the profile sweep as one hand-kernel launch
# ---------------------------------------------------------------------------

LAUNCHES = {"profile_sweep": 0, "golden_refine": 0}
MAX_COMP = 64  # harmonics or components K5 takes (csrc/toafit.cu MAX_COMP)
_KIND_CODE = {FOURIER: 0, VONMISES: 1, CAUCHY: 2}
NORM_NEWTON, NORM_JOINT, NORM_FIXED = 0, 1, 2  # csrc/toafit.cu NormMode

_LIB = None
_LIB_LOCK = threading.Lock()
# guards LAUNCHES and _GROUP_STREAMS (a survey's or serving engine's fit runs
# beside the heartbeat and the engine's prep thread)
_STATE_LOCK = threading.Lock()
_GROUP_STREAMS: dict = {}  # (device, row group) -> its stream (_group_stream)


def reset_launches() -> None:
    with _STATE_LOCK:
        for key in LAUNCHES:
            LAUNCHES[key] = 0


def _lib():
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            from crimp_tpu_torch.ops import z2_grid

            lib = ctypes.CDLL(str(z2_grid.build()["toafit"]))
            vp, ci, cd, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_double, ctypes.c_longlong
            lib.toafit_profile.argtypes = [vp] * 8 + [ci, ci, cl, ci, ci, ci, ci, cd, cd, cd, ci, vp, vp, vp, vp]
            lib.toafit_profile.restype = ci
            lib.toafit_golden.argtypes = [vp] * 9 + [ci, cl, ci, ci, ci, ci, ci, cd, cd, cd, ci, vp, vp, vp, vp, vp]
            lib.toafit_golden.restype = ci
            lib.toafit_smem_events.argtypes = []
            lib.toafit_smem_events.restype = ci
            _LIB = lib
    return _LIB


def norm_mode(cfg: ToAFitConfig) -> int:
    """The sweep's norm solve: the joint (A, b) Newton with ``vary_amps``,
    else the fixed template norm with ``fix_norm``, else Newton on A."""
    return NORM_JOINT if cfg.vary_amps else NORM_FIXED if cfg.fix_norm else NORM_NEWTON


def _on_card(x: torch.Tensor) -> bool:
    """Whether a profile on ``x`` launches K5, or K6 with ``cfg.free_idx``
    (a CUDA tensor), or runs the twin: the one device test of both."""
    return x.device.type == "cuda"


def sweep_events(kind, tpl, x, cfg: ToAFitConfig) -> dict:
    """K5's per-row operands that do not depend on the phases, each
    contiguous on x's device with a leading row axis (a shared template
    expanded to every row), computed with the twin's own expressions:
    ``row`` (S, 3), the norm lower bound, the norm and sum_j amp_j ampShift;
    for Fourier the per-event coefficients ``ev_c``, ``ev_s`` (S, K, N);
    else ``comp`` (S, 3, K): coef, kappa or cosh(wid), centre. A fit
    computes them once for all its sweeps (``events=``); a subset of rows
    takes ``events_rows``."""
    S, K = x.shape[0], tpl.n_comp
    rows = lambda t, *shape: t.expand(S, *shape).contiguous()  # noqa: E731
    out = {"row": rows(torch.stack(torch.broadcast_tensors(
        cfg.norm_lo_frac * tpl.norm, tpl.norm, _amp_total(tpl)), dim=-1), 3)}
    if kind == FOURIER:
        C, Sn = _fourier_event_coeffs(tpl, x)  # (S, N, K)
        out.update(ev_c=C.transpose(-1, -2).contiguous(), ev_s=Sn.transpose(-1, -2).contiguous())
    else:
        amp = tpl.amp * tpl.amp_shift[..., None]
        if kind == CAUCHY:
            coef, shape2 = (amp / (2 * math.pi)) * torch.sinh(tpl.wid), torch.cosh(tpl.wid)
        else:
            shape2 = 1.0 / tpl.wid**2
            coef = amp / (2 * math.pi * torch.special.i0(shape2))
        out["comp"] = rows(torch.stack([coef, shape2, tpl.loc], dim=-2), 3, K)
    return out


def events_rows(events: dict | None, rows) -> dict | None:
    """``sweep_events`` of a subset of rows."""
    return None if events is None else {k: v[rows] for k, v in events.items()}


def _row_operands(entry, kind, tpl, x, mask, exposure, grids, cfg: ToAFitConfig, events=None) -> dict:
    """Check what K5's entry point ``entry`` takes and return its per-row
    operands (``events``, or ``sweep_events`` computed here): every operand
    a contiguous f64 tensor (mask bool) on x's device, x and mask (S, N),
    exposure (S,), and ``grids`` {name: (tensor, ndim)} with S leading rows.
    Raises ``KernelError`` on anything else; an empty batch returns None."""
    if kind not in _KIND_CODE:
        raise resilience.KernelError(f"{entry}: K5 takes no template family {kind!r}")
    if tpl.n_comp < 1 or tpl.n_comp > MAX_COMP:
        raise resilience.KernelError(f"{entry}: K5 takes 1 to {MAX_COMP} template components, "
                                     f"got {tpl.n_comp}")
    for name, (t, dtype, ndim) in {"x": (x, _F64, 2), "mask": (mask, torch.bool, 2), "exposure": (exposure, _F64, 1),
                                   **{k: (t, _F64, nd) for k, (t, nd) in grids.items()}}.items():
        if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous() or t.device != x.device:
            raise resilience.KernelError(
                f"{entry}: K5 takes {name} as a contiguous {ndim}-D {dtype} tensor on x's device "
                f"(got {t.dtype}, shape {tuple(t.shape)}, contiguous {t.is_contiguous()}, {t.device})")
    S, N = x.shape
    if mask.shape != (S, N) or exposure.shape != (S,) or any(t.shape[0] != S for t, _ in grids.values()):
        raise resilience.KernelError(
            f"{entry}: shapes x {tuple(x.shape)}, mask {tuple(mask.shape)}, exposure {tuple(exposure.shape)}, "
            + ", ".join(f"{k} {tuple(t.shape)}" for k, (t, _) in grids.items())
            + " do not line up as (S, N), (S, N), (S,) and S leading rows")
    if S == 0 or any(t.numel() == 0 for t, _ in grids.values()):
        return None
    if N == 0:
        raise resilience.KernelError(f"{entry}: K5 takes at least one event slot a row")
    ops = dict(sweep_events(kind, tpl, x, cfg) if events is None else events)
    for name, t in ops.items():
        if t.shape[0] != S or not t.is_contiguous() or t.device != x.device or t.dtype != _F64:
            raise resilience.KernelError(f"{entry}: K5's operand {name} is not a contiguous f64 "
                                         f"tensor of x's {S} rows on its device")
    return ops


def _count_launch(key: str) -> None:
    with _STATE_LOCK:
        LAUNCHES[key] += 1


def _launch_profile(kind, tpl, x, mask, exposure, phis, cfg: ToAFitConfig, events=None):
    """Check the operands and launch K5's sweep once: (LL, A, b), each
    (S, P). ``events``: ``sweep_events(kind, tpl, x, cfg)``, computed here
    if None."""
    out = [torch.empty(tuple(phis.shape), dtype=_F64, device=x.device) for _ in range(3)]
    ops = _row_operands("profile_sweep", kind, tpl, x, mask, exposure, {"phis": (phis, 2)}, cfg, events)
    if ops is None:
        return tuple(out)
    from crimp_tpu_torch.ops import z2_grid

    lib = _lib()
    ptr = lambda name: ops[name].data_ptr() if name in ops else None  # noqa: E731
    S, N = x.shape
    with profiling.launch_window(x.device):
        rc = lib.toafit_profile(
            x.data_ptr(), mask.data_ptr(), exposure.data_ptr(), phis.data_ptr(), ptr("ev_c"), ptr("ev_s"),
            ptr("comp"), ptr("row"), S, phis.shape[1], N, tpl.n_comp, _KIND_CODE[kind], norm_mode(cfg),
            cfg.newton_iters, cfg.norm_hi, cfg.amp_lo, cfg.amp_hi, int(cfg.mxu_bf16 == 1),
            out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(), z2_grid.stream_of(x))
    z2_grid.check_launch(rc, "toafit_profile")
    _count_launch("profile_sweep")
    return tuple(out)


def profile_sweep(kind, tpl, x, mask, exposure, phis, cfg: ToAFitConfig, site: str = "toa_profile_sweep",
                  events=None):
    """The fixed-shape profile sweep (LL, A*, b*), each (S, P), for x, mask
    (S, N), exposure (S,), phis (S, P) and one shared template or one per
    row: one K5 launch on a CUDA tensor (every operand contiguous, or
    ``KernelError``; nothing falls back), the twin
    ``profile_sweep_reference`` on a CPU tensor. ``site`` names the kernel
    span and cost row of the launch (``obs roofline``); ``events`` passes
    ``sweep_events`` computed once for several sweeps of the same rows."""
    if not _on_card(x):
        return profile_sweep_reference(kind, tpl, x, mask, exposure, phis, cfg)
    with costmodel.kernel_span(site):
        out = _launch_profile(kind, tpl, x, mask, exposure, phis, cfg, events)
    costmodel.capture(site, None, kind, x, mask, exposure, phis, cfg, out=list(out),
                      counts=lambda: costmodel.k5_counts(
                          x.shape[0], phis.shape[1], float(mask.sum()) / max(x.shape[0], 1), tpl.n_comp, kind,
                          norm_mode(cfg), cfg.newton_iters, bf16=cfg.mxu_bf16 == 1))
    return out


def _launch_golden(kind, tpl, x, mask, exposure, lo, hi, cfg: ToAFitConfig, events=None):
    """Check the operands and launch K5's golden-section refine once:
    (phi_best, ll_max, a_best, b_best), each (S,)."""
    if cfg.refine_iters < 0:
        raise resilience.KernelError(f"golden_refine: K5 takes refine_iters >= 0, got {cfg.refine_iters}")
    out = [torch.empty(tuple(lo.shape), dtype=_F64, device=x.device) for _ in range(4)]
    ops = _row_operands("golden_refine", kind, tpl, x, mask, exposure, {"lo": (lo, 1), "hi": (hi, 1)}, cfg,
                        events)
    if ops is None:
        return tuple(out)
    from crimp_tpu_torch.ops import z2_grid

    lib = _lib()
    ptr = lambda name: ops[name].data_ptr() if name in ops else None  # noqa: E731
    S, N = x.shape
    with profiling.launch_window(x.device):
        rc = lib.toafit_golden(
            x.data_ptr(), mask.data_ptr(), exposure.data_ptr(), lo.data_ptr(), hi.data_ptr(), ptr("ev_c"),
            ptr("ev_s"), ptr("comp"), ptr("row"), S, N, tpl.n_comp, _KIND_CODE[kind], norm_mode(cfg),
            cfg.newton_iters, cfg.refine_iters, cfg.norm_hi, cfg.amp_lo, cfg.amp_hi, int(cfg.mxu_bf16 == 1),
            *(t.data_ptr() for t in out), z2_grid.stream_of(x))
    z2_grid.check_launch(rc, "toafit_golden")
    _count_launch("golden_refine")
    return tuple(out)


def golden_refine_reference(kind, tpl, x, mask, exposure, lo, hi, cfg: ToAFitConfig, sweep=None):
    """Plain version of K5's golden-section refine: ``optimize.golden_section``
    over one-phase sweeps of every row on [lo, hi] (``cfg.refine_iters``
    iterations), then a one-phase sweep at the optimum for its (A, b).
    Returns (phi_best, ll_max, a_best, b_best), each (S,). ``sweep`` is the
    fixed-shape sweep it chains, the twin ``profile_sweep_reference`` by
    default (``profile_sweep`` makes it the chain of one-phase K5 launches
    that a card fit ran before the refine was one launch)."""
    sweep = profile_sweep_reference if sweep is None else sweep

    def at(phi):
        return sweep(kind, tpl, x, mask, exposure, phi[:, None].contiguous(), cfg)

    phi_best, ll_max = golden_section(lambda phi: at(phi)[0][:, 0], lo, hi, iters=cfg.refine_iters)
    _, a, b = at(phi_best)
    return phi_best, ll_max, a[:, 0], b[:, 0]


def golden_refine(kind, tpl, x, mask, exposure, lo, hi, cfg: ToAFitConfig, events=None):
    """The golden-section refine of every row's profile likelihood on
    [lo, hi] (each (S,)) and the nuisance parameters at the optimum:
    (phi_best, ll_max, a_best, b_best), each (S,). On a CUDA tensor one K5
    launch (``csrc/toafit.cu`` ``toafit_golden``: a cluster of two blocks a
    row, ``cfg.refine_iters`` rounds), bitwise the chain of one-phase K5
    sweeps under ``golden_section`` and the sweep at the optimum; operands
    K5 cannot take raise ``KernelError`` (nothing falls back). On a CPU
    tensor ``golden_refine_reference``. ``events``: ``sweep_events`` of the
    rows, computed once a fit."""
    if not _on_card(x):
        return golden_refine_reference(kind, tpl, x, mask, exposure, lo, hi, cfg)
    site = "toa_sweep_refine"
    with costmodel.kernel_span(site):
        out = _launch_golden(kind, tpl, x, mask, exposure, lo, hi, cfg, events)
    costmodel.capture(site, None, kind, x, mask, exposure, lo, hi, cfg, out=list(out),
                      counts=lambda: costmodel.k5_golden_counts(
                          x.shape[0], float(mask.sum()) / max(x.shape[0], 1), tpl.n_comp, kind, norm_mode(cfg),
                          cfg.newton_iters, cfg.refine_iters, bf16=cfg.mxu_bf16 == 1))
    return out


def profile_loglik_full(kind, tpl, x, mask, exposure, phis, cfg: ToAFitConfig, warm_vec=None,
                        site: str = "toa_profile_sweep", events=None):
    """(LL(phi), A*(phi), b*(phi)), each (S, P): profile over phShift with
    the nuisance parameters re-optimized per shift. x, mask (S, N);
    exposure (S,); phis (S, P). The fixed-shape sweep is
    :func:`profile_sweep` (K5 on a card, one launch under span ``site``,
    reusing ``events``). With ``cfg.free_idx`` the general Nelder-Mead path
    is ``general_sweep.general_profile`` (K6 on a card, one launch under the
    span ``site`` names with ``toa_general_`` for ``toa_sweep_``);
    ``warm_vec`` (S, D) warm-starts it."""
    if cfg.free_idx:
        ll, vecs = general_sweep.general_profile(kind, tpl, x, mask, exposure, phis, cfg, warm_vec,
                                                 site=general_site(site))
        return ll, vecs[..., 0], vecs[..., 1 + 3 * tpl.n_comp]
    return profile_sweep(kind, tpl, x.contiguous(), mask.contiguous(), exposure.contiguous(),
                         phis.contiguous(), cfg, site=site, events=events)


def profile_loglik(kind, tpl, x, mask, exposure, phis, cfg: ToAFitConfig, warm_vec=None,
                   site: str = "toa_profile_sweep", events=None):
    """(LL(phi), A*(phi)) profile with the norm re-optimized per shift."""
    ll, a, _ = profile_loglik_full(kind, tpl, x, mask, exposure, phis, cfg, warm_vec, site=site, events=events)
    return ll, a


# ---------------------------------------------------------------------------
# General free-parameter path (readvaryparam)
# ---------------------------------------------------------------------------


def _unflatten_tpl(vec: torch.Tensor, tpl: ProfileParams) -> ProfileParams:
    """Template from flattened vectors (..., D); ph_shift is tpl's."""
    K = tpl.n_comp
    return tpl.replace(
        norm=vec[..., 0],
        amp=vec[..., 1 : 1 + K],
        loc=vec[..., 1 + K : 1 + 2 * K],
        wid=vec[..., 1 + 2 * K : 1 + 3 * K],
        amp_shift=vec[..., 1 + 3 * K],
    )


def general_site(site: str) -> str:
    """The K6 span of a K5 sweep's role: ``toa_sweep_brute`` ->
    ``toa_general_brute``, ...; any other caller's ``toa_general_sweep``."""
    return "toa_general_" + site[len("toa_sweep_"):] if site.startswith("toa_sweep_") else "toa_general_sweep"


# ---------------------------------------------------------------------------
# Per-segment fit, batched over segments
# ---------------------------------------------------------------------------


def template_rows(tpl: ProfileParams, rows) -> ProfileParams:
    """The templates of ``rows`` when ``tpl`` carries one per segment row
    (leaves with a leading row axis); a shared template as it is."""
    if tpl.norm.dim() == 0:
        return tpl
    return ProfileParams(**{f.name: getattr(tpl, f.name)[rows] for f in fields(tpl)})


def free_param_spec(kind: str, template: dict, vary_amps: bool = False):
    """(free_idx, lo, hi, n_free) from a template dict's 'vary' flags.

    Bounds follow the reference's readvaryparam mode: norm in
    [val/5, 5*val]; Fourier amp in [0, 1000], ph in [-pi, pi]; vm/cauchy
    amp in [0, 5*val], cen in val +/- 0.6, wid in [0, 30*pi]. ``n_free``
    counts the varying template parameters but not phShift (a reference
    quirk kept for parity).
    """
    K = int(template["nbrComp"])

    def varies(key):
        entry = template[key]
        return bool(entry["vary"]) if isinstance(entry, dict) else False

    def value(key):
        entry = template[key]
        return float(entry["value"]) if isinstance(entry, dict) else float(entry)

    idx, lo, hi = [], [], []
    n_free = 0
    if varies("norm"):
        idx.append(0)
        lo.append(value("norm") / 5)
        hi.append(value("norm") * 5)
        n_free += 1
    for k in range(1, K + 1):
        if varies(f"amp_{k}"):
            idx.append(k)
            if kind == FOURIER:
                lo.append(0.0)
                hi.append(1000.0)
            else:
                five = 5 * value(f"amp_{k}")
                lo.append(min(0.0, five))
                hi.append(max(0.0, five))
            n_free += 1
        loc_key = f"ph_{k}" if kind == FOURIER else f"cen_{k}"
        if varies(loc_key):
            idx.append(K + k)
            if kind == FOURIER:
                lo.append(-np.pi)
                hi.append(np.pi)
            else:
                lo.append(value(loc_key) - 0.6)
                hi.append(value(loc_key) + 0.6)
            n_free += 1
        if kind != FOURIER and varies(f"wid_{k}"):
            idx.append(2 * K + k)
            lo.append(0.0)
            hi.append(30 * np.pi)
            n_free += 1
    if vary_amps:
        idx.append(3 * K + 1)
        lo.append(0.01 if kind == FOURIER else 1e-6)
        hi.append(100.0 if kind == FOURIER else (500.0 if kind == VONMISES else 1e6))
        n_free += 1

    # Widen any box that excludes its own template value.
    flat_vals = [value("norm")]
    for k in range(1, K + 1):
        flat_vals.append(value(f"amp_{k}"))
    for k in range(1, K + 1):
        flat_vals.append(value(f"ph_{k}" if kind == FOURIER else f"cen_{k}"))
    for k in range(1, K + 1):
        flat_vals.append(value(f"wid_{k}") if kind != FOURIER else 0.0)
    flat_vals.append(1.0)  # ampShift starts at 1
    for pos, i in enumerate(idx):
        v = flat_vals[i]
        margin = abs(v) * 1e-6 + 1e-9
        if v - margin < lo[pos]:
            lo[pos] = v - margin
        if v + margin > hi[pos]:
            hi[pos] = v + margin
    return tuple(idx), tuple(lo), tuple(hi), n_free


def _binned_chi2(kind, tpl, x, mask, exposure, phi_best, a_best, b_best, cfg: ToAFitConfig):
    """chi2 of the binned profile against the best-fit model (mask-safe for
    empty bins), per segment."""
    upper = 1.0 if kind == FOURIER else 2 * math.pi
    nbins = cfg.nbins
    idx = torch.clamp((x / upper * nbins).to(torch.int32), 0, nbins - 1).long()
    counts = torch.zeros(x.shape[0], nbins, dtype=x.dtype, device=x.device)
    counts.scatter_add_(1, idx, mask.to(x.dtype))
    per_bin_exp = (exposure / nbins)[:, None]
    rate = counts / per_bin_exp
    rate_err = torch.sqrt(counts) / per_bin_exp
    centers = (torch.arange(nbins, dtype=x.dtype, device=x.device) + 0.5) * (upper / nbins)
    shape = shape_at_shifts(kind, tpl, centers, phi_best[:, None])[:, 0, :]
    model = a_best[:, None] + b_best[:, None] * shape
    valid = counts > 0
    chi2 = torch.sum(
        torch.where(valid, (model - rate) ** 2 / torch.where(valid, rate_err, 1.0) ** 2, 0.0),
        dim=-1,
    )
    n_free = cfg.n_free if cfg.n_free >= 0 else 2 + (1 if cfg.vary_amps else 0)
    return chi2 / max(nbins - n_free, 1)


def _first_true(block: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis (0 when none)."""
    return torch.argmax(block.to(torch.uint8), dim=-1)


def _dense_steps(cfg: ToAFitConfig) -> int:
    """W, the error scan's dense first window in steps a side."""
    W = cfg.err_dense_window if cfg.err_dense_window >= 0 else DENSE_WINDOW_DEFAULT
    return min(W, cfg.ph_shift_res // 2)


def _scan_profile(kind, tpl, x, mask, exposure, cfg: ToAFitConfig, warm_vec, events, rows, phis, site):
    """The error scan's profile LL of ``rows`` at phis (R, P)."""
    warm = None if warm_vec is None else warm_vec[rows]
    ll, _ = profile_loglik(kind, template_rows(tpl, rows), x[rows], mask[rows], exposure[rows], phis,
                           cfg, warm, site=site, events=events_rows(events, rows))
    return ll


def _dense_window(kind, tpl, x, mask, exposure, phi_best, ll_max, cfg: ToAFitConfig, warm_vec=None, events=None):
    """The error scan's dense first window: both sides' first W steps
    (``_dense_steps``) in one profile. Returns (S, 2W) bool, where the LL
    drop exceeds the half-chi2 threshold (the low side's W steps, then the
    high side's), or None at W 0."""
    W = _dense_steps(cfg)
    if W == 0:
        return None
    step = (2 * math.pi) / cfg.ph_shift_res
    all_rows = torch.arange(x.shape[0], device=x.device)
    ks_w = (1 + torch.arange(W, device=x.device)).to(_F64)
    phis_dense = torch.cat([phi_best[:, None] - ks_w * step, phi_best[:, None] + ks_w * step], dim=1)
    ll_dense = _scan_profile(kind, tpl, x, mask, exposure, cfg, warm_vec, events, all_rows, phis_dense,
                             "toa_sweep_err_dense")
    return (ll_max[:, None] - ll_dense) > CHI2_1SIG_HALF


def _error_scan(kind, tpl, x, mask, exposure, phi_best, ll_max, cfg: ToAFitConfig, warm_vec=None,
                events=None, dense_cross=None):
    """Likelihood-profile 1-sigma bounds: dense first window + chunked loop.

    The reported bound is (k*+1)*step + step/2 where k* is the first step
    whose LL drop exceeds the half-chi2 threshold; with no crossing within
    res/2 steps the bound saturates. Phase 1 evaluates both sides' first W
    steps in one sweep (``_dense_window``; ``dense_cross`` is its result,
    computed here when None); phase 2, the fallback loop seeded at k0 = W, runs
    chunks of ``err_chunk`` steps only for the segments that have not
    crossed yet, so every segment's bounds equal a lone run's. ``warm_vec``
    (S, D) seeds the readvaryparam Nelder-Mead at each segment's optimum;
    ``events`` are K5's ``sweep_events`` of all S rows.

    Returns (err_lo, err_hi, loop_iters), each (S,).
    """
    S = x.shape[0]
    dev = x.device
    step = (2 * math.pi) / cfg.ph_shift_res
    max_k = cfg.ph_shift_res // 2
    chunk = cfg.err_chunk
    W = _dense_steps(cfg)

    def scan_profile(rows, phis, site):
        return _scan_profile(kind, tpl, x, mask, exposure, cfg, warm_vec, events, rows, phis, site)

    if W > 0:
        if dense_cross is None:
            dense_cross = _dense_window(kind, tpl, x, mask, exposure, phi_best, ll_max, cfg, warm_vec, events)

        def seed(block):
            any_cross = torch.any(block, dim=-1)
            k_star = _first_true(block) + 1
            kstop = torch.where(any_cross, k_star + 1, max_k + 1)
            return torch.full((S,), W, device=dev), any_cross, kstop

        init_lo = seed(dense_cross[:, :W])
        init_hi = seed(dense_cross[:, W:])
    else:
        cold = (
            torch.zeros(S, dtype=torch.long, device=dev),
            torch.zeros(S, dtype=torch.bool, device=dev),
            torch.full((S,), max_k + 1, device=dev),
        )
        init_lo = init_hi = cold

    def one_side(sign, init):
        k0, found, kstop = (t.clone() for t in init)
        ks_c = 1 + torch.arange(chunk, device=dev)
        while True:
            active = (~found) & (k0 < max_k)
            rows = torch.nonzero(active).flatten()
            if rows.numel() == 0:
                break
            ks = k0[rows, None] + ks_c  # (R, chunk)
            phis = phi_best[rows, None] + sign * ks.to(_F64) * step
            drop = ll_max[rows, None] - scan_profile(rows, phis, "toa_sweep_err_loop")
            crossed = (drop > CHI2_1SIG_HALF) & (ks <= max_k)
            any_cross = torch.any(crossed, dim=-1)
            k_star = torch.gather(ks, 1, _first_true(crossed)[:, None])[:, 0]
            kstop[rows] = torch.where(~found[rows] & any_cross, k_star + 1, kstop[rows])
            found[rows] = found[rows] | any_cross
            k0[rows] = k0[rows] + chunk
        iters = torch.div(k0 - init[0], chunk, rounding_mode="floor")
        return kstop.to(_F64) * step + step / 2, iters

    err_lo, it_lo = one_side(-1.0, init_lo)
    err_hi, it_hi = one_side(+1.0, init_hi)
    return err_lo, err_hi, it_lo + it_hi


def _brute_sweep(kind, tpl, x, mask, exposure, cfg: ToAFitConfig, brute_phis, events=None):
    """The coarse global grid's profile LL (S, n_brute) at ``brute_phis``:
    on K5's or K6's route one sweep of all n_brute phases (it keeps no (S,
    P, N) temporaries, and rows are independent); the twin sweeps chunks of
    brute_chunk phases."""
    S = x.shape[0]
    chunk = cfg.n_brute if _on_card(x) else max(1, min(cfg.brute_chunk, cfg.n_brute))
    pad = (-cfg.n_brute) % chunk
    phis_pad = torch.cat([brute_phis, brute_phis[-1:].expand(pad)]) if pad else brute_phis
    return torch.cat([
        profile_loglik(kind, tpl, x, mask, exposure, p.expand(S, chunk), cfg, site="toa_sweep_brute",
                       events=events)[0]
        for p in phis_pad.reshape(-1, chunk)
    ], dim=1)[:, : cfg.n_brute]


def _general_chain(kind, tpl, x, mask, exposure, cfg: ToAFitConfig, brute_phis):
    """The readvaryparam fit's chain of K6 launches on rows x, mask (R, N),
    exposure (R,), each row's values its own: the brute grid, the golden
    refine on the best phase +- one grid step with the refit vector at its
    optimum, and the error scan's dense window from that vector. Returns
    (phi_best, ll_max, vec_best, dense_cross) (``_dense_window``)."""
    grid_step = 2 * _phase_range(kind) / (cfg.n_brute - 1)
    phi0 = brute_phis[torch.argmax(_brute_sweep(kind, tpl, x, mask, exposure, cfg, brute_phis), dim=1)]
    phi_best, ll_max, vec_best = general_sweep.general_golden(kind, tpl, x, mask, exposure, phi0 - grid_step,
                                                              phi0 + grid_step, cfg)
    dense = _dense_window(kind, tpl, x, mask, exposure, phi_best, ll_max, cfg, vec_best)
    return phi_best, ll_max, vec_best, dense


def _row_groups(x, mask, cfg: ToAFitConfig, row_events=None) -> list | None:
    """The row groups of a readvaryparam fit on a CUDA device
    (``general_sweep.plan_row_groups`` from each row's masked events,
    ``row_events`` or counted from ``mask``, and the card's SMs, at most one
    group a stream priority level); None for one group: the batch as it
    stands, and every fit off a CUDA device, which has no streams."""
    if x.device.type != "cuda" or x.shape[0] < 2:
        return None
    least, greatest = torch.cuda.Stream.priority_range()
    counts = mask.sum(dim=1).cpu().numpy() if row_events is None else row_events
    groups = general_sweep.plan_row_groups(
        counts, torch.cuda.get_device_properties(x.device).multi_processor_count, cfg.n_brute,
        2 * _dense_steps(cfg), max_groups=min(general_sweep.MAX_ROW_GROUPS, least - greatest + 1))
    return groups if len(groups) > 1 else None


def _group_stream(device, g: int):
    """Row group g's stream on ``device``, at the g-th highest priority:
    one a (device, group), kept for every fit, so the memory a group's
    chain frees stays in its stream's pool of the caching allocator for the
    next fit's chain."""
    key = (torch.device(device), g)
    with _STATE_LOCK:
        stream = _GROUP_STREAMS.get(key)
        if stream is None:
            greatest = torch.cuda.Stream.priority_range()[1]
            stream = _GROUP_STREAMS[key] = torch.cuda.Stream(device=device, priority=greatest + g)
    return stream


def _general_chains(kind, tpl, x, mask, exposure, cfg: ToAFitConfig, brute_phis, groups=None):
    """``_general_chain`` on each row group of ``groups`` (lists of row
    indices; None: one group, the batch as it stands, on the current
    stream), each group's chain inside a ``crimp.fit.group`` range. On a
    card group g's chain runs on a stream of its own at the g-th highest
    priority, so one group's golden refine shares the SMs with another's
    sweeps; the host issues every chain before it waits on the card, the
    current stream then waits on each. Returns ``_general_chain``'s
    columns in the batch's row order, each row's bits as in one group."""
    obs.counter_add("toa_general_groups", 1 if groups is None else len(groups))
    if groups is None:
        with obs.profiler_range(spans.FIT_GROUP):
            return _general_chain(kind, tpl, x, mask, exposure, cfg, brute_phis)
    order = np.concatenate(groups)
    # the rows of each group and the inverse order, to the card in one copy before any chain
    idx = torch.as_tensor(np.stack([order, np.argsort(order)]), device=x.device)
    card = x.device.type == "cuda"
    main = torch.cuda.current_stream(x.device) if card else None
    chains, first = [], 0
    for g, rows in enumerate(groups):
        sel = idx[0, first:first + len(rows)]
        first += len(rows)
        stream = _group_stream(x.device, g) if card else None
        with torch.cuda.stream(stream) if card else contextlib.nullcontext(), obs.profiler_range(spans.FIT_GROUP):
            if card:
                stream.wait_stream(main)
            chains.append((stream, _general_chain(kind, tpl, x[sel], mask[sel], exposure[sel], cfg, brute_phis)))
    for stream, out in chains:
        if stream is not None:
            main.wait_stream(stream)
            for t in out:
                if t is not None:
                    t.record_stream(main)
    return tuple(None if parts[0] is None else torch.cat(parts)[idx[1]]
                 for parts in zip(*(out for _, out in chains)))


def fit_segment(kind: str, tpl: ProfileParams, x, mask, exposure, cfg: ToAFitConfig, row_events=None) -> dict:
    """Full ToA fit of S padded segments at once: x, mask (S, N), exposure
    (S,), tensors on one device (the JAX package's vmapped ``fit_segment``).
    ``tpl`` is one shared template, or one per row: leaves with a leading
    (S,) axis (``fit_toas_batch_multi``; not with ``cfg.free_idx``).

    On a CUDA tensor each step is one K5 launch: the brute grid (all
    ``n_brute`` phases), the whole golden-section refine with the nuisance
    solve at its optimum (``golden_refine``; with ``refine_mode="grid"``
    each refine round and the nuisance solve), the dense error window and
    each pass of the error scan's fallback loop; ``brute_chunk`` matters
    only to the twin, which a CPU tensor takes. With ``cfg.free_idx`` each
    profile is one K6 launch instead: the brute grid, the whole
    golden-section refine with the refit vector at its optimum
    (``general_sweep.general_golden``; with ``refine_mode="grid"`` each
    refine round and the nuisance solve), the dense error window and each
    fallback pass. In golden mode the first three are a chain a row group
    (``_general_chains``, the groups ``_row_groups`` plans from
    ``row_events``, each row's masked events on the host, counted from
    ``mask`` when None); the fallback passes then take the whole batch."""
    if cfg.free_idx and tpl.norm.dim() > 0:
        raise ValueError("per-row templates take the fixed-shape fit (no cfg.free_idx)")
    half_range = _phase_range(kind)
    S = x.shape[0]
    dev = x.device

    # 1) coarse global brute grid
    brute_phis = torch.as_tensor(
        np.linspace(-half_range, half_range, cfg.n_brute), dtype=_F64, device=dev
    )
    card = _on_card(x)
    # K5's phase-independent operands, once for every sweep of the fit
    events = None
    if card and not cfg.free_idx:
        with obs.profiler_range(spans.FIT_EVENTS):
            events = sweep_events(kind, tpl, x, cfg)
    dense_cross = None
    if cfg.free_idx and cfg.refine_mode == "golden":
        # 1-2) the brute grid, the refine with the refit vector at its optimum
        #      (one K6 launch on the card, golden_section over the twin on the
        #      CPU) and the error scan's dense window, a chain a row group
        phi_best, ll_max, vec_best, dense_cross = _general_chains(
            kind, tpl, x, mask, exposure, cfg, brute_phis, _row_groups(x, mask, cfg, row_events))
    else:
        ll_brute = _brute_sweep(kind, tpl, x, mask, exposure, cfg, brute_phis, events)
        i_best = torch.argmax(ll_brute, dim=1)
        phi0 = brute_phis[i_best]
        grid_step = 2 * half_range / (cfg.n_brute - 1)

    # 2) refine to the profile-likelihood optimum (a readvaryparam golden
    #    refine ran in its chain)
    if cfg.refine_mode == "grid":
        if cfg.refine_grid < 3 or cfg.refine_grid % 2 == 0:
            raise ValueError(
                f"refine_grid must be odd and >= 3, got {cfg.refine_grid}"
            )
        phi_c = phi0
        ll_max = torch.gather(ll_brute, 1, i_best[:, None])[:, 0]
        half = grid_step
        offs = torch.as_tensor(np.linspace(-1.0, 1.0, cfg.refine_grid), dtype=_F64, device=dev)
        for _ in range(cfg.refine_rounds):
            phis_r = phi_c[:, None] + half * offs
            ll_r, _ = profile_loglik(kind, tpl, x, mask, exposure, phis_r, cfg, site="toa_sweep_refine",
                                     events=events)
            j = torch.argmax(ll_r, dim=1)
            phi_c = torch.gather(phis_r, 1, j[:, None])[:, 0]
            ll_max = torch.gather(ll_r, 1, j[:, None])[:, 0]
            half = 2.0 * half / (cfg.refine_grid - 1)
        phi_best = phi_c
    elif cfg.refine_mode == "golden" and not cfg.free_idx:
        # the refine and the nuisance parameters at its optimum: one K5
        # launch on the card, golden_section over the twin on the CPU
        phi_best, ll_max, a_best, b_best = golden_refine(kind, tpl, x, mask, exposure, phi0 - grid_step,
                                                         phi0 + grid_step, cfg, events)
    elif cfg.refine_mode != "golden":
        raise ValueError(
            f"unknown refine_mode {cfg.refine_mode!r} (expected 'golden' or 'grid')"
        )

    # 3) nuisance parameters at the optimum (the golden refine's own in
    #    golden mode); general mode also yields the full refit shape vector
    #    for the chi2 model
    if cfg.free_idx:
        if cfg.refine_mode == "grid":
            _, vecs = general_sweep.general_profile(kind, tpl, x, mask, exposure, phi_best[:, None].contiguous(),
                                                    cfg, site="toa_general_nuisance")
            vec_best = vecs[:, 0]
        a_best, b_best = vec_best[:, 0], vec_best[:, 1 + 3 * tpl.n_comp]
    else:
        if cfg.refine_mode == "grid":
            _, a_arr, b_arr = profile_loglik_full(kind, tpl, x, mask, exposure, phi_best[:, None], cfg,
                                                  site="toa_sweep_nuisance", events=events)
            a_best, b_best = a_arr[:, 0], b_arr[:, 0]
        vec_best = general_sweep.flatten_template(tpl).expand(S, -1).clone()
        vec_best[:, 0] = a_best
        vec_best[:, 1 + 3 * tpl.n_comp] = b_best

    # 4) likelihood-profile error bounds (general mode: each step's
    #    Nelder-Mead starts from the best-fit vector)
    warm = vec_best if cfg.free_idx else None
    with obs.profiler_range(spans.FIT_ERROR_SCAN):
        err_lo, err_hi, scan_iters = _error_scan(kind, tpl, x, mask, exposure, phi_best, ll_max, cfg, warm,
                                                 events, dense_cross)

    # 5) binned-profile goodness of fit (general mode: the model at the
    #    refit shape, ampShift folded into the template)
    with obs.profiler_range(spans.FIT_CHI2):
        if cfg.free_idx:
            red_chi2 = _binned_chi2(kind, _unflatten_tpl(vec_best, tpl), x, mask, exposure, phi_best,
                                    vec_best[:, 0], torch.ones_like(a_best), cfg)
        else:
            red_chi2 = _binned_chi2(kind, tpl, x, mask, exposure, phi_best, a_best, b_best, cfg)

    return {
        "phShift": phi_best,
        "phShift_LL": err_lo,
        "phShift_UL": err_hi,
        "norm": a_best,
        "ampShift": b_best,
        "logLmax": ll_max,
        "redChi2": red_chi2,
        # fallback-loop passes the error scan ran (both sides): 0 when the
        # dense first window covered the whole scan
        "errScanLoopIters": scan_iters,
        # flattened best-fit vector [norm, amps, locs, wids, ampShift]
        "theta_best": vec_best,
    }


def fit_toas_batch(kind: str, tpl: ProfileParams, phases, masks, exposures,
                   cfg: ToAFitConfig, device=None) -> dict:
    """The whole ToA batch in one call: phases/masks (S, Nmax) padded,
    exposures (S,). Returns a dict of tensors on ``device`` (default cuda)."""
    dev = resolve_device(device)
    with obs.span(spans.FIT), torch.no_grad():
        with obs.profiler_range(spans.FIT_TO_CARD):
            x = torch.as_tensor(phases, dtype=_F64).to(dev)
            # each row's masked events, for the readvaryparam fit's row groups
            row_events = np.count_nonzero(np.asarray(masks), axis=1) if cfg.free_idx else None
            mask = torch.as_tensor(masks, dtype=torch.bool).to(dev)
            exposure = torch.as_tensor(exposures, dtype=_F64).to(dev)
            tpl = tpl.to(dev)
        return fit_segment(kind, tpl, x, mask, exposure, cfg, row_events)


def resolve_runtime_cfg(cfg: ToAFitConfig, n_segments: int = 1, n_events: int = 1, device=None) -> ToAFitConfig:
    """Fill the cfg's auto (-1) knobs, dense window and bf16 sweep, through
    ``autotune.resolve_toafit(n_segments, n_events)``: the environment, then
    a cached verdict of ``device``, then the static defaults (window 32,
    bf16 off).
    Explicit (>= 0) values win. Any window gives the same bits."""
    if cfg.err_dense_window >= 0 and cfg.mxu_bf16 >= 0:
        return cfg
    from crimp_tpu_torch.ops import autotune

    resolved = autotune.resolve_toafit(n_segments, n_events, device=device)
    upd = {}
    if cfg.err_dense_window < 0:
        upd["err_dense_window"] = int(resolved["err_dense_window"])
    if cfg.mxu_bf16 < 0:
        upd["mxu_bf16"] = int(resolved["mxu_bf16"])
    return cfg._replace(**upd)


def fit_toas_batch_auto(kind: str, tpl: ProfileParams, phases, masks, exposures,
                        cfg: ToAFitConfig, device=None, mesh=None) -> dict:
    """``fit_toas_batch`` on host arrays, numpy results, with the SEGMENT
    axis sharded across devices when it helps.

    With ``mesh`` (a ``parallel.mesh.segment_mesh``), or on a job with
    several devices of ``device``'s type (``CRIMP_TORCH_SHARD=0`` opts
    out), and at least as many segments as shards, the batch is padded to a
    multiple of the shard count with fully masked segments (exposure 1),
    dropped from the result, and each shard fits its block of rows on its
    device, with no communication. A block's event sums round with the rows
    beside it (``ops/reduce.event_sum``), so a sharded fit agrees with the
    one-batch fit to that rounding. Otherwise one batch on ``device``."""
    from crimp_tpu_torch.parallel import mesh as pmesh

    phases = np.asarray(phases, dtype=float)
    n_seg = phases.shape[0]
    if n_seg == 0:
        return {}
    with obs.profiler_range(spans.FIT_PLAN):
        obs.counter_add("toas_fit", n_seg)
        masks, exposures = np.asarray(masks, dtype=bool), np.asarray(exposures, dtype=float)
        dev = resolve_device(device)
        cfg = resolve_runtime_cfg(cfg, n_seg, phases.shape[1], device=dev)
        if mesh is None and pmesh.sharding_enabled():
            local = [d for d in pmesh.available_devices() if d.type == dev.type]
            if len(local) >= 2:
                mesh = pmesh.segment_mesh(local)
    if mesh is None or n_seg < mesh.size:
        with costmodel.kernel_span("toa_fit_batch"):
            out = fit_toas_batch(kind, tpl, phases, masks, exposures, cfg, device=dev)
        costmodel.capture("toa_fit_batch", None, kind, tpl, phases, masks, exposures, cfg)
        with obs.profiler_range(spans.FIT_TO_HOST):
            return {k: v.cpu().numpy() for k, v in out.items()}
    from crimp_tpu_torch.parallel import registry

    pad = pmesh.pad_batch_for_mesh(n_seg, mesh)
    if pad:
        phases = np.concatenate([phases, np.zeros((pad,) + phases.shape[1:])])
        masks = np.concatenate([masks, np.zeros((pad,) + masks.shape[1:], dtype=masks.dtype)])
        exposures = np.concatenate([exposures, np.ones(pad)])
    with costmodel.kernel_span("toa_fit_batch"):
        parts = pmesh.map_blocks(
            lambda slot, ph, mk, ex: fit_toas_batch(kind, tpl, ph, mk, ex, cfg, device=slot.device),
            pmesh.shard_segments(phases, mesh), pmesh.shard_segments(masks, mesh),
            pmesh.shard_segments(exposures, mesh))
    with obs.profiler_range(spans.FIT_TO_HOST):
        out = {k: np.concatenate([p[k].cpu().numpy() for p in parts])[:n_seg] for k in parts[0]}
    costmodel.capture("toa_fit_batch", None, kind, tpl, phases, masks, exposures, cfg,
                      out=list(out.values()), plan=registry.specs_for("segment_batch", mesh))
    return out


def slice_sorted_intervals(times, starts, ends, assume_sorted: bool = False) -> list[np.ndarray]:
    """Per-interval event segments of ``times`` over inclusive [start, end]
    windows (host helper): binary-search slices on sorted input, boolean
    masks otherwise."""
    with obs.profiler_range(spans.FOLD_SLICE):
        times = np.asarray(times)
        if not assume_sorted:
            assume_sorted = bool(np.all(np.diff(times) >= 0))
        if assume_sorted:
            return [
                times[np.searchsorted(times, s, "left"):np.searchsorted(times, e, "right")]
                for s, e in zip(starts, ends)
            ]
        return [times[(times >= s) & (times <= e)] for s, e in zip(starts, ends)]


def pad_segments(phase_list: list[np.ndarray]) -> tuple[np.ndarray, np.ndarray]:
    """Pad ragged per-segment phase arrays to (S, Nmax) + mask (host helper)."""
    with obs.profiler_range(spans.FOLD_PAD):
        n_max = max((len(p) for p in phase_list), default=1)
        S = len(phase_list)
        phases = np.zeros((S, n_max))
        masks = np.zeros((S, n_max), dtype=bool)
        for i, p in enumerate(phase_list):
            phases[i, : len(p)] = p
            masks[i, : len(p)] = True
    return phases, masks


def bucket_by_pow2(sizes, max_pad_ratio: float = 4.0) -> list[list[int]]:
    """Group indices of ``sizes`` into power-of-two size buckets: sort by size
    (stable), give each item its ceil-pow2 capacity, and merge consecutive
    capacities while the padding waste for the smallest member stays under
    ``max_pad_ratio``. Returns buckets of original indices, smallest first."""
    sizes = np.asarray(sizes)
    if sizes.size == 0:
        return []
    order = np.argsort(sizes, kind="stable")
    pow2 = 1 << np.ceil(np.log2(np.maximum(sizes[order], 1))).astype(int)
    buckets: list[list[int]] = []
    current: list[int] = []
    current_cap = pow2[0]
    for pos, idx in enumerate(order):
        cap = pow2[pos]
        if current and cap > current_cap and cap > max_pad_ratio * sizes[current[0]]:
            buckets.append(current)
            current = []
        current.append(int(idx))
        current_cap = cap
    if current:
        buckets.append(current)
    return buckets


def fit_toas_bucketed(kind: str, tpl: ProfileParams, phase_list: list[np.ndarray],
                      exposures: np.ndarray, cfg: ToAFitConfig,
                      max_pad_ratio: float = 4.0, device=None) -> dict:
    """Batched ToA fit with size-bucketed padding: heterogeneous segments are
    grouped into power-of-two buckets, each bucket is one batched fit, and
    results scatter back to the original order (numpy)."""
    if len(phase_list) == 0:
        return {}
    sizes = np.asarray([len(p) for p in phase_list])
    exposures = np.asarray(exposures, dtype=float)
    out: dict[str, np.ndarray] = {}
    for bucket in bucket_by_pow2(sizes, max_pad_ratio):
        phases, masks = pad_segments([phase_list[i] for i in bucket])
        res = fit_toas_batch_auto(kind, tpl, phases, masks, exposures[bucket], cfg, device=device)
        for key, arr in res.items():
            if key not in out:
                out[key] = np.zeros((len(phase_list),) + arr.shape[1:], dtype=arr.dtype)
            out[key][bucket] = arr
    return out
