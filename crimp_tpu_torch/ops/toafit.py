"""Batched unbinned maximum-likelihood ToA extraction.

Port of ``crimp_tpu/ops/toafit.py``. For all three template families the
extended log-likelihood at fixed shape is

    LL(phi, A) = -A*T + sum_i m_i log(A + s_i(phi)) + const(T, N)

which is strictly concave in the norm A, so the inner "re-optimize the
norm" solve is a safeguarded Newton iteration vectorized across the whole
phase grid, and the profile likelihood over phShift is one dense sweep.

The JAX package vmaps ``fit_segment`` over ToA segments; here the segment
axis is a leading batch dimension S of every tensor ((S, N) phases,
(S, P, N) sweeps). ``fori_loop`` becomes a Python loop. The error scan's
batched ``while_loop`` becomes a loop that runs while any segment is still
active, updating only the active segments, so each segment's result equals
a lone run of that segment. Everything is float64, so TF32 cannot enter
the Fourier sweep (``torch.matmul`` on f64 never uses it).

Error bars keep the reference's stepping semantics (step = 2*pi/phShiftRes;
first step k* whose LL drop exceeds chi2_1(0.6827)/2; reported bound =
(k*+1)*step + step/2), with the dense first window of W steps per side.

The readvaryparam general path (``cfg.free_idx``) refits every flagged
template parameter per phase by a fixed-iteration bounded Nelder-Mead,
batched over (segment, phase).

``cfg.mxu_bf16 == 1`` runs the Fourier profile sweep's two matrix products
on bf16-rounded operands with f32 accumulation (a plain ``torch.matmul``,
as JAX leaves it to XLA outside any kernel); off by default. The host
wrappers fill the auto (-1) knobs through ``autotune.resolve_toafit``
(``resolve_runtime_cfg``). ``fit_toas_batch_auto`` shards the segment
axis over a segment mesh when the job has several devices of the call's
type (``parallel.mesh``; ``CRIMP_TORCH_SHARD=0`` opts out), or over the mesh
its caller passes.
"""

from __future__ import annotations

import math
from dataclasses import fields
from typing import NamedTuple

import numpy as np
import torch

from crimp_tpu_torch import obs
from crimp_tpu_torch.models.profiles import CAUCHY, FOURIER, VONMISES, ProfileParams
from crimp_tpu_torch.models.profiles import extended_loglik
from crimp_tpu_torch.obs import costmodel
from crimp_tpu_torch.ops.optimize import bounded_transform, golden_section, nelder_mead
from crimp_tpu_torch.ops import reduce
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
    brute_chunk: int = 64  # brute phases evaluated per sweep (memory bound)
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


def profile_loglik_full(kind, tpl, x, mask, exposure, phis, cfg: ToAFitConfig, warm_vec=None):
    """(LL(phi), A*(phi), b*(phi)), each (S, P): profile over phShift with
    the nuisance parameters re-optimized per shift. x, mask (S, N);
    exposure (S,); phis (S, P). With ``cfg.free_idx`` the general
    Nelder-Mead path runs; ``warm_vec`` (S, D) warm-starts it."""
    if cfg.free_idx:
        ll, vecs = _general_profile_vecs(kind, tpl, x, mask, exposure, phis, cfg, warm_vec)
        return ll, vecs[..., 0], vecs[..., 1 + 3 * tpl.n_comp]
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


def profile_loglik(kind, tpl, x, mask, exposure, phis, cfg: ToAFitConfig, warm_vec=None):
    """(LL(phi), A*(phi)) profile with the norm re-optimized per shift."""
    ll, a, _ = profile_loglik_full(kind, tpl, x, mask, exposure, phis, cfg, warm_vec)
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


def _general_profile_vecs(kind, tpl, x, mask, exposure, phis, cfg: ToAFitConfig, warm_vec=None):
    """Profile LL over phShift with all flagged template parameters refit
    per (segment, phase) by a fixed-iteration bounded Nelder-Mead; returns
    (LL (S, P), refit flattened vectors (S, P, D)).

    ``warm_vec`` (S, D) starts each segment's simplices at a previous
    best-fit vector (the error scan passes the optimum), as the
    reference's sequential refits inherit lmfit state.
    """
    S, P = phis.shape
    dev = x.device
    free_idx = torch.as_tensor(cfg.free_idx, dtype=torch.long, device=dev)
    tf = bounded_transform(cfg.free_lo, cfg.free_hi)
    base = _flatten_tpl(tpl)
    start = base.expand(S, -1) if warm_vec is None else warm_vec
    u0 = tf.to_unbounded(start[:, free_idx])[:, None, :].expand(S, P, -1)

    def vectors(u):
        vec = base.expand(*u.shape[:-1], base.shape[0]).clone()
        vec[..., free_idx] = tf.to_bounded(u)
        return vec

    xs, ms, ts = x[:, None, None, :], mask[:, None, None, :], exposure[:, None, None]

    def nll(u):  # u (S, P, m, F) -> (S, P, m)
        p = _unflatten_tpl(vectors(u), tpl).replace(ph_shift=phis[:, :, None])
        return -extended_loglik(kind, p, xs, ts, ms)

    u_best, f_best = nelder_mead(nll, u0, init_scale=0.25, iters=cfg.nm_iters)
    return -f_best, vectors(u_best)


# ---------------------------------------------------------------------------
# Per-segment fit, batched over segments
# ---------------------------------------------------------------------------


def _flatten_tpl(tpl: ProfileParams) -> torch.Tensor:
    """[norm, amp_1..K, loc_1..K, wid_1..K, ampShift] flattened vector (D,),
    or (S, D) for per-row templates."""
    return torch.cat([tpl.norm[..., None], tpl.amp, tpl.loc, tpl.wid, tpl.amp_shift[..., None]], dim=-1)


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


def _error_scan(kind, tpl, x, mask, exposure, phi_best, ll_max, cfg: ToAFitConfig, warm_vec=None):
    """Likelihood-profile 1-sigma bounds: dense first window + chunked loop.

    The reported bound is (k*+1)*step + step/2 where k* is the first step
    whose LL drop exceeds the half-chi2 threshold; with no crossing within
    res/2 steps the bound saturates. Phase 1 evaluates both sides' first W
    steps in one sweep; phase 2, the fallback loop seeded at k0 = W, runs
    chunks of ``err_chunk`` steps only for the segments that have not
    crossed yet, so every segment's bounds equal a lone run's. ``warm_vec``
    (S, D) seeds the readvaryparam Nelder-Mead at each segment's optimum.

    Returns (err_lo, err_hi, loop_iters), each (S,).
    """
    S = x.shape[0]
    dev = x.device
    step = (2 * math.pi) / cfg.ph_shift_res
    max_k = cfg.ph_shift_res // 2
    chunk = cfg.err_chunk
    W = cfg.err_dense_window if cfg.err_dense_window >= 0 else DENSE_WINDOW_DEFAULT
    W = min(W, max_k)

    def scan_profile(rows, phis):
        warm = None if warm_vec is None else warm_vec[rows]
        ll, _ = profile_loglik(kind, template_rows(tpl, rows), x[rows], mask[rows], exposure[rows], phis,
                               cfg, warm)
        return ll

    all_rows = torch.arange(S, device=dev)
    if W > 0:
        ks_w = 1 + torch.arange(W, device=dev)
        phis_dense = torch.cat(
            [phi_best[:, None] - ks_w.to(_F64) * step, phi_best[:, None] + ks_w.to(_F64) * step], dim=1
        )
        dense_cross = (ll_max[:, None] - scan_profile(all_rows, phis_dense)) > CHI2_1SIG_HALF

        def seed(block):
            any_cross = torch.any(block, dim=-1)
            k_star = ks_w[_first_true(block)]
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
            drop = ll_max[rows, None] - scan_profile(rows, phis)
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


def fit_segment(kind: str, tpl: ProfileParams, x, mask, exposure, cfg: ToAFitConfig) -> dict:
    """Full ToA fit of S padded segments at once: x, mask (S, N), exposure
    (S,), tensors on one device (the JAX package's vmapped ``fit_segment``).
    ``tpl`` is one shared template, or one per row: leaves with a leading
    (S,) axis (``fit_toas_batch_multi``; not with ``cfg.free_idx``)."""
    if cfg.free_idx and tpl.norm.dim() > 0:
        raise ValueError("per-row templates take the fixed-shape fit (no cfg.free_idx)")
    half_range = _phase_range(kind)
    S = x.shape[0]
    dev = x.device

    # 1) coarse global brute grid, swept in chunks of brute_chunk phases
    brute_phis = torch.as_tensor(
        np.linspace(-half_range, half_range, cfg.n_brute), dtype=_F64, device=dev
    )
    chunk = max(1, min(cfg.brute_chunk, cfg.n_brute))
    pad = (-cfg.n_brute) % chunk
    phis_pad = torch.cat([brute_phis, brute_phis[-1:].expand(pad)]) if pad else brute_phis
    ll_brute = torch.cat([
        profile_loglik(kind, tpl, x, mask, exposure, p.expand(S, chunk), cfg)[0]
        for p in phis_pad.reshape(-1, chunk)
    ], dim=1)[:, : cfg.n_brute]
    i_best = torch.argmax(ll_brute, dim=1)
    phi0 = brute_phis[i_best]
    grid_step = 2 * half_range / (cfg.n_brute - 1)

    # 2) refine to the profile-likelihood optimum
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
            ll_r, _ = profile_loglik(kind, tpl, x, mask, exposure, phis_r, cfg)
            j = torch.argmax(ll_r, dim=1)
            phi_c = torch.gather(phis_r, 1, j[:, None])[:, 0]
            ll_max = torch.gather(ll_r, 1, j[:, None])[:, 0]
            half = 2.0 * half / (cfg.refine_grid - 1)
        phi_best = phi_c
    elif cfg.refine_mode == "golden":
        def ll_of(phi):
            return profile_loglik(kind, tpl, x, mask, exposure, phi[:, None], cfg)[0][:, 0]

        phi_best, ll_max = golden_section(
            ll_of, phi0 - grid_step, phi0 + grid_step, iters=cfg.refine_iters
        )
    else:
        raise ValueError(
            f"unknown refine_mode {cfg.refine_mode!r} (expected 'golden' or 'grid')"
        )

    # 3) nuisance parameters at the optimum; general mode also yields the
    #    full refit shape vector for the chi2 model
    if cfg.free_idx:
        _, vecs = _general_profile_vecs(kind, tpl, x, mask, exposure, phi_best[:, None], cfg)
        vec_best = vecs[:, 0]
        a_best, b_best = vec_best[:, 0], vec_best[:, 1 + 3 * tpl.n_comp]
    else:
        _, a_arr, b_arr = profile_loglik_full(kind, tpl, x, mask, exposure, phi_best[:, None], cfg)
        a_best, b_best = a_arr[:, 0], b_arr[:, 0]
        vec_best = _flatten_tpl(tpl).expand(S, -1).clone()
        vec_best[:, 0] = a_best
        vec_best[:, 1 + 3 * tpl.n_comp] = b_best

    # 4) likelihood-profile error bounds (general mode: each step's
    #    Nelder-Mead starts from the best-fit vector)
    warm = vec_best if cfg.free_idx else None
    err_lo, err_hi, scan_iters = _error_scan(kind, tpl, x, mask, exposure, phi_best, ll_max, cfg, warm)

    # 5) binned-profile goodness of fit (general mode: the model at the
    #    refit shape, ampShift folded into the template)
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
    x = torch.as_tensor(phases, dtype=_F64).to(dev)
    mask = torch.as_tensor(masks, dtype=torch.bool).to(dev)
    exposure = torch.as_tensor(exposures, dtype=_F64).to(dev)
    with torch.no_grad():
        return fit_segment(kind, tpl.to(dev), x, mask, exposure, cfg)


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
    out = {k: np.concatenate([p[k].cpu().numpy() for p in parts])[:n_seg] for k in parts[0]}
    costmodel.capture("toa_fit_batch", None, kind, tpl, phases, masks, exposures, cfg,
                      out=list(out.values()), plan=registry.specs_for("segment_batch", mesh))
    return out


def slice_sorted_intervals(times, starts, ends, assume_sorted: bool = False) -> list[np.ndarray]:
    """Per-interval event segments of ``times`` over inclusive [start, end]
    windows (host helper): binary-search slices on sorted input, boolean
    masks otherwise."""
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
