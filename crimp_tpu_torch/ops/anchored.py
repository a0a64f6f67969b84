"""Anchored (precision-split) phase folding.

Port of ``crimp_tpu/ops/anchored.py``. The ToA budget is <1 us ~ 1.4e-7
cycles while the absolute model phase reaches ~2.7e6 cycles, so folding
absolute phases in f64 leaves no margin. The split:

 host (numpy longdouble, exact):
   - one anchor time t_ref per ToA interval,
   - frac(phi_ref) at each anchor, minus the glitch/wave values there,
   - re-centered Taylor coefficients b_m (binomial re-expansion),
   - event times as seconds relative to their anchor (exact in f64),
   - per-anchor glitch/wave epoch offsets in seconds.

 device (torch f64, all quantities small):
   folded = frac( const[a] + Horner_b(d) + G(d; a) + W(d; a) )

``fold_segments`` takes the delta-fold engine (``ops/deltafold.py``) with
``delta_fold=1`` (None: CRIMP_TORCH_DELTA_FOLD, else 0, the JAX default, the
exact branch). ``pad_anchored`` pads a model with inert rows, so models of
ragged anchor, glitch and wave counts stack over a source axis
(``ops/multisource.py``).
``fold_chunked`` folds an arbitrary MJD array through per-chunk anchors
(the template pipeline, ``fold_phases``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, fields
from math import comb, factorial

import numpy as np
import torch

from crimp_tpu_torch import obs
from crimp_tpu_torch.obs import costmodel
from crimp_tpu_torch.models import timing
from crimp_tpu_torch.models.timing import N_FREQ_TERMS, TimingParams
from crimp_tpu_torch.utils.device import resolve_device

SECONDS_PER_DAY = 86400.0


@dataclass(frozen=True)
class AnchoredModel:
    """Host-prepared anchored timing model (A anchors), float64 tensors."""

    const: torch.Tensor  # (A,) frac(phi_ref) - G(t_ref) - W(t_ref)
    taylor: torch.Tensor  # (A, 13) local Taylor coeffs b_m (cycles / s^m)
    glep_off: torch.Tensor  # (A, G) (t_ref - GLEP) in seconds
    glph: torch.Tensor  # (G,)
    glf0: torch.Tensor  # (G,)
    glf1: torch.Tensor  # (G,)
    glf2: torch.Tensor  # (G,)
    glf0d: torch.Tensor  # (G,)
    gltd_sec: torch.Tensor  # (G,) recovery timescale in seconds (1 s padding)
    wep_off: torch.Tensor  # (A,) (t_ref - WAVEEPOCH) in seconds
    wave_om_sec: torch.Tensor  # scalar, wave fundamental in rad/s
    wave_a: torch.Tensor  # (W,)
    wave_b: torch.Tensor  # (W,)
    f0: torch.Tensor  # scalar (waves are seconds-residuals scaled by F0)

    def to(self, device) -> "AnchoredModel":
        return AnchoredModel(**{f.name: getattr(self, f.name).to(device) for f in fields(self)})


# ---------------------------------------------------------------------------
# Host side (exact)
# ---------------------------------------------------------------------------


def _host_taylor_phase(tm: TimingParams, t_mjd: np.ndarray) -> np.ndarray:
    """Taylor phase at t_mjd in longdouble (host, exact)."""
    ld = np.longdouble
    dt = (np.asarray(t_mjd, dtype=ld) - ld(float(tm.pepoch))) * ld(SECONDS_PER_DAY)
    f = tm.numpy("f")
    acc = np.zeros_like(dt)
    for n in range(N_FREQ_TERMS, 0, -1):
        acc = acc + ld(f[n - 1]) / ld(factorial(n)) * dt**n
    return acc


def _host_glitch_phase(tm: TimingParams, t_mjd: np.ndarray) -> np.ndarray:
    """Glitch phase at t_mjd in f64 (host; magnitudes are small)."""
    t = np.asarray(t_mjd, dtype=np.float64)
    total = np.zeros_like(t)
    glep = tm.numpy("glep")
    for g in range(tm.n_glitch):
        if not np.isfinite(glep[g]):
            continue
        after = t >= glep[g]
        dt_days = np.where(after, t - glep[g], 0.0)
        dt_sec = dt_days * SECONDS_PER_DAY
        gltd = float(tm.gltd[g])
        recovery = (
            0.0
            if gltd == 0.0
            else gltd * SECONDS_PER_DAY * (1.0 - np.exp(-dt_days / gltd))
        )
        contrib = (
            float(tm.glph[g])
            + float(tm.glf0[g]) * dt_sec
            + 0.5 * float(tm.glf1[g]) * dt_sec**2
            + (1.0 / 6.0) * float(tm.glf2[g]) * dt_sec**3
            + float(tm.glf0d[g]) * recovery
        )
        total += np.where(after, contrib, 0.0)
    return total


def _host_wave_phase(tm: TimingParams, t_mjd: np.ndarray) -> np.ndarray:
    t = np.asarray(t_mjd, dtype=np.float64)
    total = np.zeros_like(t)
    if tm.n_wave:
        base = t - float(tm.wave_epoch)
        om = float(tm.wave_om)
        a = tm.numpy("wave_a")
        b = tm.numpy("wave_b")
        for k in range(1, tm.n_wave + 1):
            arg = k * om * base
            total += a[k - 1] * np.sin(arg) + b[k - 1] * np.cos(arg)
    return total * float(tm.f[0])


def host_total_phase(timMod, t_mjd) -> np.ndarray:
    """Exact (longdouble Taylor) total model phase on host, as longdouble."""
    tm = timing.resolve(timMod)
    t = np.atleast_1d(np.asarray(t_mjd, dtype=np.float64))
    return (
        _host_taylor_phase(tm, t)
        + _host_glitch_phase(tm, t).astype(np.longdouble)
        + _host_wave_phase(tm, t).astype(np.longdouble)
    )


def _local_taylor_coeffs(tm: TimingParams, t_ref_mjd: np.ndarray) -> np.ndarray:
    """Re-centered Taylor coefficients b_m (A, 13), longdouble -> f64.

    phi_T(t_ref + d) - phi_T(t_ref) = sum_{m=1..13} b_m d^m with
    b_m = sum_{n>=m} C(n, m) c_n dt_ref^(n-m), c_n = F_{n-1}/n! per s^n.
    """
    ld = np.longdouble
    f = tm.numpy("f")
    c = np.array([ld(f[n - 1]) / ld(factorial(n)) for n in range(1, N_FREQ_TERMS + 1)])
    dt_ref = (np.asarray(t_ref_mjd, dtype=ld) - ld(float(tm.pepoch))) * ld(SECONDS_PER_DAY)
    A = dt_ref.shape[0]
    b = np.zeros((A, N_FREQ_TERMS), dtype=ld)
    for m in range(1, N_FREQ_TERMS + 1):
        acc = np.zeros(A, dtype=ld)
        for n in range(N_FREQ_TERMS, m - 1, -1):
            acc = acc * dt_ref + ld(comb(n, m)) * c[n - 1]
        b[:, m - 1] = acc
    return b.astype(np.float64)


def prepare_anchors(timMod, t_ref_mjd) -> AnchoredModel:
    """Build the AnchoredModel (CPU tensors) for anchor times t_ref (MJD)."""
    tm = timing.resolve(timMod)
    t_ref = np.atleast_1d(np.asarray(t_ref_mjd, dtype=np.float64))

    phi_ref = host_total_phase(tm, t_ref)
    frac_ref = (phi_ref - np.floor(phi_ref)).astype(np.float64)
    const = frac_ref - _host_glitch_phase(tm, t_ref) - _host_wave_phase(tm, t_ref)

    glep = tm.numpy("glep")
    gltd = tm.numpy("gltd")
    # Padded glitches (GLEP=+inf) get a -inf offset => never active on device.
    glep_off = np.where(
        np.isfinite(glep)[None, :],
        (t_ref[:, None] - glep[None, :]) * SECONDS_PER_DAY,
        -np.inf,
    )
    gltd_sec = np.where(gltd == 0.0, 1.0, gltd * SECONDS_PER_DAY)
    gltd_zero = gltd == 0.0

    t64 = lambda x: torch.as_tensor(np.asarray(x, dtype=np.float64))
    return AnchoredModel(
        const=t64(const),
        taylor=t64(_local_taylor_coeffs(tm, t_ref)),
        glep_off=t64(glep_off),
        glph=t64(tm.numpy("glph")),
        glf0=t64(tm.numpy("glf0")),
        glf1=t64(tm.numpy("glf1")),
        glf2=t64(tm.numpy("glf2")),
        glf0d=t64(np.where(gltd_zero, 0.0, tm.numpy("glf0d"))),
        gltd_sec=t64(gltd_sec),
        wep_off=t64((t_ref - float(tm.wave_epoch)) * SECONDS_PER_DAY),
        wave_om_sec=t64(float(tm.wave_om) / SECONDS_PER_DAY),
        wave_a=t64(tm.numpy("wave_a")),
        wave_b=t64(tm.numpy("wave_b")),
        f0=t64(float(tm.f[0])),
    )


def pad_anchored(am: AnchoredModel, n_anchor: int, n_glitch: int, n_wave: int) -> AnchoredModel:
    """Pad an AnchoredModel to (A, G, W) = (n_anchor, n_glitch, n_wave)
    with INERT rows, the conventions ``prepare_anchors`` already uses for
    absent terms, so padded entries add exactly +0.0 on the device: extra
    glitch columns get glep_off = -inf (never active) with gltd_sec = 1 (no
    division by zero in the recovery term), extra wave harmonics zero
    amplitudes, extra anchors zero const/taylor rows (gathered only by
    padded events, whose results are discarded). Shrinking raises."""
    A, G = am.glep_off.shape
    W = am.wave_a.shape[0]
    if n_anchor < A or n_glitch < G or n_wave < W:
        raise ValueError(f"pad_anchored cannot shrink ({A},{G},{W}) -> ({n_anchor},{n_glitch},{n_wave})")

    def pad1(x, n, fill=0.0):
        return torch.cat([x, torch.full((n - x.shape[0],), fill, dtype=x.dtype, device=x.device)])

    glep_off = torch.full((n_anchor, n_glitch), -math.inf, dtype=am.glep_off.dtype, device=am.glep_off.device)
    glep_off[:A, :G] = am.glep_off
    taylor = torch.zeros((n_anchor, am.taylor.shape[1]), dtype=am.taylor.dtype, device=am.taylor.device)
    taylor[:A] = am.taylor
    return AnchoredModel(
        const=pad1(am.const, n_anchor),
        taylor=taylor,
        glep_off=glep_off,
        glph=pad1(am.glph, n_glitch),
        glf0=pad1(am.glf0, n_glitch),
        glf1=pad1(am.glf1, n_glitch),
        glf2=pad1(am.glf2, n_glitch),
        glf0d=pad1(am.glf0d, n_glitch),
        gltd_sec=pad1(am.gltd_sec, n_glitch, fill=1.0),
        wep_off=pad1(am.wep_off, n_anchor),
        wave_om_sec=am.wave_om_sec,
        wave_a=pad1(am.wave_a, n_wave),
        wave_b=pad1(am.wave_b, n_wave),
        f0=am.f0,
    )


def anchor_deltas(times_mjd: np.ndarray, t_ref_mjd: np.ndarray, anchor_idx: np.ndarray) -> np.ndarray:
    """Event times as exact seconds relative to their anchor (host f64)."""
    return (
        np.asarray(times_mjd, dtype=np.float64) - np.asarray(t_ref_mjd)[anchor_idx]
    ) * SECONDS_PER_DAY


# ---------------------------------------------------------------------------
# Device side
# ---------------------------------------------------------------------------


def _device_glitch(am: AnchoredModel, delta: torch.Tensor, anchor_idx: torch.Tensor) -> torch.Tensor:
    """Summed glitch phase at anchored offsets (per event)."""
    total = torch.zeros_like(delta)
    for g in range(am.glph.shape[0]):
        dt = delta + am.glep_off[:, g][anchor_idx]
        after = dt >= 0.0
        dt = torch.where(after, dt, 0.0)
        recovery = am.gltd_sec[g] * (1.0 - torch.exp(-dt / am.gltd_sec[g]))
        contrib = (
            am.glph[g] + am.glf0[g] * dt + 0.5 * am.glf1[g] * dt**2
            + (1.0 / 6.0) * am.glf2[g] * dt**3 + am.glf0d[g] * recovery
        )
        total = total + torch.where(after, contrib, 0.0)
    return total


def _device_wave(am: AnchoredModel, delta: torch.Tensor, anchor_idx: torch.Tensor) -> torch.Tensor:
    n_wave = am.wave_a.shape[0]
    total = torch.zeros_like(delta)
    if n_wave == 0:
        return total
    base = (delta + am.wep_off[anchor_idx]) * am.wave_om_sec
    for k in range(1, n_wave + 1):
        arg = float(k) * base
        total = total + am.wave_a[k - 1] * torch.sin(arg) + am.wave_b[k - 1] * torch.cos(arg)
    return total * am.f0


def anchored_fold(am: AnchoredModel, delta: torch.Tensor, anchor_idx: torch.Tensor) -> torch.Tensor:
    """Cycle-folded phases in [0,1) for events at anchored second offsets
    (all tensors on one device; f64)."""
    coeffs = am.taylor[anchor_idx]  # (N, 13)
    acc = torch.zeros_like(delta)
    for m in range(N_FREQ_TERMS - 1, -1, -1):
        acc = acc * delta + coeffs[:, m]
    local = acc * delta
    phase = (
        am.const[anchor_idx]
        + local
        + _device_glitch(am, delta, anchor_idx)
        + _device_wave(am, delta, anchor_idx)
    )
    return phase - torch.floor(phase)


# ---------------------------------------------------------------------------
# Batched host wrapper
# ---------------------------------------------------------------------------


def fold_segments(timMod, seg_times, t_ref_mjd=None, device=None, delta_fold: int | None = None,
                  budget: float | None = None, fold_cache=None, cache_tag: str | None = None):
    """Anchored fold of ragged per-segment event times in ONE device call.

    One anchor per segment (default: each segment's midpoint
    t0 + (t_end - t0)/2, the reference's ToA epoch), events concatenated
    with a per-event anchor index. Returns (seg_phase_list, t_ref): numpy
    cycle-folded [0,1) phases split back per segment, plus the anchors.

    ``delta_fold=1`` routes the fold through the delta-fold engine
    (``ops/deltafold.py``: the fold cache ``fold_cache``, namespaced by
    ``cache_tag``, and K4 refolds for linear updates within ``budget``
    cycles); None reads CRIMP_TORCH_DELTA_FOLD and
    CRIMP_TORCH_DELTA_FOLD_BUDGET (``deltafold.resolve_delta_fold``). Off,
    the engine is never consulted.
    """
    seg_times = [np.atleast_1d(np.asarray(t, dtype=np.float64)) for t in seg_times]
    if t_ref_mjd is None:
        t_ref = np.asarray(
            [(t[-1] - t[0]) / 2 + t[0] if t.size else 0.0 for t in seg_times]
        )
    else:
        t_ref = np.atleast_1d(np.asarray(t_ref_mjd, dtype=np.float64))
    if not seg_times:
        return [], t_ref
    dev = resolve_device(device)
    tm = timing.resolve(timMod)
    sizes = [t.size for t in seg_times]
    anchor_idx = np.repeat(np.arange(len(seg_times)), sizes)
    times_cat = np.concatenate(seg_times)
    obs.counter_add("events_folded", int(times_cat.size))
    obs.counter_add("fold_segments", len(seg_times))
    delta = anchor_deltas(times_cat, t_ref, anchor_idx)

    def exact():
        am = prepare_anchors(tm, t_ref).to(dev)
        delta_dev = torch.as_tensor(delta, device=dev)
        idx_dev = torch.as_tensor(anchor_idx, device=dev)
        with costmodel.kernel_span("anchored_fold"):
            out = anchored_fold(am, delta_dev, idx_dev)
        costmodel.capture("anchored_fold", None, am, delta_dev, idx_dev, out=out)
        return out.cpu().numpy()

    from crimp_tpu_torch.ops import deltafold

    delta_fold, budget = deltafold.resolve_delta_fold(delta_fold, budget, n_events=int(times_cat.size), device=dev)
    if delta_fold:
        folded, _ = deltafold.cached_fold(tm, times_cat, sizes, t_ref, delta, anchor_idx, exact,
                                          budget=budget, tag=cache_tag, fold_cache=fold_cache,
                                          device=dev)
    else:
        folded = exact()
    return list(np.split(folded, np.cumsum(sizes)[:-1])), t_ref


def fold_chunked(times_mjd, timMod, chunk_days: float = 30.0, device=None):
    """Fold an arbitrary MJD array via per-chunk anchors (host orchestration).

    Splits the time span into <= chunk_days chunks, anchors each at its
    midpoint, and runs the anchored fold on ``device`` (default cuda).
    Returns cycle-folded phases in [0,1) with the input's ordering.
    """
    tm = timing.resolve(timMod)
    t = np.atleast_1d(np.asarray(times_mjd, dtype=np.float64))
    if t.size == 0:
        return np.zeros(0)
    dev = resolve_device(device)
    lo = t.min()
    idx = np.minimum(
        ((t - lo) / chunk_days).astype(np.int64),
        max(int(np.ceil((t.max() - lo) / chunk_days)) - 1, 0),
    )
    # Anchor at each chunk's midpoint (any in-chunk point works).
    n_chunks = int(idx.max()) + 1
    t_ref = lo + (np.arange(n_chunks) + 0.5) * chunk_days
    am = prepare_anchors(tm, t_ref).to(dev)
    delta = anchor_deltas(t, t_ref, idx)
    folded = anchored_fold(
        am, torch.as_tensor(delta, device=dev), torch.as_tensor(idx, device=dev)
    ).cpu().numpy()
    return folded.reshape(np.shape(times_mjd))
