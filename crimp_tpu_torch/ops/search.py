"""Periodicity searches: Z^2_n, H-test, the (nu, nudot) grid and the
(nu, nudot, nuddot) cube.

Port of ``crimp_tpu/ops/search.py``. Statistic parity with the reference
(periodsearch.py:57-125):

  Z^2_n(f)  = (2/N) * sum_{k=1..n} [ (sum_i cos k*theta_i)^2 + (sum_i sin k*theta_i)^2 ]
  H(f)      = max_m ( cumsum_m Z^2 terms - 4*(m-1) )
  cube      : theta_i = 2*pi*(f*t_i + 0.5*fdot*t_i^2 + fddot/6*t_i^3), times
              centered by the caller; PeriodSearch centers on
              t0 = (t[0]+t[-1])/2 and takes the nudot axis as log10
              magnitudes applied as -10^x (spin-down only), the nuddot axis
              signed.

Three engines, as in the JAX package:

- **Uniform grids** (f0 + j*df) run through K2, the Z^2 tile kernel
  (``ops/z2_grid.py``): f64-reduced rows per tile, fdot and fddot, f32 trig
  (polynomial by default, ``poly=False`` for f32 sin/cos), Chebyshev
  harmonics, up to 20 harmonics, optional per-event weights.
- **Any grid, any nharm** runs through K3, the general exact-phase kernel
  (``ops/z2_general.py``): the f64 phase per pair, reduced once, f32 (or
  f64) trig. ``PeriodSearch`` falls through to it for non-uniform grids,
  nharm > 20 and ``use_grid_fastpath=False``.
- **Factorized uniform grids** (``mxu=True``, default off): the affine phase
  in the trial index factors by angle addition into per-row trig and a
  per-trial sweep, and the event reduction becomes f32 matrix products
  (``torch.matmul``, full f32 precision pinned; ``mxu_bf16`` rounds the
  operands to bf16 and keeps an f32 result).

The streamed wrappers copy events to the card in chunks from pinned host
memory on a side stream, overlapped with the previous chunk's kernel, and
are bitwise the monolithic result at the same split length.

``h_power_segments`` (the per-ToA H-test) is plain torch: the phase f*t in
f64, reduced mod 1, then hardware f32 sin/cos and the Chebyshev recurrence.
On the CPU every kernel wrapper takes its plain twin.
"""

from __future__ import annotations

import contextlib
import math
import threading

import numpy as np
import torch

from crimp_tpu_torch import knobs, obs, resilience
from crimp_tpu_torch.obs import costmodel
from crimp_tpu_torch.obs import names as spans
from crimp_tpu_torch.ops import autotune, fasttrig, reduce, z2_general, z2_grid
from crimp_tpu_torch.resilience import faultinject
from crimp_tpu_torch.utils import profiling
from crimp_tpu_torch.utils.device import resolve_device

# The f32 inner sweep's error grows ~linearly in harmonic number; 20 is
# the conventional H-test maximum and the JAX fast-path limit.
GRID_FASTPATH_MAX_NHARM = 20
# Factorized sweep: exact sin/cos reseed every 64 trials, the JAX default
# (crimp_tpu/ops/autotune.py GRID_MXU_RESEED_DEFAULT). With the polynomial
# pair the rotation multiplier's |cos^2+sin^2| error is a smooth function of
# b, so the sweep's amplitude drifts coherently with the stride: at high
# signal-to-noise a stride of 64 moves the statistic several times the exact
# grid's own f32 error, while 16 reaches the floor that shorter strides and
# hardware trig share (tests/test_torch_mxu.py pins both). 16 is an option,
# through ``reseed=``, never the default.
GRID_MXU_RESEED = 64
MXU_EVENT_BLOCK = 1 << 15  # factorized path: events per f32 matmul block
MXU_TRIAL_BLOCK = 256  # factorized path: trials per sweep matrix
STREAM_EVENT_CHUNK = 1 << 21  # events per streamed host->device chunk
STREAM_MIN_EVENTS_DEFAULT = 1 << 22
# Below this many (trial, event) pairs the shards' launches and the ordered
# reduce of a sharded dispatch outweigh the parallel win (PeriodSearch._mesh);
# JAX's threshold.
MIN_SHARD_PAIRS = 1 << 22
# The JAX package's default (event_block, trial_block) tiling. The port's
# kernels fix their tiles at compile time and plan the event split length
# per problem (``autotune.static_defaults``), so the pair reads as (a split
# length, K2's trial tile).
DEFAULT_EVENT_BLOCK = 1 << 16
DEFAULT_TRIAL_BLOCK = 256  # z2_grid.TRIAL_TILE (z2_grid imports this module, so not read from it here)
_FROM_ENV = object()


def resolve_blocks(kernel: str, n_events: int, n_trials: int, poly: bool = False,
                   event_block: int | None = None, trial_block: int | None = None,
                   device=None) -> tuple[int, int]:
    """(event_block, trial_block) through the autotuner: a thin delegate to
    ``autotune.resolve_blocks``, the JAX package's ``search.resolve_blocks``.
    Explicit arguments > CRIMP_TORCH_GRID_BLOCKS (grid kernels) > a cached
    verdict of ``device`` > the static plan."""
    return autotune.resolve_blocks(kernel, n_events, n_trials, poly=poly, event_block=event_block,
                                   trial_block=trial_block, device=device)


def grid_fastpath_enabled(nharm: int, override: bool | None = None) -> bool:
    """Whether the uniform-grid f32 fast path is used: the explicit
    ``override``, else CRIMP_TORCH_GRID_FASTPATH ("0"/"off" disables,
    "1"/"on" forces), else nharm <= 20."""
    if override is not None:
        return bool(override)
    state = knobs.parse_onoff(knobs.raw("CRIMP_TORCH_GRID_FASTPATH"))
    if state is not None:
        return state
    return nharm <= GRID_FASTPATH_MAX_NHARM


def stream_min_events(threshold=_FROM_ENV) -> int | None:
    """Event count above which a caller should stream: ``threshold`` when
    given (an int; None, 0 or "off" disable streaming), else
    CRIMP_TORCH_STREAM_MIN_EVENTS, else 2^22 as in the JAX package."""
    if threshold is _FROM_ENV:
        threshold = knobs.raw("CRIMP_TORCH_STREAM_MIN_EVENTS") or STREAM_MIN_EVENTS_DEFAULT
    if threshold is None or str(threshold).strip().lower() in knobs.OFF_WORDS | {"no"}:
        return None
    try:
        value = int(threshold)
    except ValueError:
        raise ValueError(f"stream_min_events={threshold!r} not recognized; expected an "
                         "integer event count or 0/off") from None
    if value < 0:
        raise ValueError(f"stream_min_events must be >= 0, got {value}")
    return value


def resolve_grid_mxu(mxu: bool | None = None, reseed: int | None = None, mxu_bf16: bool | None = None,
                     n_events: int = 1, n_trials: int = 1, poly: bool | None = None,
                     cube: bool = False, device=None) -> tuple[bool, int, bool]:
    """(use_mxu, reseed, mxu_bf16) for the grid wrappers: explicit arguments
    are hard overrides; anything left None resolves through
    ``autotune.resolve_grid_mxu`` (``resolve_grid3d_mxu`` for the ``cube``):
    CRIMP_TORCH_GRID_MXU / CRIMP_TORCH_MXU_BF16 > a cached A/B verdict for
    (n_events, n_trials, poly) on ``device`` > off, reseed GRID_MXU_RESEED.
    ``poly=None`` resolves through ``fasttrig.poly_trig_enabled`` on
    ``device``."""
    if mxu is not None and reseed is not None and mxu_bf16 is not None:
        return bool(mxu), int(reseed), bool(mxu_bf16)
    poly = fasttrig.poly_trig_enabled(poly, device)
    r = (autotune.resolve_grid3d_mxu if cube else autotune.resolve_grid_mxu)(n_events, n_trials, poly=poly,
                                                                             device=device)
    return (bool(r["grid_mxu"]) if mxu is None else bool(mxu),
            int(r["reseed"]) if reseed is None else int(reseed),
            bool(r["mxu_bf16"]) if mxu_bf16 is None else bool(mxu_bf16))


def chebyshev_weighted_sums(cos1, sin1, weights, nharm: int):
    """Weighted per-harmonic trig sums (nharm, ...) in the input dtype.

    Harmonic k comes from the Chebyshev recurrence cos(k t) = 2 cos t
    cos((k-1) t) - cos((k-2) t) (and its sine twin), so only the k=1
    sin/cos pair is ever evaluated; summation is over the trailing axis
    (``reduce.event_sum``).
    """
    rsum = reduce.event_sum
    cos_km1, sin_km1 = cos1, sin1
    cos_km2 = torch.ones_like(cos1)
    sin_km2 = torch.zeros_like(sin1)
    c_list = [rsum(weights * cos1)]
    s_list = [rsum(weights * sin1)]
    for _ in range(1, nharm):
        cos_k = 2 * cos1 * cos_km1 - cos_km2
        sin_k = 2 * cos1 * sin_km1 - sin_km2
        c_list.append(rsum(weights * cos_k))
        s_list.append(rsum(weights * sin_k))
        cos_km2, sin_km2 = cos_km1, sin_km1
        cos_km1, sin_km1 = cos_k, sin_k
    return torch.stack(c_list), torch.stack(s_list)


def _trig_rows(frac: torch.Tensor, poly: bool):
    """(cos, sin) of 2*pi*frac for frac already in [-0.5, 0.5)."""
    if poly:
        s, c = fasttrig.sincos_cycles(frac)
        return c, s
    theta = (2 * math.pi) * frac
    return torch.cos(theta), torch.sin(theta)


def _harmonic_sums_cycles(phase_cycles, weights, nharm: int, poly: bool = False):
    """(C_k, S_k) for k=1..nharm where C_k = sum_i w_i cos(2 pi k phi_i).

    ``phase_cycles``: (..., B) model phase in cycles (f64); the fractional
    part is taken in f64, then f32 sin/cos (hardware, or the polynomial
    with ``poly``) and the per-row sums run in f32. Returns f64 tensors of
    shape (nharm, ...).
    """
    cos1, sin1 = _trig_rows(fasttrig.centered_frac(phase_cycles).to(torch.float32), poly)
    c_sums, s_sums = chebyshev_weighted_sums(cos1, sin1, weights.to(torch.float32), nharm)
    return c_sums.to(torch.float64), s_sums.to(torch.float64)


def z2_from_sums(c_sum, s_sum, n_events):
    """Z^2 per harmonic from trig sums: (nharm, ...) -> (nharm, ...)."""
    return (c_sum**2 + s_sum**2) * (2.0 / n_events)


def h_from_sums(c_sum, s_sum, n_events, dim: int):
    """H-test from trig sums whose harmonic axis is ``dim``."""
    z2_cum = torch.cumsum(z2_from_sums(c_sum, s_sum, n_events), dim=dim)
    shape = [1] * z2_cum.dim()
    shape[dim] = z2_cum.shape[dim]
    penalties = 4.0 * torch.arange(z2_cum.shape[dim], dtype=torch.float64,
                                   device=z2_cum.device).reshape(shape)
    return torch.amax(z2_cum - penalties, dim=dim)


def uniform_grid(freqs: np.ndarray, rtol: float = 1e-12):
    """(f0, df) if ``freqs`` is a uniform grid, else None (host helper)."""
    f = np.asarray(freqs, dtype=np.float64)
    if f.ndim != 1 or f.size < 3:
        return None
    df = (f[-1] - f[0]) / (f.size - 1)
    if df == 0:
        return None
    recon = f[0] + df * np.arange(f.size)
    scale = max(abs(f[0]), abs(f[-1]))
    if np.max(np.abs(recon - f)) > rtol * scale:
        return None
    return float(f[0]), float(df)


def as_f64(x, dev: torch.device) -> torch.Tensor:
    """A contiguous 1-D f64 tensor of ``x`` (numpy, list or tensor) on ``dev``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=torch.float64).reshape(-1).contiguous()
    return torch.as_tensor(np.asarray(x, dtype=np.float64).reshape(-1)).to(dev)


def as_weights(weights, dev: torch.device):
    if weights is None:
        return None
    if isinstance(weights, torch.Tensor):
        return weights.to(device=dev, dtype=torch.float32).reshape(-1).contiguous()
    return torch.as_tensor(np.asarray(weights, dtype=np.float32).reshape(-1)).to(dev)


# a card's row coefficients by their values: the kernels only read them, and
# a repeated grid skips the host-to-card copy before its launch
_ROWS: dict = {}
_ROWS_KEEP = 64
_ROWS_LOCK = threading.Lock()


def row_coeffs(fdots, fddots, dev: torch.device):
    """(0.5*fdot, fdd/6 or None) in f64, as the JAX kernels form them; on a
    card the same values give the same (read-only) tensors."""
    half = 0.5 * np.asarray(fdots, dtype=np.float64).reshape(-1)
    sixth = None if fddots is None else np.asarray(fddots, dtype=np.float64).reshape(-1) / 6.0
    dev = torch.device(dev)
    if dev.type != "cuda":
        return as_f64(half, dev), None if sixth is None else as_f64(sixth, dev)
    key = (str(dev), half.tobytes(), None if sixth is None else sixth.tobytes())
    with _ROWS_LOCK:
        hit = _ROWS.get(key)
    if hit is None:
        hit = (as_f64(half, dev), None if sixth is None else as_f64(sixth, dev))
        with _ROWS_LOCK:
            if len(_ROWS) >= _ROWS_KEEP:
                _ROWS.clear()
            _ROWS[key] = hit
    return hit


# ---------------------------------------------------------------------------
# Uniform grids on K2
# ---------------------------------------------------------------------------


def tiles_to_freqs(cs: torch.Tensor, n_freq: int) -> torch.Tensor:
    """K2's (2, [n_fddot,] n_fdot, n_tiles, nharm, T) f32 sums ->
    (2, n_fddot, n_fdot, nharm, n_freq) f64."""
    if cs.dim() == 5:
        cs = cs.unsqueeze(1)
    two, n_l, n_f, n_tiles, nharm, tile = cs.shape
    cs = cs.to(torch.float64).permute(0, 1, 2, 4, 3, 5)
    return cs.reshape(two, n_l, n_f, nharm, n_tiles * tile)[..., :n_freq]


def _k2_grid_sums(t, f0: float, df: float, n_freq: int, fdots, fddots, nharm: int, poly: bool,
                  weights=None, per_split: int | None = None, tile0: int = 0,
                  site: str = "grid_sums", plan: str = "grid") -> torch.Tensor:
    """(2, n_fddot, n_fdot, nharm, n_freq) f64 sums through K2; ``fddots``
    None runs the 2-D instantiation (one fddot row of the output). The
    launch plan (``per_split``) resolves through ``autotune.resolve_blocks``
    under the family ``plan`` when not given; ``tile0`` offsets the grid by
    whole trial tiles. The launch and the copy of its tiles into the f64
    frequency layout are the kernel span of cost row ``site``."""
    with obs.profiler_range(spans.SCAN_PLAN):
        half, sixth = row_coeffs(fdots, fddots, t.device)
        n_rows = half.shape[0] * (1 if sixth is None else sixth.shape[0])
        n_tiles = -(-int(n_freq) // z2_grid.TRIAL_TILE)
        if per_split is None:
            per_split, _ = autotune.resolve_blocks(plan, t.shape[0], int(n_freq) * n_rows, poly,
                                                   n_rows=n_rows, nharm=nharm, device=t.device)
        w = as_weights(weights, t.device)
    with costmodel.kernel_span(site):
        cs = z2_grid.z2_tile_sums(t, f0, df, half, n_tiles, nharm, sixth_fddots=sixth, weights=w,
                                  poly=poly, per_split=per_split, tile0=tile0)
        # the copy out of the tiles ends the span's device work
        with profiling.launch_window(t.device) if t.device.type == "cuda" else contextlib.nullcontext():
            sums = tiles_to_freqs(cs, n_freq)
    costmodel.capture(site, z2_grid.z2_tile_sums, t, f0, df, half, n_tiles, nharm, sixth_fddots=sixth,
                      weights=w, poly=poly, per_split=per_split, tile0=tile0, out=cs,
                      counts=lambda: costmodel.k2_counts(t.shape[0], int(n_freq), n_rows, nharm, cs, weights=w))
    return sums


def _grid3d_sums_dispatch(times, f0: float, df: float, n_freq: int, fdots, fddots, nharm: int,
                          poly: bool | None = None, mxu: bool | None = None, reseed: int | None = None,
                          mxu_bf16: bool | None = None, weights=None,
                          per_split: int | None = None, tile0: int = 0, device=None,
                          ladder: bool = True, plan: str | None = None, mxu_blocks=None):
    """(c, s, n_events) for the uniform-grid wrappers, c and s of shape
    (n_fddot, n_fdot, nharm, n_freq) f64 (n_fddot = 1 when ``fddots`` is
    None: the 2-D K2 instantiation). ``poly`` None resolves through
    ``fasttrig.poly_trig_enabled`` on the call's device. ``mxu`` picks the
    factorized matmul path (explicit > CRIMP_TORCH_GRID_MXU > a cached verdict > off;
    ``resolve_grid_mxu``). ``per_split`` pins K2's launch plan (None:
    ``autotune.resolve_blocks`` under ``plan``, by default "grid3d" for a
    cube and "grid" otherwise); ``tile0`` computes the trial tiles
    [tile0, tile0 + ceil(n_freq / tile)) of the grid that starts at ``f0``,
    the same bits as those tiles of one call over the whole grid;
    ``mxu_blocks`` pins the factorized path's (event_block, trial_block).

    With ``ladder`` (the 1-D and cube wrappers, as in the JAX package; its
    2-D wrappers have none) this is the grid resilience ladder: a failed
    factorized rung drops to the streamed K2 grid, then to the in-core K2
    grid, each step recorded (``degraded_grid_*``). ``weights`` skip the
    streamed rung, which carries no weights. A ``KernelError`` is never
    taken down the ladder: it propagates."""
    if nharm < 1:
        raise ValueError(f"nharm must be >= 1, got {nharm}")
    with obs.profiler_range(spans.SCAN_TO_CARD):
        t = as_f64(times, resolve_device(device))
    with obs.profiler_range(spans.SCAN_PLAN):
        poly = fasttrig.poly_trig_enabled(poly, t.device)
        n_rows = len(np.atleast_1d(fdots)) * (1 if fddots is None else len(np.atleast_1d(fddots)))
        cube = fddots is not None
        use_mxu, rs, b16 = resolve_grid_mxu(mxu, reseed, mxu_bf16, t.shape[0],
                                            int(n_freq) * (n_rows if cube else 1), poly, cube, device=t.device)
        site = "grid_sums_3d" if cube else ("grid_sums" if ladder else "grid_sums_2d")
        obs.counter_add("grid_trials", int(n_freq) * n_rows)
    if use_mxu:
        try:
            if ladder:
                faultinject.fire("harmonic_sums")
            # one exact-sincos reseed row per `rs` trials per grid row
            obs.counter_add("grid_mxu_reseeds", -(-int(n_freq) // max(1, rs)) * n_rows)
            eb, tb = mxu_blocks or autotune.resolve_blocks("grid_mxu", t.shape[0], int(n_freq) * n_rows, poly,
                                                           device=t.device)
            with costmodel.kernel_span(site + "_mxu"):
                c, s = _mxu_grid_sums(t, weights, f0, df, n_freq, fdots, fddots, nharm, poly, rs, b16,
                                      eb, tb, tile0)
            costmodel.capture(site + "_mxu", _mxu_grid_sums, t, weights, f0, df, n_freq, fdots, fddots,
                              nharm, poly, rs, b16, eb, tb, tile0, out=(c, s))
            return c, s, t.shape[0]
        except resilience.KernelError:
            raise
        except Exception as exc:  # grid ladder: the factorized rung fell
            if not ladder:
                raise
            kind = resilience.classify(exc)
            if weights is None:
                try:
                    resilience.record_degradation("grid", "streamed", kind)
                    c, s = _streamed_uniform_sums(t, f0, df, n_freq, nharm, poly=poly,
                                                  fdots=fdots, fddots=fddots, tile0=tile0,
                                                  device=t.device)
                    return c, s, t.shape[0]
                except resilience.KernelError:
                    raise
                except Exception as exc2:  # last rung: the in-core exact grid
                    resilience.record_degradation("grid", "exact", resilience.classify(exc2))
            else:
                resilience.record_degradation("grid", "exact", kind)
    elif ladder:
        faultinject.fire("harmonic_sums")
    if nharm > z2_grid.MAX_NHARM:
        raise ValueError(f"the uniform-grid kernel takes nharm <= {z2_grid.MAX_NHARM}; "
                         "use the general kernels (z2_power, h_power, ...) beyond that")
    cs = _k2_grid_sums(t, f0, df, n_freq, fdots, fddots, nharm, poly, weights, per_split, tile0,
                       site, plan or ("grid3d" if cube else "grid"))
    return cs[0], cs[1], t.shape[0]


def harmonic_sums_2d_grid(times, f0: float, df: float, n_freq: int, fdots, nharm: int,
                          device=None, **kw):
    """f64 trig sums (n_fdot, nharm, n_freq) each over the (fdot x uniform
    frequency) grid, plus the event count. ``fdots`` are signed Hz/s; times
    are f64 seconds, pre-centered by the caller. Keywords as
    ``_grid3d_sums_dispatch`` (poly, mxu, reseed, mxu_bf16, weights,
    per_split)."""
    c, s, n = _grid3d_sums_dispatch(times, f0, df, n_freq, fdots, None, nharm, device=device,
                                    ladder=False, **kw)
    return c[0], s[0], n


def harmonic_sums_3d_grid(times, f0: float, df: float, n_freq: int, fdots, fddots, nharm: int,
                          device=None, **kw):
    """f64 trig sums (n_fddot, n_fdot, nharm, n_freq) each over the search
    cube; ``fddots`` are signed Hz/s^2. Keywords as harmonic_sums_2d_grid."""
    c, s, _ = _grid3d_sums_dispatch(times, f0, df, n_freq, fdots, fddots, nharm, device=device,
                                    **kw)
    return c, s


def _uniform_sums(times, f0, df, n_freq, fdots, fddots, nharm, event_block, trial_block, weights, poly,
                  device):
    """K2's sums for the JAX-named uniform wrappers: no factorized path, no
    ladder; ``event_block`` is the split length (None: the resolved plan)."""
    if trial_block != z2_grid.TRIAL_TILE:
        raise ValueError(f"K2's trial tile is {z2_grid.TRIAL_TILE}, got trial_block={trial_block}")
    c, s, _ = _grid3d_sums_dispatch(times, f0, df, n_freq, fdots, fddots, nharm, poly=poly, mxu=False,
                                    reseed=GRID_MXU_RESEED, mxu_bf16=False, weights=weights,
                                    per_split=event_block, device=device, ladder=False)
    return c, s


def harmonic_sums_uniform(times, f0: float, df: float, n_freq: int, nharm: int,
                          event_block: int | None = None, trial_block: int = DEFAULT_TRIAL_BLOCK,
                          fdot: float = 0.0, weights=None, poly: bool | None = None, device=None):
    """Trig sums (nharm, n_freq) f64 each over the uniform grid f0 + j*df
    through K2: the JAX package's ``harmonic_sums_uniform``, with
    ``event_block`` read as K2's split length."""
    c, s = _uniform_sums(times, f0, df, n_freq, [fdot], None, nharm, event_block, trial_block, weights,
                         poly, device)
    return c[0, 0], s[0, 0]


def harmonic_sums_uniform_2d(times, f0: float, df: float, n_freq: int, fdots, nharm: int,
                             event_block: int | None = None, trial_block: int = DEFAULT_TRIAL_BLOCK,
                             weights=None, poly: bool | None = None, device=None):
    """Trig sums (n_fdot, nharm, n_freq) f64 each over the (fdot x uniform
    frequency) grid through K2: the JAX package's ``harmonic_sums_uniform_2d``."""
    c, s = _uniform_sums(times, f0, df, n_freq, fdots, None, nharm, event_block, trial_block, weights,
                         poly, device)
    return c[0], s[0]


def harmonic_sums_uniform_3d(times, f0: float, df: float, n_freq: int, fdots, fddots, nharm: int,
                             event_block: int | None = None, trial_block: int = DEFAULT_TRIAL_BLOCK,
                             weights=None, poly: bool | None = None, device=None):
    """Trig sums (n_fddot, n_fdot, nharm, n_freq) f64 each over the search
    cube through K2: the JAX package's ``harmonic_sums_uniform_3d``."""
    return _uniform_sums(times, f0, df, n_freq, fdots, fddots, nharm, event_block, trial_block, weights,
                         poly, device)


def z2_power_grid(times, f0: float, df: float, n_freq: int, nharm: int = 2, device=None,
                  **kw) -> torch.Tensor:
    """Z^2_n over the uniform grid f0 + j*df -> (n_freq,) f64."""
    c, s, n = _grid3d_sums_dispatch(times, f0, df, n_freq, [0.0], None, nharm, device=device, **kw)
    return torch.sum(z2_from_sums(c[0, 0], s[0, 0], n), dim=0)


def h_power_grid(times, f0: float, df: float, n_freq: int, nharm: int = 20, device=None,
                 **kw) -> torch.Tensor:
    """H-test over the uniform grid f0 + j*df -> (n_freq,) f64."""
    c, s, n = _grid3d_sums_dispatch(times, f0, df, n_freq, [0.0], None, nharm, device=device, **kw)
    return h_from_sums(c[0, 0], s[0, 0], n, dim=0)


def z2_power_2d_grid(times, f0: float, df: float, n_freq: int, fdots, nharm: int = 2,
                     device=None, **kw) -> torch.Tensor:
    """Z^2_n over the (fdot x uniform-frequency) grid -> (n_fdot, n_freq) f64."""
    c, s, n = _grid3d_sums_dispatch(times, f0, df, n_freq, fdots, None, nharm, device=device,
                                    ladder=False, **kw)
    return torch.sum(z2_from_sums(c[0], s[0], n), dim=1)


def z2_power_3d_grid(times, f0: float, df: float, n_freq: int, fdots, fddots, nharm: int = 2,
                     device=None, **kw) -> torch.Tensor:
    """Z^2_n over the (fddot x fdot x uniform-frequency) cube
    -> (n_fddot, n_fdot, n_freq) f64. ``fdots``/``fddots`` are signed."""
    c, s, n = _grid3d_sums_dispatch(times, f0, df, n_freq, fdots, fddots, nharm, device=device,
                                    **kw)
    return torch.sum(z2_from_sums(c, s, n), dim=2)


def h_power_3d_grid(times, f0: float, df: float, n_freq: int, fdots, fddots, nharm: int = 20,
                    device=None, **kw) -> torch.Tensor:
    """H-test over the cube -> (n_fddot, n_fdot, n_freq) f64."""
    c, s, n = _grid3d_sums_dispatch(times, f0, df, n_freq, fdots, fddots, nharm, device=device,
                                    **kw)
    return h_from_sums(c, s, n, dim=2)


# ---------------------------------------------------------------------------
# Factorized (matmul) uniform grids
# ---------------------------------------------------------------------------
#
# The uniform-grid phase is affine in the trial index: for trial
# j = j0 + j_lo and harmonic k, k*phase = k*theta0(row, e) + j_lo*(k*b_e), so
# cos/sin factor by angle addition into a per-row part (theta0: one row per
# tile (+) fdot (+) fddot, Chebyshev in k) and a per-trial sweep
# (cos/sin(2*pi*j_lo*k*b_e): a rotation recurrence in j_lo reseeded with
# exact sin/cos every `reseed` trials, Chebyshev in k), and the harmonic sums
# become f32 matrix products per event block:
#
#     C_k = Xw_k @ Csw_k^T - Yw_k @ Ssw_k^T        (rows, EB) @ (EB, TB)
#     S_k = Yw_k @ Csw_k^T + Xw_k @ Ssw_k^T
#
# summed over blocks in f64. The JAX package leaves these products to XLA
# outside any Pallas kernel; here they stay torch.matmul.


@contextlib.contextmanager
def _full_f32_matmul():
    """Pin full f32 matmul precision for the block (TF32 keeps ~3 digits and
    the global setting belongs to the caller); restored on exit."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def _sweep_matrices(b: torch.Tensor, trial_block: int, reseed: int, poly: bool):
    """cos/sin(2*pi*j_lo*b_e) for j_lo = 0..trial_block-1 -> (TB, EB) pair.

    Exact sin/cos only at the reseed anchors j_lo = m*reseed; within a
    segment the pair advances by the angle-addition rotation, whose f32
    drift is cut back to zero at every anchor. The anchor phases
    m*reseed*b are reduced in f32."""
    reseed = max(1, min(int(reseed), trial_block))
    n_seg = -(-trial_block // reseed)
    seg = torch.arange(n_seg, dtype=torch.float32, device=b.device)
    c, s = _trig_rows(fasttrig.centered_frac(seg[:, None] * (reseed * b)[None, :]), poly)
    ca, sa = _trig_rows(b, poly)  # rotation by 2*pi*b
    c_all, s_all = [], []
    for _ in range(reseed):
        c_all.append(c)
        s_all.append(s)
        c, s = c * ca - s * sa, s * ca + c * sa
    csw = torch.stack(c_all, dim=1).reshape(n_seg * reseed, -1)[:trial_block]
    ssw = torch.stack(s_all, dim=1).reshape(n_seg * reseed, -1)[:trial_block]
    return csw, ssw


def _mxu_dot(a: torch.Tensor, b: torch.Tensor, mxu_bf16: bool) -> torch.Tensor:
    """a @ b^T with an f32 result. With ``mxu_bf16`` the operands are rounded
    to bf16 and multiplied by an f32 GEMM: a product of two bf16 values is
    exact in f32, so this is the f32-accumulated bf16 product that JAX's
    preferred_element_type=f32 asks for (torch.matmul of bf16 tensors would
    round its output to bf16)."""
    if mxu_bf16:
        a = a.to(torch.bfloat16).to(torch.float32)
        b = b.to(torch.bfloat16).to(torch.float32)
    return a @ b.T


def _factored_harmonic_sums(cos0, sin0, weights, csw, ssw, nharm: int, mxu_bf16: bool):
    """(C, S) of shape (nharm, n_rows, TB) f64 from the factor matrices:
    ``cos0``/``sin0`` (n_rows, EB) trig of the per-row base phase,
    ``csw``/``ssw`` (TB, EB) the sweep. Harmonic k of both factors comes from
    the Chebyshev recurrence; four f32 matmuls per harmonic."""
    w = weights[None, :]
    ck, sk = cos0, sin0
    ck_m2, sk_m2 = torch.ones_like(cos0), torch.zeros_like(sin0)
    cswk, sswk = csw, ssw
    cswk_m2, sswk_m2 = torch.ones_like(csw), torch.zeros_like(ssw)
    c_list, s_list = [], []
    for k in range(nharm):
        if k:
            ck, ck_m2 = 2 * cos0 * ck - ck_m2, ck
            sk, sk_m2 = 2 * cos0 * sk - sk_m2, sk
            cswk, cswk_m2 = 2 * csw * cswk - cswk_m2, cswk
            sswk, sswk_m2 = 2 * csw * sswk - sswk_m2, sswk
        xw, yw = w * ck, w * sk
        c_list.append(_mxu_dot(xw, cswk, mxu_bf16) - _mxu_dot(yw, sswk, mxu_bf16))
        s_list.append(_mxu_dot(yw, cswk, mxu_bf16) + _mxu_dot(xw, sswk, mxu_bf16))
    return torch.stack(c_list).to(torch.float64), torch.stack(s_list).to(torch.float64)


def _mxu_block(t, w, f_tiles, half, sixth, df: float, nharm: int, trial_block: int, poly: bool,
               reseed: int, mxu_bf16: bool):
    """One event block of the factorized cube: (C, S) of shape
    (nharm, n_fddot*n_fdot*n_tiles, TB) f64. Rows combine tile (+) fdot
    (+) fddot by angle addition, so the transcendental rows number
    n_tiles + n_fdot + n_fddot per block."""
    tt = t * t
    ct, st = _trig_rows(fasttrig.centered_frac(f_tiles[:, None] * t[None, :]).to(torch.float32), poly)
    cq, sq = _trig_rows(fasttrig.centered_frac(half[:, None] * tt[None, :]).to(torch.float32), poly)
    c0 = cq[:, None, :] * ct[None, :, :] - sq[:, None, :] * st[None, :, :]  # (n_fdot, n_tiles, EB)
    s0 = sq[:, None, :] * ct[None, :, :] + cq[:, None, :] * st[None, :, :]
    if sixth is not None:
        cr, sr = _trig_rows(fasttrig.centered_frac(sixth[:, None] * (tt * t)[None, :]).to(torch.float32),
                            poly)
        c0, s0 = (cr[:, None, None, :] * c0[None] - sr[:, None, None, :] * s0[None],
                  sr[:, None, None, :] * c0[None] + cr[:, None, None, :] * s0[None])
    csw, ssw = _sweep_matrices(fasttrig.centered_frac(df * t).to(torch.float32), trial_block,
                               reseed, poly)
    return _factored_harmonic_sums(c0.reshape(-1, t.shape[0]), s0.reshape(-1, t.shape[0]), w,
                                   csw, ssw, nharm, mxu_bf16)


class MxuCarry:
    """The factorized path's f64 running sums over event blocks, fed in
    block order by the monolithic and the streamed drivers alike."""

    def __init__(self, f0: float, df: float, n_freq: int, fdots, fddots, nharm: int, poly: bool,
                 reseed: int, mxu_bf16: bool, device, event_block: int = MXU_EVENT_BLOCK,
                 trial_block: int = MXU_TRIAL_BLOCK, tile0: int = 0):
        self.df, self.n_freq, self.nharm, self.poly = float(df), int(n_freq), int(nharm), bool(poly)
        self.reseed, self.mxu_bf16 = int(reseed), bool(mxu_bf16)
        self.event_block, self.trial_block = int(event_block), int(trial_block)
        self.n_tiles = -(-self.n_freq // self.trial_block)
        # f0 + (tile*TB)*df: the association of the JAX factorized kernels
        self.f_tiles = f0 + ((torch.arange(self.n_tiles, dtype=torch.float64, device=device) + tile0)
                             * self.trial_block) * df
        self.half, self.sixth = row_coeffs(fdots, fddots, device)
        self.shape = (1 if fddots is None else self.sixth.shape[0], self.half.shape[0])
        self.c = self.s = None

    def feed(self, t: torch.Tensor, w: torch.Tensor | None) -> None:
        """Add the sums of ``t`` (a whole number of event blocks, or the tail)."""
        with _full_f32_matmul():
            for e0 in range(0, t.shape[0], self.event_block):
                tb = t[e0:e0 + self.event_block]
                wb = (torch.ones(tb.shape[0], dtype=torch.float32, device=t.device) if w is None
                      else w[e0:e0 + self.event_block])
                c, s = _mxu_block(tb, wb, self.f_tiles, self.half, self.sixth, self.df,
                                  self.nharm, self.trial_block, self.poly, self.reseed,
                                  self.mxu_bf16)
                self.c = c if self.c is None else self.c + c
                self.s = s if self.s is None else self.s + s

    def result(self):
        """(c, s) of shape (n_fddot, n_fdot, nharm, n_freq) f64."""
        def freqs(x):
            x = x.reshape(self.nharm, *self.shape, self.n_tiles * self.trial_block)
            return x.permute(1, 2, 0, 3)[..., :self.n_freq]
        return freqs(self.c), freqs(self.s)


def _mxu_grid_sums(t, weights, f0, df, n_freq, fdots, fddots, nharm, poly, reseed, mxu_bf16,
                   event_block: int = MXU_EVENT_BLOCK, trial_block: int = MXU_TRIAL_BLOCK, tile0: int = 0):
    carry = MxuCarry(f0, df, n_freq, fdots, fddots, nharm, poly, reseed, mxu_bf16, t.device,
                      event_block, trial_block, tile0)
    carry.feed(t, as_weights(weights, t.device))
    return carry.result()


def harmonic_sums_uniform_mxu(times, f0: float, df: float, n_freq: int, nharm: int,
                              event_block: int = MXU_EVENT_BLOCK,
                              trial_block: int = MXU_TRIAL_BLOCK, fdot: float = 0.0,
                              weights=None, poly: bool | None = None, reseed: int = GRID_MXU_RESEED,
                              mxu_bf16: bool = False, device=None):
    """Factorized 1-D grid sums -> (nharm, n_freq) f64 each."""
    t = as_f64(times, resolve_device(device))
    poly = fasttrig.poly_trig_enabled(poly, t.device)
    c, s = _mxu_grid_sums(t, weights, f0, df, n_freq, [fdot], None, nharm, poly, reseed, mxu_bf16,
                          event_block, trial_block)
    return c[0, 0], s[0, 0]


def harmonic_sums_uniform_2d_mxu(times, f0: float, df: float, n_freq: int, fdots, nharm: int,
                                 event_block: int = MXU_EVENT_BLOCK,
                                 trial_block: int = MXU_TRIAL_BLOCK, weights=None,
                                 poly: bool | None = None, reseed: int = GRID_MXU_RESEED,
                                 mxu_bf16: bool = False, device=None):
    """Factorized (fdot x frequency) grid sums -> (n_fdot, nharm, n_freq) f64 each."""
    t = as_f64(times, resolve_device(device))
    poly = fasttrig.poly_trig_enabled(poly, t.device)
    c, s = _mxu_grid_sums(t, weights, f0, df, n_freq, fdots, None, nharm, poly, reseed, mxu_bf16,
                          event_block, trial_block)
    return c[0], s[0]


def harmonic_sums_uniform_3d_mxu(times, f0: float, df: float, n_freq: int, fdots, fddots,
                                 nharm: int, event_block: int = MXU_EVENT_BLOCK,
                                 trial_block: int = MXU_TRIAL_BLOCK, weights=None,
                                 poly: bool | None = None, reseed: int = GRID_MXU_RESEED,
                                 mxu_bf16: bool = False, device=None):
    """Factorized cube sums -> (n_fddot, n_fdot, nharm, n_freq) f64 each."""
    t = as_f64(times, resolve_device(device))
    poly = fasttrig.poly_trig_enabled(poly, t.device)
    return _mxu_grid_sums(t, weights, f0, df, n_freq, fdots, fddots, nharm, poly, reseed,
                          mxu_bf16, event_block, trial_block)


# ---------------------------------------------------------------------------
# Streamed uniform grids (host -> device overlap)
# ---------------------------------------------------------------------------


def _stream_chunks(n_events: int, event_chunk: int) -> list[tuple[int, int]]:
    """Host chunk plan: [(lo, hi), ...] of ``event_chunk`` events, the last
    one ragged. The chunk is the unit the monolithic kernel splits on, so
    each chunk's sums are the ones the monolithic run forms for it."""
    return [(lo, min(n_events, lo + event_chunk)) for lo in range(0, n_events, event_chunk)]


def _device_chunks(times: np.ndarray, plan, dev: torch.device):
    """Yield each chunk of ``times`` on ``dev`` in plan order. On the card the
    copy of chunk i+1 is issued on a side stream, from pinned host memory,
    before chunk i is handed back, so it runs under chunk i's kernel."""
    if dev.type != "cuda":
        for lo, hi in plan:
            yield torch.from_numpy(times[lo:hi]).to(dev)
        return
    host = torch.from_numpy(times).pin_memory()
    copy_stream = torch.cuda.Stream(dev)
    compute = torch.cuda.current_stream(dev)

    def issue(lo, hi):
        with torch.cuda.stream(copy_stream):
            chunk = host[lo:hi].to(dev, non_blocking=True)
            done = torch.cuda.Event()
            done.record(copy_stream)
        return chunk, done

    pending = issue(*plan[0])
    for i in range(len(plan)):
        chunk, done = pending
        if i + 1 < len(plan):
            pending = issue(*plan[i + 1])
        compute.wait_event(done)
        chunk.record_stream(compute)
        yield chunk


def _streamed_uniform_sums(times, f0: float, df: float, n_freq: int, nharm: int,
                           poly: bool | None = None, fdots=(0.0,), fddots=None,
                           event_chunk: int | None = None, mxu: bool = False,
                           reseed: int = GRID_MXU_RESEED, mxu_bf16: bool = False, tile0: int = 0,
                           device=None):
    """Double-buffered driver of the streamed grid wrappers: (c, s) of shape
    (n_fddot, n_fdot, nharm, n_freq) f64, bitwise the monolithic result at
    the same split length. Exact path: each chunk is one K2 split and the
    f32 carry adds the chunks in order, as z2_reduce_splits adds splits;
    the chunk length (a multiple of 1024 events) is the monolithic
    ``per_split``. Factorized path: the same event blocks feed the same f64
    carry (the chunk length is a multiple of MXU_EVENT_BLOCK)."""
    dev = resolve_device(device)
    poly = fasttrig.poly_trig_enabled(poly, dev)
    host = np.ascontiguousarray(
        times.detach().cpu().numpy() if isinstance(times, torch.Tensor) else times,
        dtype=np.float64).reshape(-1)
    unit = MXU_EVENT_BLOCK if mxu else z2_grid.EVENT_CHUNK
    chunk = STREAM_EVENT_CHUNK if event_chunk is None else int(event_chunk)
    chunk = max(unit, chunk // unit * unit)
    plan = _stream_chunks(host.shape[0], chunk)
    if mxu:
        carry = MxuCarry(f0, df, n_freq, fdots, fddots, nharm, poly, reseed, mxu_bf16, dev, tile0=tile0)
        with costmodel.kernel_span("grid_sums_streamed"):
            for t in _device_chunks(host, plan, dev):
                carry.feed(t, None)
        return carry.result()
    if nharm > z2_grid.MAX_NHARM:
        raise ValueError(f"the uniform-grid kernel takes nharm <= {z2_grid.MAX_NHARM}")
    half, sixth = row_coeffs(fdots, fddots, dev)
    n_tiles = -(-int(n_freq) // z2_grid.TRIAL_TILE)
    acc = None
    n_rows = half.shape[0] * (1 if sixth is None else sixth.shape[0])
    with costmodel.kernel_span("grid_sums_streamed"):
        for t in _device_chunks(host, plan, dev):
            cs = z2_grid.z2_tile_sums(t, f0, df, half, n_tiles, nharm, sixth_fddots=sixth, poly=poly,
                                      per_split=chunk, tile0=tile0)
            acc = cs if acc is None else acc + cs
    costmodel.capture("grid_sums_streamed", z2_grid.z2_tile_sums, host, f0, df, half, n_tiles, nharm,
                      sixth_fddots=sixth, poly=poly, per_split=chunk, tile0=tile0, out=acc,
                      counts=lambda: costmodel.k2_counts(host.shape[0], int(n_freq), n_rows, nharm, acc))
    cs = tiles_to_freqs(acc, n_freq)
    return cs[0], cs[1]


def harmonic_sums_grid_streamed(times, f0: float, df: float, n_freq: int, nharm: int, device=None, **kw):
    """The streamed grid's f64 trig sums (c, s), each (n_fddot, n_fdot,
    nharm, n_freq), bitwise the in-core grid's at the same split length
    (``event_chunk``); keywords as the streamed wrappers (poly, fdots,
    fddots, event_chunk, mxu, reseed, mxu_bf16, tile0)."""
    return _streamed_uniform_sums(times, f0, df, n_freq, nharm, device=device, **kw)


def z2_power_grid_streamed(times, f0: float, df: float, n_freq: int, nharm: int = 2,
                           device=None, **kw) -> torch.Tensor:
    """z2_power_grid with double-buffered host->device event streaming."""
    c, s = _streamed_uniform_sums(times, f0, df, n_freq, nharm, device=device, **kw)
    return torch.sum(z2_from_sums(c[0, 0], s[0, 0], np.shape(times)[0]), dim=0)


def h_power_grid_streamed(times, f0: float, df: float, n_freq: int, nharm: int = 20,
                          device=None, **kw) -> torch.Tensor:
    """h_power_grid with double-buffered host->device event streaming."""
    c, s = _streamed_uniform_sums(times, f0, df, n_freq, nharm, device=device, **kw)
    return h_from_sums(c[0, 0], s[0, 0], np.shape(times)[0], dim=0)


def z2_power_2d_grid_streamed(times, f0: float, df: float, n_freq: int, fdots, nharm: int = 2,
                              device=None, **kw) -> torch.Tensor:
    """z2_power_2d_grid with double-buffered host->device event streaming."""
    c, s = _streamed_uniform_sums(times, f0, df, n_freq, nharm, fdots=fdots, device=device, **kw)
    return torch.sum(z2_from_sums(c[0], s[0], np.shape(times)[0]), dim=1)


def z2_power_3d_grid_streamed(times, f0: float, df: float, n_freq: int, fdots, fddots,
                              nharm: int = 2, device=None, **kw) -> torch.Tensor:
    """z2_power_3d_grid with double-buffered host->device event streaming."""
    c, s = _streamed_uniform_sums(times, f0, df, n_freq, nharm, fdots=fdots, fddots=fddots,
                                  device=device, **kw)
    return torch.sum(z2_from_sums(c, s, np.shape(times)[0]), dim=2)


# ---------------------------------------------------------------------------
# Any grid, any nharm: K3
# ---------------------------------------------------------------------------


def general_harmonic_sums(times, freqs, fdots=(0.0,), fddots=(0.0,), nharm: int = 2,
                          trig_dtype: torch.dtype = torch.float32, poly: bool = False,
                          device=None, per_split: int | None = None):
    """(c, s) of shape (n_fddot, n_fdot, nharm, n_freq) f64 for arbitrary
    frequencies through K3; ``fdots``/``fddots`` signed Hz/s and Hz/s^2.
    ``per_split`` pins K3's launch plan (None: ``autotune.resolve_blocks``
    under "general"); each trial's sums depend on it and on nothing else of
    the grid. The launch is the kernel span and cost row "general_sums"."""
    dev = resolve_device(device)
    half, sixth = row_coeffs(fdots, fddots, dev)
    t, f = as_f64(times, dev), as_f64(freqs, dev)
    n_rows = half.shape[0] * sixth.shape[0]
    if per_split is None:
        per_split, _ = autotune.resolve_blocks("general", t.shape[0], f.shape[0] * n_rows, poly,
                                               n_rows=n_rows, nharm=int(nharm), trig_dtype=trig_dtype,
                                               device=dev)
    with costmodel.kernel_span("general_sums"):
        cs = z2_general.general_sums(t, f, half, sixth, int(nharm), trig_dtype, poly, per_split=per_split)
    costmodel.capture("general_sums", z2_general.general_sums, t, f, half, sixth, int(nharm), trig_dtype,
                      poly, per_split=per_split, out=cs,
                      counts=lambda: costmodel.k3_counts(t.shape[0], f.shape[0], n_rows, int(nharm), trig_dtype,
                                                         poly, has_d=bool(np.any(np.asarray(fdots) != 0)
                                                                          or np.any(np.asarray(fddots) != 0))))
    return cs[0], cs[1]


def harmonic_sums_1d(times, freqs, nharm: int, trig_dtype: torch.dtype = torch.float32,
                     poly: bool = False, device=None, per_split: int | None = None):
    """Trig sums (nharm, n_freq) f64 over all events at arbitrary frequencies."""
    c, s = general_harmonic_sums(times, freqs, nharm=nharm, trig_dtype=trig_dtype, poly=poly,
                                 device=device, per_split=per_split)
    return c[0, 0], s[0, 0]


def z2_power(times, freqs, nharm: int = 2, trig_dtype: torch.dtype = torch.float32,
             poly: bool = False, device=None, per_split: int | None = None) -> torch.Tensor:
    """Z^2_n at each frequency (times pre-centered by the caller) -> (n_freq,)."""
    c, s = harmonic_sums_1d(times, freqs, nharm, trig_dtype, poly, device, per_split)
    return torch.sum(z2_from_sums(c, s, np.shape(times)[0]), dim=0)


def h_power(times, freqs, nharm: int = 20, trig_dtype: torch.dtype = torch.float32,
            poly: bool = False, device=None, per_split: int | None = None) -> torch.Tensor:
    """H-test at each frequency: max_m (cumsum Z^2_m - 4(m-1)) -> (n_freq,)."""
    c, s = harmonic_sums_1d(times, freqs, nharm, trig_dtype, poly, device, per_split)
    return h_from_sums(c, s, np.shape(times)[0], dim=0)


def z2_power_2d(times, freqs, fdots, nharm: int = 2, trig_dtype: torch.dtype = torch.float32,
                poly: bool = False, device=None, per_split: int | None = None) -> torch.Tensor:
    """Z^2_n over the (fdot, freq) grid -> (n_fdot, n_freq); signed fdots."""
    c, s = general_harmonic_sums(times, freqs, fdots, (0.0,), nharm, trig_dtype, poly, device, per_split)
    return torch.sum(z2_from_sums(c[0], s[0], np.shape(times)[0]), dim=1)


def z2_power_3d(times, freqs, fdots, fddots, nharm: int = 2,
                trig_dtype: torch.dtype = torch.float32, poly: bool = False,
                device=None, per_split: int | None = None) -> torch.Tensor:
    """Z^2_n over the (fddot, fdot, freq) cube -> (n_fddot, n_fdot, n_freq);
    the arbitrary-grid fallback of the jerk search, both axes signed."""
    c, s = general_harmonic_sums(times, freqs, fdots, fddots, nharm, trig_dtype, poly, device, per_split)
    return torch.sum(z2_from_sums(c, s, np.shape(times)[0]), dim=2)


# ---------------------------------------------------------------------------
# Per-segment H-test
# ---------------------------------------------------------------------------


def h_power_segments(times, masks, freqs, nharm: int = 5, device=None) -> torch.Tensor:
    """H-test power per segment at its own frequency: times (S, N) pre-centered
    seconds (padded), masks (S, N) validity, freqs (S,). Backs the per-ToA
    H-test of the ToA pipeline. Returns (S,) f64."""
    with obs.profiler_range(spans.HTEST_SUMS):
        dev = resolve_device(device)
        t = torch.as_tensor(np.asarray(times, dtype=np.float64)).to(dev)
        m = torch.as_tensor(np.asarray(masks)).to(dev).to(torch.float64)
        f = torch.as_tensor(np.asarray(freqs, dtype=np.float64)).to(dev)
        c, s = _harmonic_sums_cycles(f[:, None] * t, m, nharm)  # (nharm, S)
        return h_from_sums(c, s, torch.sum(m, dim=-1), dim=0)


def h_power_segments_chunked(times, masks, freqs, nharm: int = 5, row_block: int | None = None,
                             device=None) -> np.ndarray:
    """``h_power_segments`` in row chunks of ``row_block`` (None/<=0 or >=
    the row count: one call), bounding the (rows, events, harmonics)
    temporaries. Returns (S,) numpy."""
    faultinject.fire("harmonic_sums")
    times = np.asarray(times)
    n_rows = times.shape[0]
    if row_block is None or row_block <= 0 or row_block >= n_rows:
        return h_power_segments(times, masks, freqs, nharm, device).cpu().numpy()
    masks, freqs = np.asarray(masks), np.asarray(freqs)
    pending = [h_power_segments(times[lo:lo + row_block], masks[lo:lo + row_block],
                                freqs[lo:lo + row_block], nharm, device)
               for lo in range(0, n_rows, row_block)]
    return np.concatenate([p.cpu().numpy() for p in pending])


# ---------------------------------------------------------------------------
# The reference-compatible API
# ---------------------------------------------------------------------------


class PeriodSearch:
    """Reference-compatible search API (periodsearch.py:20-125) on the card.

    ``time`` in seconds; trials are centered on t0 = (time[0]+time[-1])/2.
    Uniform trial grids with nharm <= 20 run through K2 unless
    ``use_grid_fastpath=False``; everything else through K3. ``poly_trig``
    picks the polynomial sin/cos or f32 sin/cos (None:
    ``fasttrig.poly_trig_enabled`` on ``device``, the polynomial on the card
    and f32 sin/cos on the CPU, as JAX's rule). Runs on ``device`` (default
    cuda). From ``MIN_SHARD_PAIRS`` (trial, event) pairs on, a job with
    several devices of that type shards the scan through
    ``parallel.mesh``'s twins (``auto_mesh``; ``CRIMP_TORCH_SHARD=0`` opts
    out); one card never shards.
    """

    def __init__(self, time, freq, nbrHarm: int = 2, use_grid_fastpath: bool | None = None,
                 poly_trig: bool | None = None, device=None):
        self.time = np.asarray(time, dtype=np.float64)
        self.freq = np.asarray(freq, dtype=np.float64)
        self.nbrHarm = int(nbrHarm)
        self.t0 = (self.time[0] + self.time[-1]) / 2
        self.use_grid_fastpath = use_grid_fastpath
        self.poly_trig = poly_trig
        self.device = resolve_device(device)

    def _poly(self) -> bool:
        return fasttrig.poly_trig_enabled(self.poly_trig, self.device)

    def _grid(self):
        """(f0, df) when the trial grid is uniform and the fast path is on."""
        if not grid_fastpath_enabled(self.nbrHarm, self.use_grid_fastpath):
            return None
        return uniform_grid(self.freq)

    def _centered(self) -> np.ndarray:
        return self.time - self.t0

    def _kw(self) -> dict:
        return {"poly": self._poly(), "device": self.device}

    def _mesh(self, n_pairs: int | None = None):
        """Device mesh for auto-sharding, or None for the single-device path."""
        if n_pairs is None:
            n_pairs = len(self.time) * len(self.freq)
        if n_pairs < MIN_SHARD_PAIRS:
            return None
        from crimp_tpu_torch.parallel import mesh as pmesh

        return pmesh.auto_mesh(device=self.device)

    def _sharded_kw(self) -> dict:
        return {"use_fastpath": self.use_grid_fastpath, "poly": self._poly()}

    def ztest(self) -> np.ndarray:
        mesh = self._mesh()
        if mesh is not None:
            from crimp_tpu_torch.parallel import mesh as pmesh

            return pmesh.z2_sharded(self._centered(), self.freq, self.nbrHarm, mesh, **self._sharded_kw())
        grid = self._grid()
        if grid is not None:
            power = z2_power_grid(self._centered(), *grid, len(self.freq), self.nbrHarm, **self._kw())
        else:
            power = z2_power(self._centered(), self.freq, self.nbrHarm, **self._kw())
        return power.cpu().numpy()

    def htest(self) -> np.ndarray:
        mesh = self._mesh()
        if mesh is not None:
            from crimp_tpu_torch.parallel import mesh as pmesh

            return pmesh.h_sharded(self._centered(), self.freq, self.nbrHarm, mesh, **self._sharded_kw())
        grid = self._grid()
        if grid is not None:
            power = h_power_grid(self._centered(), *grid, len(self.freq), self.nbrHarm, **self._kw())
        else:
            power = h_power(self._centered(), self.freq, self.nbrHarm, **self._kw())
        return power.cpu().numpy()

    def twod_ztest(self, freq_dot):
        """2-D Z^2 on a (log10 |nudot|) grid, spin-down sign enforced.

        Returns (array of rows [freq, log10_fdot, z2], column dict) with the
        reference's row ordering: outer loop fdot, inner loop freq.
        """
        with obs.span(spans.SCAN):
            with obs.profiler_range(spans.SCAN_PLAN):
                log_fdots = np.asarray(freq_dot, dtype=np.float64)
                signed = -(10.0**log_fdots)
                mesh = self._mesh(len(self.time) * len(self.freq) * len(signed))
                grid = self._grid()
                centered = self._centered()
            if mesh is not None:
                from crimp_tpu_torch.parallel import mesh as pmesh

                power = pmesh.z2_2d_sharded(centered, self.freq, signed, self.nbrHarm, mesh, **self._sharded_kw())
            elif grid is not None:
                power = z2_power_2d_grid(centered, *grid, len(self.freq), signed, self.nbrHarm, **self._kw())
            else:
                power = z2_power_2d(centered, self.freq, signed, self.nbrHarm, **self._kw())
            with obs.profiler_range(spans.SCAN_ROWS):
                if isinstance(power, torch.Tensor):
                    power = power.cpu().numpy()
                rows = np.column_stack([
                    np.tile(self.freq, len(log_fdots)),
                    np.repeat(log_fdots, len(self.freq)),
                    power.reshape(-1),
                ])
                table = {"Freq": rows[:, 0], "Freq_dot": rows[:, 1], "Z2pow": rows[:, 2]}
        return rows, table

    def _threed_rows(self, log_fdots, fdd, power):
        """(rows, column dict) for the cube scans: outer fddot, then fdot,
        then freq (the reference 2-D row ordering extended by one axis)."""
        rows = np.column_stack([
            np.tile(self.freq, len(log_fdots) * len(fdd)),
            np.tile(np.repeat(log_fdots, len(self.freq)), len(fdd)),
            np.repeat(fdd, len(self.freq) * len(log_fdots)),
            np.asarray(power).reshape(-1),
        ])
        table = {"Freq": rows[:, 0], "Freq_dot": rows[:, 1], "Freq_ddot": rows[:, 2],
                 "Z2pow": rows[:, 3]}
        return rows, table

    def threed_ztest(self, freq_dot, freq_ddot):
        """3-D Z^2 over the (freq x log10 |nudot| x signed nuddot) cube.

        ``freq_dot`` keeps twod_ztest's convention (log10 magnitudes applied
        as -10**x); ``freq_ddot`` is signed s^-3. Returns (rows, column
        dict) ordered outer fddot, then fdot, then freq.
        """
        log_fdots = np.asarray(freq_dot, dtype=np.float64)
        signed = -(10.0**log_fdots)
        fdd = np.asarray(freq_ddot, dtype=np.float64)
        mesh = self._mesh(len(self.time) * len(self.freq) * len(signed) * len(fdd))
        grid = self._grid()
        if mesh is not None:
            from crimp_tpu_torch.parallel import mesh as pmesh

            power = pmesh.z2_3d_sharded(self._centered(), self.freq, signed, fdd, self.nbrHarm, mesh,
                                        **self._sharded_kw())
        elif grid is not None:
            power = z2_power_3d_grid(self._centered(), *grid, len(self.freq), signed, fdd,
                                     self.nbrHarm, **self._kw()).cpu().numpy()
        else:
            power = z2_power_3d(self._centered(), self.freq, signed, fdd, self.nbrHarm,
                                **self._kw()).cpu().numpy()
        return self._threed_rows(log_fdots, fdd, power)

    def semicoherent_ztest(self, freq_dot, freq_ddot, n_segments: int):
        """Semi-coherent stacked Z^2 over the cube (ops/semicoherent).

        Events split into ``n_segments`` equal-duration segments, each
        scanned coherently at the global phase model, the per-segment Z^2
        terms summed incoherently. Same axis conventions and row ordering as
        threed_ztest; needs a uniform frequency grid.
        """
        from crimp_tpu_torch.ops import semicoherent

        grid = uniform_grid(self.freq)
        if grid is None:
            raise ValueError("semicoherent_ztest needs a uniform frequency grid")
        log_fdots = np.asarray(freq_dot, dtype=np.float64)
        signed = -(10.0**log_fdots)
        fdd = np.asarray(freq_ddot, dtype=np.float64)
        power = semicoherent.semicoherent_z2_grid(
            self._centered(), *grid, len(self.freq), signed, fdd, nharm=self.nbrHarm,
            n_segments=int(n_segments), **self._kw())
        return self._threed_rows(log_fdots, fdd, power.cpu().numpy())
