"""Semi-coherent stacked searches over the (f, fdot, fddot) cube.

Port of ``crimp_tpu/ops/semicoherent.py``. The coherent cube pays for fddot
resolution in proportion to T_obs^3. Splitting T_obs into S equal-duration
segments, scanning each coherently at the global phase model and summing
the per-segment Z^2 terms incoherently keeps the (f, fdot) sensitivity
while the fddot spacing each segment needs coarsens by ~S^2, so a
matched-coverage scan runs with ~S^2 fewer fddot trials at the cost of a
sqrt(S)-ish sensitivity loss (stack-slide, astro-ph/0112006).

Numeric contract, as in the JAX package:

- every per-segment statistic is computed at the exact global phase model:
  segment times are not re-centered;
- ``stack="incoherent"`` sums per-segment Z^2 in fixed ascending segment
  order and is bitwise a hand-written per-segment loop over the same padded
  rows;
- ``stack="coherent"`` sums the per-segment trig sums (a re-blocking of the
  event reduction) and matches the monolithic cube to reduction-order
  tolerance.

Per-segment sums run through K2 (``search._grid3d_sums_dispatch``) with the
segment's validity mask as the per-event weights; every row is padded to one
common length.
"""

from __future__ import annotations

import numpy as np
import torch

from crimp_tpu_torch.ops import autotune, search
from crimp_tpu_torch.utils.device import resolve_device


def split_segments(times, n_segments: int):
    """Pad ``times`` into ``n_segments`` equal-duration rows + 0/1 weights.

    Returns (seg_times, seg_weights), both (S, Nmax) f64 numpy; rows are
    padded with zeros carrying zero weight. Segments are equal spans of the
    observation (np.linspace edges), not equal event counts. ``times`` must
    be sorted; raises ValueError otherwise.
    """
    t = np.asarray(times, dtype=np.float64)
    n_segments = int(n_segments)
    if n_segments < 1:
        raise ValueError(f"n_segments must be >= 1, got {n_segments}")
    if t.ndim != 1 or t.size == 0:
        raise ValueError("split_segments needs a non-empty 1-D time array")
    if np.any(np.diff(t) < 0):
        raise ValueError("split_segments needs time-sorted events")
    edges = np.linspace(t[0], t[-1], n_segments + 1)
    # each event lands in exactly one segment; the final edge is inclusive
    bounds = np.searchsorted(t, edges[1:-1], side="left")
    starts = np.concatenate([[0], bounds])
    stops = np.concatenate([bounds, [t.size]])
    n_max = max(1, int(np.max(stops - starts)))
    seg_times = np.zeros((n_segments, n_max), dtype=np.float64)
    seg_weights = np.zeros((n_segments, n_max), dtype=np.float64)
    for i, (lo, hi) in enumerate(zip(starts, stops)):
        seg_times[i, : hi - lo] = t[lo:hi]
        seg_weights[i, : hi - lo] = 1.0
    return seg_times, seg_weights


def stacked_sums_grid(seg_times, seg_weights, f0, df, n_freq, fdots, fddots, nharm: int = 2,
                      poly: bool = True, mxu: bool = False,
                      reseed: int = search.GRID_MXU_RESEED, mxu_bf16: bool = False,
                      device=None, per_split: int | None = None, tile0: int = 0):
    """Per-segment cube trig sums at the global phase model.

    Returns (c, s, counts): c/s (S, n_fddot, n_fdot, nharm, n_freq) f64
    tensors, counts the (S,) valid-event totals (numpy). Each segment goes
    through the grid dispatch (K2, or the factorized path with ``mxu``) with
    its pad mask as the event weights, under one launch plan (``per_split``;
    None resolves it once, ``autotune.resolve_blocks("semicoherent")``);
    ``tile0`` as in ``search._grid3d_sums_dispatch``.
    """
    seg_times = np.asarray(seg_times, dtype=np.float64)
    seg_weights = np.asarray(seg_weights, dtype=np.float64)
    counts = seg_weights.sum(axis=1)
    if per_split is None and not mxu:
        n_rows = np.size(fdots) * np.size(fddots)
        per_split, _ = autotune.resolve_blocks("semicoherent", seg_times.shape[1], int(n_freq) * n_rows, poly,
                                               n_rows=n_rows, nharm=nharm, device=resolve_device(device))
    c_rows, s_rows = [], []
    for i in range(seg_times.shape[0]):
        c, s, _ = search._grid3d_sums_dispatch(
            seg_times[i], f0, df, n_freq, fdots, fddots, nharm, poly=poly, mxu=mxu,
            reseed=reseed, mxu_bf16=mxu_bf16, weights=seg_weights[i], per_split=per_split,
            tile0=tile0, device=device)
        c_rows.append(c)
        s_rows.append(s)
    return torch.stack(c_rows), torch.stack(s_rows), counts


def semicoherent_z2_grid(times, f0, df, n_freq, fdots, fddots, nharm: int = 2,
                         n_segments: int = 8, stack: str = "incoherent", poly: bool = True,
                         mxu: bool = False, reseed: int = search.GRID_MXU_RESEED,
                         mxu_bf16: bool = False, mesh=None, device=None, per_split: int | None = None,
                         tile0: int = 0) -> torch.Tensor:
    """Stacked Z^2 over the uniform (fddot, fdot, freq) cube
    -> (n_fddot, n_fdot, n_freq) f64.

    ``stack="incoherent"`` (the semi-coherent statistic) sums per-segment
    Z^2, each normalized by its own event count, in fixed segment order;
    ``stack="coherent"`` sums the trig sums first (the monolithic coherent
    statistic up to reduction order). An explicit ``mesh`` (a 1-D segment
    mesh, ``parallel.mesh.segment_mesh``) routes the incoherent stack
    through ``parallel.mesh.semicoherent_stack_sharded`` on K2, as in JAX:
    the segment rows padded with inert zero rows to a multiple of the mesh
    size, each shard's segments summed in order, then the shards in order,
    under the loop's launch plan; reduction-order tolerance against the
    loop, bitwise with one segment a shard.
    """
    if stack not in ("incoherent", "coherent"):
        raise ValueError(f"unknown stack mode {stack!r}")
    seg_times, seg_weights = split_segments(times, n_segments)
    if mesh is not None and stack == "incoherent":
        from crimp_tpu_torch.parallel import mesh as pmesh

        pad = (-len(seg_times)) % int(mesh.size)
        if pad:
            seg_times = np.pad(seg_times, ((0, pad), (0, 0)))
            seg_weights = np.pad(seg_weights, ((0, pad), (0, 0)))
        return pmesh.semicoherent_stack_sharded(seg_times, seg_weights, f0, df, n_freq, fdots, fddots, nharm,
                                                mesh, poly=poly, per_split=per_split, tile0=tile0)
    c, s, counts = stacked_sums_grid(seg_times, seg_weights, f0, df, n_freq, fdots, fddots, nharm,
                                     poly, mxu, reseed, mxu_bf16, device, per_split, tile0)
    if stack == "coherent":
        return torch.sum(search.z2_from_sums(torch.sum(c, dim=0), torch.sum(s, dim=0),
                                             float(counts.sum())), dim=2)
    # fixed ascending segment order: the hand-loop bitwise contract
    power = None
    for i in range(c.shape[0]):
        term = torch.sum(search.z2_from_sums(c[i], s[i], max(float(counts[i]), 1.0)), dim=2)
        power = term if power is None else power + term
    return power


def stacked_power_from_phases(phase_segments, nharm: int = 2, statistic: str = "z2",
                              stack: str = "incoherent", poly: bool = False,
                              device=None) -> float:
    """Stacked Z^2/H from already-folded per-segment phases (cycles).

    Ragged per-segment phase lists are reduced per segment with the
    Chebyshev harmonic sums of the search kernels (f32 trig), then stacked.
    For ``statistic="h"`` the H-test applies to the stacked per-harmonic Z^2
    profile. Returns a float.
    """
    if statistic not in ("z2", "h"):
        raise ValueError(f"unknown statistic {statistic!r}")
    if stack not in ("incoherent", "coherent"):
        raise ValueError(f"unknown stack mode {stack!r}")
    dev = resolve_device(device)
    rows = [torch.as_tensor(np.asarray(p, dtype=np.float64).ravel()).to(dev)
            for p in phase_segments if np.size(p)]
    if not rows:
        raise ValueError("stacked_power_from_phases needs >= 1 non-empty segment")
    per_harm = None  # (nharm,) stacked per-harmonic Z^2
    c_tot = s_tot = None
    n_tot = 0.0
    for ph in rows:
        c, s = search._harmonic_sums_cycles(ph, torch.ones_like(ph), nharm, poly=poly)
        if stack == "coherent":
            c_tot = c if c_tot is None else c_tot + c
            s_tot = s if s_tot is None else s_tot + s
            n_tot += float(ph.shape[0])
        else:
            term = search.z2_from_sums(c, s, float(ph.shape[0]))
            per_harm = term if per_harm is None else per_harm + term
    if stack == "coherent":
        per_harm = search.z2_from_sums(c_tot, s_tot, n_tot)
    if statistic == "z2":
        return float(torch.sum(per_harm))
    z2_cum = torch.cumsum(per_harm, dim=0)
    return float(torch.amax(z2_cum - 4.0 * torch.arange(nharm, dtype=torch.float64, device=dev)))


def segment_h_from_model(timMod, seg_times, nharm: int = 5, t_ref_mjd=None,
                         row_block: int | None = None, device=None) -> np.ndarray:
    """Per-segment H-test of a timing model: fold_segments -> stacked rows.

    Folds each segment's events through the anchored fold, pads the ragged
    phase lists into one (S, Nmax) batch and scores every segment with
    h_power_segments_chunked at frequency 1.0 (the phases are already
    cycle-folded). Empty segments score 0.0. Returns (S,) numpy.
    """
    from crimp_tpu_torch.ops import anchored

    seg_phase, _ = anchored.fold_segments(timMod, seg_times, t_ref_mjd=t_ref_mjd, device=device)
    sizes = [np.size(p) for p in seg_phase]
    n_max = max(1, max(sizes, default=1))
    ph = np.zeros((len(seg_phase), n_max), dtype=np.float64)
    mask = np.zeros((len(seg_phase), n_max), dtype=np.float64)
    for i, p in enumerate(seg_phase):
        ph[i, : sizes[i]] = np.asarray(p, dtype=np.float64)
        mask[i, : sizes[i]] = 1.0
    out = search.h_power_segments_chunked(ph, mask, np.ones(len(seg_phase), dtype=np.float64),
                                          nharm=nharm, row_block=row_block, device=device)
    out[np.asarray(sizes) == 0] = 0.0
    return out
