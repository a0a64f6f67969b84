"""Survey-scale multi-source batch engine: stacked fold / fit / H-test / MCMC.

Port of ``crimp_tpu/ops/multisource.py``. The per-source device paths gain
a leading SOURCE axis, so many sources fold, ToA-fit, H-test and sample in
a handful of device calls:

- :class:`StackedAnchoredModel` stacks per-source ``AnchoredModel`` blocks,
  padding ragged anchor/glitch/wave counts to the batch maximum with INERT
  rows (``anchored.pad_anchored``), so every real source's bits are
  untouched;
- whole sources bucket by padded event-count shape (``bucket_sources``,
  ``toafit.bucket_by_pow2`` over sources);
- the fold (``stacked_fold``, the port's ``anchored_fold`` broadcast over
  the source axis), the per-segment H-test and ``fit_segment`` (one
  template per row: ``fit_toas_batch_multi``) run across sources, chunked
  so that one call stays under ~MULTISOURCE_EVENT_BLOCK x
  MULTISOURCE_SOURCE_BLOCK padded cells (``_resolve_chunk``).

Parity contract: the fold is per-event elementwise, so every source's
batched fold bits equal its single-source fold bits regardless of padding.
The fit and the H-test reduce over the padded event axis with
``torch.sum`` (``ops/reduce.event_sum``), whose rounding can depend on the
rows beside a row: they match the single-source survey path
(``pipelines/survey.measure_source_toas``) to that rounding when the
padding is exact (every source in a bucket padded to the width its solo
run uses), not bit for bit. On the card the fit's profile sweeps are K5's,
with a fixed order of event sums a row, so there the fit's columns but the
binned redChi2 are the single-source bits.

The stacked fold shards its source rows over the shards of a source mesh
when the job has several devices of the call's type
(``_maybe_shard_sources``; across processes the global source mesh, each
process folding only its own rows and ``multihost.fetch_global`` gathering
them in rank order): pure data parallelism, bitwise the one-device fold.
``CRIMP_TORCH_SHARD=0`` opts out. The fit and the H-test run on one device.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from crimp_tpu_torch import obs
from crimp_tpu_torch.models import timing
from crimp_tpu_torch.obs import costmodel
from crimp_tpu_torch.models.profiles import ProfileParams
from crimp_tpu_torch.ops import anchored, autotune, search, toafit
from crimp_tpu_torch.ops.anchored import AnchoredModel
from crimp_tpu_torch.resilience import faultinject
from crimp_tpu_torch.utils.device import resolve_device
from crimp_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

MULTISOURCE_EVENT_BLOCK = autotune.MULTISOURCE_EVENT_BLOCK
MULTISOURCE_SOURCE_BLOCK = autotune.MULTISOURCE_SOURCE_BLOCK


@dataclass(frozen=True)
class StackedAnchoredModel:
    """``AnchoredModel`` with a leading source axis on every field (B, ...).

    Field names and meanings mirror :class:`~crimp_tpu_torch.ops.anchored.
    AnchoredModel`; build with :func:`stack_models`.
    """

    const: torch.Tensor  # (B, A)
    taylor: torch.Tensor  # (B, A, 13)
    glep_off: torch.Tensor  # (B, A, G)
    glph: torch.Tensor  # (B, G)
    glf0: torch.Tensor  # (B, G)
    glf1: torch.Tensor  # (B, G)
    glf2: torch.Tensor  # (B, G)
    glf0d: torch.Tensor  # (B, G)
    gltd_sec: torch.Tensor  # (B, G)
    wep_off: torch.Tensor  # (B, A)
    wave_om_sec: torch.Tensor  # (B,)
    wave_a: torch.Tensor  # (B, W)
    wave_b: torch.Tensor  # (B, W)
    f0: torch.Tensor  # (B,)

    @property
    def n_source(self) -> int:
        return int(self.const.shape[0])

    def to(self, device) -> "StackedAnchoredModel":
        return StackedAnchoredModel(**{name: getattr(self, name).to(device) for name in _FIELDS})


_FIELDS = tuple(f.name for f in dataclasses.fields(StackedAnchoredModel))


def stack_models(models: list[AnchoredModel]) -> StackedAnchoredModel:
    """Stack per-source AnchoredModels into one struct-of-arrays block,
    ragged anchor/glitch/wave counts padded to the batch maximum with the
    inert rows of ``anchored.pad_anchored`` (+0.0 on the device)."""
    if not models:
        raise ValueError("stack_models needs at least one model")
    n_anchor = max(m.const.shape[0] for m in models)
    n_glitch = max(m.glph.shape[0] for m in models)
    n_wave = max(m.wave_a.shape[0] for m in models)
    padded = [anchored.pad_anchored(m, n_anchor, n_glitch, n_wave) for m in models]
    return StackedAnchoredModel(**{name: torch.stack([getattr(m, name) for m in padded])
                                   for name in _FIELDS})


def inert_rows(like: StackedAnchoredModel, n: int) -> StackedAnchoredModel:
    """``n`` padding source rows shaped like ``like`` that fold to frac(0):
    zero const/taylor, never-active glitches (glep_off = -inf, gltd_sec =
    1), zero-amplitude waves."""
    A, G, W = like.const.shape[1], like.glph.shape[1], like.wave_a.shape[1]
    z = lambda *shape: torch.zeros(shape, dtype=torch.float64)  # noqa: E731
    row = anchored.pad_anchored(
        AnchoredModel(const=z(A), taylor=z(A, like.taylor.shape[2]), glep_off=z(A, 0), glph=z(0),
                      glf0=z(0), glf1=z(0), glf2=z(0), glf0d=z(0), gltd_sec=z(0), wep_off=z(A),
                      wave_om_sec=torch.tensor(0.0, dtype=torch.float64), wave_a=z(0), wave_b=z(0),
                      f0=torch.tensor(1.0, dtype=torch.float64)),
        A, G, W)
    return StackedAnchoredModel(**{
        name: getattr(row, name)[None].expand(n, *getattr(row, name).shape).clone().to(
            getattr(like, name).device)
        for name in _FIELDS})


def concat_stacked(a: StackedAnchoredModel, b: StackedAnchoredModel) -> StackedAnchoredModel:
    return StackedAnchoredModel(**{name: torch.cat([getattr(a, name), getattr(b, name)])
                                   for name in _FIELDS})


def stacked_fold(sm: StackedAnchoredModel, delta: torch.Tensor, anchor_idx: torch.Tensor) -> torch.Tensor:
    """Cycle-folded phases (B, E) for B sources in one call.

    ``delta`` (B, E) are per-source anchored second offsets padded to the
    bucket width E; ``anchor_idx`` (B, E) their per-event anchor rows
    (padding slots may carry any valid index; their outputs are
    discarded). This is ``anchored.anchored_fold`` with every per-source
    field broadcast over the source axis, operation for operation, so
    each row's bits equal that source's single-model fold.
    """
    rows = torch.arange(delta.shape[0], device=delta.device)[:, None]
    coeffs = sm.taylor[rows, anchor_idx]  # (B, E, 13)
    acc = torch.zeros_like(delta)
    for m in range(coeffs.shape[-1] - 1, -1, -1):
        acc = acc * delta + coeffs[..., m]
    local = acc * delta

    glitch = torch.zeros_like(delta)
    for g in range(sm.glph.shape[1]):
        col = lambda f: f[:, g, None]  # noqa: E731 — per-source scalar against (B, E)
        dt = delta + sm.glep_off[:, :, g][rows, anchor_idx]
        after = dt >= 0.0
        dt = torch.where(after, dt, 0.0)
        recovery = col(sm.gltd_sec) * (1.0 - torch.exp(-dt / col(sm.gltd_sec)))
        contrib = (
            col(sm.glph) + col(sm.glf0) * dt + 0.5 * col(sm.glf1) * dt**2
            + (1.0 / 6.0) * col(sm.glf2) * dt**3 + col(sm.glf0d) * recovery
        )
        glitch = glitch + torch.where(after, contrib, 0.0)

    wave = torch.zeros_like(delta)
    if sm.wave_a.shape[1]:
        base = (delta + sm.wep_off[rows, anchor_idx]) * sm.wave_om_sec[:, None]
        for k in range(1, sm.wave_a.shape[1] + 1):
            arg = float(k) * base
            wave = wave + sm.wave_a[:, k - 1, None] * torch.sin(arg) + sm.wave_b[:, k - 1, None] * torch.cos(arg)
        wave = wave * sm.f0[:, None]

    phase = sm.const[rows, anchor_idx] + local + glitch + wave
    return phase - torch.floor(phase)


# ---------------------------------------------------------------------------
# Source bucketing + dispatch chunking
# ---------------------------------------------------------------------------


def bucket_sources(sizes, max_pad_ratio: float = 4.0, batch_cap: int = 0) -> list[list[int]]:
    """Bucket whole sources by padded size (pow2 merge, then a batch cap).

    ``sizes`` is the per-source padding-relevant size (the survey uses the
    max per-segment event count, the width the fit/H-test pad to).
    ``batch_cap`` > 0 splits each bucket so no dispatch exceeds that many
    sources."""
    buckets = toafit.bucket_by_pow2(sizes, max_pad_ratio)
    if batch_cap and batch_cap > 0:
        split: list[list[int]] = []
        for b in buckets:
            split.extend(b[i:i + batch_cap] for i in range(0, len(b), batch_cap))
        buckets = split
    obs.counter_add("bucket_count", len(buckets))
    return buckets


def _source_chunk(source_block: int, event_block: int, width: int) -> int:
    """Sources per dispatch so a chunk stays under the cell budget
    (~event_block * source_block padded cells), but never below 1."""
    cells = max(1, int(event_block)) * max(1, int(source_block))
    return max(1, min(int(source_block), cells // max(int(width), 1)))


def _resolve_chunk(n_sources: int, width: int) -> int:
    """Sources per dispatch for ``n_sources`` rows of padded ``width``."""
    eb, sb = autotune.multisource_blocks()
    return _source_chunk(sb, eb, width)


# ---------------------------------------------------------------------------
# Batched fold across sources
# ---------------------------------------------------------------------------


def fold_sources(timing_models, seg_times_list, t_ref_list=None, device=None):
    """Anchored fold of MANY sources' ragged segments, batched on ``device``
    (default cuda).

    ``timing_models``: one timing model per source (anything
    ``timing.resolve`` accepts); ``seg_times_list``: one list of per-segment
    MJD arrays per source. Anchors default to each segment's midpoint, as
    in ``anchored.fold_segments``; host prep (longdouble anchor phases,
    re-centered Taylor coefficients) runs per source, then ``stacked_fold``
    folds every source in source-chunked calls. Returns ``(phase_lists,
    t_refs)``: per source, the list of cycle-folded [0,1) segment phases
    and the anchors used. Per source bitwise ``fold_segments`` with the
    delta-fold engine off (the batched path never uses the fold cache).
    """
    dev = resolve_device(device)
    B = len(seg_times_list)
    if B == 0:
        return [], []
    prepped = []
    for src_i, (tm, seg_times) in enumerate(zip(timing_models, seg_times_list)):
        tm = timing.resolve(tm)
        seg_times = [np.atleast_1d(np.asarray(t, dtype=np.float64)) for t in seg_times]
        if t_ref_list is not None and t_ref_list[src_i] is not None:
            t_ref = np.atleast_1d(np.asarray(t_ref_list[src_i], dtype=np.float64))
        else:
            t_ref = np.asarray([(t[-1] - t[0]) / 2 + t[0] if t.size else 0.0 for t in seg_times])
        if t_ref.size == 0:
            # a source with no segments still needs one (dummy) anchor so
            # the stacked gather never indexes an empty table
            t_ref = np.zeros(1)
        sizes = [t.size for t in seg_times]
        anchor_idx = np.repeat(np.arange(len(seg_times)), sizes) if seg_times else np.zeros(0, dtype=np.int64)
        times_cat = np.concatenate(seg_times) if seg_times else np.zeros(0)
        delta = anchored.anchor_deltas(times_cat, t_ref, anchor_idx) if times_cat.size else np.zeros(0)
        am = anchored.prepare_anchors(tm, t_ref)
        prepped.append((am, delta, anchor_idx, sizes, t_ref))
        obs.counter_add("events_folded", int(times_cat.size))
        obs.counter_add("fold_segments", len(seg_times))
    obs.counter_add("sources_batched", B)

    E_max = max(max((p[1].size for p in prepped), default=1), 1)
    chunk = _resolve_chunk(B, E_max)
    folded_rows: list[np.ndarray] = []
    for lo in range(0, B, chunk):
        faultinject.fire("fold_sources")
        part = prepped[lo:lo + chunk]
        sm = stack_models([p[0] for p in part]).to(dev)
        delta_pad = np.zeros((len(part), E_max))
        idx_pad = np.zeros((len(part), E_max), dtype=np.int64)
        for r, (_, delta, anchor_idx, _, _) in enumerate(part):
            delta_pad[r, : delta.size] = delta
            idx_pad[r, : anchor_idx.size] = anchor_idx
        shard = _maybe_shard_sources(len(part), dev)
        if shard is not None:
            folded_rows.extend(_sharded_fold(sm, delta_pad, idx_pad, *shard))
            continue
        delta_dev = torch.as_tensor(delta_pad, device=dev)
        idx_dev = torch.as_tensor(idx_pad, device=dev)
        with costmodel.kernel_span("stacked_fold"):
            rows = stacked_fold(sm, delta_dev, idx_dev)
        costmodel.capture("stacked_fold", None, sm, delta_dev, idx_dev, out=rows)
        folded_rows.extend(rows.cpu().numpy())
    phase_lists, t_refs = [], []
    for (_, delta, _, sizes, t_ref), row in zip(prepped, folded_rows):
        flat = row[: delta.size]
        phase_lists.append(list(np.split(flat, np.cumsum(sizes)[:-1])) if sizes else [])
        t_refs.append(t_ref)
    return phase_lists, t_refs


def _maybe_shard_sources(n: int, dev: torch.device):
    """(source mesh, registry plan, padding rows) when an n-source chunk
    shards, else None: sharding on, the job's shards of ``dev``'s type
    number at least two, and n at least one source a shard. Across
    processes the mesh is ``multihost.global_source_mesh`` (host-major),
    else ``parallel.mesh.source_mesh`` over this process's devices."""
    from crimp_tpu_torch.parallel import mesh as pmesh
    from crimp_tpu_torch.parallel import multihost, registry

    if not pmesh.sharding_enabled():
        return None
    local = pmesh.available_devices()
    if len(local) < 1 or any(d.type != dev.type for d in local):
        return None
    smesh = multihost.global_source_mesh() if multihost.process_identity()[1] > 1 else pmesh.source_mesh(local)
    if smesh.size < 2 or n < smesh.size:
        return None
    return smesh, registry.specs_for("stacked_fold", smesh), pmesh.pad_batch_for_mesh(n, smesh, pmesh.SOURCE_AXIS)


def _sharded_fold(sm: StackedAnchoredModel, delta: np.ndarray, idx: np.ndarray, smesh, plan, pad: int):
    """The chunk's folded rows (numpy, padding dropped) with the source axis
    padded by ``pad`` inert rows and split over ``smesh``: each local shard
    folds its block on its device, then ``fetch_global`` joins every
    process's rows in rank order. Bitwise the one-device fold."""
    from crimp_tpu_torch.parallel import mesh as pmesh
    from crimp_tpu_torch.parallel import multihost

    n = sm.n_source
    if pad:
        sm = concat_stacked(sm, inert_rows(sm, pad))
        delta = np.concatenate([delta, np.zeros((pad,) + delta.shape[1:])])
        idx = np.concatenate([idx, np.zeros((pad,) + idx.shape[1:], dtype=idx.dtype)])
    total = n + pad
    if smesh.group is not None:
        lo, hi = multihost.process_local_rows(total)

        def put(arr):
            return multihost.global_array(np.asarray(arr)[lo:hi], smesh, plan.spec("rows"), np.shape(arr))
    else:
        def put(arr):
            return pmesh.shard_sources(arr, smesh)
    fields = {name: put(getattr(sm, name).cpu().numpy()) for name in _FIELDS}
    d_sh, i_sh = put(delta), put(idx)

    def fold(slot, d_blk, i_blk, *field_blks):
        return stacked_fold(StackedAnchoredModel(**dict(zip(_FIELDS, field_blks))), d_blk, i_blk)

    with costmodel.kernel_span("stacked_fold"):
        parts = pmesh.map_blocks(fold, d_sh, i_sh, *(fields[name] for name in _FIELDS))
    folded = pmesh.Sharded(smesh, plan.spec("rows"), delta.shape,
                           [(slot, lo, hi, out) for (slot, lo, hi, _), out in zip(d_sh.blocks, parts)])
    rows = multihost.fetch_global(folded)[:n]
    costmodel.capture("stacked_fold", None, sm, delta, idx, out=rows, plan=plan)
    return list(rows)


# ---------------------------------------------------------------------------
# Batched ToA fit across sources
# ---------------------------------------------------------------------------


def fit_toas_batch_multi(kind: str, tpls: ProfileParams, phases, masks, exposures, cfg: toafit.ToAFitConfig,
                         device=None) -> dict:
    """``toafit.fit_toas_batch`` with a PER-ROW template: ``tpls`` carries a
    leading row axis on every field (one template per padded segment row),
    for sources that share the profile family, component count and fit
    config but not the template. Returns a dict of tensors on ``device``."""
    dev = resolve_device(device)
    x = torch.as_tensor(phases, dtype=torch.float64).to(dev)
    mask = torch.as_tensor(masks, dtype=torch.bool).to(dev)
    exposure = torch.as_tensor(exposures, dtype=torch.float64).to(dev)
    with torch.no_grad():
        return toafit.fit_segment(kind, tpls.to(dev), x, mask, exposure, cfg)


def _templates_identical(tpls) -> bool:
    first = tpls[0]
    for t in tpls[1:]:
        for f in dataclasses.fields(first):
            a, b = getattr(first, f.name), getattr(t, f.name)
            if a.shape != b.shape or not torch.equal(a, b):
                return False
    return True


def fit_sources(kind, tpls, phase_lists, exposure_list, cfg, device=None):
    """ToA-fit every segment of every source in batched calls.

    ``tpls``: one ProfileParams per source (same family ``kind`` and
    component count: group sources before calling); ``phase_lists``: the
    per-source lists of folded segment phases (radians already applied for
    the CAUCHY/VONMISES families); ``exposure_list``: per-source exposure
    arrays. All (source, segment) rows flatten into ONE segment batch
    padded to the bucket-wide max width. A bitwise-shared template takes
    ``toafit.fit_toas_batch_auto``; otherwise the per-row-template fit
    runs. Returns the flat numpy result dict plus the per-source row
    slices.
    """
    rows: list[np.ndarray] = []
    row_tpl_idx: list[int] = []
    exposures: list[float] = []
    slices: list[slice] = []
    for src_i, (plist, exps) in enumerate(zip(phase_lists, exposure_list)):
        start = len(rows)
        rows.extend(plist)
        row_tpl_idx.extend([src_i] * len(plist))
        exposures.extend(np.asarray(exps, dtype=float).tolist())
        slices.append(slice(start, len(rows)))
    if not rows:
        return {}, slices
    phases, masks = toafit.pad_segments(rows)
    exposures = np.asarray(exposures, dtype=float)
    if _templates_identical(tpls):
        out = toafit.fit_toas_batch_auto(kind, tpls[0], phases, masks, exposures, cfg, device=device)
    else:
        obs.counter_add("toas_fit", len(rows))
        cfg = toafit.resolve_runtime_cfg(cfg, phases.shape[0], phases.shape[1], device=device)
        idx = torch.as_tensor(row_tpl_idx)
        tpl_rows = ProfileParams(**{f.name: torch.stack([getattr(t, f.name) for t in tpls])[idx]
                                    for f in dataclasses.fields(tpls[0])})
        with costmodel.kernel_span("toa_fit_batch_multi"):
            out = fit_toas_batch_multi(kind, tpl_rows, phases, masks, exposures, cfg, device=device)
        costmodel.capture("toa_fit_batch_multi", None, kind, tpl_rows, phases, masks, exposures, cfg)
        out = {k: v.cpu().numpy() for k, v in out.items()}
    return out, slices


# ---------------------------------------------------------------------------
# Batched per-ToA H-test across sources
# ---------------------------------------------------------------------------


def h_power_sources(seg_times_list, freqs_list, nharm: int = 5, device=None):
    """Per-ToA H-test for every (source, segment) row in chunked batches.

    ``seg_times_list``: per source, the list of per-segment event MJD
    arrays; ``freqs_list``: per source, the per-segment trial frequency
    (the local ephemeris frequency at the ToA epoch). Rows are centered to
    seconds as in the single-source pipeline and run through
    ``search.h_power_segments_chunked``.
    Returns one (S_i,) H-power array per source.
    """
    rows, freqs, slices = [], [], []
    for seg_times, fs in zip(seg_times_list, freqs_list):
        start = len(rows)
        for t_seg in seg_times:
            t_seg = np.asarray(t_seg, dtype=np.float64)
            rows.append((t_seg - (t_seg[0] + t_seg[-1]) / 2) * 86400.0 if t_seg.size else t_seg)
        freqs.extend(np.asarray(fs, dtype=float).tolist())
        slices.append(slice(start, len(rows)))
    if not rows:
        return [np.zeros(0) for _ in seg_times_list]
    width = max(max((r.size for r in rows), default=1), 1)
    sec_padded = np.zeros((len(rows), width))
    sec_masks = np.zeros((len(rows), width), dtype=bool)
    for i, r in enumerate(rows):
        sec_padded[i, : r.size] = r
        sec_masks[i, : r.size] = True
    chunk = _resolve_chunk(len(rows), width)
    h = np.asarray(search.h_power_segments_chunked(sec_padded, sec_masks, np.asarray(freqs), nharm=nharm,
                                                   row_block=chunk, device=device))
    return [h[s] for s in slices]


# ---------------------------------------------------------------------------
# Survey-scale posteriors: batched delta-basis MCMC across the source axis
# ---------------------------------------------------------------------------


def source_seed(seed: int, index: int) -> int:
    """The per-source generator seed, a function of (seed, source index)
    alone, so the draws do not depend on how the sources are chunked."""
    return int(np.random.SeedSequence([int(seed), int(index)]).generate_state(1, dtype=np.uint64)[0]
               & ((1 << 63) - 1))


def sample_posterior_sources(problems, steps: int, walkers: int, seed: int = 0, stretch_a: float = 2.0,
                             draws=None, chunk: int | None = None, device=None):
    """Delta-basis ensemble MCMC for MANY sources in chunked batch calls.

    ``problems`` is one dict per source with ``basis`` (n_i, ndim), ``y``
    (n_i,), ``err`` (n_i,) and ``lo``/``hi`` (ndim,): the
    ``mcmc.delta_logprob`` data, typically from
    ``pipelines.fit_toas.make_logprob_delta``. All sources share ``ndim``;
    ragged ToA counts pad to the batch max with INERT rows (``mask == 0``)
    whose every log-probability term is exactly +0.0.

    Walkers start uniformly inside each source's prior box from
    ``np.random.default_rng([seed, i])``, as in the JAX package. The
    sampler's random numbers are ``draws`` when given (``mcmc.Draws``, each
    (steps, B, walkers): e.g. the JAX package's per-source streams), else a
    per-source ``torch.Generator`` seeded from ``(seed, i)``
    (``source_seed``). Both are functions of the source index alone, so the
    result does not depend on the chunking (``chunk`` sources per call;
    None: ``_resolve_chunk``). On the card each chunk runs from replayed
    CUDA graphs.

    Returns (chains (B, steps, walkers, ndim), log_probs (B, steps,
    walkers)) as numpy arrays.
    """
    from crimp_tpu_torch.ops import mcmc as mcmc_ops

    dev = resolve_device(device)
    if not problems:
        return np.zeros((0, steps, walkers, 0)), np.zeros((0, steps, walkers))
    ndims = {np.asarray(p["basis"]).shape[1] for p in problems}
    if len(ndims) != 1:
        raise ValueError(f"all sources must share ndim, got {sorted(ndims)}")
    (ndim,) = ndims
    B = len(problems)
    n_max = max(np.asarray(p["basis"]).shape[0] for p in problems)

    basis = np.zeros((B, n_max, ndim))
    y = np.zeros((B, n_max))
    err = np.ones((B, n_max))  # padded rows keep err = 1 so log() stays finite
    mask = np.zeros((B, n_max))
    lo = np.empty((B, ndim))
    hi = np.empty((B, ndim))
    p0 = np.empty((B, walkers, ndim))
    for i, p in enumerate(problems):
        nb = np.asarray(p["basis"], dtype=np.float64)
        n = nb.shape[0]
        basis[i, :n] = nb
        y[i, :n] = np.asarray(p["y"], dtype=np.float64)
        err[i, :n] = np.asarray(p["err"], dtype=np.float64)
        mask[i, :n] = 1.0
        lo[i] = np.asarray(p["lo"], dtype=np.float64)
        hi[i] = np.asarray(p["hi"], dtype=np.float64)
        rng = np.random.default_rng([seed, i])
        for d in range(ndim):
            p0[i, :, d] = rng.uniform(lo[i, d], hi[i, d], size=walkers)

    if chunk is None:
        chunk = _resolve_chunk(B, n_max * max(walkers, 1))
    obs.counter_add("mcmc_sources_batched", B)
    chains = np.empty((B, steps, walkers, ndim))
    lps = np.empty((B, steps, walkers))
    graph_steps = mcmc_ops.GRAPH_STEPS if dev.type == "cuda" else 0
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    with obs.span("mcmc_sources", sources=B, steps=steps, walkers=walkers, chunk=chunk, n_toas_padded=n_max):
        for start in range(0, B, chunk):
            sl = slice(start, min(start + chunk, B))
            data = {"basis": t(basis[sl]), "y": t(y[sl]), "err": t(err[sl]), "mask": t(mask[sl]),
                    "lo": t(lo[sl]), "hi": t(hi[sl])}
            if draws is None:
                parts = [mcmc_ops.ensemble_draws(steps, walkers, source_seed(seed, i), device=dev)
                         for i in range(sl.start, sl.stop)]
                fed = mcmc_ops.Draws(*(torch.stack(d, dim=1) for d in zip(*parts)))
            else:
                fed = mcmc_ops.Draws(*(d[:, sl].to(dev) for d in draws))
            with costmodel.kernel_span("mcmc_ensemble_sources"):
                c_t, l_t = mcmc_ops.ensemble_sample_draws(mcmc_ops.delta_logprob, t(p0[sl]), fed, stretch_a,
                                                          data=data, graph_steps=graph_steps)
            costmodel.capture("mcmc_ensemble_sources", None, p0[sl], data, steps, out=c_t)
            chains[sl] = c_t.movedim(0, 1).cpu().numpy()
            lps[sl] = l_t.movedim(0, 1).cpu().numpy()
    return chains, lps
