"""Survey-scale ToA measurement: many pulsars per device call.

Port of ``crimp_tpu/pipelines/survey.py``. The per-source pipeline
(``pipelines/measure_toas.py``) runs one pulsar end to end; this module
lifts it to fleet scale on the ``ops/multisource`` batch engine:
per-source timing models stack into struct-of-arrays blocks, whole sources
bucket by padded event-count shape, and the anchored fold, the per-ToA
H-test and the template fit run across the source axis.

Failure domain: one pathological source (empty interval, malformed
model/template, a bucket-level device failure) degrades to the
single-source path, ``measure_source_toas``, instead of poisoning its
batch. A failed bucket first splits in two and retries (the multisource
ladder: batched -> split_bucket -> per_source); a source whose solo run
also fails gets ``None``, its classified error in ``last_survey_info()``.
Unlike the JAX package, no source is re-run on the CPU after a device
failure: the survey's work stays on the device it was given. A
``KernelError`` (a hand kernel that failed to build or launch) is never
taken down any of these rungs: it propagates.

Parity contract: when the padding is exact (every source in a bucket
padded to the width its solo run uses: equal max segment event counts, and
a segment-size ratio that keeps the solo path off its own bucketed
branch), the batched path equals ``measure_source_toas`` looped over
sources in every column but those of the fit and the H-test. Those sum
events with ``torch.sum`` (``ops/reduce.py``), whose rounding can depend
on the rows beside a source: phShift agrees within 1e-6 rad, phShift_LL/UL
within one profile step, Hpower within 1e-5 relative (f32 sums) and
redChi2 within 1e-6 relative. On the card the fit's profile sweeps are
K5's (``ops/toafit.profile_sweep``), whose event sums run in a fixed order
a row, so there phShift, its bounds, norm, ampShift and logLmax are the
solo run's bits; redChi2 and the H-test keep the tolerances. The fold under them is bitwise
(``ops/multisource.stacked_fold``). Results are column dicts (``SURVEY_TOA_COLUMNS``), as the
port's ``measure_toas`` returns.

Knobs (``ops/autotune.resolve_multisource``): ``CRIMP_TORCH_MULTISOURCE=0``
forces the per-source loop; ``CRIMP_TORCH_MULTISOURCE_MAX_PAD`` caps the
bucket-merge padding waste; ``CRIMP_TORCH_MULTISOURCE_BATCH`` caps
sources per call.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

import numpy as np

from crimp_tpu_torch import obs, resilience
from crimp_tpu_torch.io import template as template_io
from crimp_tpu_torch.io.table import read_columns
from crimp_tpu_torch.models import profiles, timing
from crimp_tpu_torch.ops import anchored, autotune, multisource, search, toafit
from crimp_tpu_torch.ops.ephem import spin_frequency_host
from crimp_tpu_torch.parallel import multihost
from crimp_tpu_torch.resilience import faultinject
from crimp_tpu_torch.utils.device import resolve_device
from crimp_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

SURVEY_TOA_COLUMNS = [
    "ToA", "ToA_mid", "ToA_start", "ToA_end", "ToA_lenInt", "ToA_exp",
    "nbr_events", "count_rate", "phShift", "phShift_LL", "phShift_UL",
    "Hpower", "redChi2",
]

_last_info: dict = {}


def last_survey_info() -> dict:
    """Telemetry of the most recent survey_measure_toas call: source counts
    per path, per-source errors and demotions, bucket layout and padding
    occupancy."""
    return dict(_last_info)


@dataclass
class SourceSpec:
    """One survey target, in memory.

    ``times``: event MJDs (sorted); ``timing_model``: anything
    ``timing.resolve`` accepts (TimingParams, parameter dict, .par path);
    ``template``: a template dict (``template_io.read_template``'s shape) or
    a path to one; ``intervals``: the ToA interval table, a column dict with
    ``ToA_tstart`` / ``ToA_tend`` / ``ToA_exposure`` (``ToA_lenInt``
    optional) or a path to a whitespace interval file.
    """

    name: str
    times: np.ndarray
    timing_model: object
    template: object
    intervals: object

    def interval_columns(self) -> dict:
        if isinstance(self.intervals, dict):
            return self.intervals
        return read_columns(self.intervals)

    def template_dict(self) -> dict:
        if isinstance(self.template, dict):
            return self.template
        return template_io.read_template(self.template)


@dataclass
class _Prepped:
    """Host-side per-source prep shared by the batched and solo paths."""

    spec: SourceSpec
    tm: object
    kind: str
    tpl: object
    cfg: object
    seg_times: list = field(default_factory=list)
    starts: np.ndarray = None
    ends: np.ndarray = None
    exposures: np.ndarray = None
    len_int: np.ndarray = None

    @property
    def max_seg(self) -> int:
        return max((t.size for t in self.seg_times), default=0)


def _build_cfg(kind: str, phShiftRes: int, nbrBins: int, varyAmps: bool):
    # the non-readvaryparam branch of measure_toas: ampShift box bounds per
    # family
    amp_lo, amp_hi = {
        profiles.FOURIER: (0.01, 100.0),
        profiles.CAUCHY: (1e-6, 1e6),
        profiles.VONMISES: (1e-6, 500.0),
    }[kind]
    return toafit.ToAFitConfig(kind=kind, ph_shift_res=phShiftRes, nbins=nbrBins, vary_amps=varyAmps,
                               amp_lo=amp_lo, amp_hi=amp_hi)


def _prep_source(spec: SourceSpec, phShiftRes: int, nbrBins: int, varyAmps: bool) -> _Prepped:
    tm = timing.resolve(spec.timing_model)
    kind, tpl = profiles.from_template(spec.template_dict())
    intervals = spec.interval_columns()
    starts = np.asarray(intervals["ToA_tstart"], dtype=np.float64)
    ends = np.asarray(intervals["ToA_tend"], dtype=np.float64)
    exposures = np.asarray(intervals["ToA_exposure"]).astype(float)
    len_int = intervals["ToA_lenInt"] if "ToA_lenInt" in intervals else ends - starts
    times = np.asarray(spec.times, dtype=np.float64)
    seg_times = toafit.slice_sorted_intervals(times, starts, ends)
    for ii, t_seg in enumerate(seg_times):
        if t_seg.size == 0:
            raise ValueError(f"source {spec.name!r}: ToA interval {ii} contains no events")
    return _Prepped(spec=spec, tm=tm, kind=kind, tpl=tpl, cfg=_build_cfg(kind, phShiftRes, nbrBins, varyAmps),
                    seg_times=seg_times, starts=starts, ends=ends, exposures=exposures,
                    len_int=np.asarray(len_int, dtype=float))


def _assemble_frame(prep: _Prepped, toa_mids, results: dict, h_powers) -> dict:
    n_seg = len(prep.seg_times)
    nbr_events = np.asarray([t.size for t in prep.seg_times])
    return {
        "ToA": np.arange(n_seg),
        "ToA_mid": np.asarray(toa_mids),
        "ToA_start": prep.starts[:n_seg],
        "ToA_end": prep.ends[:n_seg],
        "ToA_lenInt": prep.len_int[:n_seg],
        "ToA_exp": prep.exposures[:n_seg],
        "nbr_events": nbr_events,
        "count_rate": nbr_events / prep.exposures[:n_seg],
        "phShift": np.asarray(results["phShift"]),
        "phShift_LL": np.asarray(results["phShift_LL"]),
        "phShift_UL": np.asarray(results["phShift_UL"]),
        "Hpower": np.asarray(h_powers),
        "redChi2": np.asarray(results["redChi2"]),
    }


def _empty_frame() -> dict:
    return {c: np.zeros(0) for c in SURVEY_TOA_COLUMNS}


def _centered_seconds(seg_times: list[np.ndarray]) -> tuple[np.ndarray, np.ndarray]:
    n_max = max((t.size for t in seg_times), default=1)
    sec = np.zeros((len(seg_times), max(n_max, 1)))
    msk = np.zeros(sec.shape, dtype=bool)
    for i, t_seg in enumerate(seg_times):
        if t_seg.size:
            sec[i, : t_seg.size] = (t_seg - (t_seg[0] + t_seg[-1]) / 2) * 86400.0
            msk[i, : t_seg.size] = True
    return sec, msk


def measure_source_toas(spec: SourceSpec, phShiftRes: int = 1000, nbrBins: int = 15, varyAmps: bool = False,
                        _prep: _Prepped | None = None, delta_fold=None, device=None) -> dict:
    """Single-source in-memory ToA measurement on ``device`` (default cuda):
    the survey's per-source fallback AND its parity reference.

    Mirrors ``measure_toas`` (anchored per-interval fold, padded batch fit
    with the same size-ratio bucketing branch, per-ToA H-test at the local
    ephemeris frequency) without its file outputs; returns the per-source
    ToA column dict (SURVEY_TOA_COLUMNS). ``delta_fold`` passes through to
    ``anchored.fold_segments`` (None: its knob, off by default).
    """
    dev = resolve_device(device)
    prep = _prep if _prep is not None else _prep_source(spec, phShiftRes, nbrBins, varyAmps)
    if not prep.seg_times:
        return _empty_frame()
    seg_phase_list, toa_mids = anchored.fold_segments(prep.tm, prep.seg_times, cache_tag=spec.name,
                                                      delta_fold=delta_fold, device=dev)
    if prep.kind in (profiles.CAUCHY, profiles.VONMISES):
        seg_phase_list = [p * (2 * np.pi) for p in seg_phase_list]
    seg_sizes = [t.size for t in prep.seg_times]
    if max(seg_sizes) / max(min(seg_sizes), 1) > 4.0:
        results = toafit.fit_toas_bucketed(prep.kind, prep.tpl, seg_phase_list, prep.exposures, prep.cfg,
                                           device=dev)
    else:
        phases, masks = toafit.pad_segments(seg_phase_list)
        results = toafit.fit_toas_batch_auto(prep.kind, prep.tpl, phases, masks, prep.exposures, prep.cfg,
                                             device=dev)
    freqs_mid, _ = spin_frequency_host(prep.tm, toa_mids)
    sec, msk = _centered_seconds(prep.seg_times)
    h_powers = search.h_power_segments(sec, msk, freqs_mid, nharm=5, device=dev)
    return _assemble_frame(prep, toa_mids, results, h_powers.cpu().numpy())


def compute_bucket(ps: list[_Prepped], phase_lists=None, t_refs=None, device=None):
    """Batched fold + fit + H-test for one bucket of prepped sources.

    ``ps`` share (kind, cfg, n_comp), the grouping the survey
    applies before bucketing. Returns ``(frames, phase_lists, t_refs)``:
    the per-source ToA column dicts plus the raw cycle-folded phase lists
    and anchors (before any radians conversion). Callers that already hold
    the cycle-folded phases pass ``phase_lists``/``t_refs`` (both, aligned
    with ``ps``) to skip the fold.
    """
    dev = resolve_device(device)
    kind, cfg = ps[0].kind, ps[0].cfg
    if phase_lists is None or t_refs is None:
        phase_lists, t_refs = multisource.fold_sources([p.tm for p in ps], [p.seg_times for p in ps],
                                                       device=dev)
    fit_lists = phase_lists
    if kind in (profiles.CAUCHY, profiles.VONMISES):
        fit_lists = [[ph * (2 * np.pi) for ph in pl] for pl in phase_lists]
    results, slices = multisource.fit_sources(kind, [p.tpl for p in ps], fit_lists, [p.exposures for p in ps],
                                              cfg, device=dev)
    freqs_list = [spin_frequency_host(p.tm, t_refs[r])[0] for r, p in enumerate(ps)]
    h_list = multisource.h_power_sources([p.seg_times for p in ps], freqs_list, device=dev)
    frames = []
    for r, p in enumerate(ps):
        res_r = {k: v[slices[r]] for k, v in results.items()}
        frames.append(_assemble_frame(p, t_refs[r], res_r, h_list[r]) if p.seg_times else _empty_frame())
    return frames, phase_lists, t_refs


def survey_measure_toas(specs, phShiftRes: int = 1000, nbrBins: int = 15, varyAmps: bool = False,
                        device=None) -> list[dict | None]:
    """Measure ToAs for MANY sources in batched calls on ``device`` (default
    cuda).

    Returns one column dict per spec (order preserved); ``None`` for sources
    whose fallback also failed (the error in :func:`last_survey_info`).
    Flight-recorded as an obs run with ``sources_batched`` /
    ``bucket_count`` / ``bucket_occupancy_pct`` telemetry and an
    ``obs.beat(label="sources")`` heartbeat per bucket. On a multi-process
    job bucket assignment never consults the rank; only the per-source
    fallback is rank-partitioned (source i is retried by rank i mod world).
    """
    dev = resolve_device(device)
    # every knob resolved inside reads the verdict cache once
    with obs.run("survey_measure_toas"), autotune.entries_scope(autotune.load_entries()):
        return _survey_impl(list(specs), phShiftRes, nbrBins, varyAmps, dev)


def _survey_impl(specs, phShiftRes, nbrBins, varyAmps, dev):
    global _last_info
    pidx, pcount = multihost.process_identity()
    n_total = len(specs)
    frames: list[dict | None] = [None] * n_total
    # per-source failure records: {"kind", "type", "message"}, classified
    errors: dict[str, dict] = {}
    demoted: dict[str, str] = {}
    preps: dict[int, _Prepped] = {}
    fallback: list[int] = []

    for i, spec in enumerate(specs):
        try:
            preps[i] = _prep_source(spec, phShiftRes, nbrBins, varyAmps)
        except Exception as exc:  # per-source failure domain
            demoted[spec.name] = f"prep: {resilience.classify(exc).value}: {type(exc).__name__}: {exc}"
            fallback.append(i)

    max_events = max((p.max_seg for p in preps.values()), default=1)
    resolved = autotune.resolve_multisource(n_total, max(max_events, 1), device=dev)
    batched = sorted(preps)
    if not resolved["multisource"]:
        for i in batched:
            demoted[specs[i].name] = "knob: multisource off"
        fallback.extend(batched)
        batched = []

    # group sources whose fits share (kind, cfg, n_comp), then bucket each
    # group by padded width
    groups: dict[tuple, list[int]] = {}
    for i in batched:
        p = preps[i]
        groups.setdefault((p.kind, p.cfg, int(p.tpl.n_comp)), []).append(i)
    buckets: list[list[int]] = []
    for members in groups.values():
        for b in multisource.bucket_sources([max(preps[i].max_seg, 1) for i in members],
                                            max_pad_ratio=resolved["max_pad"], batch_cap=resolved["batch_cap"]):
            buckets.append([members[j] for j in b])

    done = 0
    occ_used = occ_total = 0
    splits = 0
    obs.beat(0, n_total, label="sources", force=True)
    queue = deque(buckets)
    while queue:
        bucket = queue.popleft()
        ps = [preps[i] for i in bucket]
        try:
            faultinject.fire("survey_bucket")
            bucket_frames, _, _ = compute_bucket(ps, device=dev)
            width = max(max((p.max_seg for p in ps), default=1), 1)
            for i, p, frame in zip(bucket, ps, bucket_frames):
                frames[i] = frame
                occ_used += sum(t.size for t in p.seg_times)
                occ_total += width * len(p.seg_times)
        except resilience.KernelError:
            raise
        except Exception as exc:  # the bucket failure domain walks the
            # multisource ladder: split the batch in two and retry (an OOM'd
            # bucket usually fits as two halves); only a one-source bucket
            # demotes to the per-source path
            fkind = resilience.classify(exc)
            if len(bucket) > 1:
                mid = (len(bucket) + 1) // 2
                queue.appendleft(bucket[mid:])
                queue.appendleft(bucket[:mid])
                splits += 1
                resilience.record_degradation("multisource", "split_bucket", fkind)
                logger.warning("survey bucket of %d failed (%s); splitting and retrying", len(bucket),
                               fkind.value, exc_info=True)
                continue  # halves re-enter the queue; done is unchanged
            resilience.record_degradation("multisource", "per_source", fkind)
            logger.warning("survey bucket failed (%s); falling back per source", fkind.value, exc_info=True)
            for i in bucket:
                demoted[specs[i].name] = f"bucket: {fkind.value}: {type(exc).__name__}: {exc}"
            fallback.extend(bucket)
        done += len(bucket)
        obs.beat(done, n_total, label="sources")

    n_batched = sum(1 for f in frames if f is not None)
    # each demoted source is retried by exactly one rank
    owned = [i for i in sorted(fallback) if i % pcount == pidx]
    for i in owned:
        try:
            frames[i] = measure_source_toas(specs[i], phShiftRes, nbrBins, varyAmps, _prep=preps.get(i),
                                            device=dev)
        except resilience.KernelError:
            raise
        except Exception as exc:  # per-source domain: a classified record
            errors[specs[i].name] = resilience.error_record(exc)
        done = min(done + 1, n_total)
        obs.beat(done, n_total, label="sources")
    obs.beat(n_total, n_total, label="sources", force=True)

    occupancy = 100.0 * occ_used / occ_total if occ_total else 100.0
    obs.gauge_set("bucket_occupancy_pct", round(occupancy, 2))
    _last_info = {
        "n_sources": n_total,
        "n_batched": n_batched,
        "process_index": pidx,
        "process_count": pcount,
        "n_fallback": len(fallback),
        "n_failed": sum(1 for f in frames if f is None),
        "bucket_count": len(buckets),
        "bucket_splits": splits,
        "occupancy_pct": round(occupancy, 2),
        "demoted": demoted,
        "errors": errors,
        "device": str(dev),
    }
    if demoted or errors:
        logger.info("survey fallback summary: %s", _last_info)
    return frames
