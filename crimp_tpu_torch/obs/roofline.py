"""Roofline join: cost-model rows x kernel spans -> share of the roofline.

Port of ``crimp_tpu/obs/roofline.py``. Given a manifest that carries a
``costmodel`` table (``obs/costmodel.py``) and measured kernel spans (device
time from CUDA events on the card, ``utils/profiling.timed``), compute per
kernel the achieved FLOP/s and bytes/s, the arithmetic intensity, and the
share of the card's roofline reached: achieved FLOP/s over min(peak FLOP/s,
intensity x peak bytes/s), which for a bytes-bound kernel is its bytes over
the time the memory rate needs for them. Surfaced as ``python -m
crimp_tpu_torch.obs roofline`` (``--fail-below PCT`` gates the worst
kernel). A share above 100% is a counting fault, never a result.

Peak table: the NVIDIA H100 SXM (NVIDIA's H100 data sheet, dense rates
without sparsity, at the 700 W power limit): 67 TFLOP/s in f32 outside the
tensor cores, the rate ``PERF.md``'s bounds use for K2 and K3 (K4's
bound is its bytes), 34 TFLOP/s in f64 outside the tensor cores
(``flops_f64``, which rows with ``flops_dtype`` "f64" meet: K5's
``toa_sweep_*`` and K6's ``toa_general_*``), 3.35 TB/s
of HBM3, 900 GB/s of NVLink (no one-card
row uses it). A card set below 700 W runs slower under load: read a share
beside the card's power limit. The CPU entry is JAX's order-of-magnitude
placeholder, kept so CPU runs render; its share is a sanity indicator, not
a measurement. No TPU row: a manifest of the port never runs on one. Rows
whose kernel has cost data but no matching span degrade to partial rows
with a null share; nothing here raises on a sparse manifest.

A row whose spans were primed (``utils/profiling.primed_launches``: the
device time of the launch alone, its launch latency left out) carries
``primed_calls`` and says so in ``render``: its share is the kernel's own,
above what a caller's single launch on an idle card reaches.
"""

from __future__ import annotations

from crimp_tpu_torch.obs.manifest import span_paths

# device kind substring (lowercased, first match wins) -> per-card peaks;
# then the backend name ("cpu")
PEAKS: tuple[tuple[str, dict], ...] = (
    ("h100", {"flops": 67e12, "flops_f64": 34e12, "bytes_per_s": 3.35e12, "ici_bytes_per_s": 900e9,
              "source": "NVIDIA H100 SXM data sheet (f32 67 TFLOP/s and f64 34 TFLOP/s outside the "
                        "tensor cores, HBM3 3.35 TB/s, NVLink 900 GB/s; 700 W)"}),
    ("cpu", {"flops": 1e11, "bytes_per_s": 5e10,
             "ici_bytes_per_s": 1e10,
             "dcn_bytes_per_s": 1e9,
             "source": "CPU fallback placeholder (order of magnitude: one "
                       "AVX2-class core + DDR channel; 'ICI' = shared "
                       "memory fabric placeholder)"}),
)


def peak_for(platform: dict | None) -> dict | None:
    """The peak-table entry for a manifest's platform block, or None.

    Matches the first device's ``kind`` first (the card's name), then the
    backend name (catches bare "cpu").
    """
    plat = platform or {}
    devices = plat.get("devices") or []
    kind = str((devices[0] or {}).get("kind", "")).lower() if devices else ""
    backend = str(plat.get("backend") or "").lower()
    for needle, entry in PEAKS:
        if needle in kind:
            return dict(entry)
    for needle, entry in PEAKS:
        if needle in backend:
            return dict(entry)
    return None


def _leaf_rollup(doc: dict) -> dict[str, dict]:
    """Span durations aggregated by LEAF name (the cost rows' join key).

    The manifest rollup keys on full ``/`` paths; cost rows key on the
    span name ``profiling.timed()``/``obs.span()`` emitted — the leaf.
    """
    out: dict[str, dict] = {}
    for path, row in zip(span_paths(doc), doc.get("spans") or []):
        dur = row.get("dur_s")
        if dur is None:
            continue
        leaf = path.rsplit("/", 1)[-1]
        agg = out.setdefault(leaf, {"sum_s": 0.0, "count": 0})
        agg["sum_s"] += float(dur)
        agg["count"] += 1
        if (row.get("attrs") or {}).get("primed"):
            agg["primed"] = agg.get("primed", 0) + 1
    return out


def analyze(doc: dict) -> dict:
    """The roofline join for one manifest.

    Returns ``{"backend", "device_kind", "peak", "rows", "aggregate",
    "worst_pct", "best_pct"}``. Each row: kernel name, calls, measured
    seconds, flops/bytes from the cost model, achieved flops/s + bytes/s,
    arithmetic intensity (flops/byte), ``pct_of_roof`` (achieved flops
    over the roofline at that intensity — min(peak_flops, intensity *
    peak_bandwidth)), and ``bound`` ("compute" / "memory" by the ridge
    point, or "comm" when the collective dominates — see below).

    Sharded rows (cost rows with ``devices > 1``, whose flops/bytes count
    PER SHARD, as JAX's per-device rows) additionally carry ``devices``,
    the aggregate achieved rates (``agg_flops_per_s``/``agg_bytes_per_s``
    = per card x cards), ``collective_bytes_per_call`` (the registry's
    ring all-reduce estimate, split into
    ``collective_bytes_ici``/``collective_bytes_dcn``
    legs on manifests captured under a multi-process mesh), and
    ``comm_vs_roof`` — the ratio of the estimated collective time (each
    leg priced at its own bandwidth: ICI within a host, DCN across
    hosts) to the per-device compute/memory roofline time; above 1.0 the
    verdict flips to ``bound = "comm"``, with ``comm_leg`` naming the
    dominant leg. Rows captured on a multi-process run carry their
    ``process_index``/``process_count`` stamps (per-host rows). When any sharded row exists, ``aggregate``
    holds the N-device roofline (single-chip peaks x the widest row's
    device count; per-row pct_of_roof is per-device and is unchanged by
    that uniform scaling). A port row also carries ``cards``, the
    distinct devices under its shards: a card that runs several shards
    does all of their work within the call's span, so its share is
    computed from devices / cards shards' counts, and the aggregate roof
    counts cards. Fields degrade to None wherever the manifest
    is partial (CPU rows without cost_analysis, cost rows without a
    matching span, no peak entry).
    """
    plat = doc.get("platform") or {}
    devices = plat.get("devices") or []
    kind = (devices[0] or {}).get("kind") if devices else None
    peak = peak_for(plat)
    durs = _leaf_rollup(doc)
    rows = []
    for name, cost in sorted((doc.get("costmodel") or {}).items()):
        if not isinstance(cost, dict):
            continue
        agg = durs.get(name)
        if agg is None and cost.get("span") \
                and cost["span"] != doc.get("name"):
            # fall back to the enclosing stage span the row was captured
            # under — but never to the run root, whose duration is the
            # whole run and would fabricate a meaningless rate
            agg = durs.get(str(cost["span"]))
        dur = agg["sum_s"] if agg else None
        calls = agg["count"] if agg else 0
        flops = cost.get("flops")
        nbytes = cost.get("bytes_accessed")
        cards = cost.get("cards")
        if isinstance(cards, (int, float)) and cards >= 1 and isinstance(cost.get("devices"), (int, float)):
            # the port's sharded rows count per shard; a card running several
            # shards does all of their work within the call's span
            per_card = float(cost["devices"]) / float(cards)
            flops = flops * per_card if isinstance(flops, (int, float)) else flops
            nbytes = nbytes * per_card if isinstance(nbytes, (int, float)) else nbytes
        # the cost row is per CALL; the rollup sums over calls
        tot_flops = flops * calls if isinstance(flops, (int, float)) else None
        tot_bytes = nbytes * calls if isinstance(nbytes, (int, float)) else None
        fps = tot_flops / dur if tot_flops is not None and dur else None
        bps = tot_bytes / dur if tot_bytes is not None and dur else None
        intensity = (flops / nbytes
                     if isinstance(flops, (int, float))
                     and isinstance(nbytes, (int, float)) and nbytes else None)
        pct = None
        bound = None
        # a row counting operations of another type (K5, K6: f64) meets that
        # type's peak where the table has one
        dtype = cost.get("flops_dtype")
        peak_flops = (peak.get(f"flops_{dtype}") or peak["flops"]) if peak else None
        if peak and intensity is not None:
            roof = min(peak_flops, intensity * peak["bytes_per_s"])
            bound = "compute" if intensity >= peak_flops / peak["bytes_per_s"] else "memory"
            if fps is not None and roof > 0:
                pct = 100.0 * fps / roof
        ndev = cost.get("devices")
        ndev = int(ndev) if isinstance(ndev, (int, float)) and ndev >= 1 else 1
        coll = cost.get("collective_bytes")
        coll = float(coll) if isinstance(coll, (int, float)) else None
        coll_ici = cost.get("collective_bytes_ici")
        coll_ici = (float(coll_ici)
                    if isinstance(coll_ici, (int, float)) else None)
        coll_dcn = cost.get("collective_bytes_dcn")
        coll_dcn = (float(coll_dcn)
                    if isinstance(coll_dcn, (int, float)) else None)
        if coll is not None and coll_ici is None:
            # pre-split manifests: the whole estimate rode ICI
            coll_ici, coll_dcn = coll, 0.0
        comm_vs_roof = None
        comm_leg = None
        if ndev > 1 and peak and peak.get("ici_bytes_per_s") \
                and coll_ici is not None \
                and isinstance(flops, (int, float)) \
                and isinstance(nbytes, (int, float)):
            # per-device, per-call: the time the collective needs on the
            # interconnect (ICI leg + DCN leg, each priced at its own
            # bandwidth) vs the time the compute/memory roofline grants
            # the kernel body — whichever dominates names the binding
            # resource
            t_roof = max(flops / peak_flops, nbytes / peak["bytes_per_s"])
            t_ici = coll_ici / peak["ici_bytes_per_s"]
            t_dcn = ((coll_dcn or 0.0)
                     / (peak.get("dcn_bytes_per_s") or peak["ici_bytes_per_s"]))
            if t_roof > 0:
                comm_vs_roof = (t_ici + t_dcn) / t_roof
                if t_ici or t_dcn:
                    comm_leg = "dcn" if t_dcn > t_ici else "ici"
                if comm_vs_roof > 1.0:
                    bound = "comm"
        rows.append({
            "name": name,
            "calls": calls,
            "sum_s": round(dur, 6) if dur is not None else None,
            "flops_per_call": flops,
            "bytes_per_call": nbytes,
            "flops_per_s": fps,
            "bytes_per_s": bps,
            "intensity": round(intensity, 4) if intensity is not None else None,
            "pct_of_roof": round(pct, 3) if pct is not None else None,
            "bound": bound,
            "devices": ndev,
            "agg_flops_per_s": fps * (int(cards) if cards else ndev) if fps is not None else None,
            "agg_bytes_per_s": bps * (int(cards) if cards else ndev) if bps is not None else None,
            "collective_bytes_per_call": coll,
            "collective_bytes_ici": coll_ici,
            "collective_bytes_dcn": coll_dcn,
            "comm_vs_roof": (round(comm_vs_roof, 3)
                             if comm_vs_roof is not None else None),
            "comm_leg": comm_leg,
            "process_index": cost.get("process_index"),
            "process_count": cost.get("process_count"),
            "peak_bytes": cost.get("peak_bytes"),
            "span": cost.get("span"),
        })
        if dtype:
            rows[-1]["flops_dtype"] = dtype
        if agg and agg.get("primed"):
            rows[-1]["primed_calls"] = agg["primed"]
        if isinstance(cards, (int, float)) and cards >= 1:
            rows[-1]["cards"] = int(cards)
    rows.sort(key=lambda r: -(r["sum_s"] or 0.0))
    pcts = [r["pct_of_roof"] for r in rows if r["pct_of_roof"] is not None]
    shard_devs = [r.get("cards") or r["devices"] for r in rows if (r.get("cards") or r["devices"]) > 1]
    aggregate = None
    if shard_devs and peak:
        n = max(shard_devs)
        aggregate = {
            "devices": n,
            "flops": peak["flops"] * n,
            "bytes_per_s": peak["bytes_per_s"] * n,
            "ici_bytes_per_s": peak.get("ici_bytes_per_s"),
            "dcn_bytes_per_s": peak.get("dcn_bytes_per_s"),
        }
    return {
        "run_id": doc.get("run_id"),
        "backend": plat.get("backend"),
        "device_kind": kind,
        "peak": peak,
        "rows": rows,
        "aggregate": aggregate,
        "worst_pct": min(pcts) if pcts else None,
        "best_pct": max(pcts) if pcts else None,
    }


def _eng(val, unit: str) -> str:
    """Engineering-notation humanization ('1.2 GF/s'); '?' for None."""
    if not isinstance(val, (int, float)):
        return "?"
    for scale, prefix in ((1e12, "T"), (1e9, "G"), (1e6, "M"), (1e3, "k")):
        if abs(val) >= scale:
            return f"{val / scale:.2f} {prefix}{unit}"
    return f"{val:.2f} {unit}"


def render(analysis: dict, top: int = 20) -> str:
    """Human-readable roofline table, heaviest kernels first."""
    peak = analysis.get("peak")
    lines = [f"run      {analysis.get('run_id') or '?'}",
             f"backend  {analysis.get('backend') or 'none recorded'}"
             + (f"  ({analysis['device_kind']})"
                if analysis.get("device_kind") else "")]
    if peak:
        lines.append(
            f"peaks    {_eng(peak['flops'], 'FLOP/s')}  "
            f"{_eng(peak['bytes_per_s'], 'B/s')}  "
            f"ridge {peak['flops'] / peak['bytes_per_s']:.1f} flop/byte  "
            f"[{peak['source']}]")
    else:
        lines.append("peaks    no table entry for this backend; "
                     "%-of-roof unavailable")
    rows = analysis.get("rows") or []
    if not rows:
        lines.append("no cost-model rows in this manifest (CRIMP_TORCH_OBS_COST "
                     "off, or no instrumented kernels ran)")
        return "\n".join(lines)
    lines.append(f"{'kernel':<22} {'calls':>5} {'time':>9} {'flop/call':>10} "
                 f"{'achieved':>12} {'intens':>7} {'%roof':>6} {'dev':>3}"
                 "  bound")
    for r in rows[:top]:
        dur = f"{r['sum_s']:.3f}s" if r["sum_s"] is not None else "?"
        pct = f"{r['pct_of_roof']:.1f}" if r["pct_of_roof"] is not None else "?"
        lines.append(
            f"{r['name']:<22} {r['calls']:>5} {dur:>9} "
            f"{_eng(r['flops_per_call'], 'F'):>10} "
            f"{_eng(r['flops_per_s'], 'F/s'):>12} "
            f"{r['intensity'] if r['intensity'] is not None else '?':>7} "
            f"{pct:>6} {r.get('devices', 1):>3}  {r['bound'] or '?'}")
        if r.get("primed_calls"):
            lines.append(f"  {r['name']}: {r['primed_calls']} of {r['calls']} call(s) primed: the launch's "
                         "device time alone, launch latency left out")
    agg = analysis.get("aggregate")
    if agg:
        lines.append(
            f"sharded  {agg['devices']}-device aggregate roof: "
            f"{_eng(agg['flops'], 'FLOP/s')}  "
            f"{_eng(agg['bytes_per_s'], 'B/s')}  "
            f"ici {_eng(agg.get('ici_bytes_per_s'), 'B/s')}  "
            f"dcn {_eng(agg.get('dcn_bytes_per_s'), 'B/s')}")
        for r in rows[:top]:
            if r.get("devices", 1) <= 1:
                continue
            ratio = r.get("comm_vs_roof")
            coll = (f"collective ici "
                    f"{_eng(r.get('collective_bytes_ici'), 'B')}"
                    f" + dcn {_eng(r.get('collective_bytes_dcn'), 'B')}/call"
                    if r.get("collective_bytes_ici") is not None
                    else "collective "
                    f"{_eng(r['collective_bytes_per_call'], 'B')}/call")
            host = ""
            if isinstance(r.get("process_count"), int) \
                    and r["process_count"] > 1:
                host = (f"  host {r.get('process_index')}"
                        f"/{r['process_count']}")
            leg = f" [{r['comm_leg']}]" if r.get("comm_leg") else ""
            lines.append(
                f"  {r['name']}: x{r['devices']}  "
                f"agg {_eng(r['agg_flops_per_s'], 'F/s')}  "
                f"{coll}"
                f"  t_comm/t_roof "
                f"{ratio if ratio is not None else '?'}{leg}"
                f"  {(r['bound'] or '?') + '-bound'}{host}")
    worst = analysis.get("worst_pct")
    if worst is not None:
        lines.append(f"worst measured kernel: {worst:.2f}% of roof")
    return "\n".join(lines)
