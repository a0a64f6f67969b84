"""Multi-host trace aggregation: join per-host event streams into one manifest.

Port of ``crimp_tpu/obs/merge.py``. A multi-host run writes one
``<run_id>.host<k>.events.jsonl`` stream (and heartbeat sidecar) per
process; coordinated run_ids come from ``obs.core`` dropping the pid from
multi-host run ids (``CRIMP_TORCH_OBS_HOST`` or the ``torch.distributed``
rank names the host). No single host
ever holds the whole picture, so ``obs merge`` replays every per-host
stream through the salvage machinery (torn tails on killed hosts are
tolerated by construction) and joins them BY RUN_ID into one document:

- one synthetic run root whose children are per-host subtree roots named
  ``host<k>`` (kind ``"host"``); every merged span carries a ``"host"``
  field, which the Chrome-trace exporter turns into per-host lanes
  (pid = host + 1) and the Prometheus exporter into a ``host`` label;
- counters are summed across hosts (they are monotonic totals), gauges
  take the per-key max (high-water semantics; per-host values survive in
  ``hosts[]``), cost-model rows are unioned (SPMD hosts capture identical
  rows, so collisions are re-captures, not conflicts);
- ``wall_s`` is the max across hosts; ``"merged": true`` and a
  ``hosts[]`` table (per-host run_id/wall/error/salvaged/counters/gauges)
  mark the document, and it passes ``validate_manifest`` with zero
  problems so ``summary`` and ``diff`` consume it
  like any single-host manifest.

Import-safe: pure event-stream and dict work.
"""

from __future__ import annotations

import glob
import json
import os
import re

from crimp_tpu_torch.obs import salvage as slv

_HOST_STEM_RE = re.compile(r"\.host(\d+)$")


def resolve_streams(targets: list[str],
                    run_id: str | None = None) -> list[str]:
    """Expand CLI targets into event-stream paths.

    A single directory target selects one run's host streams: all
    ``*.events.jsonl`` are grouped by run_id (the stem with any
    ``.host<k>`` suffix stripped). With ``run_id`` the matching group is
    chosen (exact stem, else unique substring — enough of the id to be
    unambiguous works); otherwise the most recently touched group wins.
    Explicit file lists pass through untouched.
    """
    if len(targets) == 1 and os.path.isdir(targets[0]):
        streams = glob.glob(os.path.join(targets[0], "*.events.jsonl"))
        if not streams:
            raise FileNotFoundError(f"{targets[0]}: no *.events.jsonl streams")
        groups: dict[str, list[str]] = {}
        for s in streams:
            stem = os.path.basename(s)[: -len(".events.jsonl")]
            stem = _HOST_STEM_RE.sub("", stem)
            groups.setdefault(stem, []).append(s)
        if run_id is not None:
            if run_id in groups:
                return sorted(groups[run_id])
            hits = [k for k in groups if run_id in k]
            if len(hits) != 1:
                raise FileNotFoundError(
                    f"{targets[0]}: run_id {run_id!r} matches "
                    f"{sorted(hits) if hits else 'no'} stream group(s) of "
                    f"{sorted(groups)}")
            return sorted(groups[hits[0]])
        best = max(groups.values(),
                   key=lambda g: max(os.path.getmtime(s) for s in g))
        return sorted(best)
    if run_id is not None:
        raise ValueError(
            "obs merge: --run-id selects a group within a directory "
            "target; drop it when listing stream files explicitly")
    return list(targets)


def _host_of(path: str, doc: dict, used: set[int], ordinal: int) -> int:
    """Host index for one stream: the run_start's ``host`` field, else the
    ``.host<k>`` filename suffix, else the first free ordinal."""
    h = doc.get("host")
    if isinstance(h, int) and h not in used:
        return h
    m = _HOST_STEM_RE.search(
        os.path.basename(path).replace(".events.jsonl", ""))
    if m and int(m.group(1)) not in used:
        return int(m.group(1))
    while ordinal in used:
        ordinal += 1
    return ordinal


def merge_streams(paths: list[str], force: bool = False) -> dict:
    """Join per-host event streams into one merged manifest document.

    Raises ``ValueError`` when the streams carry different run_ids —
    they are different runs, not hosts of one run — unless ``force``
    (clock skew at the stamp second can legitimately split an id).
    """
    if not paths:
        raise ValueError("obs merge: no event streams given")
    replayed: list[tuple[str, dict]] = []
    for p in paths:
        replayed.append((p, slv.salvage(p)))
    run_ids = sorted({doc["run_id"] for _, doc in replayed})
    if len(run_ids) > 1 and not force:
        raise ValueError(
            "obs merge: streams carry different run_ids "
            f"{run_ids} (different runs? clock skew? use --force to join "
            "anyway)")
    used: set[int] = set()
    docs: list[tuple[int, str, dict]] = []
    for i, (p, doc) in enumerate(replayed):
        h = _host_of(p, doc, used, i)
        used.add(h)
        docs.append((h, p, doc))
    docs.sort(key=lambda t: t[0])
    base = docs[0][2]

    wall = max((doc["wall_s"] or 0.0) for _, _, doc in docs)
    spans: list[dict] = [{
        "name": base["name"], "kind": "run", "t0_s": 0.0,
        "dur_s": round(float(wall), 6), "parent": None, "thread": 0,
        "attrs": {"hosts": len(docs)},
    }]
    counters: dict[str, float] = {}
    gauges: dict[str, float] = {}
    costmodel: dict[str, dict] = {}
    hosts_table: list[dict] = []
    error = None
    any_salvaged = False
    for h, path, doc in docs:
        offset = len(spans)
        for j, row in enumerate(doc.get("spans") or []):
            r = dict(row)
            r["host"] = h
            if j == 0:
                # the host's run root becomes its lane root under the
                # merged run root
                r.update({"name": f"host{h}", "kind": "host", "parent": 0})
            else:
                p_idx = r.get("parent")
                r["parent"] = (p_idx + offset
                               if isinstance(p_idx, int) else offset)
            spans.append(r)
        for k, v in (doc.get("counters") or {}).items():
            if isinstance(v, (int, float)):
                counters[k] = counters.get(k, 0) + v
        for k, v in (doc.get("gauges") or {}).items():
            if isinstance(v, (int, float)):
                gauges[k] = max(gauges.get(k, v), v)
        for k, row in (doc.get("costmodel") or {}).items():
            if isinstance(row, dict):
                costmodel.setdefault(k, row)
        if doc.get("error") and error is None:
            error = f"host{h}: {doc['error']}"
        any_salvaged = any_salvaged or bool(doc.get("salvaged"))
        hosts_table.append({
            "host": h,
            "stream": os.path.basename(path),
            "run_id": doc["run_id"],
            "wall_s": doc["wall_s"],
            "error": doc.get("error"),
            "salvaged": bool(doc.get("salvaged")),
            "counters": dict(doc.get("counters") or {}),
            "gauges": dict(doc.get("gauges") or {}),
        })
    return {
        "schema": base["schema"],
        "schema_version": base["schema_version"],
        "run_id": base["run_id"],
        "name": base["name"],
        "host_count": len(docs),
        "t_start_unix": min(doc.get("t_start_unix") or 0.0
                            for _, _, doc in docs),
        "wall_s": round(float(wall), 6),
        "error": error,
        "platform": dict(base.get("platform") or {}),
        "knobs": dict(base.get("knobs") or {}),
        "numeric_mode": base.get("numeric_mode"),
        "compile": base.get("compile"),
        "counters": counters,
        "gauges": gauges,
        "costmodel": costmodel,
        "spans": spans,
        "merged": True,
        "hosts": hosts_table,
        "salvaged": any_salvaged,
    }


def merge_file(paths: list[str], out: str | None = None,
               force: bool = False) -> str:
    """Merge streams and write the manifest atomically; returns its path.

    Default output sits next to the first stream as
    ``<run_id>.merged.manifest.json`` — like salvage, deliberately NOT
    the plain ``.manifest.json`` name any live host could still finalize.
    """
    doc = merge_streams(paths, force=force)
    if out is None:
        out = os.path.join(os.path.dirname(paths[0]) or ".",
                           doc["run_id"] + ".merged.manifest.json")
    tmp = out + ".tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(doc, fh, indent=1, sort_keys=False, default=str)
        fh.write("\n")
    os.replace(tmp, out)
    return out
