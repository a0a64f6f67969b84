"""Run-manifest schema: validation + loading.

Port of ``crimp_tpu/obs/manifest.py``; the schema is the JAX package's
(``OBS_SCHEMA``), so either package's reader takes either's manifests. The
manifest is deliberately plain JSON with a flat span table (parent
indices, not nesting) so it stays diffable with standard tools and cheap
to validate without a jsonschema dependency. ``validate_manifest``
returns a list of problems (empty = valid) rather than raising, so the
reporter can degrade gracefully on partially-written artifacts while
tests can assert exact emptiness.
"""

from __future__ import annotations

import json

from crimp_tpu_torch.obs.core import OBS_SCHEMA, OBS_SCHEMA_VERSION

# field name -> allowed types (None listed explicitly where nullable)
_TOP_FIELDS: dict[str, tuple] = {
    "schema": (str,),
    "schema_version": (int,),
    "run_id": (str,),
    "name": (str,),
    "t_start_unix": (int, float),
    "wall_s": (int, float),
    "error": (str, type(None)),
    "platform": (dict,),
    "knobs": (dict,),
    "numeric_mode": (dict, type(None)),
    "compile": (dict, type(None)),
    "counters": (dict,),
    "gauges": (dict,),
    "spans": (list,),
}

_SPAN_FIELDS: dict[str, tuple] = {
    "name": (str,),
    "kind": (str,),
    "t0_s": (int, float),
    "dur_s": (int, float, type(None)),
    "parent": (int, type(None)),
    "thread": (int,),
    "attrs": (dict,),
}


def validate_manifest(doc) -> list[str]:
    """Schema-check a manifest document; returns problems (empty = valid)."""
    problems: list[str] = []
    if not isinstance(doc, dict):
        return [f"manifest is {type(doc).__name__}, expected object"]
    for field, types in _TOP_FIELDS.items():
        if field not in doc:
            problems.append(f"missing top-level field {field!r}")
        elif not isinstance(doc[field], types):
            problems.append(
                f"{field!r} is {type(doc[field]).__name__}, expected "
                + "/".join(t.__name__ for t in types))
    # optional extensions (salvaged reconstructions carry these)
    if "salvaged" in doc and not isinstance(doc["salvaged"], bool):
        problems.append(
            f"'salvaged' is {type(doc['salvaged']).__name__}, expected bool")
    if "heartbeat" in doc and not isinstance(doc["heartbeat"],
                                             (dict, type(None))):
        problems.append(
            f"'heartbeat' is {type(doc['heartbeat']).__name__}, "
            "expected object/null")
    # optional extensions (the resilience layer; older manifests lack them)
    if "degraded" in doc and not isinstance(doc["degraded"], bool):
        problems.append(
            f"'degraded' is {type(doc['degraded']).__name__}, expected bool")
    if "degradations" in doc and not isinstance(doc["degradations"], list):
        problems.append(
            f"'degradations' is {type(doc['degradations']).__name__}, "
            "expected list")
    # optional extensions (multi-host observability; single-host and older
    # manifests lack them)
    for field in ("host", "host_count"):
        if field in doc and not isinstance(doc[field], int):
            problems.append(
                f"{field!r} is {type(doc[field]).__name__}, expected int")
    if "merged" in doc and not isinstance(doc["merged"], bool):
        problems.append(
            f"'merged' is {type(doc['merged']).__name__}, expected bool")
    if "hosts" in doc:
        hosts = doc["hosts"]
        if not isinstance(hosts, list):
            problems.append(
                f"'hosts' is {type(hosts).__name__}, expected list")
        else:
            for i, row in enumerate(hosts):
                if not isinstance(row, dict):
                    problems.append(
                        f"hosts[{i}] is {type(row).__name__}, "
                        "expected object")
    # optional extension (the cost-model layer; older manifests lack it)
    if "costmodel" in doc:
        cm = doc["costmodel"]
        if not isinstance(cm, dict):
            problems.append(
                f"'costmodel' is {type(cm).__name__}, expected object")
        else:
            for key, row in cm.items():
                if not isinstance(row, dict):
                    problems.append(
                        f"costmodel[{key!r}] is {type(row).__name__}, "
                        "expected object")
    if doc.get("schema") not in (None, OBS_SCHEMA):
        problems.append(f"schema is {doc.get('schema')!r}, expected {OBS_SCHEMA!r}")
    ver = doc.get("schema_version")
    if isinstance(ver, int) and ver > OBS_SCHEMA_VERSION:
        problems.append(
            f"schema_version {ver} is newer than this reader "
            f"({OBS_SCHEMA_VERSION}); upgrade crimp_tpu_torch to diff it")
    spans = doc.get("spans")
    if isinstance(spans, list):
        if not spans:
            problems.append("spans is empty (span 0 must be the run root)")
        for i, row in enumerate(spans):
            if not isinstance(row, dict):
                problems.append(f"spans[{i}] is {type(row).__name__}, expected object")
                continue
            for field, types in _SPAN_FIELDS.items():
                if field not in row:
                    problems.append(f"spans[{i}] missing field {field!r}")
                elif not isinstance(row[field], types):
                    problems.append(
                        f"spans[{i}].{field} is {type(row[field]).__name__}, "
                        "expected " + "/".join(t.__name__ for t in types))
            parent = row.get("parent")
            if i == 0:
                if parent is not None:
                    problems.append("spans[0].parent must be null (run root)")
            elif isinstance(parent, int) and not (0 <= parent < i):
                problems.append(
                    f"spans[{i}].parent={parent} out of range (parents "
                    "precede children)")
    for field in ("counters", "gauges"):
        table = doc.get(field)
        if isinstance(table, dict):
            for key, val in table.items():
                if not isinstance(val, (int, float)):
                    problems.append(
                        f"{field}[{key!r}] is {type(val).__name__}, expected number")
    return problems


def load_manifest(path: str) -> dict:
    """Load + validate a manifest file; raises ValueError on a bad one."""
    with open(path, encoding="utf-8") as fh:
        try:
            doc = json.load(fh)
        except json.JSONDecodeError as exc:
            raise ValueError(f"{path}: not valid JSON ({exc})") from None
    problems = validate_manifest(doc)
    if problems:
        head = "; ".join(problems[:4]) + ("; ..." if len(problems) > 4 else "")
        raise ValueError(f"{path}: invalid manifest ({head})")
    return doc


def span_paths(doc: dict) -> list[str]:
    """``/``-joined name path for every span (root = its bare name).

    The path is the diff key: two runs of the same pipeline produce the
    same paths for the same stages regardless of absolute timing.
    """
    spans = doc.get("spans") or []
    paths: list[str] = []
    for i, row in enumerate(spans):
        parent = row.get("parent")
        if parent is None or not (0 <= parent < i):
            paths.append(row["name"])
        else:
            paths.append(paths[parent] + "/" + row["name"])
    return paths
