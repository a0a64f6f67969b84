"""SARIF 2.1.0 rendering for graftlint reports (port of
``crimp_tpu/analysis/sarif.py``).

SARIF (Static Analysis Results Interchange Format) is the lingua franca
code-scanning UIs ingest — GitHub code scanning, VS Code SARIF viewers,
CI annotators. ``render_sarif`` turns a :class:`~.core.Report` into a
single-run SARIF document; waived findings are carried as suppressed
results (``suppressions[].kind = "inSource"`` with the waiver reason as
the justification) rather than dropped, so a scanning UI can show the
waiver inventory next to the live findings.

``validate_minimal`` is a hand-rolled structural check of the subset of
the SARIF schema this module emits — the repo vendors no jsonschema
dependency, and the repo-gate test needs *some* executable definition of
"valid SARIF" to pin the output against.
"""

from __future__ import annotations

import json
import pathlib

from crimp_tpu_torch.analysis.core import RULES, Report

SARIF_VERSION = "2.1.0"
SARIF_SCHEMA = ("https://raw.githubusercontent.com/oasis-tcs/sarif-spec/"
                "master/Schemata/sarif-schema-2.1.0.json")


def render_sarif(report: Report, root=None) -> dict:
    """One SARIF ``run`` for the whole report.

    ``root`` (when given) becomes the ``PROJECT_ROOT`` uriBaseId so
    result locations stay root-relative — the same paths the text
    renderer and the baseline use.
    """
    rule_ids = sorted(RULES)
    rule_index = {rid: i for i, rid in enumerate(rule_ids)}
    results = []
    for f in sorted(report.findings,
                    key=lambda f: (f.path, f.line, f.rule)):
        result = {
            "ruleId": f.rule,
            "ruleIndex": rule_index.get(f.rule, -1),
            "level": "error",
            "message": {"text": f.message},
            "locations": [{
                "physicalLocation": {
                    "artifactLocation": {
                        "uri": f.path,
                        "uriBaseId": "PROJECT_ROOT",
                    },
                    "region": {"startLine": max(1, int(f.line))},
                },
            }],
        }
        if f.waived:
            result["suppressions"] = [{
                "kind": "inSource",
                "justification": f.reason,
            }]
        results.append(result)
    run: dict = {
        "tool": {
            "driver": {
                "name": "graftlint",
                "rules": [
                    {
                        "id": rid,
                        "shortDescription": {"text": RULES[rid]},
                    }
                    for rid in rule_ids
                ],
            },
        },
        "results": results,
    }
    if root is not None:
        run["originalUriBaseIds"] = {
            "PROJECT_ROOT": {
                "uri": pathlib.Path(root).resolve().as_uri() + "/",
            },
        }
    return {
        "$schema": SARIF_SCHEMA,
        "version": SARIF_VERSION,
        "runs": [run],
    }


def render_sarif_text(report: Report, root=None) -> str:
    return json.dumps(render_sarif(report, root), indent=2, sort_keys=True)


def validate_minimal(doc) -> list[str]:
    """Structural problems with a SARIF document (empty list = valid).

    Covers the required spine of SARIF 2.1.0 as this module emits it:
    top-level version/runs, tool.driver.name, per-result ruleId +
    message.text + physical locations with positive startLine, and
    well-formed suppressions.
    """
    problems: list[str] = []
    if not isinstance(doc, dict):
        return ["document is not an object"]
    if doc.get("version") != SARIF_VERSION:
        problems.append(f"version must be {SARIF_VERSION!r}")
    runs = doc.get("runs")
    if not isinstance(runs, list) or not runs:
        return problems + ["runs must be a non-empty array"]
    for i, run in enumerate(runs):
        where = f"runs[{i}]"
        if not isinstance(run, dict):
            problems.append(f"{where} is not an object")
            continue
        driver = (run.get("tool") or {}).get("driver") \
            if isinstance(run.get("tool"), dict) else None
        if not isinstance(driver, dict) or not driver.get("name"):
            problems.append(f"{where}.tool.driver.name is required")
        rules = (driver or {}).get("rules", [])
        rule_ids = {r.get("id") for r in rules if isinstance(r, dict)}
        results = run.get("results")
        if not isinstance(results, list):
            problems.append(f"{where}.results must be an array")
            continue
        for j, res in enumerate(results):
            rwhere = f"{where}.results[{j}]"
            if not isinstance(res, dict):
                problems.append(f"{rwhere} is not an object")
                continue
            if not res.get("ruleId"):
                problems.append(f"{rwhere}.ruleId is required")
            elif rule_ids and res["ruleId"] not in rule_ids:
                problems.append(
                    f"{rwhere}.ruleId {res['ruleId']!r} not in driver rules")
            msg = res.get("message")
            if not isinstance(msg, dict) or not isinstance(
                    msg.get("text"), str) or not msg["text"]:
                problems.append(f"{rwhere}.message.text is required")
            for k, loc in enumerate(res.get("locations", [])):
                lwhere = f"{rwhere}.locations[{k}]"
                phys = loc.get("physicalLocation") \
                    if isinstance(loc, dict) else None
                art = (phys or {}).get("artifactLocation") \
                    if isinstance(phys, dict) else None
                if not isinstance(art, dict) or not art.get("uri"):
                    problems.append(
                        f"{lwhere}.physicalLocation.artifactLocation.uri "
                        "is required")
                region = (phys or {}).get("region") \
                    if isinstance(phys, dict) else None
                if region is not None:
                    start = region.get("startLine") \
                        if isinstance(region, dict) else None
                    if not isinstance(start, int) or start < 1:
                        problems.append(
                            f"{lwhere}.physicalLocation.region.startLine "
                            "must be a positive integer")
            for k, sup in enumerate(res.get("suppressions", [])):
                if not isinstance(sup, dict) or not sup.get("kind"):
                    problems.append(
                        f"{rwhere}.suppressions[{k}].kind is required")
    return problems
