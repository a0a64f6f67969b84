"""graftlint engine: wire sources -> call graph -> rules -> report.

Port of ``crimp_tpu/analysis/engine.py``."""

from __future__ import annotations

from crimp_tpu_torch.analysis import knobcheck, rules
from crimp_tpu_torch.analysis.callgraph import Project
from crimp_tpu_torch.analysis.core import (
    Config,
    Report,
    SourceFile,
    apply_waivers,
    collect_files,
    load_source,
)

RULE_FUNCS = {
    "GL001": rules.rule_gl001,
    "GL002": rules.rule_gl002,
    "GL003": knobcheck.rule_gl003,
    "GL004": rules.rule_gl004,
    "GL005": rules.rule_gl005,
    "GL006": rules.rule_gl006,
    "GL007": rules.rule_gl007,
    "GL008": rules.rule_gl008,
    "GL009": rules.rule_gl009,
    "GL010": rules.rule_gl010,
}


def run(cfg: Config) -> Report:
    files = collect_files(cfg.paths, cfg.root)
    sources: dict[str, SourceFile] = {}
    for f in files:
        src = load_source(f, cfg.root)
        sources[src.rel] = src
    project = Project({rel: s.tree for rel, s in sources.items()
                       if s.is_python and s.tree is not None})
    findings = []
    for rule, fn in RULE_FUNCS.items():
        if cfg.rule_enabled(rule):
            findings.extend(fn(cfg, sources, project))
    findings = apply_waivers(findings, sources)
    return Report(findings=findings, files_scanned=len(sources))
