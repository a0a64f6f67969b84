"""One run of one cell: set-up, the measured window, the check, the result.

Everything a cell is made of is found by name: the cell's entry in
``BENCHMARK.json`` names its configuration (``configs/<name>.json``) and
its traffic mix (``mixes/<cell>.json``); the mix names its driver
(``drivers/<driver>.py``) and holds the limits of the check; each per-layer
metric is read by ``metrics/<metric>.py``. A later cell, configuration or
metric is new files and new entries, not edits.

The window repeats whole units (a pass, a scan) from the first unit's
start until ``seconds`` have passed, and ends with the last unit's end;
every unit ends with the card synchronized. End-to-end metrics are taken
over all the window's units and all its time. With ``trace`` the window
runs under ``torch.profiler`` and the result carries the per-layer metrics
instead. Once the window has closed and the memory peak is read, the
program's state is released and the plain reference judges every unit.
"""

from __future__ import annotations

import importlib.util
import json
import math
import pathlib
import statistics
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
HERE = pathlib.Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "crimp_tpu"}


def load_module(path: pathlib.Path):
    """A module from a file of the benchmark (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(f"portbench_file_{path.stem.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell_files(name: str, bench: dict | None = None) -> tuple[dict, dict, dict]:
    """(the cell's entry, its configuration, its mix), by name alone."""
    bench = benchmark() if bench is None else bench
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config_path = ROOT / entry["file"]
    config = json.loads(config_path.read_text())
    config["_dir"] = str(config_path.parent)
    mix = json.loads((HERE / "mixes" / f"{name}.json").read_text())
    return cell, config, mix


def metric_names(bench: dict, cell: str, kind: str) -> list[str]:
    """The cell's ``end_to_end`` or ``per_layer`` metrics."""
    return [m["name"] for m in bench[kind] if cell in m.get("workloads", [cell])]


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``crimp_tpu_torch`` is not ``crimp_tpu``)."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


class Context:
    """What a per-layer metric's reader reads: the window's records, its
    trace, and each hand kernel's counts over the window."""

    def __init__(self, records, trace, counts):
        self.records, self.trace, self.counts = records, trace, counts

    def stage_ms(self, stage: str) -> float | None:
        values = [r["stages"][stage] for r in self.records if stage in r.get("stages", {})]
        return 1e3 * statistics.fmean(values) if values else None


def run(cell_name: str, seed: int, seconds: float, trace: bool, device="cuda", t_start: float | None = None,
        bench: dict | None = None, config: dict | None = None, mix: dict | None = None, log=print) -> dict:
    """One run; returns the result object (without the checks' printing)."""
    t_start = time.perf_counter() if t_start is None else t_start
    bench = benchmark() if bench is None else bench
    cell, config_file, mix_file = cell_files(cell_name, bench)
    config = config_file if config is None else config
    mix = mix_file if mix is None else mix
    driver = load_module(HERE / "drivers" / f"{mix['driver']}.py").make(config, mix, seed, device)
    driver.setup()
    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda: None)
    sync()
    setup_s = time.perf_counter() - t_start

    tracer = None
    if trace:
        from portbench.trace import Trace

        tracer = Trace()
        tracer.start()
    records = []
    w0 = time.perf_counter()
    while True:
        records.append(driver.unit(len(records) + 1))
        if time.perf_counter() - w0 >= seconds:
            break
    window_s = time.perf_counter() - w0
    if tracer is not None:
        tracer.stop()
    peak = torch.cuda.max_memory_allocated() if torch.device(device).type == "cuda" else 0

    driver.release()
    numbers, refs = driver.check(records)
    limits = mix["limits"]
    checks = {name: {"value": numbers[name] if math.isfinite(numbers[name]) else None, "limit": limit}
              for name, limit in limits.items()}
    correct = all(c["value"] is not None and c["value"] <= c["limit"] for c in checks.values())

    if trace:
        ctx = Context(records, tracer, driver.counts(records, refs))
        metrics = {}
        for m in bench["per_layer"]:
            if m["name"] not in metric_names(bench, cell_name, "per_layer"):
                continue
            value = load_module(HERE / "metrics" / f"{m['name']}.py").read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {**driver.end_to_end(window_s, records), "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in bench["end_to_end"] if m["name"] in metric_names(bench, cell_name, "end_to_end")}

    dev = torch.device(device)
    result = {"correct": bool(correct), "attempted": len(records), "failed": 0, "metrics": metrics,
              "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                         "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                         "count": 1, "memory_peak_bytes": int(peak)}}
    if trace:
        result["device"].update(busy_s=tracer.busy_s(), window_s=tracer.window_s)
        result["breakdown"] = {"device_ops": tracer.top_device_ops(), "idle_gaps": tracer.idle_gaps()}
    result["checks"] = checks
    log(f"{cell_name}: {len(records)} units ({driver.unit_name}) in {window_s:.3f} s, set-up {setup_s:.3f} s",
        file=sys.stderr)
    return result
