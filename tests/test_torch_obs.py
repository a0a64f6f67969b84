"""The port's telemetry spine (crimp_tpu_torch.obs) against crimp_tpu.obs.

- disabled (the default), every hook is a strict no-op: ``span`` returns
  the shared NULL_SPAN, counters/gauges/beats record nothing, ``run``
  yields None and writes no file;
- enabled, a run writes a JSONL event stream and a manifest that
  crimp_tpu's own ``validate_manifest`` accepts (crimp_tpu/obs/manifest.py
  holds the schema to the reference), with spans, counters, gauges,
  degradations and a heartbeat sidecar;
- outputs are bit-identical with obs on and off (survey, grid, fold);
- the counters the port shares with crimp_tpu (grid_trials,
  grid_mxu_reseeds, events_folded, fold_segments, toas_fit,
  sources_batched, bucket_count, delta_fold_*) count the same for the
  same calls;
- ``parallel.multihost.process_identity`` is (0, 1) with no process group.
"""

import json
import os

import numpy as np
import pandas as pd
import pytest
import torch

from crimp_tpu import obs as jax_obs
from crimp_tpu.obs.manifest import validate_manifest
from crimp_tpu.ops import anchored as jax_anchored
from crimp_tpu.ops import deltafold as jax_deltafold
from crimp_tpu.ops import search as jax_search
from crimp_tpu.pipelines import survey as jax_survey
from crimp_tpu_torch import obs
from crimp_tpu_torch.obs import core
from crimp_tpu_torch.ops import anchored, deltafold, search
from crimp_tpu_torch.parallel import multihost
from crimp_tpu_torch.pipelines import survey
from tests.test_torch_survey import as_jax, make_spec

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for prefix in ("CRIMP_TORCH", "CRIMP_TPU"):
        for name in ("OBS", "OBS_DIR", "OBS_EVENTS", "OBS_HEARTBEAT_S", "OBS_HOST", "FAULTS", "FOLD_CACHE",
                     "GRID_MXU"):
            monkeypatch.delenv(f"{prefix}_{name}", raising=False)
    monkeypatch.setenv("CRIMP_TPU_AUTOTUNE", "0")
    deltafold.clear_cache()
    jax_deltafold.clear_cache()


@pytest.fixture
def obs_on(monkeypatch, tmp_path):
    for prefix in ("CRIMP_TORCH", "CRIMP_TPU"):
        monkeypatch.setenv(f"{prefix}_OBS", "1")
        monkeypatch.setenv(f"{prefix}_OBS_DIR", str(tmp_path / prefix.lower()))
    return tmp_path / "crimp_torch"


def manifest() -> dict:
    with open(obs.last_manifest_path()) as fh:
        return json.load(fh)


class TestDisabled:
    def test_every_hook_is_a_no_op(self, tmp_path, monkeypatch):
        monkeypatch.chdir(tmp_path)
        assert not obs.enabled() and obs.active() is None
        assert obs.span("x") is obs.NULL_SPAN
        with obs.span("x", n=1) as s:
            assert s.set(a=1) is obs.NULL_SPAN
        obs.counter_add("c", 3)
        obs.gauge_set("g", 1.0)
        obs.mark_degraded("grid:exact")
        obs.record_span("k", 0.1)
        assert obs.beat(1, 10, force=True) is None
        assert obs.current_span_name("none") == "none"
        with obs.run("quiet") as rec:
            assert rec is None
        assert os.listdir(tmp_path) == []

    def test_malformed_switch_raises(self, monkeypatch):
        monkeypatch.setenv("CRIMP_TORCH_OBS", "yes please")
        with pytest.raises(ValueError, match="CRIMP_TORCH_OBS"):
            obs.enabled()

    def test_the_other_packages_switch_steers_nothing(self, monkeypatch, tmp_path):
        monkeypatch.setenv("CRIMP_TPU_OBS", "1")
        monkeypatch.setenv("CRIMP_TPU_OBS_DIR", str(tmp_path))
        with obs.run("quiet") as rec:
            assert rec is None
        assert os.listdir(tmp_path) == []


class TestEnabled:
    def test_manifest_passes_the_reference_validator(self, obs_on, monkeypatch):
        monkeypatch.setenv("CRIMP_TORCH_OBS_HEARTBEAT_S", "0.001")
        with obs.run("unit", tag="t") as rec:
            with obs.span("stage_a", n=3) as s:
                s.set(extra=1)
                obs.counter_add("work", 2)
                assert obs.current_span_name() == "stage_a"
                doc = obs.beat(1, 4, label="items", force=True)
            obs.gauge_set("level", 0.5)
            obs.record_span("kernel_x", 0.01)
            obs.mark_degraded("grid:exact:unknown")
            with obs.run("inner"):
                obs.counter_add("work", 1)
        assert rec.counters["work"] == 3
        assert doc["done"] == 1 and doc["total"] == 4 and doc["span"] == "unit/stage_a"
        m = manifest()
        assert validate_manifest(m) == []
        assert m["schema"] == jax_obs.OBS_SCHEMA and m["schema_version"] == jax_obs.OBS_SCHEMA_VERSION
        assert m["degraded"] is True and m["degradations"] == ["grid:exact:unknown"]
        assert m["gauges"]["level"] == 0.5 and m["counters"]["work"] == 3
        assert [s["name"] for s in m["spans"]] == ["unit", "stage_a", "kernel_x", "inner"]
        assert m["spans"][1]["attrs"] == {"n": 3, "extra": 1}
        assert m["platform"]["torch"] == torch.__version__ and m["platform"]["backend"] is None
        assert m["knobs"] == {"CRIMP_TORCH_OBS": "1", "CRIMP_TORCH_OBS_DIR": str(obs_on),
                              "CRIMP_TORCH_OBS_HEARTBEAT_S": "0.001"}
        names = sorted(os.listdir(obs_on))
        assert [n.split(".", 1)[1] for n in names] == ["events.jsonl", "heartbeat.json", "manifest.json"]
        events = [json.loads(line) for line in open(obs_on / names[0])]
        assert events[0]["ev"] == "run_start" and events[-1]["ev"] == "run_end"
        assert {"span_open", "span", "ctr", "gauge", "degraded", "heartbeat"} <= {e["ev"] for e in events}
        sidecar = json.load(open(obs_on / names[1]))
        assert sidecar["label"] == "items" and sidecar["frac"] == 0.25

    def test_error_is_recorded_and_host_suffix(self, obs_on, monkeypatch):
        with pytest.raises(RuntimeError):
            with obs.run("boom"):
                raise RuntimeError("kaput")
        assert manifest()["error"] == "RuntimeError: kaput"
        monkeypatch.setenv("CRIMP_TORCH_OBS_HOST", "1")
        with obs.run("host"):
            pass
        m = manifest()
        assert m["host"] == 1 and m["host_count"] == 2 and "-mh-" in m["run_id"]
        assert obs.last_manifest_path().endswith(".host1.manifest.json")
        assert validate_manifest(m) == []

    def test_process_identity(self):
        assert multihost.process_identity() == (0, 1)
        assert core._host_identity() == (0, 1)


class TestBitIdenticalAndSharedCounters:
    def test_grid_counters_match_jax_and_outputs_do_not_move(self, obs_on, monkeypatch):
        times = np.sort(np.random.RandomState(7).uniform(0.0, 5000.0, 3000))
        off = {}
        for mode in ("off", "on"):
            monkeypatch.setenv("CRIMP_TORCH_OBS", "0" if mode == "off" else "1")
            with obs.run("grid"):
                off[mode] = (search.z2_power_grid(times, 0.1425, 1e-6, 300, 2, device="cpu", mxu=True),
                             search.z2_power_3d_grid(times, 0.1425, 1e-6, 130, [0.0, 1e-9], [0.0, 1e-12], 2,
                                                     device="cpu", mxu=True),
                             search.z2_power_2d_grid(times, 0.1425, 1e-6, 70, [0.0, 1e-9, 2e-9], 2,
                                                     device="cpu"))
        for a, b in zip(off["off"], off["on"]):
            assert torch.equal(a, b)
        with jax_obs.run("grid"):
            jax_search.z2_power_grid(times, 0.1425, 1e-6, 300, 2, mxu=True)
            jax_search.z2_power_3d_grid(times, 0.1425, 1e-6, 130, [0.0, 1e-9], [0.0, 1e-12], 2, mxu=True)
            jax_search.z2_power_2d_grid(times, 0.1425, 1e-6, 70, np.array([0.0, 1e-9, 2e-9]), 2)
        port = manifest()["counters"]
        with open(jax_obs.last_manifest_path()) as fh:
            ref = json.load(fh)["counters"]
        for key in ("grid_trials", "grid_mxu_reseeds"):
            assert port[key] == ref[key], key
        assert port["grid_trials"] == 300 + 130 * 4 + 70 * 3

    def test_fold_counters_match_jax(self, obs_on, monkeypatch, tmp_path):
        monkeypatch.setenv("CRIMP_TORCH_FOLD_CACHE", "mem")
        rng = np.random.default_rng(0)
        segs = [np.sort(58320.0 + 120.0 * i + rng.uniform(0.0, 100.0, 500)) for i in range(3)]
        tm = {"PEPOCH": 58359.5, "F0": 0.1432825, "F1": -9.7e-15}
        moves = [tm, tm, {**tm, "F0": tm["F0"] + 1e-12}, {**tm, "F0": tm["F0"] + 1e-3},
                 {**tm, "F2": 1e-22}]
        with obs.run("fold"):
            got = [anchored.fold_segments(m, segs, delta_fold=1, device="cpu")[0] for m in moves]
        with jax_obs.run("fold"):
            for m in moves:
                jax_anchored.fold_segments(m, segs, delta_fold=1)
        port = manifest()["counters"]
        with open(jax_obs.last_manifest_path()) as fh:
            ref = json.load(fh)["counters"]
        shared = {k: v for k, v in ref.items() if k.startswith(("delta_fold", "events_folded", "fold_segments"))}
        assert shared and {k: port.get(k) for k in shared} == shared
        monkeypatch.setenv("CRIMP_TORCH_OBS", "0")
        deltafold.clear_cache()
        quiet = [anchored.fold_segments(m, segs, delta_fold=1, device="cpu")[0] for m in moves]
        for a, b in zip(got, quiet):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)

    def test_survey_counters_match_jax_and_bits_do_not_move(self, obs_on, monkeypatch):
        rng = np.random.RandomState(41)
        specs = [make_spec(i, rng, n_per=n) for i, n in enumerate([40, 40, 100, 100, 100])]
        on = survey.survey_measure_toas(specs, phShiftRes=200, device="cpu")
        port = manifest()
        jax_survey.survey_measure_toas([as_jax(s) for s in specs], phShiftRes=200)
        with open(jax_obs.last_manifest_path()) as fh:
            ref = json.load(fh)
        assert validate_manifest(port) == []
        for key in ("sources_batched", "bucket_count", "events_folded", "fold_segments", "toas_fit"):
            assert port["counters"][key] == ref["counters"][key], key
        assert port["gauges"]["bucket_occupancy_pct"] == ref["gauges"]["bucket_occupancy_pct"]
        assert port["degraded"] is False and port["name"] == "survey_measure_toas"
        monkeypatch.setenv("CRIMP_TORCH_OBS", "0")
        off = survey.survey_measure_toas(specs, phShiftRes=200, device="cpu")
        for a, b in zip(on, off):
            for col in survey.SURVEY_TOA_COLUMNS:
                assert np.array_equal(a[col], b[col]), col
        assert pd.DataFrame(on[0]).shape[1] == len(survey.SURVEY_TOA_COLUMNS)
