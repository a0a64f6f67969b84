"""Cost rows and the roofline join (crimp_tpu_torch.obs.costmodel, .roofline)
against crimp_tpu.obs on the CPU.

- ``obs.record_cost`` attaches rows to the manifest's ``costmodel`` table,
  and crimp_tpu's ``validate_manifest`` accepts the port's manifest with
  them, rows captured from real kernel sites included;
- one synthetic manifest through both packages' ``roofline.analyze`` gives
  the same rows, shares and bounds under the CPU placeholder peaks; the H100
  row is chosen for the device kind "NVIDIA H100 80GB HBM3";
- K2's, K3's and K4's rows equal their formulas' counts (``flops_per_pair``,
  ``ops_per_pair``, B*E*(P + 2)*8 bytes), each with a kernel span of the
  same name for the join;
- capture is a no-op with obs off and with CRIMP_TORCH_OBS_COST=0; repeat
  shapes hit the in-process and disk tiers.
"""

import copy
import json

import numpy as np
import pytest
import torch

from crimp_tpu.obs import manifest as jax_manifest
from crimp_tpu.obs import roofline as jax_roofline
from crimp_tpu_torch import obs
from crimp_tpu_torch.obs import costmodel, roofline
from crimp_tpu_torch.ops import anchored, deltafold, search, z2_general, z2_grid

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def obs_on(monkeypatch, tmp_path):
    monkeypatch.setenv("CRIMP_TORCH_OBS", "1")
    monkeypatch.setenv("CRIMP_TORCH_OBS_DIR", str(tmp_path / "obs"))
    monkeypatch.setenv("CRIMP_TORCH_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))
    monkeypatch.delenv("CRIMP_TORCH_OBS_COST", raising=False)
    costmodel.reset_mem_cache()
    yield tmp_path
    costmodel.reset_mem_cache()


def manifest() -> dict:
    with open(obs.last_manifest_path()) as fh:
        return json.load(fh)


def events(n=3000, seed=5):
    return np.sort(np.random.RandomState(seed).uniform(-2e4, 2e4, n))


class TestManifest:
    def test_record_cost_lands_in_the_table_and_validates(self):
        with obs.run("costs"):
            obs.record_cost("k", {"flops": 10.0, "bytes_accessed": 4.0})
        doc = manifest()
        assert doc["costmodel"] == {"k": {"flops": 10.0, "bytes_accessed": 4.0}}
        assert jax_manifest.validate_manifest(doc) == []
        assert doc["compile"]["graph_captures"] >= 0

    def test_captured_rows_validate_and_carry_spans(self):
        t = events()
        with obs.run("sites"):
            search.z2_power_2d_grid(t, 0.25, 1e-6, 300, [0.0, -1e-12], 2, device="cpu")
            search.z2_power(t, np.geomspace(0.2499, 0.2501, 50), 2, device="cpu")
        doc = manifest()
        assert jax_manifest.validate_manifest(doc) == []
        assert {"grid_sums_2d", "general_sums"} <= set(doc["costmodel"])
        spans = {s["name"]: s for s in doc["spans"] if s["kind"] == "kernel"}
        assert spans["grid_sums_2d"]["dur_s"] > 0 and spans["general_sums"]["dur_s"] > 0
        rows = {r["name"]: r for r in roofline.analyze(doc)["rows"]}
        assert rows["grid_sums_2d"]["calls"] == 1 and rows["grid_sums_2d"]["flops_per_s"] > 0
        assert rows["grid_sums_2d"]["pct_of_roof"] is None  # no card: no peak-table entry
        doc["platform"]["backend"] = "cpu"
        rows = {r["name"]: r for r in roofline.analyze(doc)["rows"]}
        assert rows["grid_sums_2d"]["pct_of_roof"] > 0


class TestFormulas:
    def test_k2_row(self):
        t = events()
        with obs.run("k2"):
            search.z2_power_2d_grid(t, 0.25, 1e-6, 300, [0.0, -1e-12], 3, device="cpu")
        row = manifest()["costmodel"]["grid_sums_2d"]
        n_tiles = -(-300 // z2_grid.TRIAL_TILE)
        assert row["flops"] == 300 * 2 * t.size * z2_grid.flops_per_pair(3)
        assert row["bytes_accessed"] == 8 * t.size + 8 * 2 + 4 * 2 * 2 * n_tiles * 3 * z2_grid.TRIAL_TILE
        assert row["flops_source"] == "formula" and row["output_bytes"] == 4 * 2 * 2 * n_tiles * 3 * 256

    @pytest.mark.parametrize("poly,fdots", [(True, None), (False, [-1e-12])])
    def test_k3_row(self, poly, fdots):
        t = events()
        freqs = np.geomspace(0.2499, 0.2501, 60)
        with obs.run("k3"):
            if fdots is None:
                search.z2_power(t, freqs, 2, poly=poly, device="cpu")
            else:
                search.z2_power_2d(t, freqs, fdots, 2, poly=poly, device="cpu")
        row = manifest()["costmodel"]["general_sums"]
        _, f32 = z2_general.ops_per_pair(2, torch.float32, poly=poly, has_d=fdots is not None)
        assert row["flops"] == 60 * t.size * f32
        assert row["bytes_accessed"] == 8 * t.size + 8 * 60 + 8 + 2 * 2 * 60 * 8

    def test_k4_rows(self):
        segs = [np.sort(58320.0 + np.random.RandomState(1).uniform(0.0, 50.0, 400))]
        tm = {"PEPOCH": 58330.0, "F0": 0.14, "F1": -1e-14}
        deltafold.clear_cache()
        with obs.run("k4"):
            anchored.fold_segments(tm, segs, device="cpu", delta_fold=1, cache_tag="k4")
            anchored.fold_segments({**tm, "F0": 0.14 + 1e-10}, segs, device="cpu", delta_fold=1, cache_tag="k4")
            deltafold.delta_refold_batch([{**tm, "F0": 0.14 + 2e-10}] * 2, [segs, segs], tags=["k4", "k4"],
                                         device="cpu")
        deltafold.clear_cache()
        doc = manifest()
        p = deltafold.n_params(0)
        assert doc["costmodel"]["delta_refold"]["bytes_accessed"] == 8 * 400 * (p + 2)
        assert doc["costmodel"]["delta_refold"]["flops"] == 2 * 400 * p
        assert doc["costmodel"]["delta_refold_batch"]["bytes_accessed"] == 8 * 2 * 400 * (p + 2)
        names = {s["name"] for s in doc["spans"] if s["kind"] == "kernel"}
        assert {"delta_refold", "delta_refold_batch", "anchored_fold"} <= names
        assert doc["costmodel"]["anchored_fold"]["flops"] is None  # torch code: a partial row

    def test_factorized_rows_count_matmuls_on_meta_tensors(self):
        t = events()
        with obs.run("mxu"):
            search.z2_power_grid(t, 0.25, 1e-6, 300, 2, mxu=True, device="cpu")
        row = manifest()["costmodel"]["grid_sums_mxu"]
        # 4 (rows x EB) @ (EB x TB) products per harmonic: 2*rows*EB*TB each
        assert row["flops_source"] == "flop_counter"
        assert row["flops"] == 2 * 4 * 2 * 2 * t.size * search.MXU_TRIAL_BLOCK


class TestRoofline:
    def _synthetic(self) -> dict:
        spans = [{"name": "run", "kind": "run", "t0_s": 0.0, "dur_s": 2.0, "parent": None, "thread": 0, "attrs": {}},
                 {"name": "stage", "kind": "stage", "t0_s": 0.0, "dur_s": 1.5, "parent": 0, "thread": 0, "attrs": {}}]
        for name, dur in (("k_compute", 0.2), ("k_compute", 0.3), ("k_memory", 0.01), ("k_nospan_stage", None)):
            if dur is not None:
                spans.append({"name": name, "kind": "kernel", "t0_s": 0.1, "dur_s": dur, "parent": 1, "thread": 0,
                              "attrs": {}})
        return {"run_id": "syn", "name": "run", "platform": {"backend": "cpu", "devices": []}, "spans": spans,
                "costmodel": {"k_compute": {"flops": 4e10, "bytes_accessed": 1e6},
                              "k_memory": {"flops": 1e6, "bytes_accessed": 4e8},
                              "k_nospan_stage": {"flops": 1e9, "bytes_accessed": 1e8, "span": "stage"},
                              "k_partial": {"flops": None, "bytes_accessed": None}}}

    def test_same_rows_shares_and_bounds_as_jax(self):
        doc = self._synthetic()
        got, want = roofline.analyze(copy.deepcopy(doc)), jax_roofline.analyze(copy.deepcopy(doc))
        assert got == want
        assert got["peak"]["source"].startswith("CPU fallback placeholder")
        assert {r["name"]: r["bound"] for r in got["rows"]} == {"k_compute": "compute", "k_memory": "memory",
                                                               "k_nospan_stage": "compute", "k_partial": None}
        assert roofline.render(got) == jax_roofline.render(want)

    def test_primed_rows_say_so(self):
        doc = self._synthetic()
        for span in doc["spans"]:
            if span["name"] == "k_compute" and span["dur_s"] == 0.3:
                span["attrs"]["primed"] = True
        got, want = roofline.analyze(copy.deepcopy(doc)), jax_roofline.analyze(copy.deepcopy(doc))
        rows = {r["name"]: r for r in got["rows"]}
        assert rows["k_compute"].pop("primed_calls") == 1
        assert all("primed_calls" not in r for r in got["rows"])
        assert got == want  # the share itself is JAX's
        text = roofline.render(roofline.analyze(copy.deepcopy(doc)))
        assert "k_compute: 1 of 2 call(s) primed" in text and "launch latency left out" in text

    def test_h100_row_for_the_card(self):
        plat = {"backend": "cuda", "devices": [{"id": 0, "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3"}]}
        peak = roofline.peak_for(plat)
        assert (peak["flops"], peak["bytes_per_s"], peak["ici_bytes_per_s"]) == (67e12, 3.35e12, 900e9)
        assert "H100" in peak["source"]
        assert roofline.peak_for({"backend": "cpu", "devices": []})["flops"] == 1e11
        assert roofline.peak_for({"backend": "tpu", "devices": [{"kind": "TPU v5 lite"}]}) is None
        doc = self._synthetic()
        doc["platform"] = plat
        rows = {r["name"]: r for r in roofline.analyze(doc)["rows"]}
        # bytes-bound share: bytes / (time x 3.35 TB/s)
        assert rows["k_memory"]["pct_of_roof"] == pytest.approx(100 * 4e8 / (0.01 * 3.35e12), rel=1e-3)
        assert rows["k_compute"]["pct_of_roof"] == pytest.approx(100 * 4e10 * 2 / 0.5 / 67e12, rel=1e-3)

    def test_cli_roofline_gate(self, capsys, tmp_path):
        from crimp_tpu_torch.obs import cli
        from crimp_tpu_torch.utils import profiling

        with obs.run("syn"):
            with profiling.timed("k_compute"):
                pass
            obs.record_cost("k_compute", {"flops": 4e10, "bytes_accessed": 1e6})
        doc = manifest()
        doc["platform"]["backend"] = "cpu"
        path = tmp_path / "m.json"
        path.write_text(json.dumps(doc))
        assert cli.main(["roofline", str(path)]) == 0
        assert "k_compute" in capsys.readouterr().out
        assert cli.main(["roofline", str(path), "--fail-below", "1e9"]) == 1
        capsys.readouterr()
        assert cli.main(["roofline", str(path), "--format", "json"]) == 0
        assert json.loads(capsys.readouterr().out)["run_id"] == doc["run_id"]


class TestCaptureSwitches:
    def test_no_op_with_obs_off(self, monkeypatch):
        monkeypatch.setenv("CRIMP_TORCH_OBS", "0")
        assert costmodel.capture("k", None, torch.zeros(3), counts={"flops": 1.0}) is None
        assert costmodel._MEM_CACHE == {}
        with costmodel.kernel_span("k"):
            pass

    def test_no_op_with_cost_knob_off(self, monkeypatch):
        monkeypatch.setenv("CRIMP_TORCH_OBS_COST", "0")
        with obs.run("off"):
            assert costmodel.capture("k", None, torch.zeros(3), counts={"flops": 1.0}) is None
            search.z2_power_grid(events(), 0.25, 1e-6, 64, 2, device="cpu")
        doc = manifest()
        assert doc["costmodel"] == {} and costmodel._MEM_CACHE == {}
        assert any(s["name"] == "grid_sums" for s in doc["spans"])  # the kernel span stays
        monkeypatch.setenv("CRIMP_TORCH_OBS_COST", "sometimes")
        with pytest.raises(ValueError, match="CRIMP_TORCH_OBS_COST"):
            costmodel.cost_capture_on()

    def test_repeat_shapes_hit_mem_then_disk(self, obs_on):
        with obs.run("a"):
            first = costmodel.capture("k", None, torch.zeros(3), counts={"flops": 1.0})
            again = costmodel.capture("k", None, torch.zeros(3), counts={"flops": 2.0})
        assert (first["cache"], again["cache"]) == ("miss", "mem") and again["flops"] == 1.0
        costmodel.reset_mem_cache()
        with obs.run("b"):
            disk = costmodel.capture("k", None, torch.zeros(3), counts={"flops": 3.0})
        assert disk["cache"] == "disk" and disk["flops"] == 1.0
        assert disk["fingerprint"].startswith("cost|cpu|cpu|k|")
        entries = json.loads((obs_on / "autotune.json").read_text())["entries"]
        assert disk["fingerprint"] in entries

    def test_a_failing_capture_never_raises(self):
        def bad_counts():
            raise RuntimeError("boom")

        with obs.run("bad"):
            assert costmodel.capture("k", None, torch.zeros(3), counts=bad_counts) is None
        assert manifest()["counters"]["costmodel_capture_errors"] == 1
