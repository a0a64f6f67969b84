"""Warm-up, timing and platform helpers of the port (crimp_tpu_torch.aot,
utils/profiling, utils/platform, utils/benchwork) against crimp_tpu's.

- ``profiling.timed`` records a ``kind="kernel"`` span, a raising body
  included (with its error); ``launch_window`` is free outside it and
  queues no spin kernel unless ``primed_launches`` asks for one (a primed
  span says so); the timing registry keeps ``KERNEL_TIMES_KEEP`` timings a
  name, however many obs runs time kernels;
  ``trace`` writes a Chrome trace and is a no-op without a directory;
  ``compile_counters`` counts builds and graph captures;
- ``aot.warmup(device="cpu")`` returns crimp_tpu's report shape; a
  ``KernelError`` inside it propagates, any other failure is an error
  target;
- ``utils/platform``: the ``--cpu`` flag and the kernel build directory
  (CRIMP_TORCH_COMPILE_CACHE);
- ``utils/benchwork``: crimp_tpu's A/B workload, byte for byte.
"""

import argparse
import contextlib
import json
import os

import numpy as np
import pytest
import torch

from crimp_tpu import aot as jax_aot
from crimp_tpu.utils import benchwork as jax_benchwork
from crimp_tpu_torch import aot, obs, resilience
from crimp_tpu_torch.ops import search, z2_grid
from crimp_tpu_torch.utils import benchwork, device, platform, profiling

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def clean(monkeypatch, tmp_path):
    monkeypatch.setenv("CRIMP_TORCH_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))
    monkeypatch.delenv("CRIMP_TORCH_COMPILE_CACHE", raising=False)
    monkeypatch.delenv("CRIMP_TORCH_TRACE_DIR", raising=False)
    profiling.reset_kernel_times()
    yield
    profiling.reset_kernel_times()
    device.set_default_device(None)


class TestTimed:
    def test_records_a_kernel_span_and_the_registry(self, monkeypatch, tmp_path):
        monkeypatch.setenv("CRIMP_TORCH_OBS", "1")
        monkeypatch.setenv("CRIMP_TORCH_OBS_DIR", str(tmp_path))
        with obs.run("timed"):
            with obs.span("stage"):
                with profiling.timed("k", sync=lambda: torch.ones(3)):
                    torch.ones(1000).sum()
            with pytest.raises(RuntimeError, match="boom"):
                with profiling.timed("k_bad"):
                    raise RuntimeError("boom")
        doc = json.load(open(obs.last_manifest_path()))
        spans = {s["name"]: s for s in doc["spans"]}
        assert spans["k"]["kind"] == "kernel" and spans["k"]["dur_s"] >= 0
        assert doc["spans"][spans["k"]["parent"]]["name"] == "stage"
        assert spans["k_bad"]["attrs"]["error"] == "RuntimeError: boom"
        times = profiling.kernel_times()
        assert len(times["k"]) == 1 and len(times["k_bad"]) == 1
        profiling.reset_kernel_times()
        assert profiling.kernel_times() == {}

    def test_timed_without_a_run_and_launch_window_outside_it(self):
        with profiling.timed("lone"):
            with profiling.launch_window():
                pass
        assert list(profiling.kernel_times()) == ["lone"]
        with profiling.launch_window():  # no timed block open: nothing recorded
            pass

    def test_the_registry_does_not_grow_across_obs_runs(self, monkeypatch, tmp_path):
        monkeypatch.setenv("CRIMP_TORCH_OBS", "1")
        monkeypatch.setenv("CRIMP_TORCH_OBS_DIR", str(tmp_path))
        monkeypatch.setattr(profiling, "KERNEL_TIMES_KEEP", 8)
        sizes = []
        for i in range(3):
            with obs.run(f"long_lived_{i}"):
                for _ in range(12):
                    with profiling.timed("k"):
                        pass
            sizes.append(len(profiling.kernel_times()["k"]))
        assert sizes == [8, 8, 8]

    def test_a_plain_span_never_primes_the_card(self, monkeypatch):
        sleeps, spans = [], []

        class Event:
            def __init__(self, enable_timing=False):
                pass

            def record(self):
                pass

        monkeypatch.setattr(profiling, "_card_stream_live", lambda: True)
        monkeypatch.setattr(torch.cuda, "Event", Event)
        monkeypatch.setattr(torch.cuda, "_sleep", sleeps.append)
        monkeypatch.setattr(obs, "record_device_span",
                            lambda name, start, end, kind, **attrs: spans.append((name, attrs)))
        for primed in (False, True, False):
            with profiling.primed_launches() if primed else contextlib.nullcontext():
                with profiling.timed("k4"):
                    with profiling.launch_window():
                        pass
        assert sleeps == [profiling.PRIME_CYCLES]
        assert spans == [("k4", {}), ("k4", {"primed": True}), ("k4", {})]

    def test_the_prime_ab_tool_needs_a_card(self, monkeypatch, capsys):
        from crimp_tpu_torch.utils import k4_prime_ab

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        assert k4_prime_ab.main(["--reps", "1"]) == 2
        assert "needs a CUDA card" in capsys.readouterr().err

    def test_force_materializes_trees(self):
        Pair = __import__("collections").namedtuple("Pair", "a b")
        out = profiling.force({"x": torch.ones(2), "y": (Pair(torch.zeros(1), 3), [torch.ones(1)])})
        assert isinstance(out["x"], np.ndarray) and isinstance(out["y"][0], Pair)
        assert out["y"][0].b.tolist() == 3 and isinstance(out["y"][1][0], np.ndarray)

    def test_trace_writes_a_chrome_trace(self, tmp_path, monkeypatch):
        with profiling.trace() as prof:
            assert prof is None
        target = tmp_path / "trace"
        with profiling.trace(str(target)) as prof:
            torch.ones(100).sum()
        assert prof is not None and any(p.suffix == ".json" for p in target.iterdir())
        monkeypatch.setenv("CRIMP_TORCH_TRACE_DIR", str(tmp_path / "env"))
        with profiling.trace():
            torch.ones(10).sum()
        assert list((tmp_path / "env").iterdir())

    def test_compile_counters(self):
        before = profiling.compile_counters()
        assert set(before) == {"nvcc_builds", "nvcc_reused", "nvcc_build_s", "graph_captures", "graph_capture_s"}
        profiling.count_graph_capture(0.25)
        after = profiling.compile_counters()
        assert after["graph_captures"] == before["graph_captures"] + 1
        assert after["graph_capture_s"] == pytest.approx(before["graph_capture_s"] + 0.25)


class TestWarmup:
    def test_report_shape_is_jax(self):
        got = aot.warmup(2048, 300, nharm=2, n_fdot=2, poly=None, mcmc={"walkers": 8, "ndim": 2, "steps": 20},
                         general=True, device="cpu")
        want = jax_aot.warmup(2048, 300, nharm=2, n_fdot=2, poly=None)
        assert set(got) == set(want) == {"targets", "total_s", "counters"}
        assert all(set(t) == {"s"} for t in got["targets"].values())
        assert {"z2_tile_sums[poly=0]", "z2_tile_sums[poly=1]", "z2_tile_sums_2d[poly=0]",
                "z2_tile_sums_2d[poly=1]", "general_sums[poly=0]", "general_sums[poly=1]",
                "ensemble_sample"} == set(got["targets"])
        assert len(got["targets"]) >= len(want["targets"])
        assert isinstance(got["total_s"], float) and "graph_captures" in got["counters"]

    def test_toa_target(self):
        from crimp_tpu_torch.models import profiles

        tpl = profiles.ProfileParams(norm=torch.tensor(17.0, dtype=torch.float64),
                                     amp=torch.tensor([1.5, 4.0], dtype=torch.float64),
                                     loc=torch.tensor([-0.4, -0.8], dtype=torch.float64),
                                     wid=torch.zeros(2, dtype=torch.float64),
                                     ph_shift=torch.tensor(0.0, dtype=torch.float64),
                                     amp_shift=torch.tensor(1.0, dtype=torch.float64))
        got = aot.warmup(1024, 64, poly=True, toa={"tpl": tpl, "kind": profiles.FOURIER, "n_segments": 2,
                                                   "n_events_max": 300}, device="cpu")
        assert "s" in got["targets"]["fit_toas_batch"]

    def test_kernel_error_propagates_other_failures_are_targets(self, monkeypatch):
        def dead(*a, **k):
            raise resilience.KernelError("nvcc not found")

        monkeypatch.setattr(search, "harmonic_sums_2d_grid", dead)
        with pytest.raises(resilience.KernelError):
            aot.warmup(1024, 64, poly=True, device="cpu")

        def oom(*a, **k):
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")

        monkeypatch.setattr(search, "harmonic_sums_2d_grid", oom)
        got = aot.warmup(1024, 64, poly=True, general=True, device="cpu")
        assert got["targets"]["z2_tile_sums[poly=1]"]["error"].startswith("OutOfMemoryError")
        assert "s" in got["targets"]["general_sums[poly=1]"]


class TestPlatform:
    def test_cpu_flag_forces_the_default_device(self):
        parser = argparse.ArgumentParser()
        platform.add_cpu_flag(parser)
        assert parser.parse_args(["--cpu"]).cpu and not parser.parse_args([]).cpu
        platform.force_cpu_platform()
        assert device.resolve_device(None) == torch.device("cpu")
        assert search.PeriodSearch(np.arange(10.0), np.linspace(0.1, 0.2, 5), 2).device.type == "cpu"
        device.set_default_device(None)
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="device='cpu'"):
                device.resolve_device(None)

    def test_build_directory(self, monkeypatch, tmp_path):
        assert platform.compilation_cache_dir() == platform.DEFAULT_BUILD_DIR
        assert platform.DEFAULT_BUILD_DIR.parts[-2:] == ("build", "kernels")
        for off in ("0", "off", "none", "false"):
            monkeypatch.setenv("CRIMP_TORCH_COMPILE_CACHE", off)
            assert platform.compilation_cache_dir() is None and platform.configure_compilation_cache() is None
            assert z2_grid.build_dir().name.startswith("crimp_tpu_torch_kernels_")
        monkeypatch.setenv("CRIMP_TORCH_COMPILE_CACHE", str(tmp_path / "kern"))
        assert platform.configure_compilation_cache() == tmp_path / "kern" and (tmp_path / "kern").is_dir()
        assert z2_grid.build_dir() == tmp_path / "kern"


class TestBenchwork:
    def test_the_workload_is_jax(self):
        got, want = benchwork.ab_workload(5000, 300), jax_benchwork.ab_workload(5000, 300)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2:] == want[2:]
        assert (benchwork.AB_N_EVENTS, benchwork.AB_N_TRIALS, benchwork.AB_SEED) == (800_000, 100_000, 7)

    def test_rates(self):
        calls = []
        rate = benchwork.best_rate(lambda: calls.append(1), 1000, repeats=2)
        assert rate > 0 and len(calls) == 3
        sec, freqs, f0, df = benchwork.ab_workload(3000, 300)
        for kernel, tile in (("grid", 256), ("general", 128), ("grid3d", 256), ("grid_mxu", 256)):
            assert benchwork.candidate_rate(kernel, sec, freqs, f0, df, 300, 2, 3072, tile, True, repeats=1,
                                            device="cpu") > 0
        with pytest.raises(ValueError, match="trial tile"):
            benchwork.candidate_rate("grid", sec, freqs, f0, df, 300, 2, 3072, 64, True, repeats=1, device="cpu")
        with pytest.raises(ValueError, match="unknown"):
            benchwork.candidate_rate("pallas", sec, freqs, f0, df, 300, 2, 3072, 256, True, device="cpu")
