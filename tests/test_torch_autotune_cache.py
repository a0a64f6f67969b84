"""The port's verdict cache (crimp_tpu_torch.ops.autotune) against
crimp_tpu.ops.autotune.

- ``resolve_serve_warm_batch`` and ``resolve_multisource`` resolve as
  crimp_tpu's for the environment set, a cached verdict present, both, and
  neither, with the cache switched off, and across the ceil-log2 size
  buckets; malformed knobs raise in both; the cache hit / miss counters
  count alike;
- the key layout and ``CRIMP_TORCH_AUTOTUNE``'s words are crimp_tpu's,
  eager tuning (1/on/eager) included; the port keeps its own file (``crimp_tpu_torch/autotune.json``) and its
  fingerprint is the device it runs on, so a verdict keyed to another
  platform never steers it;
- a corrupt or torn cache file is quarantined (renamed ``*.corrupt``) and
  the defaults apply, never an exception; so does an injected
  ``corrupt:tuner_cache`` fault;
- the survey and the serving engine act on a cached verdict, and the
  engine reads the cache file once, not once a round.
"""

import json
import pathlib

import numpy as np
import pytest
import torch

from crimp_tpu import obs as jax_obs
from crimp_tpu.ops import autotune as jax_autotune
from crimp_tpu.resilience import faultinject as jax_faultinject
from crimp_tpu_torch import obs, serve
from crimp_tpu_torch.ops import autotune, deltafold
from crimp_tpu_torch.pipelines import survey
from crimp_tpu_torch.resilience import faultinject
from tests.test_torch_survey import make_spec

torch.set_num_threads(2)

SUFFIXES = ("AUTOTUNE", "AUTOTUNE_CACHE", "MULTISOURCE", "MULTISOURCE_MAX_PAD", "MULTISOURCE_BATCH",
            "SERVE_WARM_BATCH", "FAULTS", "OBS", "OBS_DIR")


@pytest.fixture(autouse=True)
def caches(monkeypatch, tmp_path):
    """Each package's cache file in its own temp dir; no stray knobs."""
    for prefix in ("CRIMP_TORCH", "CRIMP_TPU"):
        for suffix in SUFFIXES:
            monkeypatch.delenv(f"{prefix}_{suffix}", raising=False)
    paths = {"port": tmp_path / "port" / "autotune.json", "jax": tmp_path / "jax" / "autotune.json"}
    monkeypatch.setenv("CRIMP_TORCH_AUTOTUNE_CACHE", str(paths["port"]))
    monkeypatch.setenv("CRIMP_TPU_AUTOTUNE_CACHE", str(paths["jax"]))
    faultinject.reset()
    jax_faultinject.reset()
    deltafold.clear_cache()
    yield paths
    faultinject.reset()
    jax_faultinject.reset()
    deltafold.clear_cache()


def both_env(monkeypatch, suffix, value):
    for prefix in ("CRIMP_TORCH", "CRIMP_TPU"):
        monkeypatch.setenv(f"{prefix}_{suffix}", value)


def outcome(fn, *args):
    try:
        return fn(*args)
    except ValueError:
        return ValueError


WARM_CASES = {
    "neither": ({}, None),
    "cache_off_verdict": ({}, {"serve_warm_batch": 0}),
    "cache_on_verdict": ({}, {"serve_warm_batch": 1, "warm_requests_per_s": 812.5}),
    "env_over_cache": ({"SERVE_WARM_BATCH": "1"}, {"serve_warm_batch": 0}),
    "env_off": ({"SERVE_WARM_BATCH": "0"}, None),
    "autotune_off_ignores_cache": ({"AUTOTUNE": "0"}, {"serve_warm_batch": 0}),
    "autotune_eager": ({"AUTOTUNE": "eager"}, {"serve_warm_batch": 0}),
    "malformed_verdict": ({}, {"serve_warm_batch": 2}),
    "malformed_env": ({"SERVE_WARM_BATCH": "on"}, None),
    "malformed_mode": ({"AUTOTUNE": "sometimes"}, {"serve_warm_batch": 0}),
}

MULTI_CASES = {
    "neither": ({}, None),
    "cached_loop": ({}, {"multisource": 0, "sources_per_s": 12.0}),
    "cached_pad": ({}, {"multisource": 1, "max_pad": 2.0}),
    "env_pad_over_cached_pad": ({"MULTISOURCE_MAX_PAD": "3.0"}, {"multisource": 1, "max_pad": 2.0}),
    "env_on_over_cached_loop": ({"MULTISOURCE": "1", "MULTISOURCE_BATCH": "8"}, {"multisource": 0}),
    "autotune_off": ({"AUTOTUNE": "off"}, {"multisource": 0}),
    "bad_cached_pad": ({}, {"multisource": 1, "max_pad": -1.0}),
    "malformed_env": ({"MULTISOURCE": "2"}, None),
}


class TestResolvers:
    @pytest.mark.parametrize("case", list(WARM_CASES))
    def test_serve_warm_batch_resolves_as_jax(self, monkeypatch, case):
        env, entry = WARM_CASES[case]
        for suffix, value in env.items():
            both_env(monkeypatch, suffix, value)
        if entry is not None:
            autotune.store_serve_warm_batch(16, 20000, entry)
            jax_autotune.store_serve_warm_batch(16, 20000, entry)
        got = outcome(autotune.resolve_serve_warm_batch, 16, 20000)
        assert got == outcome(jax_autotune.resolve_serve_warm_batch, 16, 20000)
        if case == "autotune_eager":  # eager mode reads the cache as auto does
            assert got == {"serve_warm_batch": 0}
        if case == "cache_off_verdict":
            assert got == {"serve_warm_batch": 0}

    @pytest.mark.parametrize("case", list(MULTI_CASES))
    def test_multisource_resolves_as_jax(self, monkeypatch, case):
        env, entry = MULTI_CASES[case]
        for suffix, value in env.items():
            both_env(monkeypatch, suffix, value)
        if entry is not None:
            autotune.store_multisource(64, 300, entry)
            jax_autotune.store_multisource(64, 300, entry)
        got = outcome(autotune.resolve_multisource, 64, 300)
        assert got == outcome(jax_autotune.resolve_multisource, 64, 300)
        if case == "cached_pad":
            assert got == {"multisource": 1, "max_pad": 2.0, "batch_cap": 0}

    @pytest.mark.parametrize("n,events", [(16, 20000), (9, 16385), (17, 20000), (16, 40000), (1, 1), (2, 2)])
    def test_size_buckets_share_a_verdict_as_jax(self, n, events):
        autotune.store_serve_warm_batch(16, 20000, {"serve_warm_batch": 0})
        jax_autotune.store_serve_warm_batch(16, 20000, {"serve_warm_batch": 0})
        got = autotune.resolve_serve_warm_batch(n, events)
        assert got == jax_autotune.resolve_serve_warm_batch(n, events)
        assert got["serve_warm_batch"] == (0 if (n, events) in ((16, 20000), (9, 16385)) else 1)

    def test_cache_counters_match_jax(self, monkeypatch, tmp_path):
        for prefix in ("CRIMP_TORCH", "CRIMP_TPU"):
            monkeypatch.setenv(f"{prefix}_OBS", "1")
            monkeypatch.setenv(f"{prefix}_OBS_DIR", str(tmp_path / prefix.lower()))
        for mod in (autotune, jax_autotune):
            mod.store_multisource(64, 300, {"multisource": 1})
        with obs.run("resolve"):
            for n in (64, 65, 64):
                autotune.resolve_multisource(n, 300)
            autotune.resolve_serve_warm_batch(4, 100)
        with jax_obs.run("resolve"):
            for n in (64, 65, 64):
                jax_autotune.resolve_multisource(n, 300)
            jax_autotune.resolve_serve_warm_batch(4, 100)
        docs = []
        for path in (obs.last_manifest_path(), jax_obs.last_manifest_path()):
            with open(path) as fh:
                docs.append({k: v for k, v in json.load(fh)["counters"].items() if k.startswith("autotune")})
        assert docs[0] == docs[1] == {"autotune_cache_hits": 2, "autotune_cache_misses": 2}


class TestCacheFile:
    @pytest.mark.parametrize("value", ["", "auto", "cache", "0", "off", "never", "1", "on", "eager", "x"])
    def test_mode_words_are_jax(self, monkeypatch, value):
        both_env(monkeypatch, "AUTOTUNE", value)
        assert outcome(autotune.autotune_mode) == outcome(jax_autotune.autotune_mode)

    def test_key_layout_and_buckets_are_jax(self):
        for args in (("serve_warm_batch_enable", False, 20000, 16), ("multisource_enable", False, 1, 1),
                     ("grid", True, 839259, 100000)):
            assert autotune.cache_key(*args, platform="cuda", device_kind="NVIDIA H100 80GB HBM3") == \
                jax_autotune.cache_key(*args, platform="cuda", device_kind="NVIDIA H100 80GB HBM3")
        for n in (1, 2, 3, 4, 5, 1023, 1024, 1025, 10**6):
            assert autotune._bucket(n) == jax_autotune._bucket(n)

    def test_own_file_and_the_port_s_fingerprint(self, monkeypatch, caches):
        monkeypatch.delenv("CRIMP_TORCH_AUTOTUNE_CACHE")
        monkeypatch.setenv("XDG_CACHE_HOME", "/nonexistent/cache")
        assert str(autotune.cache_path()) == "/nonexistent/cache/crimp_tpu_torch/autotune.json"
        monkeypatch.setenv("CRIMP_TORCH_AUTOTUNE_CACHE", str(caches["port"]))
        assert autotune.device_fingerprint() == ("cpu", "cpu")
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "NVIDIA H100 80GB HBM3")
        assert autotune.device_fingerprint() == ("cuda", "NVIDIA H100 80GB HBM3")
        # a verdict keyed to another platform (a TPU's) never steers the card
        key = autotune.serve_warm_batch_cache_key(16, 20000, platform="tpu", device_kind="TPU v5 lite")
        autotune._store_entry(key, {"serve_warm_batch": 0})
        assert autotune.resolve_serve_warm_batch(16, 20000) == {"serve_warm_batch": 1}
        autotune.store_serve_warm_batch(16, 20000, {"serve_warm_batch": 0})
        assert autotune.resolve_serve_warm_batch(16, 20000) == {"serve_warm_batch": 0}
        assert len(json.loads(caches["port"].read_text())["entries"]) == 2  # stores merge

    @pytest.mark.parametrize("content", ['{"version": 1, "entries": {"a":', "\x00\x01garbage", "[1, 2"])
    def test_a_corrupt_file_is_quarantined_not_raised(self, monkeypatch, caches, tmp_path, content):
        for prefix in ("CRIMP_TORCH", "CRIMP_TPU"):
            monkeypatch.setenv(f"{prefix}_OBS", "1")
            monkeypatch.setenv(f"{prefix}_OBS_DIR", str(tmp_path / prefix.lower()))
        for key in ("port", "jax"):
            caches[key].parent.mkdir(parents=True)
            caches[key].write_text(content)
        with obs.run("corrupt"):
            got = autotune.resolve_multisource(64, 300)
        with jax_obs.run("corrupt"):
            want = jax_autotune.resolve_multisource(64, 300)
        assert got == want == autotune.multisource_defaults()
        for key in ("port", "jax"):
            assert not caches[key].exists()
            assert caches[key].with_name("autotune.json.corrupt").read_text() == content
        with open(obs.last_manifest_path()) as fh:
            counters = json.load(fh)["counters"]
        assert counters["quarantined_tuner_cache"] == 1
        # the next store rebuilds a clean file
        autotune.store_multisource(64, 300, {"multisource": 0})
        assert autotune.resolve_multisource(64, 300)["multisource"] == 0

    def test_injected_corruption_quarantines_as_jax(self, monkeypatch, caches):
        autotune.store_serve_warm_batch(4, 100, {"serve_warm_batch": 0})
        jax_autotune.store_serve_warm_batch(4, 100, {"serve_warm_batch": 0})
        both_env(monkeypatch, "FAULTS", "corrupt:tuner_cache:1")
        got = autotune.resolve_serve_warm_batch(4, 100)
        assert got == jax_autotune.resolve_serve_warm_batch(4, 100) == {"serve_warm_batch": 1}
        assert caches["port"].with_name("autotune.json.corrupt").exists() and not caches["port"].exists()


class TestConsumers:
    def test_survey_takes_a_cached_loop_verdict(self):
        rng = np.random.RandomState(3)
        specs = [make_spec(i, rng, n_per=50) for i in range(3)]
        autotune.store_multisource(3, 50, {"multisource": 0})
        survey.survey_measure_toas(specs, phShiftRes=200, device="cpu")
        info = survey.last_survey_info()
        assert info["n_batched"] == 0 and info["demoted"] == {s.name: "knob: multisource off" for s in specs}

    def test_engine_takes_a_cached_warm_batch_verdict(self):
        rng = np.random.RandomState(4)
        specs = [make_spec(i, rng, n_per=60) for i in range(2)]
        autotune.store_serve_warm_batch(2, 60, {"serve_warm_batch": 0})
        eng = serve.ServingEngine(phShiftRes=200, device="cpu")
        for s in specs:
            eng.submit(s)
        eng.step()
        for s in specs:
            eng.submit(survey.SourceSpec(s.name, s.times, {**s.timing_model, "F0": s.timing_model["F0"] + 1e-11},
                                         s.template, s.intervals))
        assert [r.rung for r in eng.step()] == ["warm", "warm"]

    def test_engine_reads_the_cache_once(self, monkeypatch):
        rng = np.random.RandomState(5)
        specs = [make_spec(i, rng, n_per=60) for i in range(2)]
        autotune.store_serve_warm_batch(2, 60, {"serve_warm_batch": 0})
        reads = []
        real = autotune._load_cache
        monkeypatch.setattr(autotune, "_load_cache", lambda path=None: reads.append(path) or real(path))
        eng = serve.ServingEngine(phShiftRes=200, device="cpu")
        for rnd in range(3):
            for s in specs:
                eng.submit(survey.SourceSpec(s.name, s.times,
                                             {**s.timing_model, "F0": s.timing_model["F0"] + rnd * 1e-11},
                                             s.template, s.intervals))
            assert [r.status for r in eng.step()] == ["ok", "ok"]
        assert len(reads) == 1
        assert autotune.load_entries() == json.loads(pathlib.Path(autotune.cache_path()).read_text())["entries"]
        monkeypatch.setenv("CRIMP_TORCH_AUTOTUNE", "0")
        assert autotune.load_entries() == {}
