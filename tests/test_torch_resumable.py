"""Checkpointed resumable scans (crimp_tpu_torch.ops.resumable) on the CPU,
the port's counterparts of tests/test_resumable.py (but the sharded case,
which waits for the port's parallel layer).

- chunked equals the whole scan bit for bit (1-D, 2-D, H-test, cube, the
  uniform grids through K2's twin, non-uniform ones through K3's), and
  equals PeriodSearch under the same launch plan;
- a resume recomputes only the missing chunks; an aborted scan keeps every
  chunk that finished; torn chunks are recomputed;
- a different problem is refused (nharm, events, grid, fddots, segments, an
  older or the JAX package's kernel version, a malformed pinned mode), and
  resolved preferences (launch plan, grid_mxu, delta_fold) are adopted from
  the store while an explicit conflict refuses;
- semi-coherent stores round-trip;
- a timeout is retried once to the same bits, a KernelError is not;
- results match ``crimp_tpu.ops.resumable.ResumableScan`` on the same seeded
  events at test_torch_z2.py's and test_torch_search_general.py's
  tolerances.
"""

import json
import logging

import numpy as np
import pytest
import torch

from crimp_tpu.ops import resumable as jax_resumable
from crimp_tpu_torch import obs, resilience
from crimp_tpu_torch.ops import autotune, search, z2_grid
from crimp_tpu_torch.ops.resumable import ResumableScan
from crimp_tpu_torch.resilience import faultinject

torch.set_num_threads(2)

F32 = (2e-3, 0.05)  # tests/test_search.py::TestPallasZ2 (K2's twin against crimp_tpu)
K3_TOL = (1e-4, 5e-3)  # tests/test_torch_search_general.py, f32 trig


@pytest.fixture(autouse=True)
def clean(monkeypatch, tmp_path):
    for suffix in ("GRID_BLOCKS", "GRID_MXU", "MXU_BF16", "DELTA_FOLD", "DELTA_FOLD_BUDGET", "MCMC_DELTA", "FAULTS",
                   "STREAM_MIN_EVENTS", "AUTOTUNE", "RETRIES", "BACKOFF_S"):
        monkeypatch.delenv(f"CRIMP_TORCH_{suffix}", raising=False)
    monkeypatch.setenv("CRIMP_TORCH_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))
    monkeypatch.setenv("CRIMP_TORCH_BACKOFF_S", "0")
    faultinject.reset()
    yield
    faultinject.reset()


@pytest.fixture(scope="module")
def events():
    rng = np.random.RandomState(11)
    n = 3000
    base = rng.uniform(0, 86400.0, n)
    pulsed = rng.rand(n) < 0.4
    phase = rng.vonmises(0.0, 2.0, n) / (2 * np.pi)
    times = np.where(pulsed, (np.round(base * 0.1432) + phase) / 0.1432, base)
    return np.sort(times) - 43200.0


UNIFORM = np.linspace(0.1428, 0.1436, 500)
WARPED = np.geomspace(0.1428, 0.1436, 500)
FDOTS = np.array([-1e-10, 0.0])
FDDOTS = np.array([-1e-15, 1e-15])


def scan(events, freqs=UNIFORM, **kw):
    kw.setdefault("chunk_trials", 200)
    return ResumableScan(events, freqs, device="cpu", **kw)


class TestChunkedIsWhole:
    @pytest.mark.parametrize("freqs", [UNIFORM, WARPED], ids=["uniform", "nonuniform"])
    def test_1d_bitwise_and_periodsearch(self, events, freqs):
        got = scan(events, freqs, nharm=2).run()
        ps = search.PeriodSearch(events, freqs, 2, device="cpu")
        # PeriodSearch centers its times; the scan takes them as given
        np.testing.assert_array_equal(scan(ps._centered(), freqs, nharm=2).run(), ps.ztest())
        assert got.shape == (freqs.size,)
        grid = search.uniform_grid(freqs)
        whole = (search.z2_power_grid(events, *grid, freqs.size, 2, device="cpu") if grid
                 else search.z2_power(events, freqs, 2, poly=False, device="cpu"))
        np.testing.assert_array_equal(got, whole.numpy())

    @pytest.mark.parametrize("freqs", [UNIFORM, WARPED], ids=["uniform", "nonuniform"])
    def test_2d_bitwise(self, events, freqs):
        got = scan(events, freqs, nharm=2, fdots=FDOTS).run()
        grid = search.uniform_grid(freqs)
        whole = (search.z2_power_2d_grid(events, *grid, freqs.size, FDOTS, 2, device="cpu") if grid
                 else search.z2_power_2d(events, freqs, FDOTS, 2, poly=False, device="cpu"))
        assert got.shape == (2, freqs.size)
        np.testing.assert_array_equal(got, whole.numpy())

    @pytest.mark.parametrize("freqs,nharm", [(UNIFORM, 10), (WARPED, 10), (UNIFORM, 25)],
                             ids=["uniform", "nonuniform", "nharm25"])
    def test_htest_bitwise(self, events, freqs, nharm):
        got = scan(events, freqs, nharm=nharm, statistic="h").run()
        ps = search.PeriodSearch(events, freqs, nharm, device="cpu")
        np.testing.assert_array_equal(scan(ps._centered(), freqs, nharm=nharm, statistic="h").run(), ps.htest())
        assert got.shape == (freqs.size,)
        with pytest.raises(ValueError, match="1-D"):
            scan(events, freqs, nharm=nharm, statistic="h", fdots=np.array([0.0]))

    @pytest.mark.parametrize("freqs", [UNIFORM, WARPED], ids=["uniform", "nonuniform"])
    def test_cube_bitwise(self, events, freqs):
        got = scan(events, freqs, nharm=2, fdots=FDOTS, fddots=FDDOTS).run()
        grid = search.uniform_grid(freqs)
        whole = (search.z2_power_3d_grid(events, *grid, freqs.size, FDOTS, FDDOTS, 2, device="cpu") if grid
                 else search.z2_power_3d(events, freqs, FDOTS, FDDOTS, 2, poly=False, device="cpu"))
        assert got.shape == (2, 2, freqs.size)
        np.testing.assert_array_equal(got, whole.numpy())

    def test_streamed_chunks_bitmatch_unstreamed(self, events, monkeypatch):
        plain = scan(events, nharm=2)
        assert not plain._stream()
        want = plain.run()
        monkeypatch.setenv("CRIMP_TORCH_STREAM_MIN_EVENTS", "1")
        streamed = scan(events, nharm=2)
        assert streamed._stream()
        np.testing.assert_array_equal(streamed.run(), want)

    def test_one_plan_pinned_at_the_whole_grid(self, events, monkeypatch):
        seen = []
        real = z2_grid.z2_tile_sums
        monkeypatch.setattr(z2_grid, "z2_tile_sums", lambda *a, **k: seen.append((k["per_split"], k["tile0"]))
                            or real(*a, **k))
        s = scan(events, nharm=2)
        s.run()
        assert s._blocks == autotune.static_defaults("grid", events.size, UNIFORM.size, device=torch.device("cpu"))
        assert seen == [(s._blocks[0], 0), (s._blocks[0], 0), (s._blocks[0], 1)]  # chunks at trials 0, 200, 400

    def test_matches_crimp_tpu(self, events):
        for freqs, tol in ((UNIFORM, F32), (WARPED, K3_TOL)):
            want = jax_resumable.ResumableScan(events, freqs, nharm=2, chunk_trials=200).run()
            got = scan(events, freqs, nharm=2).run()
            np.testing.assert_allclose(got, want, rtol=tol[0], atol=tol[1])
            assert int(np.argmax(got)) == int(np.argmax(want))
        want = jax_resumable.ResumableScan(events, UNIFORM, nharm=2, fdots=FDOTS, fddots=FDDOTS,
                                           chunk_trials=200).run()
        np.testing.assert_allclose(scan(events, nharm=2, fdots=FDOTS, fddots=FDDOTS).run(), want,
                                   rtol=F32[0], atol=F32[1])


class TestResume:
    def test_resume_recomputes_only_missing_chunks(self, events, tmp_path):
        store = tmp_path / "ckpt"
        s = scan(events, nharm=2, store=str(store))
        full = s.run()
        assert s.done_chunks() == [0, 1, 2]
        (store / "chunk_00001.npy").unlink()
        recomputed = []
        s2 = scan(events, nharm=2, store=str(store))
        assert s2.done_chunks() == [0, 2]
        resumed = s2.run(progress=lambda i, n: recomputed.append(i))
        assert recomputed == [1], "resume must touch only the missing chunk"
        np.testing.assert_array_equal(resumed, full)

    def test_an_aborted_scan_keeps_every_finished_chunk(self, events, tmp_path, monkeypatch):
        store = tmp_path / "ckpt"
        want = scan(events, nharm=2).run()
        monkeypatch.setenv("CRIMP_TORCH_FAULTS", "data:scan_chunk:2")
        with pytest.raises(resilience.DataError):
            scan(events, nharm=2, store=str(store)).run()
        monkeypatch.delenv("CRIMP_TORCH_FAULTS")
        faultinject.reset()
        s2 = scan(events, nharm=2, store=str(store))
        assert s2.done_chunks() == [0]
        monkeypatch.setenv("CRIMP_TORCH_OBS", "1")
        monkeypatch.setenv("CRIMP_TORCH_OBS_DIR", str(tmp_path / "obs"))
        np.testing.assert_array_equal(s2.run(), want)
        counters = json.load(open(obs.last_manifest_path()))["counters"]
        assert counters["chunks_resumed"] == 1 and counters["chunks_computed"] == 2

    def test_atomic_chunks_ignore_tmp_leftovers_and_torn_chunks(self, events, tmp_path):
        store = tmp_path / "ckpt"
        full = scan(events, nharm=2, store=str(store)).run()
        (store / "chunk_00000.npy").rename(store / "chunk_00000.npy.tmp")
        (store / "chunk_00002.npy").write_bytes(b"torn")
        s2 = scan(events, nharm=2, store=str(store))
        assert s2.done_chunks() == [1, 2]
        np.testing.assert_array_equal(s2.run(), full)
        assert (store / "chunk_00002.npy.corrupt").exists()

    def test_timeout_retried_once_same_bits_kernel_error_not(self, events, tmp_path, monkeypatch):
        want = scan(events, nharm=2).run()
        monkeypatch.setenv("CRIMP_TORCH_OBS", "1")
        monkeypatch.setenv("CRIMP_TORCH_OBS_DIR", str(tmp_path))
        monkeypatch.setenv("CRIMP_TORCH_FAULTS", "timeout:scan_chunk:1")
        np.testing.assert_array_equal(scan(events, nharm=2).run(), want)
        assert json.load(open(obs.last_manifest_path()))["counters"]["retries_scan_chunk"] == 1
        monkeypatch.delenv("CRIMP_TORCH_FAULTS")
        calls = []

        def dead(*a, **k):
            calls.append(1)
            raise resilience.KernelError("z2_grid_sums: CUDA error 700 at launch")

        monkeypatch.setattr(z2_grid, "z2_tile_sums", dead)
        with pytest.raises(resilience.KernelError):
            scan(events, nharm=2).run()
        assert len(calls) == 1


class TestStoreFingerprint:
    def test_store_refuses_different_problem(self, events, tmp_path):
        store = str(tmp_path / "ckpt")
        scan(events, nharm=2, store=store).run()
        for kw in ({"nharm": 3}, {"events": events[:-1]}, {"freqs": WARPED}, {"fdots": FDOTS},
                   {"chunk_trials": 100}):
            args = {"nharm": 2, "store": store, **kw}
            ev = args.pop("events", events)
            with pytest.raises(ValueError, match="fingerprint mismatch"):
                scan(ev, **args)

    def test_store_refuses_jax_and_older_kernel_versions(self, events, tmp_path):
        store = tmp_path / "ckpt"
        scan(events, nharm=2, store=str(store)).run()
        manifest = store / "manifest.json"
        for version in (3, 1):  # a crimp_tpu store; an older one
            fp = json.loads(manifest.read_text())
            fp["version"] = version
            manifest.write_text(json.dumps(fp))
            with pytest.raises(ValueError, match="fingerprint mismatch"):
                scan(events, nharm=2, store=str(store))
        # the JAX package writes the same layout under its own version
        jax_store = tmp_path / "jax"
        jax_resumable.ResumableScan(events, UNIFORM, nharm=2, chunk_trials=200, store=str(jax_store))
        with pytest.raises(ValueError, match="fingerprint mismatch"):
            scan(events, nharm=2, store=str(jax_store))

    def test_malformed_manifest_mode_refused(self, events, tmp_path):
        store = tmp_path / "ckpt"
        scan(events, nharm=2, store=str(store)).run()
        manifest = store / "manifest.json"
        fp = json.loads(manifest.read_text())
        del fp["numeric_mode"]["poly_trig"]
        manifest.write_text(json.dumps(fp))
        with pytest.raises(ValueError, match="fingerprint mismatch"):
            scan(events, nharm=2, store=str(store))

    def test_store_adopts_pinned_plan_and_logs_it(self, events, tmp_path, monkeypatch, caplog):
        store = str(tmp_path / "ckpt")
        first = scan(events, nharm=2, store=store)
        power = first.run()
        sorted((tmp_path / "ckpt").glob("chunk_*.npy"))[0].unlink()
        # a re-tuned winner lands between sessions: a preference drift (the
        # CPU's default trig, the scan's, keys the entry)
        autotune._store_entry(autotune.cache_key("grid", False, events.size, UNIFORM.size),
                              {"event_block": 1024, "trial_block": 256})
        assert autotune.resolve_blocks("grid", events.size, UNIFORM.size, False, device="cpu") == (1024, 256)
        with caplog.at_level(logging.WARNING, logger="crimp_tpu_torch.ops.resumable"):
            resumed = scan(events, nharm=2, store=store)
        assert resumed._blocks == first._blocks
        assert any("pinned numeric mode" in r.message for r in caplog.records)
        np.testing.assert_array_equal(resumed.run(), power)
        monkeypatch.setenv("CRIMP_TORCH_GRID_BLOCKS", "1024,256")  # a hand-pinned conflict
        with pytest.raises(ValueError, match="fingerprint mismatch"):
            scan(events, nharm=2, store=store)
        monkeypatch.setenv("CRIMP_TORCH_GRID_BLOCKS", f"{first._blocks[0]},{first._blocks[1]}")
        assert scan(events, nharm=2, store=store)._blocks == first._blocks

    def test_explicit_poly_conflict_refuses(self, events, tmp_path):
        store = str(tmp_path / "ckpt")
        scan(events, nharm=2, store=store).run()  # the CPU's default: hardware sin/cos
        assert not scan(events, nharm=2, store=store, poly=False).poly
        with pytest.raises(ValueError, match="fingerprint mismatch"):
            scan(events, nharm=2, store=store, poly=True)

    @pytest.mark.parametrize("cube", [False, True])
    def test_mxu_mode_pinned_adopted_and_conflict_refused(self, events, tmp_path, monkeypatch, cube):
        kw = {"nharm": 2, "store": str(tmp_path / "ckpt")}
        if cube:
            kw.update(fdots=FDOTS, fddots=FDDOTS)
        monkeypatch.setenv("CRIMP_TORCH_GRID_MXU", "1")
        first = scan(events, **kw)
        assert first._mxu
        power = first.run()
        fp = json.loads((tmp_path / "ckpt" / "manifest.json").read_text())
        assert fp["numeric_mode"]["grid_mxu"][0] == 1
        sorted((tmp_path / "ckpt").glob("chunk_*.npy"))[0].unlink()
        monkeypatch.delenv("CRIMP_TORCH_GRID_MXU")
        resumed = scan(events, **kw)
        assert resumed._mxu  # adopted from the store
        np.testing.assert_array_equal(resumed.run(), power)
        monkeypatch.setenv("CRIMP_TORCH_GRID_MXU", "0")
        with pytest.raises(ValueError, match="fingerprint mismatch"):
            scan(events, **kw)
        exact_kw = {k: v for k, v in kw.items() if k != "store"}
        exact = scan(events, **exact_kw).run()
        assert np.max(np.abs(power - exact)) < 0.01 * np.sqrt(4.0 * 2)

    def test_delta_fold_mode_pinned_adopted_and_conflict_refused(self, events, tmp_path, monkeypatch):
        store = str(tmp_path / "ckpt")
        monkeypatch.setenv("CRIMP_TORCH_DELTA_FOLD", "1")
        monkeypatch.setenv("CRIMP_TORCH_DELTA_FOLD_BUDGET", "5e-10")
        power = scan(events, nharm=2, store=store).run()
        fp = json.loads((tmp_path / "ckpt" / "manifest.json").read_text())
        assert fp["numeric_mode"]["delta_fold"] == [1, 5e-10]
        sorted((tmp_path / "ckpt").glob("chunk_*.npy"))[0].unlink()
        monkeypatch.delenv("CRIMP_TORCH_DELTA_FOLD")
        monkeypatch.delenv("CRIMP_TORCH_DELTA_FOLD_BUDGET")
        resumed = scan(events, nharm=2, store=store)
        assert resumed._delta_fold and resumed._delta_fold_budget == 5e-10
        np.testing.assert_array_equal(resumed.run(), power)
        monkeypatch.setenv("CRIMP_TORCH_DELTA_FOLD", "0")
        with pytest.raises(ValueError, match="fingerprint mismatch"):
            scan(events, nharm=2, store=store)

    def test_legacy_store_without_mxu_or_delta_keys_adopts_off(self, events, tmp_path, monkeypatch):
        store = tmp_path / "ckpt"
        scan(events, nharm=2, store=str(store)).run()
        manifest = store / "manifest.json"
        fp = json.loads(manifest.read_text())
        del fp["numeric_mode"]["grid_mxu"], fp["numeric_mode"]["delta_fold"]
        manifest.write_text(json.dumps(fp))
        resumed = scan(events, nharm=2, store=str(store))
        assert not resumed._mxu and not resumed._delta_fold
        assert resumed._delta_fold_budget == autotune.DELTA_FOLD_BUDGET_DEFAULT
        monkeypatch.setenv("CRIMP_TORCH_GRID_MXU", "1")
        with pytest.raises(ValueError, match="fingerprint mismatch"):
            scan(events, nharm=2, store=str(store))


class TestCubeAndSemicoherent:
    def test_3d_store_roundtrip_resumes_only_missing(self, events, tmp_path):
        kw = dict(nharm=2, fdots=FDOTS, fddots=FDDOTS, store=str(tmp_path / "ckpt"))
        full = scan(events, **kw).run()
        (tmp_path / "ckpt" / "chunk_00001.npy").unlink()
        recomputed = []
        resumed = scan(events, **kw).run(progress=lambda i, n: recomputed.append(i))
        assert recomputed == [1]
        np.testing.assert_array_equal(resumed, full)

    def test_3d_fingerprint_covers_fddots(self, events, tmp_path):
        store = str(tmp_path / "ckpt")
        scan(events, nharm=2, fdots=FDOTS, fddots=FDDOTS, store=store).run()
        with pytest.raises(ValueError, match="fingerprint mismatch"):
            scan(events, nharm=2, fdots=FDOTS, fddots=FDDOTS * 2.0, store=store)
        with pytest.raises(ValueError, match="fingerprint mismatch"):
            scan(events, nharm=2, fdots=FDOTS, store=store)

    def test_semicoherent_roundtrip_and_fingerprint(self, events, tmp_path):
        from crimp_tpu_torch.ops import semicoherent as semi

        store = str(tmp_path / "ckpt")
        kw = dict(nharm=2, fdots=FDOTS, fddots=FDDOTS, semicoherent=4, store=store)
        got = scan(events, **kw).run()
        whole = semi.semicoherent_z2_grid(events, *search.uniform_grid(UNIFORM), UNIFORM.size, FDOTS, FDDOTS,
                                          nharm=2, n_segments=4, device="cpu").numpy()
        assert got.shape == whole.shape == (2, 2, UNIFORM.size)
        np.testing.assert_array_equal(got, whole)
        sorted((tmp_path / "ckpt").glob("chunk_*.npy"))[1].unlink()
        np.testing.assert_array_equal(scan(events, **kw).run(), got)
        with pytest.raises(ValueError, match="fingerprint mismatch"):
            scan(events, **{**kw, "semicoherent": 8})
        with pytest.raises(ValueError, match="fingerprint mismatch"):
            scan(events, nharm=2, fdots=FDOTS, fddots=FDDOTS, store=store)

    def test_semicoherent_validation(self, events):
        with pytest.raises(ValueError, match="fddots"):
            scan(events, nharm=2, fdots=FDOTS, semicoherent=4)
        with pytest.raises(ValueError, match="uniform"):
            scan(events, WARPED, nharm=2, fdots=FDOTS, fddots=FDDOTS, semicoherent=4)
        with pytest.raises(ValueError, match="fdots|fddots"):
            scan(events, nharm=10, statistic="h", fddots=FDDOTS)
