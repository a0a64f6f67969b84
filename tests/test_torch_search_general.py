"""Parity of the port's general exact-phase search path (K3's twin,
crimp_tpu_torch.ops.z2_general) with crimp_tpu on the CPU.

At tests/test_search.py's TestZ2/TestHTest figures: against the textbook
Z^2 and against crimp_tpu's general kernels, rtol 1e-8 / atol 1e-6 with f64
trig and rtol 1e-4 / atol 5e-3 with f32 trig (hardware or polynomial). The
PeriodSearch fall-through (non-uniform grids, nharm > 20, fast path off) is
held against crimp_tpu's PeriodSearch on the same inputs. The CUDA kernel is
held against the twin on the card by tests/test_torch_gpu.py.
"""

import pathlib
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crimp_tpu.ops import search as jax_search
from crimp_tpu.pipelines.simulate import simulate_modulated_lc
from crimp_tpu_torch.ops import fasttrig, search, z2_general

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parents[1]
F64, F32 = (1e-8, 1e-6), (1e-4, 5e-3)  # (rtol, atol)


def naive_z2(times, freqs, nharm):
    """The reference's serial Z^2 formula (periodsearch.py:57-71)."""
    out = np.zeros(len(freqs))
    for j, f in enumerate(freqs):
        for k in range(1, nharm + 1):
            theta = 2 * np.pi * k * f * times
            out[j] += np.cos(theta).sum() ** 2 + np.sin(theta).sum() ** 2
    return out * 2.0 / len(times)


@pytest.fixture(scope="module")
def sim_events():
    rng = np.random.RandomState(42)
    sim = simulate_modulated_lc(freq=0.25, srcrate=5.0, exposure=20000, pulsedfraction=0.3,
                                bgrrate=0.1, rng=rng)
    return sim["assigned_t_wBgr"][::8]


class TestZ2General:
    @pytest.mark.parametrize("trig,poly,tol", [(torch.float64, False, F64),
                                               (torch.float32, False, F32),
                                               (torch.float32, True, F32)])
    def test_matches_naive_and_jax(self, trig, poly, tol):
        """tests/test_search.py::TestZ2::test_matches_naive_formula."""
        rng = np.random.RandomState(0)
        times = np.sort(rng.uniform(0, 500, 2000))
        freqs = np.linspace(0.05, 0.3, 37)
        jax_trig = jnp.float64 if trig == torch.float64 else jnp.float32
        for nharm in (1, 2, 5):
            got = search.z2_power(times, freqs, nharm, trig_dtype=trig, poly=poly, device="cpu").numpy()
            np.testing.assert_allclose(got, naive_z2(times, freqs, nharm), rtol=tol[0], atol=tol[1])
            ref = np.asarray(jax_search.z2_power(times, freqs, nharm, event_block=256,
                                                 trig_dtype=jax_trig, poly=poly))
            np.testing.assert_allclose(got, ref, rtol=tol[0], atol=tol[1])

    def test_h_equals_max_penalized_cumsum(self):
        """tests/test_search.py::TestHTest::test_h_equals_max_penalized_cumsum."""
        rng = np.random.RandomState(5)
        times = np.sort(rng.uniform(0, 300, 1500))
        freqs = np.linspace(0.2, 0.4, 21)
        z_terms = np.array([naive_z2(times, freqs, k) for k in range(1, 7)])
        manual = np.max(z_terms - 4 * np.arange(6)[:, None], axis=0)
        exact = search.h_power(times, freqs, 6, trig_dtype=torch.float64, device="cpu").numpy()
        np.testing.assert_allclose(exact, manual, rtol=F64[0], atol=F64[1])
        mixed = search.h_power(times, freqs, 6, device="cpu").numpy()
        np.testing.assert_allclose(mixed, manual, rtol=F32[0], atol=F32[1])

    def test_h_beyond_twenty_harmonics_matches_jax(self, sim_events):
        """nharm 25 runs in two passes (20 + 5) of the recurrence."""
        sec = sim_events - sim_events.mean()
        freqs = np.linspace(0.2497, 0.2503, 41)
        for trig, jtrig, tol in ((torch.float64, jnp.float64, F64), (torch.float32, jnp.float32, F32)):
            got = search.h_power(sec, freqs, 25, trig_dtype=trig, device="cpu").numpy()
            ref = np.asarray(jax_search.h_power(sec, freqs, 25, trig_dtype=jtrig))
            np.testing.assert_allclose(got, ref, rtol=tol[0], atol=tol[1])
        c, s = search.harmonic_sums_1d(sec, freqs, 25, trig_dtype=torch.float64, device="cpu")
        c_ref, s_ref = (np.asarray(v) for v in jax_search.harmonic_sums_1d(sec, freqs, 25,
                                                                         trig_dtype=jnp.float64))
        np.testing.assert_allclose(c.numpy(), c_ref, rtol=1e-8, atol=1e-7)
        np.testing.assert_allclose(s.numpy(), s_ref, rtol=1e-8, atol=1e-7)

    @pytest.mark.parametrize("nharm", [21, 32])
    def test_h_and_sums_at_one_pass_limits_match_jax(self, sim_events, nharm):
        """nharm 21 (past K2's 20) and 32 (K3's one-pass limit)."""
        sec = sim_events - sim_events.mean()
        freqs = np.linspace(0.2497, 0.2503, 41)
        for trig, jtrig, tol in ((torch.float64, jnp.float64, F64), (torch.float32, jnp.float32, F32)):
            got = search.h_power(sec, freqs, nharm, trig_dtype=trig, device="cpu").numpy()
            ref = np.asarray(jax_search.h_power(sec, freqs, nharm, trig_dtype=jtrig))
            np.testing.assert_allclose(got, ref, rtol=tol[0], atol=tol[1])
        c, s = search.harmonic_sums_1d(sec, freqs, nharm, trig_dtype=torch.float64, device="cpu")
        c_ref, s_ref = (np.asarray(v) for v in jax_search.harmonic_sums_1d(sec, freqs, nharm,
                                                                         trig_dtype=jnp.float64))
        assert c.shape == (nharm, 41)
        np.testing.assert_allclose(c.numpy(), c_ref, rtol=1e-8, atol=1e-7)
        np.testing.assert_allclose(s.numpy(), s_ref, rtol=1e-8, atol=1e-7)

    def test_2d_and_3d_match_jax(self, sim_events):
        sec = sim_events - sim_events.mean()
        freqs = np.linspace(0.2496, 0.2504, 33)
        fdots, fddots = np.array([-1e-11, 0.0]), np.array([-1e-15, 0.0, 1e-15])
        got2 = search.z2_power_2d(sec, freqs, fdots, 2, trig_dtype=torch.float64, device="cpu")
        ref2 = jax_search.z2_power_2d(sec, freqs, fdots, 2, trig_dtype=jnp.float64)
        np.testing.assert_allclose(got2.numpy(), np.asarray(ref2), rtol=F64[0], atol=F64[1])
        got3 = search.z2_power_3d(sec, freqs, fdots, fddots, 2, device="cpu")
        ref3 = jax_search.z2_power_3d(sec, freqs, fdots, fddots, 2)
        assert got3.shape == (3, 2, 33)
        np.testing.assert_allclose(got3.numpy(), np.asarray(ref3), rtol=F32[0], atol=F32[1])


class TestPeriodSearchFallThrough:
    def test_nonuniform_grid(self, sim_events):
        jagged = np.concatenate([np.linspace(0.2490, 0.2499, 30), np.linspace(0.2500, 0.2510, 41)])
        for poly in (False, True):
            ref = jax_search.PeriodSearch(sim_events, jagged, 2, poly_trig=poly)
            got = search.PeriodSearch(sim_events, jagged, 2, poly_trig=poly, device="cpu")
            np.testing.assert_allclose(got.ztest(), ref.ztest(), rtol=F32[0], atol=F32[1])
            rows, _ = got.twod_ztest([-12.0, -11.0])
            ref_rows, _ = ref.twod_ztest([-12.0, -11.0])
            np.testing.assert_array_equal(rows[:, :2], ref_rows[:, :2])
            np.testing.assert_allclose(rows[:, 2], ref_rows[:, 2], rtol=F32[0], atol=F32[1])

    def test_high_nharm_and_fastpath_off(self, sim_events):
        freqs = np.linspace(0.2497, 0.2503, 33)
        ref = jax_search.PeriodSearch(sim_events, freqs, 22, poly_trig=False).htest()
        got = search.PeriodSearch(sim_events, freqs, 22, poly_trig=False, device="cpu").htest()
        np.testing.assert_allclose(got, ref, rtol=F32[0], atol=F32[1])
        z2_general.reset_launches()
        off = search.PeriodSearch(sim_events, freqs, 3, use_grid_fastpath=False, poly_trig=False,
                                  device="cpu").ztest()
        ref_off = jax_search.PeriodSearch(sim_events, freqs, 3, use_grid_fastpath=False,
                                          poly_trig=False).ztest()
        np.testing.assert_allclose(off, ref_off, rtol=F32[0], atol=F32[1])
        assert z2_general.LAUNCHES == {"general_sums": 0, "general_kernel": 0}  # CPU tensors take the twin

    def test_grid_fastpath_resolution(self):
        assert search.grid_fastpath_enabled(20) and not search.grid_fastpath_enabled(21)
        assert search.grid_fastpath_enabled(25, True) and not search.grid_fastpath_enabled(2, False)


class TestK3Contract:
    def test_wrapper_validates_inputs(self):
        t = torch.linspace(-10.0, 10.0, 50, dtype=torch.float64)
        f = torch.tensor([0.1, 0.2], dtype=torch.float64)
        z = torch.zeros(1, dtype=torch.float64)
        with pytest.raises(ValueError, match="poly"):
            z2_general.general_sums(t, f, z, z, 2, torch.float64, poly=True)
        with pytest.raises(ValueError, match="nharm"):
            z2_general.general_sums(t, f, z, z, 0)
        with pytest.raises(ValueError, match="float64"):
            z2_general.general_sums(t.float(), f, z, z, 2)
        assert z2_general.general_sums(t, f, z, z, 30).shape == (2, 1, 1, 30, 2)

    def test_cuda_literals_match_fasttrig(self):
        src = (REPO / "crimp_tpu_torch" / "csrc" / "z2_general.cu").read_text()
        body = src[src.index("sincos_poly(float x"):src.index("fma_t(float a")]
        lits = [float(v) for v in re.findall(r"(-?\d+\.\d+e[+-]?\d+)f", body)]
        assert sorted(lits) == sorted(fasttrig._SIN_COEFFS + fasttrig._COS_COEFFS)

    def test_source_constants_match_wrapper(self):
        """The pass limit, block width and chunk of the CUDA source are the
        wrapper's, and every pass width up to the limit has its kernel."""
        src = (REPO / "crimp_tpu_torch" / "csrc" / "z2_general.cu").read_text()
        consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
        assert int(consts["MAX_PASS"]) == z2_general.MAX_PASS == 32
        assert int(consts["THREADS"]) == z2_general.THREADS
        assert int(consts["EVENT_CHUNK"]) == z2_general.EVENT_CHUNK
        cases = sorted(int(v) for v in re.findall(r"K3_CASE\((\d+)\)", src))
        assert cases == list(range(1, z2_general.MAX_PASS + 1))

    @pytest.mark.parametrize("n_blocks,n_chunks,slots,out_bytes,per", [
        (196, 820, 528, 3_200_000, 103),  # 1e5 trials, nharm 2: 8 splits, 3 full waves
        (79, 820, 528, 4_000_000, 41),  # the H-test shape: 20 splits, 3 waves
        (1, 1, 528, 16, 1),  # one chunk
        (100000, 820, 528, 1 << 28, 820),  # 190 waves: splitting gains < 2%
        (4000, 820, 528, 64, 274),  # 7.6 waves: 3 splits fill the last one
        (4000, 820, 528, 1 << 29, 820),  # ... capped at 2 by the partial buffer: no gain
    ])
    def test_plan_splits(self, n_blocks, n_chunks, slots, out_bytes, per):
        got = z2_general.plan_splits(n_blocks, n_chunks, slots, out_bytes)
        assert got == per
        n_split = -(-n_chunks // got)
        assert n_split * out_bytes <= max(out_bytes, z2_general.PARTIAL_BYTES)

    def test_ptxas_report_and_sass_loop_counts(self):
        from crimp_tpu_torch.ops import z2_grid
        from crimp_tpu_torch.utils import k3_ab

        log = """ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_114general_kernelIfLb1ELi2EEEvPKdi' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_114general_kernelIfLb1ELi2EEEvPKdi
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 90 registers, 448 bytes cmem[0]
ptxas info    : Function properties for __internal_slowpath
    40 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_114general_kernelIdLb0ELi32EEEvPKdi' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_114general_kernelIdLb0ELi32EEEvPKdi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 200 registers, 448 bytes cmem[0]"""
        entries = z2_grid.ptxas_entries(log)
        assert [(k3_ab.kernel_label(e["name"]), e["registers"], e["stack"], e["spill"]) for e in entries] == [
            ("general_kernel<float,True,2>", 90, 8, 8), ("general_kernel<double,False,32>", 200, 0, 0)]
        # an event loop of two pairs with a nested (idle) loop inside it
        sass = [(0x00, "LDS.128", ""), (0x10, "DMUL", ""), (0x20, "FRND.F64.FLOOR", ""),
                (0x30, "F2F.F32.F64", ""), (0x40, "FFMA", ""), (0x50, "IADD3", ""),
                (0x60, "BRA", "0x50"), (0x70, "DMUL", ""), (0x80, "F2F.F32.F64", ""),
                (0x90, "FADD", ""), (0xa0, "BRA", "0x0"), (0xb0, "EXIT", "")]
        counts = k3_ab.loop_counts(sass)
        assert counts["pairs_per_iteration"] == 2 and counts["instructions"] == 9
        assert counts["per_pair"] == {"conversion": 1.0, "f32": 1.0, "f64": 1.0, "f64 round": 0.5,
                                      "integer, branch, other": 0.5, "shared load": 0.5}

    def test_ops_per_pair(self):
        assert z2_general.ops_per_pair(2, torch.float32, poly=True) == (4, 34)
        assert z2_general.ops_per_pair(2, torch.float32, poly=False, has_d=True) == (6, 35)
        f64, f32 = z2_general.ops_per_pair(3, torch.float64)
        assert f32 == 0 and f64 == 4 + 25 + 3 + 12


_IMPORT_CHECK = r"""
import importlib, pkgutil, sys
sys.path.insert(0, {repo!r})
import crimp_tpu_torch
names = [m.name for m in pkgutil.walk_packages(crimp_tpu_torch.__path__, "crimp_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = [m for m in sys.modules if m in ("jax", "crimp_tpu") or m.startswith(("jax.", "crimp_tpu."))]
print("MODULES", len(names), "serve" in " ".join(names))
print("BAD", bad)
print("MISSING", sorted(set({layer!r}) - set(names)))
"""

# the modules of the measuring and tuning layer, which the walk must reach
LAYER_MODULES = ("crimp_tpu_torch.aot", "crimp_tpu_torch.obs.costmodel", "crimp_tpu_torch.obs.roofline",
          "crimp_tpu_torch.obs.ledger", "crimp_tpu_torch.ops.resumable", "crimp_tpu_torch.utils.profiling",
          "crimp_tpu_torch.utils.platform", "crimp_tpu_torch.utils.benchwork")


def test_new_modules_import_neither_jax_nor_crimp_tpu():
    proc = subprocess.run([sys.executable, "-c", _IMPORT_CHECK.format(repo=str(REPO), layer=LAYER_MODULES)], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "MODULES" in proc.stdout and " True" in proc.stdout, proc.stdout
    assert "BAD []" in proc.stdout, proc.stdout
    assert "MISSING []" in proc.stdout, proc.stdout
