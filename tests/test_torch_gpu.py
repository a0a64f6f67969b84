"""Card-only checks of the port's kernels and device path (gpu marker).

These skip without a CUDA card. The file imports nothing of JAX, so it runs
on a machine that has only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

K1 must return 524800; K2 must match its plain twin on the same card
tensors within TestPallasZ2's rtol 2e-3 / atol 0.05 with identical argmax,
and two runs must be bitwise equal; with weights, a fddot row and f32
sin/cos as well; weights of 1.0 must give the unweighted sums and a zero
fddot row the 2-D sums bit for bit; K2 must match its mirror (the plain
form of its rotation arithmetic) within rtol 1e-4 / atol 5e-3 at each
nharm's register block, with weights, a fddot row and either trig, at
the kernel's own split plan. K3 must match its twin and the textbook
Z^2 (rtol 1e-8 with f64 trig, rtol 1e-4 / atol 5e-3 with f32 trig,
TestZ2's figures) and rerun bitwise; the streamed grids must equal the
monolithic ones bit for bit. The device fold, fit and H-test, the
template fit (chi2 within 1e-6 relative, parameters within 1e-6) and the
MCMC fed the same draws (chain and log-probs within rtol 1e-10) are held
against the same functions run on the CPU. K4, the delta-fold refold, must
equal its twin bit for bit at P = 13 and 23, batched rows the solo refolds
and a split of the events the whole run, must refuse malformed operands, and
the engine's delta mode must lie within 1e-8 cycles of an exact fold. K3
launched at an explicit split length equal to its static plan must equal the
default call bit for bit; a kernel span timed by CUDA events must lie within
5% of the synchronized wall time of a ~90 ms K2 call; K2 at a tile offset
must give the whole grid's tiles bit for bit. K5, the ToA fit's profile
sweep, must match its twin (LL rtol 1e-12, A and b rtol 1e-10, bf16 rtol
1e-5) for every family and norm solve with the shape term in shared memory
and recomputed, rerun bitwise, give a row alone its bits in a batch (and a
lone segment's fit its row of an 84-segment batch in every column K5
feeds, redChi2 within 1e-12 relative), and refuse with
KernelError what it cannot take. K5's golden-section refine, one cluster
launch, must be bitwise the chain of one-phase K5 sweeps under
golden_section plus the sweep at the optimum for every family, norm solve
and bf16 mode, with the shape term in shared memory and recomputed, a
row alone its batch row, reruns bitwise; a refused launch must raise
KernelError out of the fit, with no chain or twin run in its place. K6,
the readvaryparam fit's bounded Nelder-Mead, must match its twin (LL rtol
1e-12, vectors rtol 1e-10) for every family cold and warm, through a
shrinking case too, and be its bits in LL, vectors, per-step decisions,
shrink steps and candidate values read at 128, 64, 7 (a ragged last group
of phases) and 1 phases, at every group size alike, rerun bitwise, give a
row alone its batch row's bits, take the decisions of the replay over its
own evaluation, raise KernelError out of the fit when refused, and
measure_toas -rv on cuda must agree with the cpu run. K6's golden-section
refine, one launch, must be bitwise the chain of one-phase K6 launches
under golden_section plus the launch at the optimum in phi_best, ll_max,
the refit vector and its counts, for every family at 25 and 3 iterations
on ragged rows and for a NaN row, a row alone its batch row; a fit must
launch it once and equal the fit through the chain bit for bit; what it
cannot take and a refused launch raise KernelError, with no chain or twin
run in its place; its first harmonic pairs staged in shared memory move no
bit: the planned stage, a stage short of the rows, n_stage 0 and the whole
row give the chain's bits for every family, and a stage the entry cannot
take raises KernelError; so do K6's Nelder-Mead's at G 2 and 4: the
planned stage gives n_stage 0's bits in all five outputs on the north
star's rows at 128 and 64 phases and on rows longer than the stage, and
von Mises plans none. The readvaryparam fit in row groups, each group's chain of
K6 launches on a stream of its own, must give the one-group fit's bits in
every column, the groups sorted or permuted, and the campaign's 84 rows
must plan two groups or more on a card of 100 SMs or more. Under torch.profiler, a -rv fit at the north-star
rows must show one range a K6 launch, each inside the fit's span, and none
on the device's timeline; a campaign pass's device idle must lie inside
step spans for at least 85% of it. On two or more cards, the
sharded twins over distinct cards must give the bits of the same layout
on shards of one card, their kernel spans must resolve, and a large scan
must auto-shard over the cards within K2's tolerance of the opt-out.
"""

import functools
import json
import pathlib

import numpy as np
import pytest
import torch

from crimp_tpu_torch.ops import anchored, search, toafit, z2_general, z2_grid
from crimp_tpu_torch.models import profiles

torch.set_num_threads(2)

DATA = pathlib.Path(__file__).parent / "data"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
    return torch.device("cuda")


def _pulsed(n: int, seed: int = 42) -> np.ndarray:
    rng = np.random.RandomState(seed)
    t = rng.uniform(0.0, 20000.0, 3 * n)
    keep = rng.uniform(0.0, 1.3, t.size) < 1.0 + 0.3 * np.cos(2 * np.pi * 0.25 * t)
    t = np.sort(t[keep][:n])
    return t - (t[0] + t[-1]) / 2


@pytest.mark.gpu
class TestKernels:
    def test_k1_probe(self, cuda_device):
        z2_grid.reset_launches()
        x = torch.arange(1024, dtype=torch.float32, device=cuda_device).reshape(8, 128)
        assert float(z2_grid.probe(x)) == 524800.0
        assert z2_grid.LAUNCHES["probe"] == 1

    @pytest.mark.parametrize("nharm", [2, 3, 5, 20])
    def test_k2_matches_twin_bitwise_reruns(self, cuda_device, nharm):
        n = 20011
        t = torch.as_tensor(_pulsed(n), device=cuda_device)
        hf = torch.tensor([-5e-11, 0.0, 5e-11], dtype=torch.float64, device=cuda_device)
        got = z2_grid.z2_tile_sums(t, 0.2495, 3e-6, hf, 2, nharm)
        again = z2_grid.z2_tile_sums(t, 0.2495, 3e-6, hf, 2, nharm)
        ref = z2_grid.z2_tile_sums_reference(t, 0.2495, 3e-6, hf, 2, nharm)
        assert torch.equal(got, again)
        z = ((got.double() ** 2).sum(0).sum(2) * (2.0 / n)).cpu().numpy()
        z_ref = ((ref.double() ** 2).sum(0).sum(2) * (2.0 / n)).cpu().numpy()
        np.testing.assert_allclose(z.reshape(3, -1), z_ref.reshape(3, -1), rtol=2e-3, atol=0.05)
        for row in range(3):
            assert int(np.argmax(z[row])) == int(np.argmax(z_ref[row]))

    @pytest.mark.parametrize("nharm", [1, 2, 3, 5, 6, 20])
    def test_k2_matches_its_mirror(self, cuda_device, nharm):
        # 20011 events: 19 full chunks and a ragged one; 3 fdot rows x 2 tiles
        # = 6 (tile, row) pairs, so the last block of R = 4 or 8 pairs is partly idle
        n = 20011
        rng = np.random.RandomState(4)
        t = torch.as_tensor(_pulsed(n), device=cuda_device)
        w = torch.as_tensor(rng.uniform(0.5, 1.5, n).astype(np.float32), device=cuda_device)
        hf = torch.tensor([-5e-11, 0.0, 5e-11], dtype=torch.float64, device=cuda_device)
        sf = torch.tensor([-1e-16, 1e-16], dtype=torch.float64, device=cuda_device) / 6.0
        for kw in ({"poly": True}, {"poly": True, "weights": w, "sixth_fddots": sf},
                   {"poly": False, "weights": w}):
            plan = z2_grid.default_per_split(n, 2 * 3 * (2 if "sixth_fddots" in kw else 1), cuda_device, nharm,
                                             kw["poly"])
            got = z2_grid.z2_tile_sums(t, 0.2495, 3e-6, hf, 2, nharm, per_split=plan, **kw)
            mirror = z2_grid.z2_tile_sums_mirror(t, 0.2495, 3e-6, hf, 2, nharm, per_split=plan, **kw)
            z, z_m = _z2(got, n).reshape(-1, 512), _z2(mirror, n).reshape(-1, 512)
            np.testing.assert_allclose(z, z_m, rtol=1e-4, atol=5e-3, err_msg=str(sorted(kw)))
            for row in range(z.shape[0]):
                assert int(np.argmax(z[row])) == int(np.argmax(z_m[row]))

    def test_search_on_card_matches_cpu_twin(self, cuda_device):
        t = _pulsed(5000)
        freqs = np.linspace(0.2495, 0.2505, 300)
        gpu = search.PeriodSearch(t, freqs, 2, device=cuda_device).twod_ztest([-11.0, -10.0])[0]
        cpu = search.PeriodSearch(t, freqs, 2, device="cpu").twod_ztest([-11.0, -10.0])[0]
        np.testing.assert_allclose(gpu[:, 2], cpu[:, 2], rtol=2e-3, atol=0.05)


def naive_z2(times, freqs, nharm):
    """The reference's serial Z^2 formula (periodsearch.py:57-71), in numpy f64."""
    out = np.zeros(len(freqs))
    for j, f in enumerate(freqs):
        for k in range(1, nharm + 1):
            theta = 2 * np.pi * k * f * times
            out[j] += np.cos(theta).sum() ** 2 + np.sin(theta).sum() ** 2
    return out * 2.0 / len(times)


def _z2(cs, n):
    """(2, ..., nharm, T) sums -> Z^2 summed over the harmonic axis (-2)."""
    c = cs.double()
    return ((c[0] ** 2 + c[1] ** 2).sum(-2) * (2.0 / n)).cpu().numpy()


@pytest.mark.gpu
class TestSearchKernels:
    @pytest.mark.parametrize("poly", [True, False])
    def test_k2_weights_fddot_trig_mode_match_twin(self, cuda_device, poly):
        n = 9000
        rng = np.random.RandomState(2)
        t = torch.as_tensor(_pulsed(n), device=cuda_device)
        w = torch.as_tensor(rng.uniform(0.5, 1.5, n).astype(np.float32), device=cuda_device)
        hf = torch.tensor([-5e-11, 0.0], dtype=torch.float64, device=cuda_device)
        sf = torch.tensor([-1e-16, 0.0, 1e-16], dtype=torch.float64, device=cuda_device) / 6.0
        kw = dict(sixth_fddots=sf, weights=w, poly=poly)
        got = z2_grid.z2_tile_sums(t, 0.2495, 3e-6, hf, 2, 3, **kw)
        again = z2_grid.z2_tile_sums(t, 0.2495, 3e-6, hf, 2, 3, **kw)
        ref = z2_grid.z2_tile_sums_reference(t, 0.2495, 3e-6, hf, 2, 3, **kw)
        assert got.shape == (2, 3, 2, 2, 3, z2_grid.TRIAL_TILE)
        assert torch.equal(got, again)
        z, z_ref = _z2(got, n).reshape(6, -1), _z2(ref, n).reshape(6, -1)
        np.testing.assert_allclose(z, z_ref, rtol=2e-3, atol=0.05)
        for row in range(6):
            assert int(np.argmax(z[row])) == int(np.argmax(z_ref[row]))

    def test_k2_unit_weights_and_zero_fddot_are_bitwise_2d(self, cuda_device):
        t = torch.as_tensor(_pulsed(20011), device=cuda_device)
        hf = torch.tensor([-5e-11, 0.0, 5e-11], dtype=torch.float64, device=cuda_device)
        plain = z2_grid.z2_tile_sums(t, 0.2495, 3e-6, hf, 2, 5)
        ones = torch.ones(t.shape[0], dtype=torch.float32, device=cuda_device)
        assert torch.equal(z2_grid.z2_tile_sums(t, 0.2495, 3e-6, hf, 2, 5, weights=ones), plain)
        zero = torch.zeros(1, dtype=torch.float64, device=cuda_device)
        assert torch.equal(z2_grid.z2_tile_sums(t, 0.2495, 3e-6, hf, 2, 5, sixth_fddots=zero)[:, 0],
                           plain)

    @pytest.mark.parametrize("trig,poly,rtol,atol", [(torch.float64, False, 1e-8, 1e-6),
                                                     (torch.float32, False, 1e-4, 5e-3),
                                                     (torch.float32, True, 1e-4, 5e-3)])
    def test_k3_matches_twin_and_naive(self, cuda_device, trig, poly, rtol, atol):
        rng = np.random.RandomState(0)
        times = np.sort(rng.uniform(0, 500, 2000))
        freqs = np.linspace(0.05, 0.3, 37)
        for nharm in (1, 2, 5, 25, 32):
            args = (torch.as_tensor(times, device=cuda_device), torch.as_tensor(freqs, device=cuda_device),
                    torch.zeros(1, dtype=torch.float64, device=cuda_device),
                    torch.zeros(1, dtype=torch.float64, device=cuda_device), nharm, trig, poly)
            got = z2_general.general_sums(*args)
            assert torch.equal(got, z2_general.general_sums(*args))
            ref = z2_general.general_sums_reference(*args)
            z = _z2(got[:, 0, 0], times.size)
            np.testing.assert_allclose(z, _z2(ref[:, 0, 0], times.size), rtol=rtol, atol=atol)
            if nharm <= 5:
                np.testing.assert_allclose(z, naive_z2(times, freqs, nharm), rtol=rtol, atol=atol)

    @staticmethod
    def _k3_args(dev, n_events=5001, n_freq=300):
        # 5001 events: four full 1024-event chunks and a ragged odd one (905); so
        # few chunks that every call below is planned at one chunk per split,
        # which makes the f64 sums of different calls comparable bit for bit
        t = torch.as_tensor(_pulsed(n_events), device=dev)
        f = torch.as_tensor(np.sort(np.random.RandomState(7).uniform(0.2495, 0.2505, n_freq)), device=dev)
        return t, f, torch.zeros(1, dtype=torch.float64, device=dev)

    @pytest.mark.parametrize("nharm", [21, 25, 32, 40])
    def test_k3_high_nharm_matches_twin_and_lower_nharm_calls(self, cuda_device, nharm):
        t, f, z = self._k3_args(cuda_device)
        z2_general.reset_launches()
        got = z2_general.general_sums(t, f, z, z, nharm, torch.float32, True)
        # one general_kernel pass up to 32 harmonics, as launched
        assert z2_general.LAUNCHES == {"general_sums": 1, "general_kernel": 1 if nharm <= 32 else 2}
        assert torch.equal(got, z2_general.general_sums(t, f, z, z, nharm, torch.float32, True))
        ref = z2_general.general_sums_reference(t, f, z, z, nharm, torch.float32, True)
        np.testing.assert_allclose(_z2(got, t.shape[0]), _z2(ref, t.shape[0]), rtol=1e-4, atol=5e-3)
        # harmonic k of this call is harmonic k of an nharm-k call (another R,
        # one pass or two), bit for bit
        for k in sorted({1, 2, 3, 8, 9, 20, 21, min(nharm, 32)}):
            if k <= nharm:
                low = z2_general.general_sums(t, f, z, z, k, torch.float32, True)
                assert torch.equal(got[:, :, :, k - 1], low[:, :, :, k - 1]), f"harmonic {k}"

    def test_k3_ragged_tile_and_trial_subsets_bitwise(self, cuda_device):
        # 515 trials: tiles of 128 * R trials (R = 1, 2 or 4 by nharm and trig
        # mode), the last ragged and not a multiple of R; every trial is
        # independent of its neighbours
        t, f, z = self._k3_args(cuda_device, n_freq=515)
        for nharm, poly in ((2, True), (2, False), (5, True), (25, True)):
            got = z2_general.general_sums(t, f, z, z, nharm, torch.float32, poly)
            ref = z2_general.general_sums_reference(t, f, z, z, nharm, torch.float32, poly)
            np.testing.assert_allclose(_z2(got, t.shape[0]), _z2(ref, t.shape[0]), rtol=1e-4, atol=5e-3)
            for lo, hi in ((0, 3), (510, 515), (128, 131)):
                part = z2_general.general_sums(t, f[lo:hi].contiguous(), z, z, nharm, torch.float32, poly)
                assert torch.equal(got[..., lo:hi], part), (nharm, poly, lo)

    @pytest.mark.parametrize("trig,poly", [(torch.float32, True), (torch.float32, False), (torch.float64, False)])
    def test_k3_zero_derivative_row_is_bitwise_1d(self, cuda_device, trig, poly):
        t, f, z = self._k3_args(cuda_device)
        hf = torch.tensor([-1e-11, 0.0], dtype=torch.float64, device=cuda_device)
        sf = torch.tensor([0.0, 1e-13], dtype=torch.float64, device=cuda_device) / 6.0
        cube = z2_general.general_sums(t, f, hf, sf, 3, trig, poly)
        assert torch.equal(cube[:, 0, 1], z2_general.general_sums(t, f, z, z, 3, trig, poly)[:, 0, 0])
        ref = z2_general.general_sums_reference(t, f, hf, sf, 3, trig, poly)
        tol = (1e-8, 1e-6) if trig == torch.float64 else (1e-4, 5e-3)
        np.testing.assert_allclose(_z2(cube, t.shape[0]), _z2(ref, t.shape[0]), rtol=tol[0], atol=tol[1])

    def test_k3_sincosf_restatement_is_bitwise_sincosf(self, cuda_device):
        # every float frac in [-0.5, 0.5]: K3's argument range with f32 hardware trig
        assert z2_general.sincosf_mismatches(cuda_device) == 0

    def test_k3_cube_rows_match_twin(self, cuda_device):
        t = _pulsed(6000)
        freqs = np.sort(np.random.RandomState(1).uniform(0.2495, 0.2505, 300))
        got = search.z2_power_3d(t, freqs, [-1e-11, 0.0], [-1e-16, 1e-16], 3,
                                 device=cuda_device).cpu().numpy()
        ref = search.z2_power_3d(t, freqs, [-1e-11, 0.0], [-1e-16, 1e-16], 3, device="cpu").numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=5e-3)

    @pytest.mark.parametrize("mxu", [False, True])
    def test_streamed_is_bitwise_monolithic(self, cuda_device, mxu):
        t = _pulsed(70000)
        f0, df = 0.2495, 3e-6
        fdots, fddots = [-1e-11, 0.0], [0.0, 1e-16]
        chunk = 1 << 15
        kw = dict(mxu=mxu) if mxu else dict(per_split=chunk)
        mono = search.z2_power_3d_grid(t, f0, df, 300, fdots, fddots, 2, device=cuda_device, **kw)
        strm = search.z2_power_3d_grid_streamed(t, f0, df, 300, fdots, fddots, 2, device=cuda_device,
                                                event_chunk=chunk, mxu=mxu)
        assert torch.equal(mono, strm)
        mono2 = search.z2_power_2d_grid(t, f0, df, 300, fdots, 2, device=cuda_device, **kw)
        strm2 = search.z2_power_2d_grid_streamed(t, f0, df, 300, fdots, 2, device=cuda_device,
                                                 event_chunk=chunk, mxu=mxu)
        assert torch.equal(mono2, strm2)

    def test_periodsearch_falls_through_to_k3(self, cuda_device):
        t = _pulsed(5000)
        jagged = np.concatenate([np.linspace(0.2490, 0.2499, 40), np.linspace(0.2500, 0.2510, 61)])
        z2_general.reset_launches()
        gpu = search.PeriodSearch(t, jagged, 2, device=cuda_device).ztest()
        assert z2_general.LAUNCHES["general_sums"] == 1
        cpu = search.PeriodSearch(t, jagged, 2, device="cpu").ztest()
        np.testing.assert_allclose(gpu, cpu, rtol=1e-4, atol=5e-3)


@pytest.mark.gpu
class TestDevicePath:
    def test_fold_fit_htest_match_cpu(self, cuda_device):
        rng = np.random.RandomState(3)
        par = {"PEPOCH": 58359.55765869704, "F0": 0.14328254547263483, "F1": -9.746993965547238e-15}
        segs = [np.sort(rng.uniform(lo, lo + 0.3, 4000)) for lo in (58144.0, 58145.0, 58146.0)]
        gpu, _ = anchored.fold_segments(par, segs, device=cuda_device)
        cpu, _ = anchored.fold_segments(par, segs, device="cpu")
        for g, c in zip(gpu, cpu):
            assert np.max(np.abs((g - c + 0.5) % 1.0 - 0.5)) < 1e-12
        tpl = profiles.ProfileParams(
            norm=torch.tensor(10.0, dtype=torch.float64), amp=torch.tensor([3.0, 1.0], dtype=torch.float64),
            loc=torch.tensor([0.2, -0.4], dtype=torch.float64), wid=torch.zeros(2, dtype=torch.float64),
            ph_shift=torch.tensor(0.0, dtype=torch.float64), amp_shift=torch.tensor(1.0, dtype=torch.float64))
        phases, masks = toafit.pad_segments(cpu)
        cfg = toafit.ToAFitConfig(ph_shift_res=500)
        fit_g = toafit.fit_toas_batch("fourier", tpl, phases, masks, [300.0] * 3, cfg, device=cuda_device)
        fit_c = toafit.fit_toas_batch("fourier", tpl, phases, masks, [300.0] * 3, cfg, device="cpu")
        np.testing.assert_allclose(fit_g["phShift"].cpu().numpy(), fit_c["phShift"].numpy(), atol=1e-6, rtol=0)
        np.testing.assert_allclose(fit_g["redChi2"].cpu().numpy(), fit_c["redChi2"].numpy(), rtol=1e-6)
        sec = (phases - 0.5) * 1e4
        freqs = np.array([0.1432, 0.1433, 0.1434])
        h_g = search.h_power_segments(sec, masks, freqs, device=cuda_device).cpu().numpy()
        h_c = search.h_power_segments(sec, masks, freqs, device="cpu").numpy()
        np.testing.assert_allclose(h_g, h_c, rtol=1e-4)

    def test_readvaryparam_fit_matches_cpu(self, cuda_device):
        rng = np.random.RandomState(5)
        x = rng.uniform(0, 1, 3000)
        x = x[rng.uniform(0, 14.5, x.size) < 10.0 + 3.0 * np.cos(2 * np.pi * x + 0.2) + 1.0][:1500]
        tpl = profiles.ProfileParams(
            norm=torch.tensor(10.0, dtype=torch.float64), amp=torch.tensor([3.0], dtype=torch.float64),
            loc=torch.tensor([0.2], dtype=torch.float64), wid=torch.zeros(1, dtype=torch.float64),
            ph_shift=torch.tensor(0.0, dtype=torch.float64), amp_shift=torch.tensor(1.0, dtype=torch.float64))
        cfg = toafit.ToAFitConfig(ph_shift_res=60, n_brute=16, refine_iters=12, nm_iters=40, err_chunk=4,
                                  free_idx=(0, 1), free_lo=(2.0, 0.1), free_hi=(50.0, 10.0), n_free=2)
        args = ("fourier", tpl, x[None], np.ones((1, x.size), bool), [x.size / 10.0], cfg)
        g = toafit.fit_toas_batch(*args, device=cuda_device)
        c = toafit.fit_toas_batch(*args, device="cpu")
        np.testing.assert_allclose(g["phShift"].cpu().numpy(), c["phShift"].numpy(), atol=1e-6, rtol=0)
        np.testing.assert_allclose(g["theta_best"].cpu().numpy(), c["theta_best"].numpy(), rtol=1e-5)


@pytest.mark.gpu
class TestWorkedExampleOnCard:
    def test_template_fit_matches_cpu(self, cuda_device):
        from crimp_tpu_torch.pipelines.pulseprofile import PulseProfileFromEventFile

        fits, par = str(DATA / "1e2259_ni1020600110.fits"), str(DATA / "1e2259.par")
        got, want = (
            PulseProfileFromEventFile(fits, par, eneLow=1.0, eneHigh=5.0, nbrBins=70, device=dev)
            .fitpulseprofile(ppmodel="fourier", nbrComp=6)[0]
            for dev in (cuda_device, "cpu")
        )
        assert got["dof"] == want["dof"] == 57
        np.testing.assert_allclose(got["chi2"], want["chi2"], rtol=1e-6)
        for key in want:
            if key.startswith(("norm", "amp_", "ph_")):
                assert abs(got[key] - want[key]) < 1e-6, key

    @staticmethod
    def _f0_f1_problem(dev):
        from crimp_tpu_torch.io.yamlcfg import Prior
        from crimp_tpu_torch.pipelines import fit_toas

        par = {"PEPOCH": {"value": 58300.0, "flag": 0}, "F0": {"value": 0.15, "flag": 1},
               "F1": {"value": -1e-13, "flag": 1}}
        rng = np.random.RandomState(4)
        x = np.sort(rng.uniform(58100.0, 58500.0, 40))
        y, yerr = rng.normal(0.0, 7.5e-6, 40), np.full(40, 7.5e-6)
        prior = Prior({"F0": (-1e-8, 1e-8), "F1": (-1e-15, 1e-15)}, {})
        p0 = rng.uniform(-1, 1, (32, 2)) * np.array([1e-8, 1e-15])
        fn, data = fit_toas.make_logprob_parts(par, ["F0", "F1"], prior, x, y, yerr, device=dev)
        return fn, data, torch.as_tensor(p0, device=dev)

    def test_mcmc_with_fed_draws_matches_cpu(self, cuda_device):
        from crimp_tpu_torch.ops import mcmc

        draws = mcmc.ensemble_draws(300, 32, seed=5, device="cpu")
        out = {}
        for dev in (cuda_device, torch.device("cpu")):
            fn, data, p0 = self._f0_f1_problem(dev)
            fed = mcmc.Draws(*(d.to(dev) for d in draws))
            out[dev.type] = [t.cpu().numpy() for t in mcmc.ensemble_sample_draws(fn, p0, fed, data=data)]
        np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-10, atol=0)
        np.testing.assert_allclose(out["cuda"][1], out["cpu"][1], rtol=1e-10, atol=0)

    def test_graph_replay_equals_eager(self, cuda_device):
        from crimp_tpu_torch.ops import mcmc

        fn, data, p0 = self._f0_f1_problem(cuda_device)
        draws = mcmc.ensemble_draws(250, 32, seed=6, device=cuda_device)  # 2 blocks + 50 steps
        eager = mcmc.ensemble_sample_draws(fn, p0, draws, data=data)
        graphed = mcmc.ensemble_sample_draws(fn, p0, draws, data=data, graph_steps=100)
        assert torch.equal(eager[0], graphed[0]) and torch.equal(eager[1], graphed[1])
        assert len(torch.unique(graphed[0])) > 100


def _refold_operands(dev, n_events, n_glitch, seed=0):
    """Phases of a fold and the delta-fold basis of tests/test_deltafold.py's
    model (n_glitch 0 or 2), with an update touching every column group."""
    from crimp_tpu_torch.ops import deltafold

    pars = {"PEPOCH": 58359.55765869704, "F0": 0.14328254547263483, "F1": -9.746993965547238e-15}
    if n_glitch:
        pars.update({"GLEP_1": 58400.0, "GLPH_1": 0.01, "GLF0_1": 3e-8, "GLF1_1": -1e-15, "GLF0D_1": 2e-8,
                     "GLTD_1": 40.0, "GLEP_2": 58600.0, "GLF0_2": 1e-8})
    rng = np.random.default_rng(seed)
    segs = [np.sort(58320.0 + 120.0 * i + rng.uniform(0.0, 100.0, n_events // 4)) for i in range(4)]
    ph, t_ref = anchored.fold_segments(pars, segs, device=dev)
    sizes = [s.size for s in segs]
    idx = np.repeat(np.arange(4), sizes)
    delta = anchored.anchor_deltas(np.concatenate(segs), t_ref, idx)
    fb = deltafold.build_basis(pars, t_ref, delta, idx, device=dev)
    dp = np.zeros(deltafold.n_params(n_glitch))
    dp[:3] = [3e-10, 2e-17, 1e-25]
    if n_glitch:
        dp[[13, 14, 17, 19]] = [1e-3, 5e-10, 1e-9, -3e-10]
    return torch.as_tensor(np.concatenate(ph), device=dev), fb.b, torch.as_tensor(dp, device=dev)


@pytest.mark.gpu
class TestRefoldKernel:
    @pytest.mark.parametrize("n_glitch", [0, 2])
    def test_k4_bitwise_twin(self, cuda_device, n_glitch):
        from crimp_tpu_torch.ops import deltafold

        folded, basis, dp = _refold_operands(cuda_device, 40000, n_glitch)
        assert basis.shape[1] == (13 if n_glitch == 0 else 23)
        deltafold.reset_launches()
        got = deltafold.refold(folded, basis, dp)
        assert deltafold.LAUNCHES["refold"] == 1
        assert torch.equal(got, deltafold.refold_reference(folded, basis, dp))
        assert torch.equal(got.cpu(), deltafold.refold(folded.cpu(), basis.cpu(), dp.cpu()))

    def test_batched_equals_solo_and_split_equals_whole(self, cuda_device):
        from crimp_tpu_torch.ops import deltafold

        ops = [_refold_operands(cuda_device, n, g, seed=s) for n, g, s in ((40000, 2, 1), (30001, 0, 2),
                                                                         (12345, 2, 3))]
        n_ev, n_par = max(o[0].shape[0] for o in ops), max(o[1].shape[1] for o in ops)
        folded = torch.zeros(3, n_ev, dtype=torch.float64, device=cuda_device)
        basis = torch.zeros(3, n_ev, n_par, dtype=torch.float64, device=cuda_device)
        dp = torch.zeros(3, n_par, dtype=torch.float64, device=cuda_device)
        for r, (f, b, d) in enumerate(ops):
            folded[r, :f.shape[0]], basis[r, :f.shape[0], :b.shape[1]], dp[r, :d.shape[0]] = f, b, d
        out = deltafold.refold_batch(folded, basis, dp)
        for r, (f, b, d) in enumerate(ops):
            assert torch.equal(out[r, :f.shape[0]], deltafold.refold(f, b, d)), f"row {r}"
        f, b, d = ops[0]
        k = 17777  # not a multiple of the kernel's 128-event block
        split = torch.cat([deltafold.refold(f[:k].contiguous(), b[:k].contiguous(), d),
                           deltafold.refold(f[k:].contiguous(), b[k:].contiguous(), d)])
        assert torch.equal(split, deltafold.refold(f, b, d))

    def test_bad_operands_raise(self, cuda_device):
        from crimp_tpu_torch.ops import deltafold

        folded, basis, dp = _refold_operands(cuda_device, 4000, 0)
        with pytest.raises(ValueError, match="contiguous"):
            deltafold.refold(folded, basis.T.contiguous().T, dp)
        with pytest.raises(ValueError, match="float64"):
            deltafold.refold(folded.float(), basis, dp)
        with pytest.raises(ValueError, match="device"):
            deltafold.refold(folded, basis.cpu(), dp)

    def test_engine_delta_mode_on_card(self, cuda_device):
        from crimp_tpu_torch.ops import deltafold

        pars = {"PEPOCH": 58359.55765869704, "F0": 0.14328254547263483, "F1": -9.746993965547238e-15}
        rng = np.random.default_rng(4)
        segs = [np.sort(58320.0 + 120.0 * i + rng.uniform(0.0, 100.0, 5000)) for i in range(4)]
        deltafold.clear_cache()
        anchored.fold_segments(pars, segs, device=cuda_device, delta_fold=1)
        new = {**pars, "F0": pars["F0"] + 3e-10, "F1": pars["F1"] + 2e-17}
        deltafold.reset_launches()
        got, _ = anchored.fold_segments(new, segs, device=cuda_device, delta_fold=1)
        assert deltafold.last_fold_info()["mode"] == "delta" and deltafold.LAUNCHES["refold"] == 1
        exact, _ = anchored.fold_segments(new, segs, device=cuda_device)
        d = np.abs(np.concatenate(got) - np.concatenate(exact))
        assert np.max(np.minimum(d, 1.0 - d)) < 1e-8
        deltafold.clear_cache()


def _survey_specs(n_sources: int, n_per: int = 2000, n_int: int = 3, seed: int = 21, differ: bool = True):
    """Pulsed synthetic sources. With ``differ`` they differ as a sample's
    do, within exact padding: per-source templates of one family, and the
    first half with ``n_per`` events in its first interval and fewer in the
    others, the second half (fainter) with ``n_per // 5`` and fewer, so the
    survey makes two buckets, each of one max width. Without, every
    interval holds ``n_per`` events under one template."""
    from crimp_tpu_torch.pipelines import survey

    rng = np.random.RandomState(seed)
    edges = np.linspace(58000.0, 58008.0, n_int + 1)
    specs = []
    for i in range(n_sources):
        tpl = {"model": "fourier", "nbrComp": 2, "norm": 1.0, "amp_1": 0.3, "amp_2": 0.1, "ph_1": 0.2,
               "ph_2": 0.05}
        counts = [n_per] * n_int
        if differ:
            tpl.update(amp_1=0.3 + 0.02 * i, ph_1=0.2 - 0.01 * i)
            top = n_per if i < n_sources // 2 else n_per // 5
            counts = [top] + [top - (top // 40) * ((i + k) % 5) for k in range(1, n_int)]
        tm = {"PEPOCH": 58000.0, "F0": 0.14 + 0.003 * i, "F1": -1e-13}
        chunks = []
        for (lo, hi), n in zip(zip(edges[:-1], edges[1:]), counts):
            t = rng.uniform(lo + 1e-6, hi - 1e-6, 8 * n)
            ph = tm["F0"] * (t - 58000.0) * 86400.0
            chunks.append(t[rng.uniform(0, 1.6, t.size) < 1 + 0.6 * np.cos(2 * np.pi * ph)][:n])
        iv = {"ToA_tstart": edges[:-1], "ToA_tend": edges[1:],
              "ToA_exposure": np.full(n_int, (edges[1] - edges[0]) * 86400.0)}
        specs.append(survey.SourceSpec(name=f"src{i}", times=np.sort(np.concatenate(chunks)), timing_model=tm,
                                       template=tpl, intervals=iv))
    return specs


@pytest.mark.gpu
class TestSurveyOnCard:
    def test_survey_matches_its_loop(self, cuda_device, monkeypatch):
        """Per-row templates (fit_toas_batch_multi) in two buckets, within
        survey.py's parity contract of the per-source loop."""
        from crimp_tpu_torch.ops import multisource
        from crimp_tpu_torch.pipelines import survey

        specs = _survey_specs(12)
        calls = []
        real = multisource.fit_toas_batch_multi
        monkeypatch.setattr(multisource, "fit_toas_batch_multi", lambda *a, **k: calls.append(1) or real(*a, **k))
        frames = survey.survey_measure_toas(specs, phShiftRes=200, device=cuda_device)
        info = survey.last_survey_info()
        assert info["n_batched"] == 12 and info["demoted"] == {} and info["errors"] == {}
        assert info["bucket_count"] == 2 and len(calls) == 2 and info["occupancy_pct"] < 100.0
        for spec, frame in zip(specs, frames):
            solo = survey.measure_source_toas(spec, phShiftRes=200, device=cuda_device)
            for col in survey.SURVEY_TOA_COLUMNS:
                if col not in ("phShift", "phShift_LL", "phShift_UL", "Hpower", "redChi2"):
                    assert np.array_equal(frame[col], solo[col]), (spec.name, col)
            np.testing.assert_allclose(frame["phShift"], solo["phShift"], rtol=0, atol=1e-6)
            for col in ("phShift_LL", "phShift_UL"):
                assert np.max(np.abs(frame[col] - solo[col])) <= 2 * np.pi / 200 * (1 + 1e-9), (spec.name, col)
            np.testing.assert_allclose(frame["Hpower"], solo["Hpower"], rtol=1e-5)
            np.testing.assert_allclose(frame["redChi2"], solo["redChi2"], rtol=1e-6)
            assert np.all(frame["Hpower"] > 20)

    def test_sources_fold_bitwise_and_h_test_match_their_loop(self, cuda_device):
        from crimp_tpu_torch.ops import multisource
        from crimp_tpu_torch.ops.ephem import spin_frequency_host
        from crimp_tpu_torch.models import timing

        specs = _survey_specs(20, n_per=300, n_int=4, seed=13, differ=False)
        tms = [s.timing_model for s in specs]
        segs = [[s.times[(s.times >= lo) & (s.times <= hi)] for lo, hi in
                 zip(s.intervals["ToA_tstart"], s.intervals["ToA_tend"])] for s in specs]
        phases, t_refs = multisource.fold_sources(tms, segs, device=cuda_device)
        freqs = [spin_frequency_host(timing.resolve(tm), t)[0] for tm, t in zip(tms, t_refs)]
        h = multisource.h_power_sources(segs, freqs, device=cuda_device)
        for i in range(len(specs)):
            solo, _ = anchored.fold_segments(tms[i], segs[i], delta_fold=0, device=cuda_device)
            for a, b in zip(phases[i], solo):
                assert np.array_equal(a, b)
            h_solo = multisource.h_power_sources(segs[i:i + 1], freqs[i:i + 1], device=cuda_device)[0]
            np.testing.assert_allclose(h[i], h_solo, rtol=1e-5)


@pytest.mark.gpu
class TestResilienceOnCard:
    def test_real_out_of_memory_classifies_resource_exhausted(self, cuda_device):
        from crimp_tpu_torch.resilience import FailureKind, classify

        free, _ = torch.cuda.mem_get_info(cuda_device)
        with pytest.raises(torch.cuda.OutOfMemoryError) as info:
            torch.empty(int(free) * 2, dtype=torch.uint8, device=cuda_device)
        assert classify(info.value) is FailureKind.RESOURCE_EXHAUSTED
        torch.cuda.empty_cache()

    def test_kernel_error_passes_through_the_grid_ladder(self, cuda_device, monkeypatch):
        from crimp_tpu_torch.resilience import KernelError, faultinject

        t = torch.as_tensor(_pulsed(50000), device=cuda_device)
        lib = z2_grid._lib()

        class FailingLaunch:
            def __getattr__(self, name):
                return getattr(lib, name)

            @staticmethod
            def z2_grid_sums(*args):
                return 700  # cudaErrorIllegalAddress

        monkeypatch.setattr(z2_grid, "_lib", lambda: FailingLaunch())
        monkeypatch.setenv("CRIMP_TORCH_FAULTS", "oom:harmonic_sums:1")
        faultinject.reset()
        # the factorized rung fails by injection; the streamed K2 rung's
        # launch fails, and that KernelError is not taken to the exact rung
        with pytest.raises(KernelError, match="CUDA error 700"):
            search.z2_power_grid(t, 0.2495, 1e-6, 500, 2, device=cuda_device, mxu=True)
        monkeypatch.delenv("CRIMP_TORCH_FAULTS")
        faultinject.reset()
        with pytest.raises(KernelError):
            search.z2_power_grid(t, 0.2495, 1e-6, 500, 2, device=cuda_device)


def _serve_specs(n_clients: int = 4, seed: int = 30):
    """tests/test_torch_serve_engine.py's clients with more events a
    client, on the card's path."""
    return _survey_specs(n_clients, n_per=1500, n_int=2, seed=seed, differ=False)


def _moved(spec, f0_bump):
    from crimp_tpu_torch.pipelines import survey

    return survey.SourceSpec(name=spec.name, times=spec.times,
                             timing_model={**spec.timing_model, "F0": spec.timing_model["F0"] + f0_bump},
                             template=spec.template, intervals=spec.intervals)


@pytest.mark.gpu
class TestServingOnCard:
    def test_warm_batched_round_is_one_k4_launch_bitwise_the_solo_rung(self, cuda_device, monkeypatch):
        """warm_batch=1 refolds every warm client in one K4 launch a round,
        warm_batch=0 one launch a client; the refolded phases are the same
        bits, and the frames agree within the survey's parity contract."""
        from crimp_tpu_torch import serve
        from crimp_tpu_torch.ops import deltafold

        specs = _serve_specs()
        got = {"batched": {}, "solo": {}}
        real_batch, real_fold = deltafold.delta_refold_batch, deltafold.cached_fold

        def batch(tms, seg_lists, tags=None, **kw):
            out = real_batch(tms, seg_lists, tags=tags, **kw)
            got["batched"].update({t: np.concatenate(pl) for t, pl in zip(tags, out[0]) if pl is not None})
            return out

        def fold(*args, tag=None, **kw):
            folded, info = real_fold(*args, tag=tag, **kw)
            if info.get("mode") == "delta":
                got["solo"][tag] = np.array(folded)
            return folded, info

        monkeypatch.setattr(deltafold, "delta_refold_batch", batch)
        monkeypatch.setattr(deltafold, "cached_fold", fold)
        frames, launches = {}, {}
        for pin in (1, 0):
            deltafold.clear_cache()
            eng = serve.ServingEngine(phShiftRes=200, warm_batch=pin, device=cuda_device)
            for s in specs:
                eng.submit(s)
            assert all(r.status == "ok" for r in eng.step())
            for s in specs:
                eng.submit(_moved(s, 1e-11))
            deltafold.reset_launches()
            res = eng.step()
            launches[pin] = deltafold.LAUNCHES["refold"]
            assert all(r.status == "ok" and r.path == "delta_fold:delta" for r in res)
            frames[pin] = [r.frame for r in res]
            eng.close()
        assert launches == {1: 1, 0: len(specs)}
        for s in specs:
            assert np.array_equal(got["batched"][s.name], got["solo"][s.name]), s.name
        for a, b in zip(frames[1], frames[0]):
            np.testing.assert_allclose(a["phShift"], b["phShift"], rtol=0, atol=1e-6)
            np.testing.assert_allclose(a["Hpower"], b["Hpower"], rtol=1e-5)
            np.testing.assert_array_equal(a["nbr_events"], b["nbr_events"])
        deltafold.clear_cache()

    def test_kernel_error_propagates_out_of_step(self, cuda_device, monkeypatch):
        """A K4 launch failure inside a warm batch leaves step() as
        KernelError: no solo retry, no exact fold."""
        from crimp_tpu_torch import serve
        from crimp_tpu_torch.ops import deltafold
        from crimp_tpu_torch.resilience import KernelError

        specs = _serve_specs(3, seed=31)
        deltafold.clear_cache()
        eng = serve.ServingEngine(phShiftRes=200, warm_batch=1, device=cuda_device)
        for s in specs:
            eng.submit(s)
        eng.step()
        lib = deltafold._lib()

        class FailingLaunch:
            def __getattr__(self, name):
                return getattr(lib, name)

            @staticmethod
            def deltafold_refold(*args):
                return 700  # cudaErrorIllegalAddress

        monkeypatch.setattr(deltafold, "_lib", lambda: FailingLaunch())
        for s in specs:
            eng.submit(_moved(s, 1e-11))
        with pytest.raises(KernelError, match="700"):
            eng.step()
        eng.close()
        deltafold.clear_cache()


@pytest.mark.gpu
class TestMeasuringLayerOnCard:
    def test_k3_explicit_plan_is_bitwise_the_default(self, cuda_device):
        from crimp_tpu_torch.ops import autotune

        t = torch.as_tensor(_pulsed(60000), device=cuda_device)
        freqs = torch.as_tensor(np.geomspace(0.2490, 0.2510, 3000), device=cuda_device)
        half = torch.zeros(1, dtype=torch.float64, device=cuda_device)
        sixth = torch.zeros(1, dtype=torch.float64, device=cuda_device)
        for nharm, poly in ((2, True), (25, False)):
            default = z2_general.general_sums(t, freqs, half, sixth, nharm, poly=poly)
            plan = z2_general.default_per_split(t.shape[0], freqs.shape[0], 1, nharm, torch.float32, poly,
                                                cuda_device)
            assert torch.equal(z2_general.general_sums(t, freqs, half, sixth, nharm, poly=poly, per_split=plan),
                               default)
            assert plan == z2_general.LAST_PLAN["per_split"]
            assert autotune.static_defaults("general", t.shape[0], freqs.shape[0], nharm=nharm, poly=poly,
                                            device=cuda_device) == (plan, z2_general.THREADS)

    def test_k2_event_span_within_five_percent_of_synchronized_wall(self, cuda_device, monkeypatch, tmp_path):
        import json
        import time

        from crimp_tpu_torch import obs

        monkeypatch.setenv("CRIMP_TORCH_OBS", "1")
        monkeypatch.setenv("CRIMP_TORCH_OBS_DIR", str(tmp_path))
        t = torch.as_tensor(_pulsed(800000, seed=3), device=cuda_device)
        freqs = np.linspace(0.2490, 0.2510, 100000)
        f0, df = search.uniform_grid(freqs)
        search.harmonic_sums_2d_grid(t, f0, df, freqs.size, [0.0], 2, device=cuda_device)  # warm-up
        torch.cuda.synchronize()
        with obs.run("span"):
            t0 = time.perf_counter()
            search.harmonic_sums_2d_grid(t, f0, df, freqs.size, [0.0], 2, device=cuda_device)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        doc = json.load(open(obs.last_manifest_path()))
        (span,) = [s for s in doc["spans"] if s["name"] == "grid_sums_2d"]
        assert span["kind"] == "kernel" and abs(span["dur_s"] - wall) <= 0.05 * wall, (span["dur_s"], wall)

    def test_tile_offset_chunks_are_bitwise_the_whole_grid(self, cuda_device):
        t = torch.as_tensor(_pulsed(50000), device=cuda_device)
        freqs = np.linspace(0.2490, 0.2510, 2000)
        f0, df = search.uniform_grid(freqs)
        whole = search.z2_power_grid(t, f0, df, freqs.size, 2, device=cuda_device, per_split=50176)
        part = search.z2_power_grid(t, f0, df, 1000 - 768 + 500, 2, device=cuda_device, per_split=50176,
                                    tile0=3)[1000 - 768:]
        assert torch.equal(part, whole[1000:1500])


def _sweep_operands(kind, n_max, dev, seed=40, n_rows=3, n_phis=8, n_comp=6):
    """Seeded K5 operands on ``dev``: ragged rows (n_max, 0.86 n_max and
    0.75 n_max events) of uniform phases, a template of the family and a
    jittered phase grid a row."""
    rng = np.random.RandomState(seed)
    t = lambda v: torch.as_tensor(np.asarray(v, dtype=np.float64), device=dev)  # noqa: E731
    if kind == "fourier":
        leaves = dict(norm=12.0, amp=rng.uniform(0.3, 2.0, n_comp), loc=rng.uniform(-np.pi, np.pi, n_comp),
                      wid=np.zeros(n_comp))
        cycle, half = 1.0, np.pi
    else:
        leaves = dict(norm=9.0, amp=rng.uniform(5.0, 15.0, n_comp), loc=rng.uniform(0.5, 5.8, n_comp),
                      wid=rng.uniform(0.3, 0.9, n_comp))
        cycle, half = 2 * np.pi, 1.5 * np.pi
    tpl = profiles.ProfileParams(ph_shift=t(0.0), amp_shift=t(1.0), **{k: t(v) for k, v in leaves.items()})
    counts = [n_max, int(0.86 * n_max), int(0.75 * n_max)][:n_rows]
    x = np.zeros((n_rows, n_max))
    mask = np.zeros((n_rows, n_max), dtype=bool)
    for r, n in enumerate(counts):
        x[r, :n] = rng.uniform(0.0, cycle, n)
        mask[r, :n] = True
    phis = np.linspace(-half, half, n_phis)[None, :] + rng.uniform(-0.05, 0.05, (n_rows, n_phis))
    return (tpl, t(x), torch.as_tensor(mask, device=dev), t([n / 14.0 for n in counts]), t(phis))


SWEEP_MODES = {"newton": {}, "joint": {"vary_amps": True}, "fixed": {"fix_norm": True}}


@pytest.mark.gpu
class TestProfileKernel:
    """K5 against its twin on the same card tensors: LL within rtol 1e-12, A
    and b within rtol 1e-10 (the event sums' order); with bf16 within rtol
    1e-5 (the f32 sums of bf16 products); 2 000 events a row keep the shape
    term in shared memory, 40 000 recompute it every pass."""

    @pytest.mark.parametrize("n_max", [2000, 40000])
    @pytest.mark.parametrize("bf16", [0, 1])
    @pytest.mark.parametrize("mode", sorted(SWEEP_MODES))
    @pytest.mark.parametrize("kind", ["fourier", "vonmises", "cauchy"])
    def test_k5_matches_twin(self, cuda_device, kind, mode, bf16, n_max):
        assert 2000 < toafit._lib().toafit_smem_events() < 40000  # one case a branch
        tpl, x, mask, exposure, phis = _sweep_operands(kind, n_max, cuda_device)
        cfg = toafit.ToAFitConfig(kind=kind, mxu_bf16=bf16, **SWEEP_MODES[mode])
        toafit.reset_launches()
        got = toafit.profile_sweep(kind, tpl, x, mask, exposure, phis, cfg)
        assert toafit.LAUNCHES["profile_sweep"] == 1
        want = toafit.profile_sweep_reference(kind, tpl, x, mask, exposure, phis, cfg)
        rtol = 1e-5 if bf16 and kind == "fourier" else None
        ll, ll_w = got[0].cpu().numpy(), want[0].cpu().numpy()
        np.testing.assert_array_equal(np.isfinite(ll), np.isfinite(ll_w))
        assert np.isfinite(ll_w).any()
        fin = np.isfinite(ll_w)
        np.testing.assert_allclose(ll[fin], ll_w[fin], rtol=rtol or 1e-12, atol=0)
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), rtol=rtol or 1e-10, atol=0)

    def test_k5_reruns_bitwise_and_rows_alone(self, cuda_device):
        tpl, x, mask, exposure, phis = _sweep_operands("vonmises", 3000, cuda_device)
        cfg = toafit.ToAFitConfig(kind="vonmises", vary_amps=True)
        first = toafit.profile_sweep("vonmises", tpl, x, mask, exposure, phis, cfg)
        again = toafit.profile_sweep("vonmises", tpl, x, mask, exposure, phis, cfg)
        assert all(torch.equal(a, b) for a, b in zip(first, again))
        n = int(mask[2].sum())  # the last row alone, padded only to its own length
        alone = toafit.profile_sweep("vonmises", tpl, x[2:, :n].contiguous(), mask[2:, :n].contiguous(),
                                     exposure[2:], phis[2:], cfg)
        assert all(torch.equal(a[0], b[2]) for a, b in zip(alone, first))

    def test_lone_segment_fit_is_its_row_of_an_84_segment_batch(self, cuda_device):
        rng = np.random.RandomState(41)
        tpl = profiles.ProfileParams(
            norm=torch.tensor(10.0, dtype=torch.float64), amp=torch.tensor([3.0, 1.0], dtype=torch.float64),
            loc=torch.tensor([0.2, -0.4], dtype=torch.float64), wid=torch.zeros(2, dtype=torch.float64),
            ph_shift=torch.tensor(0.0, dtype=torch.float64), amp_shift=torch.tensor(1.0, dtype=torch.float64))
        segs = []
        for _ in range(84):
            cand = rng.uniform(0, 1, 6000)
            dens = 10.0 + 3.0 * np.cos(2 * np.pi * cand + 0.2) + np.cos(4 * np.pi * cand - 0.4)
            segs.append(cand[rng.uniform(0, 14.5, cand.size) < dens][: rng.randint(800, 3000)])
        phases, masks = toafit.pad_segments(segs)
        exposures = np.array([len(s) / 10.0 for s in segs])
        cfg = toafit.ToAFitConfig(ph_shift_res=1000)
        toafit.reset_launches()
        batch = toafit.fit_toas_batch("fourier", tpl, phases, masks, exposures, cfg, device=cuda_device)
        # the brute grid and the dense window are sweeps, the refine one launch
        assert toafit.LAUNCHES["golden_refine"] == 1 and toafit.LAUNCHES["profile_sweep"] >= 2
        for r in (0, 41, 83):
            one = toafit.fit_toas_batch("fourier", tpl, segs[r][None], np.ones((1, len(segs[r])), bool),
                                        exposures[r:r + 1], cfg, device=cuda_device)
            for key in ("phShift", "phShift_LL", "phShift_UL", "norm", "ampShift", "logLmax", "errScanLoopIters"):
                assert torch.equal(one[key][0], batch[key][r]), (r, key)
            # the binned chi2 is torch code (a batched matrix product, a sum
            # over the bins), not K5: it rounds with the rows beside it
            np.testing.assert_allclose(one["redChi2"][0].item(), batch["redChi2"][r].item(), rtol=1e-12)

    def test_k5_refuses_what_it_cannot_take(self, cuda_device):
        from crimp_tpu_torch.resilience import KernelError

        tpl, x, mask, exposure, phis = _sweep_operands("fourier", 500, cuda_device)
        cfg = toafit.ToAFitConfig()
        toafit.reset_launches()
        with pytest.raises(KernelError, match="contiguous"):
            toafit.profile_sweep("fourier", tpl, x, mask, exposure, phis.T.contiguous().T, cfg)
        with pytest.raises(KernelError, match="float64"):
            toafit.profile_sweep("fourier", tpl, x.float(), mask, exposure, phis, cfg)
        wide = tpl.replace(amp=torch.ones(toafit.MAX_COMP + 1, dtype=torch.float64, device=cuda_device),
                           loc=torch.zeros(toafit.MAX_COMP + 1, dtype=torch.float64, device=cuda_device),
                           wid=torch.zeros(toafit.MAX_COMP + 1, dtype=torch.float64, device=cuda_device))
        with pytest.raises(KernelError, match="components"):
            toafit.profile_sweep("fourier", wide, x, mask, exposure, phis, cfg)
        assert toafit.LAUNCHES["profile_sweep"] == 0


GOLDEN_CASES = [(kind, mode, 0) for kind in ("fourier", "vonmises", "cauchy") for mode in sorted(SWEEP_MODES)] \
    + [("fourier", mode, 1) for mode in sorted(SWEEP_MODES)]


@pytest.mark.gpu
class TestGoldenRefine:
    """K5's golden-section refine in one launch against the chain it
    replaced: 2 + 2 refine_iters one-phase K5 sweeps under golden_section's
    torch bookkeeping, then a one-phase sweep at the optimum, bitwise."""

    @pytest.mark.parametrize("n_max", [2000, 40000])
    @pytest.mark.parametrize("kind,mode,bf16", GOLDEN_CASES)
    def test_golden_launch_is_bitwise_the_chain(self, cuda_device, kind, mode, bf16, n_max):
        tpl, x, mask, exposure, phis = _sweep_operands(kind, n_max, cuda_device, seed=42)
        cfg = toafit.ToAFitConfig(kind=kind, mxu_bf16=bf16, **SWEEP_MODES[mode])
        lo, hi = phis[:, 3].contiguous(), phis[:, 4].contiguous()
        events = toafit.sweep_events(kind, tpl, x, cfg)
        toafit.reset_launches()
        got = toafit.golden_refine(kind, tpl, x, mask, exposure, lo, hi, cfg, events)
        assert toafit.LAUNCHES == {"profile_sweep": 0, "golden_refine": 1}
        chain = toafit.golden_refine_reference(kind, tpl, x, mask, exposure, lo, hi, cfg,
                                               sweep=functools.partial(toafit.profile_sweep, events=events))
        assert toafit.LAUNCHES == {"profile_sweep": 2 + 2 * cfg.refine_iters + 1, "golden_refine": 1}
        names = ("phi_best", "ll_max", "a_best", "b_best")
        for name, g, w in zip(names, got, chain):
            assert torch.equal(g, w), name
        assert bool(torch.isfinite(got[1]).any())
        again = toafit.golden_refine(kind, tpl, x, mask, exposure, lo, hi, cfg)  # operands made anew
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        # a row alone (S = 1, padded to its own length) is its batch row
        n = int(mask[1].sum())
        alone = toafit.golden_refine(kind, tpl, x[1:2, :n].contiguous(), mask[1:2, :n].contiguous(), exposure[1:2],
                                     lo[1:2], hi[1:2], cfg)
        for name, a, b in zip(names, alone, got):
            assert torch.equal(a[0], b[1]), name

    def test_refused_launch_raises_out_of_the_fit(self, cuda_device, monkeypatch):
        from crimp_tpu_torch.resilience import KernelError

        tpl, x, mask, exposure, phis = _sweep_operands("fourier", 500, cuda_device)
        cfg = toafit.ToAFitConfig()
        lib = toafit._lib()
        rc = lib.toafit_golden(x.data_ptr(), mask.data_ptr(), exposure.data_ptr(), phis.data_ptr(), phis.data_ptr(),
                               None, None, None, None, 0, x.shape[1], 6, 0, 0, 20, 25, 500.0, 0.01, 100.0, 0,
                               None, None, None, None, torch.cuda.current_stream().cuda_stream)
        assert rc != 0  # no rows: refused before any launch
        with pytest.raises(KernelError, match="contiguous"):
            toafit.golden_refine("fourier", tpl, x, mask, exposure, phis[:, 1], phis[:, 2].contiguous(), cfg)

        class Refusing:  # the card refuses every cluster launch
            def __getattr__(self, name):
                return getattr(lib, name)

            @staticmethod
            def toafit_golden(*args):
                return 801  # cudaErrorNotSupported

        monkeypatch.setattr(toafit, "_LIB", Refusing())
        toafit.reset_launches()
        segs = [np.random.RandomState(r).uniform(0, 1, 700 + 50 * r) for r in range(3)]
        phases, masks = toafit.pad_segments(segs)
        with pytest.raises(KernelError, match="toafit_golden"):
            toafit.fit_toas_batch("fourier", tpl, phases, masks, [70.0, 75.0, 80.0], cfg, device=cuda_device)
        # the brute grid ran; no chain of one-phase sweeps and no twin took the refine's place
        assert toafit.LAUNCHES == {"profile_sweep": 1, "golden_refine": 0}


def _rv_operands(kind, dev, n_rows=3, n_max=1500, seed=50):
    """(template, x, mask, exposure, phis (S, 8), cfg) for K6: a
    two-component template with every parameter (and ampShift) free, ragged
    rows of uniform phases in the family's cycle."""
    rng = np.random.RandomState(seed)
    t = lambda v: torch.as_tensor(np.asarray(v, dtype=np.float64))  # noqa: E731
    if kind == "fourier":
        tpl = profiles.ProfileParams(norm=t(10.0), amp=t([3.0, 1.2]), loc=t([0.2, -0.9]), wid=t([0.0, 0.0]),
                                     ph_shift=t(0.0), amp_shift=t(1.0))
        idx, lo, hi = (0, 1, 2, 3, 4, 7), (2.0, 0.1, 0.0, -np.pi, -np.pi, 0.2), (50.0, 8.0, 4.0, np.pi, np.pi, 5.0)
    else:
        tpl = profiles.ProfileParams(norm=t(2.0), amp=t([3.0, 1.0]), loc=t([1.2, 3.6]),
                                     wid=t([0.5, 0.8] if kind == "vonmises" else [0.3, 0.5]), ph_shift=t(0.0),
                                     amp_shift=t(1.0))
        idx = (0, 1, 2, 3, 4, 5, 6, 7)
        lo, hi = (0.4, 0.0, 0.0, 0.6, 3.0, 0.05, 0.05, 0.2), (10.0, 15.0, 5.0, 1.8, 4.2, 3.0, 3.0, 5.0)
    cycle = 1.0 if kind == "fourier" else 2 * np.pi
    counts = [n_max, n_max - 300, n_max - 700][:n_rows]
    x = np.zeros((n_rows, n_max))
    mask = np.zeros((n_rows, n_max), dtype=bool)
    for r, n in enumerate(counts):
        x[r, :n] = rng.uniform(0, cycle, n)
        mask[r, :n] = True
    exposure = np.array(counts, dtype=float) / 10.0
    half = np.pi if kind == "fourier" else 1.5 * np.pi
    phis = np.linspace(-half, half, 8)[None, :] + rng.uniform(-0.05, 0.05, (n_rows, 8))
    cfg = toafit.ToAFitConfig(kind=kind, free_idx=idx, free_lo=lo, free_hi=hi, nm_iters=80)
    as_dev = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    return tpl.to(dev), as_dev(x), as_dev(mask), as_dev(exposure), as_dev(phis), cfg


@pytest.mark.gpu
class TestGeneralSweepKernel:
    """K6, the readvaryparam fit's bounded Nelder-Mead, against its twin on
    the card: general_nll's event sums are K6's fixed order and each of its
    operations the one K6 takes, so the evaluation and the whole Nelder-Mead
    are expected bit for bit (held to LL rtol 1e-12 and vectors rtol 1e-10
    at the least); reruns bitwise; a row alone its batch row; the Nelder-Mead
    replayed in K6's order over K6's own evaluation is K6's, step by step."""

    @pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
    @pytest.mark.parametrize("kind", ["fourier", "vonmises", "cauchy"])
    def test_k6_matches_its_twin(self, cuda_device, kind, warm):
        from crimp_tpu_torch.ops import general_sweep

        tpl, x, mask, exposure, phis, cfg = _rv_operands(kind, cuda_device)
        warm_vec = None
        if warm:
            warm_vec = general_sweep.flatten_template(tpl).expand(3, -1).clone()
            warm_vec[:, 0] *= 1.1
        pk = general_sweep.pack(tpl, cfg, 3, warm_vec, cuda_device)
        u = (pk["u0"][:, None, None, :] + 0.3 * torch.as_tensor(
            np.random.RandomState(1).standard_normal((3, 8, 6, len(cfg.free_idx))), device=cuda_device)).contiguous()
        f_k = general_sweep.general_eval(kind, tpl, x, mask, exposure, phis, cfg, u)
        f_t = general_sweep.general_nll(kind, pk, x, mask, exposure, phis, u)
        fin = torch.isfinite(f_t)
        assert torch.equal(torch.isfinite(f_k), fin)
        assert bool(torch.all(torch.abs(f_k[fin] - f_t[fin]) <= 1e-12 * torch.abs(f_t[fin])))
        general_sweep.reset_launches()
        ll, vec, shrinks, reads, steps = general_sweep._launch_nm(kind, tpl, x, mask, exposure, phis, cfg,
                                                                  warm_vec, trace=True)
        assert general_sweep.LAUNCHES["general_sweep"] == 1
        ll_t, vec_t = general_sweep.general_profile_reference(kind, tpl, x, mask, exposure, phis, cfg, warm_vec)
        assert bool(torch.all(torch.abs(ll - ll_t) <= 1e-12 * torch.abs(ll_t)))
        assert bool(torch.all(torch.abs(vec - vec_t) <= 1e-10 * torch.abs(vec_t)))
        again = general_sweep.general_profile(kind, tpl, x, mask, exposure, phis, cfg, warm_vec)
        assert torch.equal(again[0], ll) and torch.equal(again[1], vec)
        # the replay over K6's evaluation takes K6's decisions and ends on its bits
        ll_r, vec_r, trace = general_sweep.mirror_profile(kind, tpl, x, mask, exposure, phis, cfg, warm_vec,
                                                          kernel=True)
        assert torch.equal(ll_r, ll) and torch.equal(vec_r, vec)
        assert torch.equal(torch.stack([t["step"] for t in trace], -1).reshape(steps.shape).to(torch.int8), steps)
        assert torch.equal(shrinks, sum((t["step"] == 4).int() for t in trace))
        # the candidate values K6's decisions read: what k6_counts charges
        assert torch.equal(reads.long(), sum(t["reads"] for t in trace))
        # a row alone, padded to its own length
        n = int(mask[1].sum())
        alone = general_sweep.general_profile(kind, tpl, x[1:2, :n].contiguous(), mask[1:2, :n].contiguous(),
                                              exposure[1:2], phis[1:2].contiguous(), cfg,
                                              None if warm_vec is None else warm_vec[1:2])
        assert torch.equal(alone[0][0], ll[1]) and torch.equal(alone[1][0], vec[1])

    @pytest.mark.parametrize("n_phis", [128, 64, 7, 1])
    @pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
    @pytest.mark.parametrize("kind", ["fourier", "vonmises", "cauchy"])
    def test_k6_is_bitwise_its_twin(self, cuda_device, kind, warm, n_phis):
        """K6 (G phases a block, general_sweep.group_for; 7 phases: a ragged
        last group) against the twin's branch-free Nelder-Mead, bit for bit
        in LL, vectors, the per-step decisions, the shrink steps and the
        candidate values read; a row alone bitwise its batch row."""
        from crimp_tpu_torch.ops import general_sweep

        tpl, x, mask, exposure, _, cfg = _rv_operands(kind, cuda_device)
        half = np.pi if kind == "fourier" else 1.5 * np.pi
        rng = np.random.RandomState(n_phis)
        phis = torch.as_tensor(np.linspace(-half, half, n_phis)[None, :] + rng.uniform(-0.05, 0.05, (3, n_phis)),
                               device=cuda_device)
        warm_vec = None
        if warm:
            warm_vec = general_sweep.flatten_template(tpl).expand(3, -1).clone()
            warm_vec[:, 0] *= 1.1
        got = general_sweep._launch_nm(kind, tpl, x, mask, exposure, phis, cfg, warm_vec, trace=True)
        trace = []
        ll_t, vec_t = general_sweep.general_profile_reference(kind, tpl, x, mask, exposure, phis, cfg, warm_vec, trace)
        ll, vec, shrinks, reads, steps = got
        assert torch.equal(ll, ll_t) and torch.equal(vec, vec_t)
        assert torch.equal(torch.stack([t["step"] for t in trace], -1).to(torch.int8), steps)
        assert torch.equal(shrinks.long(), sum((t["step"] == 4).long() for t in trace))
        assert torch.equal(reads.long(), sum(t["reads"] for t in trace))
        n = int(mask[1].sum())
        alone = general_sweep._launch_nm(kind, tpl, x[1:2, :n].contiguous(), mask[1:2, :n].contiguous(),
                                         exposure[1:2], phis[1:2].contiguous(), cfg,
                                         None if warm_vec is None else warm_vec[1:2], trace=True)
        assert all(torch.equal(a[0], b[1]) for a, b in zip(alone, got))

    def test_every_group_size_is_bitwise(self, cuda_device):
        """The phases a block takes side by side move no bit: every G of
        general_sweep.GROUPS (a ragged last group at 36 phases) gives the
        default launch's bits."""
        from crimp_tpu_torch.ops import general_sweep

        tpl, x, mask, exposure, _, cfg = _rv_operands("fourier", cuda_device)
        phis = torch.as_tensor(np.linspace(-np.pi, np.pi, 36), device=cuda_device).expand(3, 36).contiguous()
        want = general_sweep._launch_nm("fourier", tpl, x, mask, exposure, phis, cfg, trace=True)
        for g in general_sweep.GROUPS:
            got = general_sweep._launch_nm("fourier", tpl, x, mask, exposure, phis, cfg, trace=True, group=g)
            assert all(torch.equal(a, b) for a, b in zip(got, want)), g

    def test_shrink_path(self, cuda_device):
        """A one-harmonic template whose amplitude nearly reaches its norm (the
        model touches zero): its Nelder-Mead shrinks, and K6 is the twin."""
        from crimp_tpu_torch.ops import general_sweep

        t = lambda v: torch.as_tensor(np.asarray(v, dtype=np.float64))  # noqa: E731
        tpl = profiles.ProfileParams(norm=t(1.0), amp=t([0.99]), loc=t([0.2]), wid=t([0.0]), ph_shift=t(0.0),
                                     amp_shift=t(1.0)).to(cuda_device)
        x = torch.as_tensor(np.random.RandomState(41).uniform(0, 1, (3, 2000)), device=cuda_device)
        mask = torch.ones(3, 2000, dtype=torch.bool, device=cuda_device)
        exposure = torch.full((3,), 2000.0, dtype=torch.float64, device=cuda_device)
        phis = torch.as_tensor(np.linspace(-3, 3, 8), device=cuda_device).expand(3, 8).contiguous()
        cfg = toafit.ToAFitConfig(kind="fourier", free_idx=(0, 1, 2), free_lo=(0.2, 0.0, -np.pi),
                                  free_hi=(5.0, 1000.0, np.pi), nm_iters=150)
        ll, vec, shrinks, _, _ = general_sweep._launch_nm("fourier", tpl, x, mask, exposure, phis, cfg)
        ll_t, vec_t = general_sweep.general_profile_reference("fourier", tpl, x, mask, exposure, phis, cfg)
        assert int(shrinks.sum()) > 0
        assert bool(torch.all(torch.abs(ll - ll_t) <= 1e-12 * torch.abs(ll_t)))
        assert bool(torch.all(torch.abs(vec - vec_t) <= 1e-10 * torch.abs(vec_t)))

    def test_refused_launch_raises(self, cuda_device, monkeypatch):
        from crimp_tpu_torch.ops import general_sweep
        from crimp_tpu_torch.resilience import KernelError

        tpl, x, mask, exposure, phis, cfg = _rv_operands("fourier", cuda_device)
        with pytest.raises(KernelError, match="contiguous"):
            general_sweep.general_profile("fourier", tpl, x, mask, exposure, phis.float(), cfg)
        lib = general_sweep._lib()

        class Refusing:
            def __getattr__(self, name):
                return getattr(lib, name)

            @staticmethod
            def toafit_general_nm(*args):
                return 801  # cudaErrorNotSupported

        monkeypatch.setattr(general_sweep, "_LIB", Refusing())
        general_sweep.reset_launches()
        with pytest.raises(KernelError, match="toafit_general_nm"):
            toafit.fit_toas_batch("fourier", tpl.to("cpu"), x.cpu().numpy(), mask.cpu().numpy(),
                                  exposure.cpu().numpy(), cfg, device=cuda_device)
        assert general_sweep.LAUNCHES["general_sweep"] == 0

    def test_measure_toas_readvaryparam_cuda_vs_cpu(self, cuda_device, tmp_path):
        """measure_toas -rv on two short windows of the bundled observation,
        three template parameters flagged vary: cuda (K6) against cpu (the
        twin), phShift within 1e-6 rad, LL/UL within one step."""
        from crimp_tpu_torch.ops import general_sweep
        from crimp_tpu_torch.pipelines.measure_toas import measure_toas

        lines = (DATA / "1e2259_template.txt").read_text().splitlines()
        keep = {"norm", "amp_2", "ph_2"}
        tpl_path = tmp_path / "template_rv.txt"
        tpl_path.write_text("\n".join(
            ln.replace("vary True", "vary True" if (ln.split() or [""])[0] in keep else "vary False") for ln in lines) + "\n")
        from crimp_tpu_torch.io.events import EventFile

        t = EventFile(str(DATA / "1e2259_ni1020600110.fits")).build_time_energy_df().filtenergy(
            1.0, 5.0).time_energy_df["TIME"]
        out = ["ToA\tToA_tstart\tToA_tend\tToA_lenInt\tToA_exposure\tEvents\tct_rate"]
        for i, (a, b) in enumerate(((0, 799), (800, 1599))):
            t0, t1 = float(t[a]), float(t[b])
            exposure = (t1 - t0) * 86400.0
            out.append("\t".join([str(i), repr(t0), repr(t1), repr(t1 - t0), repr(exposure), "800",
                                   repr(800 / exposure)]))
        gti = tmp_path / "intervals_rv.txt"
        gti.write_text("\n".join(out) + "\n")
        res = {}
        for dev in (cuda_device, "cpu"):
            general_sweep.reset_launches()
            res[str(dev)] = measure_toas(str(DATA / "1e2259_ni1020600110.fits"), str(DATA / "1e2259.par"),
                                         str(tpl_path), str(gti), eneLow=1.0, eneHigh=5.0, phShiftRes=100,
                                         readvaryparam=True, toaFile=str(tmp_path / f"ToAs_{dev}"),
                                         timFile=str(tmp_path / f"ToAs_{dev}"), plotResiduals=False, device=dev)
            assert (general_sweep.LAUNCHES["general_sweep"] > 0) == (str(dev) != "cpu")
        g, c = res[str(cuda_device)], res["cpu"]
        assert len(g["phShift"]) == 2
        np.testing.assert_allclose(g["phShift"], c["phShift"], atol=1e-6, rtol=0)
        step = 2 * np.pi / 100
        for key in ("phShift_LL", "phShift_UL"):
            assert np.max(np.abs(np.asarray(g[key]) - np.asarray(c[key]))) <= step * (1 + 1e-9)


def _golden_chain(kind, tpl, x, mask, exposure, lo, hi, cfg):
    """The chain one toafit_general_golden launch replaces, on the card:
    golden_section over one-phase K6 launches, then the launch at the
    optimum; with the shrink steps and candidate values read summed over
    the refine's 2 + 2 refine_iters launches, per row."""
    from crimp_tpu_torch.ops import general_sweep

    counts = []

    def sweep(kind_, tpl_, x_, mask_, exposure_, phis_, cfg_):
        ll, vec, shrinks, reads, _ = general_sweep._launch_nm(kind_, tpl_, x_, mask_, exposure_, phis_, cfg_)
        counts.append((shrinks[:, 0], reads[:, 0]))
        return ll, vec

    out = general_sweep.general_golden_reference(kind, tpl, x, mask, exposure, lo, hi, cfg, sweep=sweep)
    assert len(counts) == 2 + 2 * cfg.refine_iters + 1
    return out, sum(c[0] for c in counts[:-1]), sum(c[1] for c in counts[:-1])


def _nan_bits(a, b) -> bool:
    return torch.equal(torch.isnan(a), torch.isnan(b)) and torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))


@pytest.mark.gpu
class TestGeneralGoldenKernel:
    """K6's golden-section refine in one launch (toafit_general_golden) against
    the chain it replaced: 2 + 2 refine_iters one-phase K6 launches under
    golden_section's torch bookkeeping, then the launch at the optimum, bit
    for bit in phi_best, ll_max and the refit vector, and in the shrink
    steps and candidate values read it reports."""

    @pytest.mark.parametrize("refine_iters", [25, 3])
    @pytest.mark.parametrize("kind", ["fourier", "vonmises", "cauchy"])
    def test_golden_launch_is_bitwise_the_chain(self, cuda_device, kind, refine_iters):
        from crimp_tpu_torch.ops import general_sweep

        tpl, x, mask, exposure, phis, cfg = _rv_operands(kind, cuda_device)
        cfg = cfg._replace(refine_iters=refine_iters)
        lo, hi = phis[:, 3].contiguous(), phis[:, 4].contiguous()
        general_sweep.reset_launches()
        got = general_sweep._launch_golden(kind, tpl, x, mask, exposure, lo, hi, cfg)
        assert general_sweep.LAUNCHES == {"general_sweep": 0, "general_eval": 0, "general_golden": 1}
        (phi, ll, vec), shrinks, reads = _golden_chain(kind, tpl, x, mask, exposure, lo, hi, cfg)
        assert torch.equal(got[0], phi) and torch.equal(got[1], ll) and torch.equal(got[2], vec)
        assert torch.equal(got[3].long(), shrinks.long()) and torch.equal(got[4].long(), reads.long())
        assert bool(torch.isfinite(got[1]).all()) and bool(torch.all((got[0] >= lo) & (got[0] <= hi)))
        # the wrapper: the same launch, the same bits
        again = general_sweep.general_golden(kind, tpl, x, mask, exposure, lo, hi, cfg)
        assert all(torch.equal(a, b) for a, b in zip(again, got[:3]))
        # a row alone (S = 1, padded to its own length) is its batch row
        n = int(mask[2].sum())
        alone = general_sweep._launch_golden(kind, tpl, x[2:3, :n].contiguous(), mask[2:3, :n].contiguous(),
                                             exposure[2:3], lo[2:3], hi[2:3], cfg)
        assert all(torch.equal(a[0], b[2]) for a, b in zip(alone, got))

    def test_nan_row_is_the_chain(self, cuda_device):
        from crimp_tpu_torch.ops import general_sweep

        tpl, x, mask, exposure, phis, cfg = _rv_operands("vonmises", cuda_device)
        cfg = cfg._replace(refine_iters=5)
        exposure = exposure.clone()
        exposure[1] = float("nan")
        lo, hi = phis[:, 3].contiguous(), phis[:, 4].contiguous()
        got = general_sweep._launch_golden("vonmises", tpl, x, mask, exposure, lo, hi, cfg)
        (phi, ll, vec), _, _ = _golden_chain("vonmises", tpl, x, mask, exposure, lo, hi, cfg)
        assert bool(torch.isnan(got[1][1])) and bool(torch.isfinite(got[1][[0, 2]]).all())
        assert _nan_bits(got[0], phi) and _nan_bits(got[1], ll) and _nan_bits(got[2], vec)

    def test_operands_and_refusals_raise(self, cuda_device, monkeypatch):
        from crimp_tpu_torch.ops import general_sweep
        from crimp_tpu_torch.resilience import KernelError

        tpl, x, mask, exposure, phis, cfg = _rv_operands("fourier", cuda_device)
        lo, hi = phis[:, 3].contiguous(), phis[:, 4].contiguous()
        for bad in ({"lo": lo.float()}, {"hi": hi.cpu()}, {"hi": hi[:2]}, {"cfg": cfg._replace(refine_iters=-1)},
                    {"kind": "gaussian"}):
            kw = {"kind": "fourier", "lo": lo, "hi": hi, "cfg": cfg, **bad}
            with pytest.raises(KernelError):
                general_sweep.general_golden(kw["kind"], tpl, x, mask, exposure, kw["lo"], kw["hi"], kw["cfg"])
        lib = general_sweep._lib()

        class Refusing:
            def __getattr__(self, name):
                return getattr(lib, name)

            @staticmethod
            def toafit_general_golden(*args):
                return 801  # cudaErrorNotSupported

        def refuse(*a, **k):
            raise AssertionError("the chain or the twin took the refine's place")

        monkeypatch.setattr(general_sweep, "_LIB", Refusing())
        monkeypatch.setattr(general_sweep, "general_golden_reference", refuse)
        general_sweep.reset_launches()
        cfg = cfg._replace(n_brute=16, refine_iters=4, nm_iters=20)
        with pytest.raises(KernelError, match="toafit_general_golden"):
            toafit.fit_toas_batch("fourier", tpl.to("cpu"), x.cpu().numpy(), mask.cpu().numpy(),
                                  exposure.cpu().numpy(), cfg, device=cuda_device)
        assert general_sweep.LAUNCHES == {"general_sweep": 1, "general_eval": 0, "general_golden": 0}

    def test_fit_launches_one_golden_and_equals_the_chained_fit(self, cuda_device, monkeypatch):
        """A readvaryparam fit on the card: one golden launch, no twin; bit
        for bit the fit whose refine is the chain of one-phase launches."""
        from crimp_tpu_torch.ops import general_sweep

        tpl, x, mask, exposure, _, cfg = _rv_operands("cauchy", cuda_device)
        cfg = cfg._replace(n_brute=32, refine_iters=8, nm_iters=40, ph_shift_res=200, err_chunk=4,
                           err_dense_window=4)
        host = (x.cpu().numpy(), mask.cpu().numpy(), exposure.cpu().numpy())
        general_sweep.reset_launches()
        fit = toafit.fit_toas_batch("cauchy", tpl.to("cpu"), *host, cfg, device=cuda_device)
        one = dict(general_sweep.LAUNCHES)
        assert one["general_golden"] == 1 and one["general_eval"] == 0 and one["general_sweep"] >= 2

        def chain(kind_, tpl_, x_, mask_, exposure_, lo_, hi_, cfg_):
            out, shrinks, reads = _golden_chain(kind_, tpl_, x_, mask_, exposure_, lo_, hi_, cfg_)
            return (*out, shrinks.int(), reads.int())

        monkeypatch.setattr(general_sweep, "_launch_golden", chain)
        general_sweep.reset_launches()
        chained = toafit.fit_toas_batch("cauchy", tpl.to("cpu"), *host, cfg, device=cuda_device)
        assert general_sweep.LAUNCHES["general_sweep"] == one["general_sweep"] + 2 + 2 * cfg.refine_iters + 1
        for key in fit:
            assert torch.equal(fit[key], chained[key]), key


def _bundled_rv_fit():
    """(kind, template, cfg) of the north star's -rv fit: the bundled Fourier
    template with its 13 vary parameters free, nm_iters 150."""
    from crimp_tpu_torch.io import template as template_io

    tpl_dict = template_io.read_template(str(DATA / "1e2259_template.txt"))
    kind, tpl = profiles.from_template(tpl_dict)
    idx, lo, hi, n_free = toafit.free_param_spec(kind, tpl_dict)
    return kind, tpl, toafit.ToAFitConfig(kind=kind, free_idx=idx, free_lo=lo, free_hi=hi, n_free=n_free)


def _nm_stage_operands(kind, phases, dev):
    """K6 Nelder-Mead operands of a stage case: the north star's rows (84 x
    10 000 events) at the brute grid (``phases`` 128) or a 64-phase dense
    window, or ``_rv_operands``' 3 ragged rows of 15 300 to 16 000 events,
    each longer than the stage, at 8 phases (``phases`` "ragged")."""
    if phases == "ragged":
        return _rv_operands(kind, dev, n_max=16000)
    kind, tpl, cfg = _bundled_rv_fit()
    _, intervals, x, mask = _north_star_rows()
    x, mask = torch.as_tensor(x, device=dev), torch.as_tensor(mask, device=dev)
    exposure = torch.as_tensor(intervals["ToA_exposure"].astype(float), device=dev)
    if phases == 128:
        phis = torch.linspace(-np.pi, np.pi, 128, dtype=torch.float64, device=dev).expand(x.shape[0], 128)
    else:
        phis = (0.3 + (2 * np.pi / 1000) * (torch.arange(64, device=dev) - 32)).to(torch.float64).expand(x.shape[0], 64)
    return tpl.to(dev), x, mask, exposure, phis.contiguous(), cfg


# the golden launch in every family (ids as before), nm_kernel<2> and <4> on
# the north star's rows, one ragged Fourier case whose rows pass the stage
# and one von Mises case, which stages nothing
STAGE_CASES = ([pytest.param("golden", kind, None, None, id=kind) for kind in ("fourier", "vonmises", "cauchy")]
               + [pytest.param("nm", "fourier", phases, group, id=f"nm{group}-84x{phases}")
                  for group in (4, 2) for phases in (128, 64)]
               + [pytest.param("nm", "fourier", "ragged", 4, id="nm4-ragged"),
                  pytest.param("nm", "vonmises", "ragged", 4, id="nm4-vonmises")])


@pytest.mark.gpu
class TestGeneralGoldenStage:
    """The staged first harmonic pairs move no bit. The golden launch: the
    planned stage, a stage short of the rows (their tails compute the pair),
    n_stage 0 and the whole row give the same five outputs, the chain's, for
    every family (von Mises and Cauchy stage nothing). nm_kernel<2> and <4>:
    the planned stage gives n_stage 0's LL, vectors, shrinks, reads and
    trace on the north star's rows and on rows longer than the stage; von
    Mises plans no stage. A stage the entry cannot take raises KernelError."""

    @pytest.mark.parametrize("launch,kind,phases,group", STAGE_CASES)
    def test_stage_moves_no_bit_on_either_side(self, cuda_device, launch, kind, phases, group):
        from crimp_tpu_torch.ops import general_sweep

        if launch == "nm":
            tpl, x, mask, exposure, phis, cfg = _nm_stage_operands(kind, phases, cuda_device)
            N, F = x.shape[1], len(cfg.free_idx)
            planned = general_sweep.nm_stage(kind, group, F, N)
            if kind != "fourier":
                assert planned == 0
            elif phases == "ragged":
                assert 0 < planned < int(mask.sum(dim=1).min())  # every row has a computed tail
            else:
                assert planned == N  # the north star's 10 000-event rows stage whole
            got = general_sweep._launch_nm(kind, tpl, x, mask, exposure, phis, cfg, trace=True, group=group)
            for stage in (0, general_sweep.STAGE_STEP, planned):
                again = general_sweep._launch_nm(kind, tpl, x, mask, exposure, phis, cfg, trace=True, group=group,
                                                 stage=stage)
                assert all(torch.equal(a, b) for a, b in zip(again, got)), stage
            return
        tpl, x, mask, exposure, phis, cfg = _rv_operands(kind, cuda_device, n_max=16000)
        cfg = cfg._replace(refine_iters=4)
        lo, hi = phis[:, 3].contiguous(), phis[:, 4].contiguous()
        N, F = x.shape[1], len(cfg.free_idx)
        planned = general_sweep.stage_events(2, F, N, general_sweep._lib().toafit_general_golden_room())
        assert 0 < planned < int(mask.sum(dim=1).min())  # every row has a computed tail
        got = general_sweep._launch_golden(kind, tpl, x, mask, exposure, lo, hi, cfg)
        (phi, ll, vec), shrinks, reads = _golden_chain(kind, tpl, x, mask, exposure, lo, hi, cfg)
        assert all(torch.equal(a, b) for a, b in zip(got, (phi, ll, vec, shrinks.int(), reads.int())))
        for stage in (0, general_sweep.STAGE_STEP, planned):
            again = general_sweep._launch_golden(kind, tpl, x, mask, exposure, lo, hi, cfg, stage=stage)
            assert all(torch.equal(a, b) for a, b in zip(again, got)), stage

    @pytest.mark.parametrize("kind", ["fourier", "vonmises", "cauchy"])
    def test_whole_row_stage_and_none_are_the_same(self, cuda_device, kind):
        from crimp_tpu_torch.ops import general_sweep

        tpl, x, mask, exposure, phis, cfg = _rv_operands(kind, cuda_device)
        cfg = cfg._replace(refine_iters=6)
        lo, hi = phis[:, 3].contiguous(), phis[:, 4].contiguous()
        whole = general_sweep._launch_golden(kind, tpl, x, mask, exposure, lo, hi, cfg, stage=x.shape[1])
        none = general_sweep._launch_golden(kind, tpl, x, mask, exposure, lo, hi, cfg, stage=0)
        planned = general_sweep._launch_golden(kind, tpl, x, mask, exposure, lo, hi, cfg)
        assert all(torch.equal(a, b) and torch.equal(a, c) for a, b, c in zip(whole, none, planned))

    def test_stages_the_entry_cannot_take_raise(self, cuda_device):
        from crimp_tpu_torch.ops import general_sweep
        from crimp_tpu_torch.resilience import KernelError

        tpl, x, mask, exposure, phis, cfg = _rv_operands("fourier", cuda_device, n_max=40000)
        lo, hi = phis[:, 3].contiguous(), phis[:, 4].contiguous()
        N = x.shape[1]
        room = general_sweep._lib().toafit_general_golden_room()
        assert general_sweep.stage_events(2, len(cfg.free_idx), N, room) < N  # 40 000 events do not fit
        general_sweep.reset_launches()
        for stage in (N, general_sweep.STAGE_STEP + 1, N + general_sweep.STAGE_STEP, -general_sweep.STAGE_STEP):
            with pytest.raises(KernelError, match="toafit_general_golden"):
                general_sweep._launch_golden("fourier", tpl, x, mask, exposure, lo, hi, cfg, stage=stage)
            with pytest.raises(KernelError, match="toafit_general_nm"):  # nm_kernel<4>, 8 phases a row
                general_sweep._launch_nm("fourier", tpl, x, mask, exposure, phis, cfg, stage=stage)
        with pytest.raises(KernelError, match="toafit_general_nm"):  # nm_kernel<1> stages nothing
            general_sweep._launch_nm("fourier", tpl, x, mask, exposure, phis[:, :1].contiguous(), cfg,
                                     stage=general_sweep.STAGE_STEP)
        assert general_sweep.LAUNCHES["general_golden"] == general_sweep.LAUNCHES["general_sweep"] == 0


def _north_star_rows():
    """(times, intervals, phases, masks) of the north star's 84 intervals at
    10 000 events a ToA, folded on the card and padded."""
    from crimp_tpu_torch.models import timing
    from crimp_tpu_torch.utils import surrogate

    times, intervals = surrogate.build_surrogate(str(DATA / "1e2259.par"), str(DATA / "timIntToAs_1e2259.txt"),
                                                 str(DATA / "1e2259_template.txt"), events_per_toa=10000, seed=7)
    segs = surrogate.slice_intervals(times, intervals["ToA_tstart"], intervals["ToA_tend"])
    seg_phases, _ = anchored.fold_segments(timing.resolve(str(DATA / "1e2259.par")), segs, device="cuda")
    phases, masks = toafit.pad_segments(seg_phases)
    return times, intervals, phases, masks


def _profiled(fn):
    """fn() under torch.profiler on the card: (host events, device events),
    each (name, start ns, end ns)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    host, device = [], []
    for ev in prof.profiler.kineto_results.events():
        row = (ev.name(), int(ev.start_ns()), int(ev.start_ns()) + int(ev.duration_ns()))
        (device if ev.device_type() == DeviceType.CUDA else host).append(row)
    return host, device


@pytest.mark.gpu
class TestRowGroupsOnCard:
    """The readvaryparam fit's row groups on the card: each group's chain of
    K6 launches on a stream of its own, every column the one-group fit's."""

    @staticmethod
    def _rows(dev):
        tpl, _, _, _, _, cfg = _rv_operands("fourier", dev)
        rng = np.random.RandomState(61)
        counts = [1500, 400, 1100, 1500, 700, 250, 1300, 900, 600]
        x = np.zeros((len(counts), max(counts)))
        mask = np.zeros(x.shape, dtype=bool)
        for r, n in enumerate(counts):
            x[r, :n] = rng.uniform(0, 1, n)
            mask[r, :n] = True
        cfg = cfg._replace(n_brute=32, refine_iters=6, nm_iters=40, ph_shift_res=200, err_chunk=4,
                           err_dense_window=4)
        return tpl.to("cpu"), x, mask, np.array(counts, dtype=float) / 10.0, cfg

    @pytest.mark.parametrize("plan", [[[0, 3, 6], [2, 7, 4], [8, 1, 5]], [[5], [1, 8, 4, 7], [0, 2, 3, 6]]],
                             ids=["sorted", "permuted"])
    def test_grouped_fit_is_the_one_group_fit(self, cuda_device, monkeypatch, plan):
        tpl, x, mask, exposure, cfg = self._rows(cuda_device)
        monkeypatch.setattr(toafit, "_row_groups", lambda *args, **kwargs: None)
        one = toafit.fit_toas_batch("fourier", tpl, x, mask, exposure, cfg, device=cuda_device)
        monkeypatch.setattr(toafit, "_row_groups", lambda *args, **kwargs: [np.asarray(g) for g in plan])
        grouped = toafit.fit_toas_batch("fourier", tpl, x, mask, exposure, cfg, device=cuda_device)
        for key in one:
            assert torch.equal(torch.nan_to_num(grouped[key]), torch.nan_to_num(one[key])), key
        streams = [toafit._GROUP_STREAMS[(torch.device(cuda_device.type, torch.cuda.current_device()), g)]
                   for g in range(len(plan))]
        assert [s.priority for s in streams] == sorted(s.priority for s in streams)
        assert len({s.cuda_stream for s in streams}) == len(plan)

    def test_the_campaign_rows_take_groups(self, cuda_device):
        lines = (DATA / "timIntToAs_1e2259.txt").read_text().splitlines()
        counts = np.array([int(float(line.split()[5])) for line in lines[1:]])
        x = torch.zeros((counts.size, 8), dtype=torch.float64, device=cuda_device)
        cfg = _bundled_rv_fit()[2]
        groups = toafit._row_groups(x, x > 0, cfg, row_events=counts)
        if torch.cuda.get_device_properties(cuda_device).multi_processor_count >= 100:
            assert groups is not None and len(groups) >= 2
        if groups is not None:
            assert np.concatenate(groups).tolist() == np.argsort(-counts, kind="stable").tolist()


@pytest.mark.gpu
class TestProfilerRanges:
    """The spans as torch.profiler ranges on the card: one range a K6 launch
    of a -rv fit at the north-star rows, each inside the fit's layer span,
    none on the device's timeline; and a traced campaign pass whose device
    idle lies inside step spans for at least 85% of it."""

    def test_rv_fit_has_one_range_a_k6_launch(self, cuda_device):
        from crimp_tpu_torch.io import template as template_io
        from crimp_tpu_torch.obs import names
        from crimp_tpu_torch.ops import general_sweep

        _, intervals, phases, masks = _north_star_rows()
        tpl_dict = template_io.read_template(str(DATA / "1e2259_template.txt"))
        kind, tpl = profiles.from_template(tpl_dict)
        idx, lo, hi, n_free = toafit.free_param_spec(kind, tpl_dict)
        cfg = toafit.ToAFitConfig(kind=kind, ph_shift_res=1000, nbins=15, free_idx=idx, free_lo=lo, free_hi=hi,
                                  n_free=n_free)
        exposures = intervals["ToA_exposure"].astype(float)
        def fit():
            return toafit.fit_toas_batch_auto(kind, tpl, phases, masks, exposures, cfg, device=cuda_device)

        fit()  # warm-up
        general_sweep.reset_launches()
        host, device = _profiled(fit)
        sites = [ev for ev in host if ev[0].startswith("toa_general_")]
        assert len(sites) == sum(general_sweep.LAUNCHES.values()) >= 4
        (layer,) = [ev for ev in host if ev[0] == names.FIT]
        assert all(layer[1] <= a and b <= layer[2] for _, a, b in sites)
        assert not [ev for ev in device if ev[0].startswith(("crimp.", "toa_"))]

    def test_campaign_pass_idle_lies_in_step_spans(self, cuda_device):
        from crimp_tpu_torch.obs import names
        from crimp_tpu_torch.utils import surrogate
        from portbench import spans

        times, intervals, _, _ = _north_star_rows()
        args = (str(DATA / "1e2259.par"), str(DATA / "1e2259_template.txt"), times, intervals)
        surrogate.north_star(*args, device=cuda_device)  # warm-up
        host, device = _profiled(lambda: surrogate.north_star(*args, device=cuda_device))
        (whole,) = [(a, b) for name, a, b in host if name == names.PASS]
        busy = spans.union((a, b) for _, a, b in device)
        idle = spans.idle_ns([whole], busy)
        in_steps = spans.idle_ns(spans.union((a, b) for name, a, b in host if spans.is_step(name)), busy)
        assert idle > 0 and in_steps >= 0.85 * idle, (in_steps / 1e6, idle / 1e6)


@pytest.mark.gpu
class TestParallelOnCard:
    """The sharded twins on shards of one card (``virtual_devices``): every
    shard launches its hand kernel; trial shards and event shards of whole
    splits of the monolithic plan are the monolithic call's bits, other
    layouts within the kernel twin's tolerance; the refold bitwise; the
    native reader reads the pure bits."""

    SPLIT = 1 << 16  # 200 000 events: 4 splits

    def test_k2_whole_splits_and_trial_shards_bitwise(self, cuda_device):
        from crimp_tpu_torch.parallel import mesh as pmesh

        t = _pulsed(200000)
        freqs = np.linspace(0.2490, 0.2510, 1500)
        fdots = np.array([-1e-13, 0.0])
        f0, df = search.uniform_grid(freqs)
        mono = search.z2_power_2d_grid(t, f0, df, freqs.size, fdots, 2, per_split=self.SPLIT,
                                       device=cuda_device).cpu().numpy()
        with pmesh.virtual_devices(["cuda:0"] * 4):
            for ev in (4, 2, 1):
                z2_grid.reset_launches()
                got = pmesh.z2_2d_sharded(t, freqs, fdots, 2, pmesh.build_mesh(event_parallel=ev), poly=True,
                                          per_split=self.SPLIT)
                assert z2_grid.LAUNCHES["z2_tile_sums"] == 4, ev
                assert np.array_equal(got, mono), ev
            # the default plan on the whole problem: fewer splits than shards
            default = search.z2_power_2d_grid(t, f0, df, freqs.size, fdots, 2, device=cuda_device).cpu().numpy()
            got = pmesh.z2_2d_sharded(t, freqs, fdots, 2, pmesh.build_mesh(event_parallel=4), poly=True)
        np.testing.assert_allclose(got, default, rtol=2e-3, atol=0.05)
        assert int(np.argmax(got)) == int(np.argmax(default))

    def test_k3_whole_splits_bitwise_and_refold(self, cuda_device):
        from crimp_tpu_torch.ops import deltafold
        from crimp_tpu_torch.parallel import mesh as pmesh

        t = _pulsed(200000)
        freqs = np.geomspace(0.2490, 0.2510, 3000)
        mono = search.z2_power(t, freqs, 2, poly=True, per_split=self.SPLIT, device=cuda_device).cpu().numpy()
        with pmesh.virtual_devices(["cuda:0"] * 4):
            z2_general.reset_launches()
            got = pmesh.z2_sharded(t, freqs, 2, pmesh.build_mesh(event_parallel=2), poly=True, use_fastpath=False,
                                   per_split=self.SPLIT)
            assert z2_general.LAUNCHES["general_sums"] == 4
        assert np.array_equal(got, mono)
        segs = [np.sort(58000.0 + 2.0 * i + np.random.RandomState(i).uniform(0.0, 1.5, 3001)) for i in range(3)]
        tm = {"PEPOCH": 58000.0, "F0": 0.1432, "F1": -1e-14}
        ph, t_ref = anchored.fold_segments(tm, segs, delta_fold=0, device=cuda_device)
        idx = np.repeat(np.arange(3), [s.size for s in segs])
        delta = anchored.anchor_deltas(np.concatenate(segs), t_ref, idx)
        folded = np.concatenate(ph)
        dp = np.zeros(deltafold.n_params(0))
        dp[0] = 3e-10
        basis = deltafold.build_basis(tm, t_ref, delta, idx, device=cuda_device).b
        mono = deltafold.refold(torch.as_tensor(folded, device=cuda_device), basis,
                                torch.as_tensor(dp, device=cuda_device)).cpu().numpy()
        with pmesh.virtual_devices(["cuda:0"] * 4):
            deltafold.reset_launches()
            sharded = pmesh.delta_refold_sharded(tm, t_ref, folded, delta, idx, dp)
            assert deltafold.LAUNCHES["refold"] == 4
        assert np.array_equal(sharded, mono)

    def test_no_mesh_on_one_card_without_virtual_devices(self, cuda_device):
        from crimp_tpu_torch.parallel import mesh as pmesh

        if torch.cuda.device_count() == 1:
            assert pmesh.auto_mesh(device=cuda_device) is None

    def test_native_reader_loads_with_the_pure_bits(self, cuda_device):
        from crimp_tpu_torch.io import events, fitsio, native

        assert native.load() is not None, native.BUILD_INFO
        path = str(DATA / "1e2259_ni1020600110.fits")
        hdu = fitsio.read_fits(path)["EVENTS"]
        cols = native.read_columns(path, "EVENTS", ["TIME", "PI"])
        for c in ("TIME", "PI"):
            assert np.array_equal(cols[c], np.asarray(hdu.column(c), dtype=np.float64))
        assert events.EventFile(path).build_time_energy_df().reader == "native"


@pytest.mark.gpu
class TestParallelOnCards:
    """The sharded twins on distinct cards (two or more, up to four): each
    shard's kernel launches on its own card, whatever card is current, and
    every layout gives the bits of the same layout on shards of one card
    (the same kernels on the same inputs); a kernel span whose launches
    went to several cards resolves; ``auto_mesh`` spreads a large scan over
    the cards."""

    SPLIT = 1 << 16  # 200 000 events: 4 splits

    @pytest.fixture
    def cards(self, cuda_device):
        if torch.cuda.device_count() < 2:
            pytest.skip("needs two or more CUDA cards")
        return [f"cuda:{i}" for i in range(min(4, torch.cuda.device_count()))]

    def test_twins_on_distinct_cards_are_the_one_card_bits(self, cards, cuda_device, monkeypatch, tmp_path):
        from crimp_tpu_torch import obs
        from crimp_tpu_torch.ops import deltafold, semicoherent
        from crimp_tpu_torch.parallel import mesh as pmesh

        monkeypatch.setenv("CRIMP_TORCH_OBS", "1")
        monkeypatch.setenv("CRIMP_TORCH_OBS_DIR", str(tmp_path))
        k = len(cards)
        t = _pulsed(200000)
        freqs = np.linspace(0.2490, 0.2510, 1500)
        fdots = np.array([-1e-13, 0.0])
        f0, df = search.uniform_grid(freqs)
        geo = np.geomspace(0.2490, 0.2510, 3000)
        segs = [np.sort(58000.0 + 2.0 * i + np.random.RandomState(i).uniform(0.0, 1.5, 3001)) for i in range(3)]
        tm = {"PEPOCH": 58000.0, "F0": 0.1432, "F1": -1e-14}
        ph, t_ref = anchored.fold_segments(tm, segs, delta_fold=0, device=cuda_device)
        idx = np.repeat(np.arange(3), [s.size for s in segs])
        delta = anchored.anchor_deltas(np.concatenate(segs), t_ref, idx)
        dp = np.zeros(deltafold.n_params(0))
        dp[0] = 3e-10

        def run(devices):
            z2_grid.reset_launches()
            z2_general.reset_launches()
            deltafold.reset_launches()
            events = pmesh.build_mesh(devices, event_parallel=k)
            out = {
                "k2_events": pmesh.z2_2d_sharded(t, freqs, fdots, 2, events, poly=True, per_split=self.SPLIT),
                "k2_trials": pmesh.z2_2d_sharded(t, freqs, fdots, 2, pmesh.build_mesh(devices, event_parallel=1),
                                                 poly=True, per_split=self.SPLIT),
                "k3_events": pmesh.z2_sharded(t, geo, 2, events, poly=True, use_fastpath=False,
                                              per_split=self.SPLIT),
                "k4_events": pmesh.delta_refold_sharded(tm, t_ref, np.concatenate(ph), delta, idx, dp,
                                                        mesh=pmesh.Mesh(devices, (pmesh.EVENT_AXIS,))),
                "stack": semicoherent.semicoherent_z2_grid(t, f0, df, freqs.size, fdots, [0.0], nharm=2,
                                                           n_segments=k, mesh=pmesh.segment_mesh(devices),
                                                           device=cuda_device).cpu().numpy(),
            }
            launches = (z2_grid.LAUNCHES["z2_tile_sums"], z2_general.LAUNCHES["general_sums"],
                        deltafold.LAUNCHES["refold"])
            return out, launches

        with obs.run("distinct_cards"):
            spread, spread_launches = run(cards)
        one, one_launches = run(["cuda:0"] * k)
        assert spread_launches == one_launches == (3 * k, k, k)
        for key in one:
            assert np.array_equal(spread[key], one[key]), key
        with open(obs.last_manifest_path()) as fh:
            doc = json.load(fh)
        names = ("sharded_sums_grid", "sharded_sums_general", "delta_refold_sharded", "semicoherent_stack")
        durs = {s["name"]: s["dur_s"] for s in doc["spans"] if s["name"] in names}
        assert set(durs) == set(names) and all(d is not None and d > 0 for d in durs.values()), durs

    def test_auto_mesh_spreads_a_large_scan_over_the_cards(self, cards, cuda_device, monkeypatch):
        from crimp_tpu_torch.parallel import mesh as pmesh

        monkeypatch.delenv("CRIMP_TORCH_SHARD", raising=False)
        mesh = pmesh.auto_mesh(device=cuda_device)
        assert mesh is not None and mesh.cards() == torch.cuda.device_count()
        t = _pulsed(400000)
        freqs = np.linspace(0.2490, 0.2510, 12000)
        z2_grid.reset_launches()
        spread = search.PeriodSearch(t, freqs, 2, device=cuda_device).ztest()
        assert z2_grid.LAUNCHES["z2_tile_sums"] == mesh.size
        monkeypatch.setenv("CRIMP_TORCH_SHARD", "0")
        z2_grid.reset_launches()
        alone = search.PeriodSearch(t, freqs, 2, device=cuda_device).ztest()
        assert z2_grid.LAUNCHES["z2_tile_sums"] == 1
        np.testing.assert_allclose(spread, alone, rtol=2e-3, atol=0.05)
        assert int(np.argmax(spread)) == int(np.argmax(alone))
