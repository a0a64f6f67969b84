"""K2's rotation form on the CPU: ``z2_grid.z2_tile_sums_mirror`` (the
kernel's arithmetic in torch ops) against crimp_tpu and the direct twin,
K2's wave-fitted split plan, its cost count and the verdict cache's version.

- The mirror forms one sin/cos for each block of ``trials_per_thread``
  trials and rotates it by (cos 2*pi*b, sin 2*pi*b) for the others. Its Z^2
  is held against the Pallas tile kernel in interpret mode (as
  tests/test_torch_z2.py runs it), against crimp_tpu's XLA uniform-grid
  path where the Pallas kernel takes no weights or fddot row, and against
  the direct twin ``z2_tile_sums_reference``: rtol 2e-3 / atol 0.05 with
  the same argmax (TestPallasZ2's tolerance), at nharm 1, 2, 5 and 20, with
  weights and the fddot row, ragged tiles, a tile offset and event splits.
- At register-block starts (j = 0 mod R) the mirror is the twin bit for
  bit; the most rotated trials (j = R - 1 mod R) stay within the tolerance.
- On a long time span (|j*b| up to ~127 cycles), and at Z^2 ~2e4 with the
  events where the rotation pair is least exact, the mirror's largest
  |Z^2| error against an f64-trig Z^2 is at most the direct twin's plus 1%
  of the noise, sqrt(4*nharm).
- ``plan_per_split`` at the north-star, cube and benchwork shapes is
  ``z2_general.plan_splits``' plan over blocks of R pairs, checked against
  a brute-force reading of its cost rule; ``default_per_split`` feeds it the
  card's resident blocks (a stubbed occupancy here).
- ``flops_per_pair`` counts the rotation form, ``flops_per_pair_direct`` the
  direct one; a verdict cache of version 1 (verdicts tuned on the direct
  kernel) is ignored and rewritten.
"""

import json

import numpy as np
import pytest
import torch

from crimp_tpu.ops import search as jax_search
from crimp_tpu.ops.pallas_z2 import z2_power_2d_grid_pallas
from crimp_tpu.pipelines.simulate import simulate_modulated_lc
from crimp_tpu_torch.ops import autotune, search, z2_general, z2_grid

torch.set_num_threads(2)

RTOL, ATOL = 2e-3, 0.05  # tests/test_search.py::TestPallasZ2


@pytest.fixture(scope="module")
def sec():
    """tests/test_search.py's pulsed light curve (seed 42, f = 0.25 Hz), centered."""
    rng = np.random.RandomState(42)
    sim = simulate_modulated_lc(freq=0.25, srcrate=5.0, exposure=20000, pulsedfraction=0.3, bgrrate=0.1,
                                rng=rng)
    t = sim["assigned_t_wBgr"]
    return t - t.mean()


def z2_rows(cs: torch.Tensor, n_freq: int, n_events: int) -> np.ndarray:
    """(2, [n_fddot,] n_fdot, n_tiles, nharm, T) sums -> (rows, n_freq) Z^2."""
    c = cs.double()
    z = ((c[0] ** 2 + c[1] ** 2) * (2.0 / n_events)).sum(dim=-2)  # (..., n_tiles, T)
    return z.reshape(-1, z.shape[-2] * z.shape[-1])[:, :n_freq].numpy()


def held(got: np.ndarray, ref: np.ndarray) -> None:
    got, ref = np.atleast_2d(got), np.atleast_2d(ref)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    for row in range(got.shape[0]):
        assert int(np.argmax(got[row])) == int(np.argmax(ref[row]))


def mirror_and_twin(t, f0, df, half, n_tiles, nharm, **kw):
    args = (torch.as_tensor(t), f0, df, torch.as_tensor(half), n_tiles, nharm)
    return z2_grid.z2_tile_sums_mirror(*args, **kw), z2_grid.z2_tile_sums_reference(*args, **kw)


class TestMirrorAgainstJax:
    @pytest.mark.parametrize("nharm", [1, 2, 5, 20])
    def test_two_dim_grid_against_pallas_and_twin(self, sec, nharm):
        t = sec[:4096]
        n_freq, fdots = 280, np.array([-1e-10, 0.0, 1e-10])
        f0, df = search.uniform_grid(np.linspace(0.2495, 0.2505, n_freq))
        mirror, twin = mirror_and_twin(t, f0, df, 0.5 * fdots, 2, nharm, poly=True)
        got = z2_rows(mirror, n_freq, t.size)
        pallas = np.asarray(z2_power_2d_grid_pallas(t, f0, df, n_freq, fdots, nharm, interpret=True))
        held(got, pallas)
        held(got, z2_rows(twin, n_freq, t.size))
        assert not np.allclose(got[0], got[1])

    @pytest.mark.parametrize("n_freq,n_events", [(300, 5000), (1100, 3000)])
    def test_ragged_tiles_against_pallas(self, sec, n_freq, n_events):
        # 300 and 1100 trials end in a partial tile; 5000 and 3000 events in a partial chunk
        t = sec[:n_events]
        f0, df = search.uniform_grid(np.linspace(0.2490, 0.2510, n_freq))
        n_tiles = -(-n_freq // z2_grid.TRIAL_TILE)
        mirror, twin = mirror_and_twin(t, f0, df, np.zeros(1), n_tiles, 3, poly=True)
        got = z2_rows(mirror, n_freq, t.size)
        held(got, np.asarray(z2_power_2d_grid_pallas(t, f0, df, n_freq, [0.0], 3, interpret=True)))
        held(got, z2_rows(twin, n_freq, t.size))

    def test_weights_against_xla(self, sec):
        t = sec[:3000]
        w = np.random.RandomState(3).uniform(0.5, 1.5, t.size).astype(np.float32)
        f0, df, n_freq = 0.2495, 4e-6, 400
        mirror, twin = mirror_and_twin(t, f0, df, np.zeros(1), 2, 2, poly=True, weights=torch.as_tensor(w))
        c, s = jax_search.harmonic_sums_uniform(t, f0, df, n_freq, 2, weights=w, poly=True)
        xla = (np.asarray(c, dtype=np.float64) ** 2 + np.asarray(s, dtype=np.float64) ** 2).sum(0) * (2.0 / t.size)
        got = z2_rows(mirror, n_freq, t.size)
        held(got, xla)
        held(got, z2_rows(twin, n_freq, t.size))

    @pytest.mark.parametrize("poly", [True, False])
    def test_fddot_rows_against_xla_cube(self, sec, poly):
        # tests/test_torch_cube.py's cube: a 4x subsample over the +-1e4 s span,
        # 97 freqs (ragged against a tile), fdot/fddot spacings that decohere
        # off-center rows so the cube has one peak cell
        t = sec[::4] - sec[::4].mean()
        freqs = np.linspace(0.2495, 0.2505, 97)
        fdots, fddots = np.array([-2e-7, 0.0, 2e-7]), np.array([-3e-11, 0.0, 3e-11])
        f0, df = freqs[0], float(freqs[1] - freqs[0])
        mirror, twin = mirror_and_twin(t, f0, df, 0.5 * fdots, 1, 2, poly=poly,
                                       sixth_fddots=torch.as_tensor(fddots / 6.0))
        xla = np.asarray(jax_search.z2_power_3d_grid(t, f0, df, 97, fdots, fddots, 2, poly=poly, mxu=False))
        got = z2_rows(mirror, 97, t.size)
        for ref in (xla.reshape(9, 97), z2_rows(twin, 97, t.size)):
            np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
            assert int(np.argmax(got)) == int(np.argmax(ref))


class TestMirrorStructure:
    @pytest.mark.parametrize("nharm", [1, 2, 3, 5, 6, 20])
    def test_register_block_edges(self, sec, nharm):
        t = sec[:2500]
        mirror, twin = mirror_and_twin(t, 0.2495, 3e-6, np.array([0.0, -5e-11]), 2, nharm, poly=True)
        r = z2_grid.trials_per_thread(nharm)
        assert torch.equal(mirror[..., ::r], twin[..., ::r])  # block starts: the direct form's bits
        assert not torch.equal(mirror[..., r - 1::r], twin[..., r - 1::r])  # the most rotated trials
        z_m, z_t = z2_rows(mirror, 512, t.size), z2_rows(twin, 512, t.size)
        np.testing.assert_allclose(z_m[:, r - 1::r], z_t[:, r - 1::r], rtol=RTOL, atol=ATOL)
        held(z_m, z_t)

    def test_unit_weights_and_zero_fddot_are_bitwise_the_plain_mirror(self, sec):
        t = torch.as_tensor(sec[:3000])
        half = torch.tensor([-5e-11, 0.0, 5e-11], dtype=torch.float64)
        plain = z2_grid.z2_tile_sums_mirror(t, 0.2495, 3e-6, half, 2, 5, poly=True)
        ones = torch.ones(t.shape[0], dtype=torch.float32)
        assert torch.equal(z2_grid.z2_tile_sums_mirror(t, 0.2495, 3e-6, half, 2, 5, poly=True, weights=ones), plain)
        zero = torch.zeros(1, dtype=torch.float64)
        assert torch.equal(z2_grid.z2_tile_sums_mirror(t, 0.2495, 3e-6, half, 2, 5, poly=True,
                                                       sixth_fddots=zero)[:, 0], plain)

    def test_tile_offset_and_splits(self, sec):
        t = torch.as_tensor(sec[:5000])
        half = torch.zeros(1, dtype=torch.float64)
        whole = z2_grid.z2_tile_sums_mirror(t, 0.2490, 2e-6, half, 4, 2, poly=True, per_split=2048)
        part = z2_grid.z2_tile_sums_mirror(t, 0.2490, 2e-6, half, 2, 2, poly=True, per_split=2048, tile0=1)
        assert torch.equal(part, whole[:, :, 1:3])
        one = z2_grid.z2_tile_sums_mirror(t, 0.2490, 2e-6, half, 4, 2, poly=True)
        held(z2_rows(whole, 1024, t.shape[0]), z2_rows(one, 1024, t.shape[0]))


class TestLongSpan:
    @pytest.mark.parametrize("nharm,poly", [(2, True), (2, False), (5, True)])
    def test_error_against_f64_trig_no_larger_than_the_direct_twin(self, nharm, poly):
        # 2e7 s: df*t spans ~60 cycles, so b takes every value in [-0.5, 0.5)
        # and |j*b| reaches ~127 cycles at j = 255, where the direct form's f32
        # phase carries its largest rounding
        rng = np.random.RandomState(8)
        t = np.sort(rng.uniform(-1e7, 1e7, 6000))
        keep = rng.uniform(0.0, 1.4, t.size) < 1.0 + 0.4 * np.cos(2 * np.pi * 0.2 * t)
        t = t[keep] - t[keep].mean()
        n_freq = 512
        f0, df = 0.2 - 200 * 3e-6, 3e-6
        mirror, twin = mirror_and_twin(t, f0, df, np.zeros(1), 2, nharm, poly=poly)
        freqs = f0 + np.arange(n_freq) * df
        truth = search.z2_power(t, freqs, nharm, trig_dtype=torch.float64, device="cpu").numpy()
        z_m, z_t = z2_rows(mirror, n_freq, t.size)[0], z2_rows(twin, n_freq, t.size)[0]
        assert truth.max() > 100.0  # a strong signal: Z^2 errors scale with it
        err_m, err_t = np.max(np.abs(z_m - truth)), np.max(np.abs(z_t - truth))
        assert err_m <= err_t + 0.01 * np.sqrt(4 * nharm), (err_m, err_t)
        held(z_m, z_t)
        assert int(np.argmax(z_m)) == int(np.argmax(truth))

    @pytest.mark.parametrize("poly", [True, False])
    def test_high_signal_where_the_pair_is_least_exact(self, poly):
        # A source at Z^2 ~2e4 observed in 12 segments of 2000 s whose b =
        # frac(df*t) sits where the polynomial pair's |(cos, sin)| is furthest
        # from 1 (5.6e-7), the peak trial 7 rotations from its block's start:
        # a rotation pair left at the polynomial's length compounds that into a
        # bias of the sums that grows with the signal; the unit pair does not
        b = torch.linspace(-0.5, 0.5, 100001, dtype=torch.float32)
        s, c = search._trig_rows(b, True)[::-1]
        b_far = float(b[int(torch.argmax(((s.double() ** 2 + c.double() ** 2).sqrt() - 1).abs()))])
        rng = np.random.RandomState(11)
        df = 4.8e-8
        t = np.concatenate([(k + b_far) / df + rng.uniform(-1000, 1000, 8000) for k in range(-6, 6)])
        keep = rng.uniform(0.0, 1.9, t.size) < 1.0 + 0.9 * np.cos(2 * np.pi * 0.2 * t)
        t = np.sort(t[keep])
        f0 = 0.2 - 255 * df
        mirror, twin = mirror_and_twin(t, f0, df, np.zeros(1), 1, 2, poly=poly)
        truth = search.z2_power(t, f0 + np.arange(256) * df, 2, trig_dtype=torch.float64, device="cpu").numpy()
        assert truth.max() > 1e4 and int(np.argmax(truth)) == 255
        z_m, z_t = z2_rows(mirror, 256, t.size)[0], z2_rows(twin, 256, t.size)[0]
        err_m, err_t = np.max(np.abs(z_m - truth)), np.max(np.abs(z_t - truth))
        assert err_m <= err_t + 0.01 * np.sqrt(4 * 2), (err_m, err_t)


NS_EVENTS = 839_259  # the north-star surrogate (84 x 10 000 events, chip_smoke phase 4)
SHAPES = {  # name: (events, (tile, row) pairs, nharm)
    "north_star": (NS_EVENTS, 10 * 40, 2),  # 2500 nu x 40 nudot
    "cube": (NS_EVENTS, 98 * 2 * 2, 2),  # 25 000 nu x 2 nudot x 2 nuddot
    "benchwork": (800_000, 391, 2),  # utils/benchwork.py: 1e5 trials on one row
}


def brute_force_chunks_per_split(n_blocks: int, n_chunks: int, slots: int) -> int:
    """The cost rule plan_splits states, read out over every split count:
    waves x chunks per block, the fewest splits within 2% of the least."""
    costs = {}
    for s in range(1, n_chunks + 1):
        per = -(-n_chunks // s)
        s_eff = -(-n_chunks // per)
        costs.setdefault(s_eff, (-(-n_blocks * s_eff // slots) * per, per))
    least = min(c for c, _ in costs.values())
    return costs[min(s for s, (c, _) in costs.items() if c <= 1.02 * least)][1]


class TestSplitPlan:
    @pytest.mark.parametrize("name", sorted(SHAPES))
    @pytest.mark.parametrize("per_sm", [1, 2, 3])
    def test_plan_is_plan_splits_over_blocks_of_r_pairs(self, name, per_sm):
        n_events, n_pairs, nharm = SHAPES[name]
        slots = per_sm * 132
        plan = z2_grid.plan_per_split(n_events, n_pairs, nharm, slots)
        n_chunks = -(-n_events // z2_grid.EVENT_CHUNK)
        n_blocks = -(-n_pairs // z2_grid.trials_per_thread(nharm))
        assert plan % z2_grid.EVENT_CHUNK == 0 and z2_grid.EVENT_CHUNK <= plan <= n_chunks * z2_grid.EVENT_CHUNK
        assert plan == z2_grid.EVENT_CHUNK * brute_force_chunks_per_split(n_blocks, n_chunks, slots)
        out_bytes = 4 * 2 * n_pairs * nharm * z2_grid.TRIAL_TILE
        assert plan == z2_grid.EVENT_CHUNK * z2_general.plan_splits(n_blocks, n_chunks, slots, out_bytes)

    def test_north_star_plan(self):
        # 400 pairs -> 50 blocks of 8 over 820 chunks; at two blocks a SM (264
        # slots) 137 splits of 6 chunks make 6850 blocks, 25.9 waves: 156
        # chunk-times against a least of 820 * 50 / 264 = 155.3 (two splits: 100
        # blocks in one wave of 410 chunk-times)
        assert z2_grid.plan_per_split(NS_EVENTS, 400, 2, 264) == 6 * 1024
        assert -(-NS_EVENTS // (6 * 1024)) == 137

    def test_default_plan_takes_the_cards_resident_blocks(self, monkeypatch):
        seen = []

        def occupancy(device, nharm, poly):
            seen.append((device.type, nharm, poly))
            return z2_grid.trials_per_thread(nharm), 2 * 132

        monkeypatch.setattr(z2_grid, "_occupancy", occupancy)
        for name, (n_events, n_pairs, nharm) in SHAPES.items():
            got = z2_grid.default_per_split(n_events, n_pairs, torch.device("cuda"), nharm, True)
            assert got == z2_grid.plan_per_split(n_events, n_pairs, nharm, 264), name
        assert seen == [("cuda", 2, True)] * 3
        # off the card: one split of every event, no occupancy query
        assert z2_grid.default_per_split(NS_EVENTS, 400, torch.device("cpu"), 2, True) == 820 * 1024
        assert len(seen) == 3


class TestCount:
    def test_flops_per_pair(self):
        assert z2_grid.trials_per_thread(2) == 8 and z2_grid.trials_per_thread(5) == 4
        assert z2_grid.trials_per_thread(6) == 2 and z2_grid.trials_per_thread(20) == 2
        # nharm 2, R 8: 3 + 6 + (6*7 + 29)/8 + (1 + 24/8)/256
        assert z2_grid.flops_per_pair(2) == 17.890625
        assert z2_grid.flops_per_pair_direct(2) == 38
        for nharm in range(1, z2_grid.MAX_NHARM + 1):
            assert z2_grid.flops_per_pair(nharm) < z2_grid.flops_per_pair_direct(nharm)


class TestVerdictCacheVersion:
    def test_verdicts_of_the_direct_kernel_are_ignored(self, tmp_path, monkeypatch):
        path = tmp_path / "autotune.json"
        monkeypatch.setenv("CRIMP_TORCH_AUTOTUNE_CACHE", str(path))
        monkeypatch.delenv("CRIMP_TORCH_AUTOTUNE", raising=False)
        monkeypatch.delenv("CRIMP_TORCH_GRID_BLOCKS", raising=False)
        cpu = torch.device("cpu")
        key = autotune.cache_key("grid", True, 10_000, 1000, device=cpu)
        path.write_text(json.dumps({"version": 1, "entries": {key: {"event_block": 2048, "trial_block": 256}}}))
        assert autotune.CACHE_VERSION == 2
        static = autotune.static_defaults("grid", 10_000, 1000, device=cpu)
        assert autotune.resolve_blocks("grid", 10_000, 1000, poly=True, device=cpu) == static != (2048, 256)
        # the next store rewrites the file at the current version, without the old verdict
        other = autotune.cache_key("general", True, 10_000, 1000, device=cpu)
        autotune._store_entry(other, {"event_block": 4096, "trial_block": z2_general.THREADS})
        doc = json.loads(path.read_text())
        assert doc["version"] == autotune.CACHE_VERSION and set(doc["entries"]) == {other}
        # a verdict stored now is read back
        autotune._store_entry(key, {"event_block": 2048, "trial_block": 256})
        assert autotune.resolve_blocks("grid", 10_000, 1000, poly=True, device=cpu) == (2048, 256)
