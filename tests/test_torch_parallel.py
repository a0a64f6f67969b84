"""The port's sharded twins (crimp_tpu_torch.parallel.mesh) on the CPU.

JAX's twins run on conftest's 8 virtual CPU devices; the port's run on an
8-shard CPU mesh (``build_mesh(["cpu"] * 8)``, or ``virtual_devices`` for
the auto paths) at the same mesh shapes, on the same seeded inputs:

- against crimp_tpu's twins, within the tolerance of the kernel twin under
  each shard: K3 (general grid) rtol 1e-4 / atol 5e-3 with f32 trig and
  rtol 1e-8 / atol 1e-6 with f64 trig; K2 (uniform grid) rtol 2e-3 /
  atol 0.05 with the same argmax; the refold within 1e-12 cycles; the
  source fold within the multisource parity budget;
- against themselves, the port's bitwise pins: trial shards (K2's
  ``tile0``, K3's literal frequencies) and event shards of whole splits of
  the monolithic plan (each pinned below) are the one-device call's bits
  (the factorized grid's f32 matrix products, blocked by their row count,
  hold JAX's factorized tolerance instead);
  the cube at fddot 0 bitwise the 2-D twin; the sharded refold bitwise the
  monolithic refold; sharded source folds bitwise the opt-out; and JAX's
  own tolerances where the layout is not whole splits: mesh-shape
  invariance (rtol 1e-12 / atol 1e-9 with f64 trig), the sharded stack
  against the loop to reduction-order tolerance (bitwise with one segment
  a shard), the auto path against ``CRIMP_TORCH_SHARD=0``, and sharded
  resumable chunks bitwise the whole sharded scan.

One JAX pin is not bitwise in the port and states what it meets: a
segment-sharded ToA fit sums each block's events with ``torch.sum``, whose
rounding depends on the block's shape, so it agrees with the one-batch fit
within 1e-9 rad in phShift (JAX's own test tolerance), not bit for bit.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from crimp_tpu.ops import search as jax_search  # noqa: E402
from crimp_tpu.parallel import mesh as jax_pmesh  # noqa: E402
from crimp_tpu_torch import obs  # noqa: E402
from crimp_tpu_torch.ops import search, semicoherent, z2_grid  # noqa: E402
from crimp_tpu_torch.parallel import mesh as pmesh  # noqa: E402

torch.set_num_threads(2)

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices (see conftest)")

K3_F32 = dict(rtol=1e-4, atol=5e-3)
K3_F64 = dict(rtol=1e-8, atol=1e-6)
K2_TOL = dict(rtol=2e-3, atol=0.05)


@pytest.fixture(autouse=True)
def _quiet_knobs(monkeypatch):
    for name in ("CRIMP_TORCH_SHARD", "CRIMP_TORCH_GRID_BLOCKS", "CRIMP_TORCH_GRID_MXU", "CRIMP_TPU_SHARD",
                 "CRIMP_TPU_GRID_BLOCKS", "CRIMP_TPU_GRID_MXU"):
        monkeypatch.delenv(name, raising=False)


@pytest.fixture()
def cpu8():
    with pmesh.virtual_devices(["cpu"] * 8):
        yield


@pytest.fixture(scope="module")
def events():
    """tests/test_parallel.py's fixture: pulsed events at 0.1432 Hz plus
    background over ~1 day, centered."""
    rng = np.random.RandomState(0)
    n = 20000
    base = rng.uniform(0, 86400.0, n)
    pulsed = rng.rand(n) < 0.3
    phase = rng.vonmises(0.0, 2.0, n) / (2 * np.pi)
    times = np.where(pulsed, (np.round(base * 0.1432) + phase) / 0.1432, base)
    times = np.sort(times)
    return times - times.mean()


@pytest.fixture(scope="module")
def freqs():
    return np.linspace(0.14315, 0.14325, 193)  # deliberately not a multiple of 8


def jax_mesh(ev_par):
    return jax_pmesh.build_mesh(jax.devices()[:8], event_parallel=ev_par)


def port_mesh(ev_par):
    return pmesh.build_mesh(["cpu"] * 8, event_parallel=ev_par)


class TestAgainstJax:
    @pytest.mark.parametrize("ev_par", [1, 2, 4, 8])
    def test_z2_general_f64(self, events, freqs, ev_par):
        want = jax_pmesh.z2_sharded(events, freqs, nharm=2, mesh=jax_mesh(ev_par), trig_dtype=jnp.float64)
        got = pmesh.z2_sharded(events, freqs, nharm=2, mesh=port_mesh(ev_par), trig_dtype=torch.float64)
        np.testing.assert_allclose(got, want, **K3_F64)

    def test_z2_general_f32(self, events, freqs):
        want = jax_pmesh.z2_sharded(events, freqs, nharm=2, mesh=jax_mesh(4), trig_dtype=jnp.float32)
        got = pmesh.z2_sharded(events, freqs, nharm=2, mesh=port_mesh(4), trig_dtype=torch.float32)
        np.testing.assert_allclose(got, want, **K3_F32)

    @pytest.mark.parametrize("ev_par", [2, 8])
    def test_h_general_f64(self, events, freqs, ev_par):
        want = jax_pmesh.h_sharded(events, freqs[:48], nharm=10, mesh=jax_mesh(ev_par), trig_dtype=jnp.float64)
        got = pmesh.h_sharded(events, freqs[:48], nharm=10, mesh=port_mesh(ev_par), trig_dtype=torch.float64)
        np.testing.assert_allclose(got, want, **K3_F64)

    def test_2d_general_f64(self, events, freqs):
        fdots = np.array([-1e-13, 0.0])
        want = jax_pmesh.z2_2d_sharded(events, freqs[:48], fdots, nharm=2, mesh=jax_mesh(2),
                                       trig_dtype=jnp.float64)
        got = pmesh.z2_2d_sharded(events, freqs[:48], fdots, nharm=2, mesh=port_mesh(2), trig_dtype=torch.float64)
        assert got.shape == (2, 48)
        np.testing.assert_allclose(got, want, **K3_F64)

    @pytest.mark.parametrize("ev_par", [1, 4, 8])
    def test_2d_grid_k2(self, events, ev_par):
        freqs = np.linspace(0.1422, 0.1442, 600)
        fdots = np.array([-1e-13, 0.0])
        want = jax_pmesh.z2_2d_sharded(events, freqs, fdots, nharm=2, mesh=jax_mesh(ev_par), use_mxu=False)
        got = pmesh.z2_2d_sharded(events, freqs, fdots, nharm=2, mesh=port_mesh(ev_par), use_mxu=False)
        assert got.shape == (2, 600)
        np.testing.assert_allclose(got, want, **K2_TOL)
        assert int(np.argmax(got)) == int(np.argmax(want))

    def test_3d_grid_k2(self, events, freqs):
        fdots, fddots = np.array([-1e-13, 0.0]), np.array([-1e-18, 1e-18])
        want = jax_pmesh.z2_3d_sharded(events, freqs, fdots, fddots, nharm=2, mesh=jax_mesh(2), use_mxu=False)
        got = pmesh.z2_3d_sharded(events, freqs, fdots, fddots, nharm=2, mesh=port_mesh(2), use_mxu=False)
        assert got.shape == (2, 2, len(freqs))
        np.testing.assert_allclose(got, want, **K2_TOL)
        assert int(np.argmax(got)) == int(np.argmax(want))

    def test_semicoherent_stack(self, events):
        from crimp_tpu.ops import semicoherent as jax_semi

        fdots, fddots = np.array([-1e-13, 0.0]), np.array([-1e-18, 1e-18])
        t = events - events.min()
        kw = dict(f0=0.14315, df=1e-6, n_freq=128, fdots=fdots, fddots=fddots, nharm=2, n_segments=6)
        want = np.asarray(jax_semi.semicoherent_z2_grid(t, mesh=jax_pmesh.segment_mesh(jax.devices()[:8]),
                                                        poly=False, **kw))
        got = semicoherent.semicoherent_z2_grid(t, mesh=pmesh.segment_mesh(["cpu"] * 8), poly=False,
                                                device="cpu", **kw).numpy()
        np.testing.assert_allclose(got, want, rtol=2e-3, atol=0.05 * 6)
        assert int(np.argmax(got)) == int(np.argmax(want))

    def test_delta_refold(self):
        from crimp_tpu.models import timing as jax_timing
        from crimp_tpu.ops import anchored as jax_anchored
        from crimp_tpu.ops import deltafold as jax_deltafold
        from tests.test_deltafold import BASE, _segments, _wrap_dev

        segs = _segments(n_per=501, n_seg=3)
        tm = jax_timing.from_dict(BASE)
        ph, t_ref = jax_anchored.fold_segments(tm, segs, delta_fold=0)
        folded = np.concatenate(ph)
        anchor_idx = np.repeat(np.arange(len(segs)), [t.size for t in segs])
        delta = jax_anchored.anchor_deltas(np.concatenate(segs), t_ref, anchor_idx)
        dp = np.zeros(jax_deltafold.n_params(2))
        dp[0], dp[13], dp[17] = 3e-10, 1e-3, 1e-9
        want = jax_pmesh.delta_refold_sharded(tm, t_ref, folded, delta, anchor_idx, dp)
        got = pmesh.delta_refold_sharded(BASE, t_ref, folded, delta, anchor_idx, dp,
                                         mesh=pmesh.Mesh(np.array(["cpu"] * 8, dtype=object), ("events",)))
        assert got.shape == want.shape
        assert _wrap_dev(got, want) < 1e-12


class TestMeshInvariance:
    def test_z2_general_f64_mesh_shapes(self, events, freqs, cpu8):
        """Every event/trial split of the 8 slots agrees with the one-device
        K3 sums within JAX's pin (the f64 partials regroup the event sum)."""
        want = search.z2_power(events, freqs, 2, trig_dtype=torch.float64, device="cpu").numpy()
        results = [pmesh.z2_sharded(events, freqs, nharm=3, mesh=port_mesh(ev), trig_dtype=torch.float64)
                   for ev in (1, 2, 4, 8)]
        for ev, r in zip((1, 2, 4, 8), results):
            np.testing.assert_allclose(r, results[0], rtol=1e-12, atol=1e-9, err_msg=str(ev))
        got = pmesh.z2_sharded(events, freqs, nharm=2, mesh=port_mesh(4), trig_dtype=torch.float64)
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-9)

    def test_trial_shards_are_bitwise_the_general_kernel(self, events, freqs):
        """An event mesh of 1: each trial shard's K3 sums are the monolithic
        call's bits (K3's trials do not depend on the trials beside them)."""
        want = search.z2_power(events, freqs, 2, device="cpu").numpy()
        got = pmesh.z2_sharded(events, freqs, nharm=2, mesh=port_mesh(1), trig_dtype=torch.float32)
        np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("n_freq", [256 * 8 * 2, 1101])
    def test_trial_shards_tile0_bitwise_monolithic_k2(self, events, n_freq):
        """Trial shards of whole tiles with the global f0 and their first
        tile index (``tile0``) are monolithic K2 bit for bit at a pinned
        split length (the counterpart of JAX's pinned-block mxu pins)."""
        freqs = np.linspace(0.14315, 0.14315 + 1e-6 * (n_freq - 1), n_freq)
        fdots = np.array([-1e-13, 0.0])
        f0, df = search.uniform_grid(freqs)
        mono = search.z2_power_2d_grid(events, f0, df, n_freq, fdots, 2, poly=True, per_split=8192,
                                       device="cpu").numpy()
        got = pmesh.z2_2d_sharded(events, freqs, fdots, nharm=2, mesh=port_mesh(1), poly=True, per_split=8192)
        np.testing.assert_array_equal(got, mono)
        c, s = pmesh.grid_sums_sharded(events, f0, df, n_freq, [0.0], None, 4, port_mesh(1), poly=True,
                                       per_split=8192)
        h = search.h_from_sums(c[0, 0], s[0, 0], len(events), dim=0).numpy()
        np.testing.assert_array_equal(h, search.h_power_grid(events, f0, df, n_freq, 4, per_split=8192,
                                                             device="cpu").numpy())

    def test_grid_mesh_shapes_agree(self, events):
        freqs = np.linspace(0.1422, 0.1442, 1101)  # odd: no trial split divides it
        fdots = np.array([-1e-13, 0.0])
        results = [pmesh.z2_2d_sharded(events, freqs, fdots, nharm=2, mesh=port_mesh(ev), poly=True)
                   for ev in (8, 4, 2, 1)]
        for r in results[1:]:
            np.testing.assert_allclose(r, results[0], rtol=1e-4, atol=1e-3)

    def test_detects_injected_signal(self, events):
        freqs = np.linspace(0.1422, 0.1442, 401)
        power = pmesh.z2_sharded(events, freqs, nharm=2, mesh=port_mesh(4))
        assert abs(freqs[int(np.argmax(power))] - 0.1432) < 2e-4

    def test_3d_fddot_zero_bitmatches_2d(self, events, freqs):
        fdots = np.array([-1e-13, 0.0])
        mesh = port_mesh(4)
        two_d = pmesh.z2_2d_sharded(events, freqs, fdots, nharm=2, mesh=mesh, use_mxu=False)
        cube = pmesh.z2_3d_sharded(events, freqs, fdots, np.array([0.0]), nharm=2, mesh=mesh, use_mxu=False)
        np.testing.assert_array_equal(cube[0], two_d)

    def test_3d_nonuniform_falls_back_to_the_general_cube(self, events, monkeypatch, tmp_path):
        fdots, fddots = np.array([-1e-13, 0.0]), np.array([-1e-18, 1e-18])
        freqs = np.concatenate([np.linspace(0.1430, 0.1431, 16), np.linspace(0.1434, 0.1438, 17)])
        monkeypatch.setenv("CRIMP_TORCH_OBS", "1")
        monkeypatch.setenv("CRIMP_TORCH_OBS_DIR", str(tmp_path))
        with obs.run("fallback") as rec:
            got = pmesh.z2_3d_sharded(events, freqs, fdots, fddots, nharm=2, mesh=port_mesh(4))
            counters = dict(rec.counters)
        assert got.shape == (2, 2, 33)
        want = search.z2_power_3d(events, freqs, fdots, fddots, 2, device="cpu").numpy()
        np.testing.assert_array_equal(got, want)
        assert counters.get("mesh_grid3d_fallbacks") == 1

    def test_sharded_refold_bitwise_monolithic(self):
        from crimp_tpu_torch.ops import anchored, deltafold
        from tests.test_deltafold import BASE, _segments

        segs = _segments(n_per=501, n_seg=3)  # not 8-aligned
        ph, t_ref = anchored.fold_segments(BASE, segs, delta_fold=0, device="cpu")
        folded = np.concatenate(ph)
        anchor_idx = np.repeat(np.arange(len(segs)), [t.size for t in segs])
        delta = anchored.anchor_deltas(np.concatenate(segs), t_ref, anchor_idx)
        dp = np.zeros(deltafold.n_params(2))
        dp[0], dp[13], dp[17] = 3e-10, 1e-3, 1e-9
        fb = deltafold.build_basis(BASE, t_ref, delta, anchor_idx, device="cpu")
        mono = deltafold.refold(torch.as_tensor(folded), fb.b, torch.as_tensor(dp)).numpy()
        with pmesh.virtual_devices(["cpu"] * 8):
            sharded = pmesh.delta_refold_sharded(BASE, t_ref, folded, delta, anchor_idx, dp)
        assert sharded.shape == mono.shape
        assert np.array_equal(sharded, mono)

    def test_semicoherent_stack_against_the_loop(self, events):
        fdots, fddots = np.array([-1e-13, 0.0]), np.array([-1e-18, 1e-18])
        t = events - events.min()
        kw = dict(f0=0.14315, df=1e-6, n_freq=128, fdots=fdots, fddots=fddots, nharm=2, n_segments=6)
        loop = semicoherent.semicoherent_z2_grid(t, device="cpu", **kw).numpy()
        sharded = semicoherent.semicoherent_z2_grid(t, mesh=pmesh.segment_mesh(["cpu"] * 8), device="cpu",
                                                    **kw).numpy()
        assert sharded.shape == loop.shape == (2, 2, 128)
        np.testing.assert_allclose(sharded, loop, rtol=1e-12, atol=1e-9)
        one = semicoherent.semicoherent_z2_grid(t, mesh=pmesh.segment_mesh(["cpu"]), device="cpu", **kw).numpy()
        np.testing.assert_array_equal(one, loop)


class TestShardedGridMXU:
    """The factorized (matmul) grid under sharding, tests/test_parallel.py's
    cases. Each trial shard's carry starts at its first trial block
    (``tile0``) and the blocks join in grid order, but an f32 matrix
    product's reduction blocking depends on the row count, which a trial
    shard changes, so trial shards hold JAX's factorized-sharded tolerance
    (rtol 1e-3 / atol 0.01 with the same argmax, its 3-D pin) rather than
    bits; with the events sharded too the result stays within the statistic
    budget of the exact sharded grid, with its argmax."""

    @pytest.mark.parametrize("blocks", [None, (512, 64)])
    def test_trial_shards_match_monolithic(self, events, blocks):
        n_freq = 8 * 256 * 2 if blocks is None else 8 * 64 * 2  # two trial blocks a shard
        fdots = np.array([-1e-13, 0.0])
        f0, df = 0.14315, 1e-6
        c, s = pmesh.grid_sums_sharded(events, f0, df, n_freq, fdots, None, 4, port_mesh(1), use_mxu=True,
                                       reseed=64, mxu_bf16=False, mxu_blocks=blocks)
        c1, s1, n = search._grid3d_sums_dispatch(events, f0, df, n_freq, fdots, None, 4, poly=False, mxu=True,
                                                 reseed=64, mxu_bf16=False, mxu_blocks=blocks, device="cpu",
                                                 ladder=False)
        got = torch.sum(search.z2_from_sums(c, s, n), dim=2).numpy()
        mono = torch.sum(search.z2_from_sums(c1, s1, n), dim=2).numpy()
        assert got.shape == mono.shape == (1, 2, n_freq)
        np.testing.assert_allclose(got, mono, rtol=1e-3, atol=0.01)
        assert int(np.argmax(got)) == int(np.argmax(mono))

    def test_event_sharding_within_the_budget_of_the_exact_grid(self, events):
        freqs = np.linspace(0.14315, 0.14315 + 1e-6 * 255, 256)
        fdots = np.array([-1e-13, 0.0])
        exact = pmesh.z2_2d_sharded(events, freqs, fdots, nharm=2, mesh=port_mesh(4), use_mxu=False)
        fact = pmesh.z2_2d_sharded(events, freqs, fdots, nharm=2, mesh=port_mesh(4), use_mxu=True, reseed=64,
                                   mxu_bf16=False)
        assert np.max(np.abs(fact - exact)) < 0.01 * np.sqrt(4.0 * 2)
        assert int(np.argmax(fact)) == int(np.argmax(exact))


class TestEventShardsOfWholeSplits:
    """Event shards of whole splits of the monolithic launch plan: each
    shard hands back its per-split partials, which add in split order
    across the shards in the kernel's own accumulator type (f32 for K2, f64
    for K3), so the sharded result is the one-device call's bits at that
    plan, with the trial axis sharded too. 20 000 events at a split length
    of 2048 make 10 splits, at least one per event shard."""

    SPLIT = 2048

    def test_the_layout_is_whole_splits(self):
        bounds = pmesh.event_bounds(20000, 4, self.SPLIT)
        assert [lo % self.SPLIT for lo, _ in bounds] == [0, 0, 0, 0]
        assert bounds[0][0] == 0 and bounds[-1][1] == 20000
        assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
        # fewer splits than shards: near-equal shards of whole 1024-event chunks
        assert pmesh.event_bounds(20000, 4, 16384) == [(0, 5120), (5120, 10240), (10240, 15360), (15360, 20000)]

    @pytest.mark.parametrize("ev_par", [2, 4, 8])
    def test_k2_bitwise_monolithic(self, events, ev_par):
        freqs = np.linspace(0.1422, 0.1442, 600)
        fdots = np.array([-1e-13, 0.0])
        f0, df = search.uniform_grid(freqs)
        mono = search.z2_power_2d_grid(events, f0, df, len(freqs), fdots, 2, poly=True, per_split=self.SPLIT,
                                       device="cpu").numpy()
        got = pmesh.z2_2d_sharded(events, freqs, fdots, nharm=2, mesh=port_mesh(ev_par), poly=True,
                                  per_split=self.SPLIT)
        np.testing.assert_array_equal(got, mono)

    @pytest.mark.parametrize("ev_par", [2, 8])
    def test_k3_bitwise_monolithic(self, events, freqs, ev_par):
        mono = search.z2_power(events, freqs, 3, poly=True, per_split=self.SPLIT, device="cpu").numpy()
        got = pmesh.z2_sharded(events, freqs, nharm=3, mesh=port_mesh(ev_par), poly=True, use_fastpath=False,
                               per_split=self.SPLIT)
        np.testing.assert_array_equal(got, mono)
        mono_h = search.h_power(events, freqs[:64], 25, poly=True, per_split=self.SPLIT, device="cpu").numpy()
        got_h = pmesh.h_sharded(events, freqs[:64], nharm=25, mesh=port_mesh(ev_par), poly=True,
                                per_split=self.SPLIT)
        np.testing.assert_array_equal(got_h, mono_h)

    def test_fewer_splits_than_shards_within_the_twin_tolerance(self, events):
        freqs = np.linspace(0.1422, 0.1442, 600)
        fdots = np.array([-1e-13, 0.0])
        f0, df = search.uniform_grid(freqs)
        mono = search.z2_power_2d_grid(events, f0, df, len(freqs), fdots, 2, poly=True, device="cpu").numpy()
        got = pmesh.z2_2d_sharded(events, freqs, fdots, nharm=2, mesh=port_mesh(4), poly=True)
        np.testing.assert_allclose(got, mono, **K2_TOL)
        assert int(np.argmax(got)) == int(np.argmax(mono))

    def test_periodsearch_auto_shards_bitwise_at_a_pinned_plan(self, events, monkeypatch, cpu8):
        """The product path: an 8-device job at a pinned plan of 10 splits
        shards PeriodSearch's 2-D scan by itself, bitwise the opt-out."""
        monkeypatch.setattr(search, "MIN_SHARD_PAIRS", 1 << 20)
        monkeypatch.setenv("CRIMP_TORCH_GRID_BLOCKS", f"{self.SPLIT},256")
        freqs = np.linspace(0.1427, 0.1437, 300)
        calls = []
        real = pmesh.z2_2d_sharded
        monkeypatch.setattr(pmesh, "z2_2d_sharded", lambda *a, **kw: calls.append(1) or real(*a, **kw))
        rows_sh, _ = search.PeriodSearch(events, freqs, 2, device="cpu").twod_ztest(np.array([-13.0, -12.0]))
        monkeypatch.setenv("CRIMP_TORCH_SHARD", "0")
        rows_pl, _ = search.PeriodSearch(events, freqs, 2, device="cpu").twod_ztest(np.array([-13.0, -12.0]))
        assert len(calls) == 1
        np.testing.assert_array_equal(rows_sh, rows_pl)


class TestAutoShardProduct:
    """The parallel layer reached through the product entry points: inside
    ``virtual_devices`` they shard by themselves and match
    ``CRIMP_TORCH_SHARD=0``."""

    def test_periodsearch_auto_shards_and_matches_opt_out(self, events, monkeypatch, cpu8):
        freqs = np.linspace(0.1422, 0.1442, 256)
        monkeypatch.setattr(search, "MIN_SHARD_PAIRS", 1 << 20)
        calls = []
        real = pmesh.z2_sharded
        monkeypatch.setattr(pmesh, "z2_sharded", lambda *a, **kw: calls.append(1) or real(*a, **kw))
        sharded = search.PeriodSearch(events, freqs, 2, device="cpu").ztest()
        assert calls, "the auto-shard path was not taken on the 8-slot job"
        monkeypatch.setenv("CRIMP_TORCH_SHARD", "0")
        single = search.PeriodSearch(events, freqs, 2, device="cpu").ztest()
        assert len(calls) == 1
        np.testing.assert_allclose(sharded, single, rtol=1e-4, atol=1e-3)
        assert int(np.argmax(sharded)) == int(np.argmax(single))

    def test_twod_and_htest_auto_shard_and_match_opt_out(self, events, monkeypatch, cpu8):
        freqs = np.linspace(0.1427, 0.1437, 128)
        monkeypatch.setattr(search, "MIN_SHARD_PAIRS", 1 << 20)
        ps = search.PeriodSearch(events, freqs, 2, device="cpu")
        rows_sh, _ = ps.twod_ztest(np.array([-13.0, -12.0]))
        h_sh = search.PeriodSearch(events, freqs[:64], 25, device="cpu").htest()  # K3 per shard
        cube_sh, _ = ps.threed_ztest(np.array([-13.0]), np.array([-1e-18, 0.0, 1e-18]))
        monkeypatch.setenv("CRIMP_TORCH_SHARD", "0")
        rows_pl, _ = ps.twod_ztest(np.array([-13.0, -12.0]))
        h_pl = search.PeriodSearch(events, freqs[:64], 25, device="cpu").htest()
        cube_pl, _ = ps.threed_ztest(np.array([-13.0]), np.array([-1e-18, 0.0, 1e-18]))
        np.testing.assert_allclose(rows_sh[:, 2], rows_pl[:, 2], rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(h_sh, h_pl, **K3_F32)
        np.testing.assert_allclose(cube_sh[:, 3], cube_pl[:, 3], rtol=1e-4, atol=1e-3)
        np.testing.assert_array_equal(rows_sh[:, :2], rows_pl[:, :2])

    def test_no_mesh_outside_virtual_devices_or_for_another_device_type(self, monkeypatch):
        assert pmesh.available_devices() == [] and pmesh.auto_mesh() is None
        with pmesh.virtual_devices(["cpu"] * 4):
            assert dict(pmesh.auto_mesh(device="cpu").shape) == {"events": 4, "trials": 1}
            monkeypatch.setenv("CRIMP_TORCH_SHARD", "off")
            assert pmesh.auto_mesh(device="cpu") is None
            monkeypatch.setenv("CRIMP_TORCH_SHARD", "garbage")  # anything but an off-word: on
            assert pmesh.auto_mesh(device="cpu") is not None
        with pmesh.virtual_devices(["cpu"]):
            assert pmesh.auto_mesh(device="cpu") is None

    @staticmethod
    def _fit_case():
        from crimp_tpu_torch.models.profiles import ProfileParams
        from crimp_tpu_torch.ops import toafit

        rng = np.random.RandomState(9)
        tpl = ProfileParams(norm=torch.tensor(12.0, dtype=torch.float64),
                            amp=torch.tensor([4.0], dtype=torch.float64),
                            loc=torch.tensor([-0.2], dtype=torch.float64),
                            wid=torch.zeros(1, dtype=torch.float64),
                            ph_shift=torch.tensor(0.0, dtype=torch.float64),
                            amp_shift=torch.tensor(1.0, dtype=torch.float64))
        n_seg, n_ev = 11, 600
        phases = rng.uniform(0, 1, (n_seg, n_ev))
        masks = np.ones((n_seg, n_ev), dtype=bool)
        exposures = np.full(n_seg, n_ev / 12.0)
        cfg = toafit.ToAFitConfig(ph_shift_res=150, n_brute=32, refine_iters=20)
        return ("fourier", tpl, phases, masks, exposures, cfg)

    def test_segment_sharded_fit_within_1e9_of_the_batch(self, monkeypatch):
        """tests/test_parallel.py's sharded-segment fit: 11 segments on a
        mesh of 8 slots (padded with masked rows). A block's event sums
        round with its own shape (ops/reduce.event_sum), so the pin is
        JAX's 1e-9 rad, not bits; the measured gap is logged in ROADMAP §C."""
        from crimp_tpu_torch.ops import toafit

        args = self._fit_case()
        n_seg = args[2].shape[0]
        placed = []
        real = pmesh.shard_segments
        monkeypatch.setattr(pmesh, "shard_segments", lambda *a, **kw: placed.append(1) or real(*a, **kw))
        with pmesh.virtual_devices(["cpu"] * 8):
            sharded = toafit.fit_toas_batch_auto(*args, device="cpu", mesh=pmesh.segment_mesh())
        assert placed, "the segment batch was not sharded on the 8-slot mesh"
        single = toafit.fit_toas_batch_auto(*args, device="cpu")
        assert sharded["phShift"].shape == (n_seg,)
        for key in ("phShift", "phShift_LL", "phShift_UL", "norm", "redChi2"):
            np.testing.assert_allclose(sharded[key], single[key], rtol=0, atol=1e-9, err_msg=key)

    def test_fit_auto_shards_and_matches_opt_out(self, monkeypatch):
        """tests/test_parallel.py's auto case: on an 8-device job the batch
        fit shards its 11 segments by itself (JAX's rule: at least two
        devices and as many segments), within 1e-9 rad of the opt-out."""
        from crimp_tpu_torch.ops import toafit

        args = self._fit_case()
        placed = []
        real = pmesh.shard_segments
        monkeypatch.setattr(pmesh, "shard_segments", lambda *a, **kw: placed.append(1) or real(*a, **kw))
        with pmesh.virtual_devices(["cpu"] * 8):
            auto = toafit.fit_toas_batch_auto(*args, device="cpu")
            assert placed, "the segment batch was not sharded on the 8-device job"
            monkeypatch.setenv("CRIMP_TORCH_SHARD", "0")
            n_placed = len(placed)
            single = toafit.fit_toas_batch_auto(*args, device="cpu")
            assert len(placed) == n_placed
        for key in ("phShift", "phShift_LL", "phShift_UL", "norm", "redChi2"):
            np.testing.assert_allclose(auto[key], single[key], rtol=0, atol=1e-9, err_msg=key)

    @pytest.mark.parametrize("n_sources,devices,device,want", [
        (4, 4, "cpu", {"sources": 4}),
        (3, 4, "cpu", None),
        (9, 1, "cpu", None),
        (9, 4, "meta", None),
    ])
    def test_source_sharding_policy(self, monkeypatch, n_sources, devices, device, want):
        from crimp_tpu_torch.ops import multisource

        with pmesh.virtual_devices(["cpu"] * devices):
            got = multisource._maybe_shard_sources(n_sources, torch.device(device))
            assert (None if got is None else dict(got[0].shape)) == want
            monkeypatch.setenv("CRIMP_TORCH_SHARD", "0")
            assert multisource._maybe_shard_sources(n_sources, torch.device(device)) is None

    @pytest.mark.parametrize("n_sources", [8, 11])
    def test_fold_sources_sharded_bitmatches_opt_out(self, n_sources, monkeypatch):
        from crimp_tpu_torch.ops import multisource

        rng = np.random.RandomState(9)
        tms, seg_lists = [], []
        for i in range(n_sources):
            tm = {"PEPOCH": 58000.0, "F0": 0.14 + 0.003 * i, "F1": -1e-13}
            if i % 3 == 0:
                tm.update({"GLEP_1": 58002.0, "GLF0_1": 1e-7})
            tms.append(tm)
            seg_lists.append([np.sort(rng.uniform(58000.0 + 2 * s, 58002.0 + 2 * s, int(rng.randint(40, 160))))
                              for s in range(2)])
        with pmesh.virtual_devices(["cpu"] * 8):
            sharded, t_sh = multisource.fold_sources(tms, seg_lists, device="cpu")
            monkeypatch.setenv("CRIMP_TORCH_SHARD", "0")
            plain, t_pl = multisource.fold_sources(tms, seg_lists, device="cpu")
        for i in range(n_sources):
            np.testing.assert_array_equal(t_sh[i], t_pl[i])
            for a, b in zip(sharded[i], plain[i]):
                np.testing.assert_array_equal(a, b)

    def test_survey_sharded_against_opt_out(self, monkeypatch):
        """tests/test_parallel.py's survey case: 9 sources on 8 devices (an
        inert padding row on the source axis). The folds and every column
        but the fit's are the opt-out's bits; the fit's segment batch shards
        too, so its columns hold the survey's parity contract (the blocks'
        event sums round with their rows), not bits."""
        from crimp_tpu_torch.pipelines import survey
        from tests.test_torch_survey import assert_matches_loop

        rng = np.random.RandomState(10)
        edges = np.linspace(58000.0, 58006.0, 3)
        specs = [survey.SourceSpec(
            name=f"s{i}", times=np.sort(rng.uniform(58000.0, 58006.0, 120)),
            timing_model={"PEPOCH": 58000.0, "F0": 0.15 + 0.002 * i, "F1": -1e-13},
            template={"model": "fourier", "nbrComp": 2, "norm": 1.0, "amp_1": 0.3, "amp_2": 0.1, "ph_1": 0.2,
                      "ph_2": 0.05},
            intervals={"ToA_tstart": edges[:-1], "ToA_tend": edges[1:],
                       "ToA_exposure": np.full(2, (edges[1] - edges[0]) * 86400.0)})
            for i in range(9)]
        with pmesh.virtual_devices(["cpu"] * 8):
            sharded = survey.survey_measure_toas(specs, phShiftRes=200, device="cpu")
            assert survey.last_survey_info()["n_batched"] == 9
            monkeypatch.setenv("CRIMP_TORCH_SHARD", "0")
            plain = survey.survey_measure_toas(specs, phShiftRes=200, device="cpu")
        for spec, a, b in zip(specs, sharded, plain):
            assert_matches_loop(a, b, spec.name, res=200)

    def test_fold_sources_match_jax_sharded(self):
        from crimp_tpu.ops import multisource as jax_ms
        from crimp_tpu_torch.ops import multisource

        rng = np.random.RandomState(4)
        tms = [{"PEPOCH": 58000.0, "F0": 0.1 + 0.002 * i, "F1": -1e-13} for i in range(9)]
        seg_lists = [[np.sort(rng.uniform(58000.0, 58002.0, 80))] for _ in range(9)]
        want, _ = jax_ms.fold_sources(tms, seg_lists)
        with pmesh.virtual_devices(["cpu"] * 8):
            got, _ = multisource.fold_sources(tms, seg_lists, device="cpu")
        for a, b in zip(got, want):
            d = np.abs(np.asarray(a[0]) - np.asarray(b[0]))
            assert float(np.max(np.minimum(d, 1 - d))) < 1e-9

    def test_serving_engine_mesh_is_a_note(self):
        from crimp_tpu_torch import serve

        with pmesh.virtual_devices(["cpu"] * 4):
            mesh = pmesh.build_mesh(event_parallel=2)
            eng = serve.ServingEngine(mesh=mesh, device="cpu")
        assert eng.mesh is mesh
        assert eng.capacity["devices"] == 4
        assert eng.capacity["mesh_axes"] == {"events": 2, "trials": 2}
        assert eng.stats()["capacity"]["mesh_axes"] == {"events": 2, "trials": 2}
        eng.close()


class TestResumableSharded:
    @pytest.mark.parametrize("fastpath", [True, False])
    def test_sharded_chunks_bitwise_the_whole(self, events, monkeypatch, tmp_path, fastpath):
        """Auto-sharded chunks (tests/test_resumable.py:91's case on the
        port): the chunked sharded scan is the one-chunk sharded scan bit
        for bit, and within K2's tolerance of the meshless scan."""
        from crimp_tpu_torch.ops import resumable

        freqs = np.linspace(0.1422, 0.1442, 700)
        monkeypatch.setattr(search, "MIN_SHARD_PAIRS", 1 << 10)
        if not fastpath:
            monkeypatch.setenv("CRIMP_TORCH_GRID_FASTPATH", "0")
        kw = dict(nharm=2, fdots=[-1e-13, 0.0], device="cpu")
        calls = []
        real = pmesh.auto_mesh
        monkeypatch.setattr(pmesh, "auto_mesh", lambda *a, **k: calls.append(1) or real(*a, **k))
        with pmesh.virtual_devices(["cpu"] * 4):
            chunked = resumable.ResumableScan(events, freqs, chunk_trials=300, store=str(tmp_path / "a"),
                                              **kw).run()
            whole = resumable.ResumableScan(events, freqs, chunk_trials=700, **kw).run()
        assert calls
        np.testing.assert_array_equal(chunked, whole)
        plain = resumable.ResumableScan(events, freqs, chunk_trials=700, **kw).run()
        np.testing.assert_allclose(chunked, plain, rtol=1e-4, atol=1e-3)

    @pytest.mark.parametrize("first,then,ok", [
        ((["cpu"] * 1, "1"), (["cpu"] * 4, "1"), False),  # a one-slot store on four slots
        ((["cpu"] * 4, "1"), (["cpu"] * 4, "0"), False),  # sharding switched off on resume
        ((["cpu"] * 4, "1"), (["cpu"] * 2, "1"), False),  # another event-shard count
        ((["cpu"] * 4, "1"), (["cpu"] * 4, "1"), True),
        ((["cpu"] * 1, "1"), (["cpu"] * 4, "0"), True),
    ])
    def test_resume_refuses_another_event_shard_count(self, events, monkeypatch, tmp_path, first, then, ok):
        """A chunk's sums round with its event-shard count, so the count is
        part of the store's numeric mode: a resume that would shard the
        chunks another way refuses rather than mixing them."""
        from crimp_tpu_torch.ops import resumable

        freqs = np.linspace(0.1422, 0.1442, 700)
        monkeypatch.setattr(search, "MIN_SHARD_PAIRS", 1 << 10)
        store = str(tmp_path / "s")

        def scan(devices, shard):
            monkeypatch.setenv("CRIMP_TORCH_SHARD", shard)
            with pmesh.virtual_devices(devices):
                return resumable.ResumableScan(events, freqs, chunk_trials=300, store=store, device="cpu")

        part = scan(*first)
        part._finish_chunk(0, part._compute_chunk_device(0), [None] * part.n_chunks, None)
        assert part.done_chunks() == [0]
        if not ok:
            with pytest.raises(ValueError, match="event shard"):
                scan(*then)
            return
        resumed = scan(*then)  # the mesh is resolved here, once for every chunk
        want = scan(*first)
        want.store = None
        np.testing.assert_array_equal(resumed.run(), want.run())
