"""K6, the readvaryparam fit's bounded Nelder-Mead (crimp_tpu_torch/csrc/
toafit_general.cu, ops/general_sweep.py), on the CPU: its plain twin against
crimp_tpu, the Nelder-Mead's per-step trace and the candidate values its
decisions read, the host packing, the routing and the C interface the
wrapper binds.

- ``general_profile_reference`` (the twin) against JAX's
  ``_general_profile_vecs`` row by row, for the three template families, cold
  and warm-started, and the committed template's 13-parameter spec at 500
  events x 2 rows: LL within rtol 1e-12, vectors within rtol 1e-8 (as
  tests/test_torch_toafit.py's readvaryparam case; the packages run the same
  f64 arithmetic, the event sums and the centroid in another order).
- ``optimize.nelder_mead``'s trace: the decisions and the candidate values
  read (``candidate_reads``, what ``costmodel.k6_counts`` charges) against a
  scalar walk of the decision tree, on an objective that shrinks and one
  that does not, the result unchanged by tracing;
  ``general_sweep.mirror_profile`` bitwise the twin.
- ``block_sum`` is K6's order (thread-strided sums, then the lane and warp
  trees) and pads with +0.0.
- The packing: what ``pack`` hands K6 is what the twin starts from.
- The routing: a ``free_idx`` fit on a "card" tensor goes to K6's launchers
  for every profile (one brute launch of all n_brute phases, one golden
  launch for the whole refine and its refit vector, the dense window, the
  error scan's passes), never to the twin and never to K5; with no nvcc the
  launch raises ``KernelError``.
- A whole readvaryparam ``fit_toas_batch`` on the CPU against crimp_tpu's.
"""

import math
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crimp_tpu.io import template as jax_template_io
from crimp_tpu.models import profiles as jax_profiles
from crimp_tpu.ops import toafit as jax_toafit
from crimp_tpu_torch.io import template as template_io
from crimp_tpu_torch.models import profiles
from crimp_tpu_torch.obs import costmodel
from crimp_tpu_torch.ops import general_sweep, optimize, toafit
from crimp_tpu_torch.resilience import KernelError
from tests.conftest import TEMPLATE

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parent.parent
SRC = REPO / "crimp_tpu_torch" / "csrc" / "toafit_general.cu"
KINDS = (profiles.FOURIER, profiles.VONMISES, profiles.CAUCHY)


def _leaves(kind: str) -> dict:
    """A two-component template of the family (numpy leaves)."""
    if kind == profiles.FOURIER:
        return dict(norm=10.0, amp=np.array([3.0, 1.2]), loc=np.array([0.2, -0.9]), wid=np.zeros(2),
                    ph_shift=0.0, amp_shift=1.0)
    return dict(norm=2.0, amp=np.array([3.0, 1.0]), loc=np.array([1.2, 3.6]),
                wid=np.array([0.5, 0.8]) if kind == profiles.VONMISES else np.array([0.3, 0.5]),
                ph_shift=0.0, amp_shift=1.0)


def _spec(kind: str):
    """Every parameter of the two-component template free (amp, loc, wid and
    ampShift for vM / Cauchy), boxes about the template."""
    if kind == profiles.FOURIER:
        return (0, 1, 2, 3, 4, 7), (2.0, 0.1, 0.0, -np.pi, -np.pi, 0.2), (50.0, 8.0, 4.0, np.pi, np.pi, 5.0)
    return ((0, 1, 2, 3, 4, 5, 6, 7), (0.4, 0.0, 0.0, 0.6, 3.0, 0.05, 0.05, 0.2),
            (10.0, 15.0, 5.0, 1.8, 4.2, 3.0, 3.0, 5.0))


def _draws(kind: str, n_rows: int = 2, n: int = 400, seed: int = 5):
    """Events drawn from the template's curve, ragged: the last row keeps
    three quarters of its slots."""
    rng = np.random.RandomState(seed)
    tpl = _port_tpl(_leaves(kind))
    cycle = 1.0 if kind == profiles.FOURIER else 2 * np.pi
    grid = np.linspace(0, cycle, 2048)
    peak = profiles.curve(kind, tpl, torch.as_tensor(grid)).numpy().max() * 1.05
    x = np.zeros((n_rows, n))
    for r in range(n_rows):
        acc = np.empty(0)
        while acc.size < n:
            cand = rng.uniform(0, cycle, 4 * n)
            keep = rng.uniform(0, peak, cand.size) < profiles.curve(kind, tpl, torch.as_tensor(cand)).numpy()
            acc = np.concatenate([acc, cand[keep]])
        x[r] = acc[:n]
    mask = np.ones_like(x, dtype=bool)
    mask[-1, 3 * n // 4:] = False
    x[-1, 3 * n // 4:] = 0.0
    exposure = mask.sum(1) / float(tpl.norm)
    return x, mask, exposure


def _port_tpl(leaves: dict) -> profiles.ProfileParams:
    return profiles.ProfileParams(**{k: torch.as_tensor(np.asarray(v, dtype=np.float64)) for k, v in leaves.items()})


def _jax_tpl(leaves: dict):
    return jax_profiles.ProfileParams(**{k: jnp.asarray(np.asarray(v, dtype=np.float64)) for k, v in leaves.items()})


def _against_jax(kind, tpl, jax_tpl, x, mask, exposure, phis, cfg_kw, warm=None):
    cfg, jcfg = toafit.ToAFitConfig(kind=kind, **cfg_kw), jax_toafit.ToAFitConfig(kind=kind, **cfg_kw)
    ll, vecs = general_sweep.general_profile_reference(
        kind, tpl, torch.as_tensor(x), torch.as_tensor(mask), torch.as_tensor(exposure), torch.as_tensor(phis),
        cfg, None if warm is None else torch.as_tensor(warm))
    for r in range(x.shape[0]):
        ll_ref, vecs_ref = jax_toafit._general_profile_vecs(
            kind, jax_tpl, jnp.asarray(x[r]), jnp.asarray(mask[r]), exposure[r], jnp.asarray(phis[r]), jcfg,
            None if warm is None else jnp.asarray(warm[r]))
        np.testing.assert_allclose(ll[r].numpy(), np.asarray(ll_ref), rtol=1e-12)
        np.testing.assert_allclose(vecs[r].numpy(), np.asarray(vecs_ref), rtol=1e-8, atol=1e-10)


class TestTwinAgainstJax:
    @pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
    @pytest.mark.parametrize("kind", KINDS)
    def test_every_parameter_free(self, kind, warm):
        x, mask, exposure = _draws(kind)
        leaves = _leaves(kind)
        idx, lo, hi = _spec(kind)
        half = toafit._phase_range(kind)
        phis = np.array([[-0.4 * half, 0.05, 0.3], [0.0, 0.2, -0.25]])
        warm_vec = None
        if warm:
            base = np.asarray(general_sweep.flatten_template(_port_tpl(leaves)))
            warm_vec = np.stack([base, base])
            warm_vec[:, 0] *= 1.1
            warm_vec[1, 1] *= 0.9
        _against_jax(kind, _port_tpl(leaves), _jax_tpl(leaves), x, mask, exposure, phis,
                     dict(free_idx=idx, free_lo=lo, free_hi=hi, nm_iters=40), warm_vec)

    @pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
    def test_committed_template_13_free(self, warm):
        """The bundled template's vary flags: norm, amp_1..6, ph_1..6."""
        kind, tpl = profiles.from_template(template_io.read_template(TEMPLATE))
        tpl_dict = jax_template_io.read_template(TEMPLATE)
        spec = toafit.free_param_spec(kind, tpl_dict)
        assert len(spec[0]) == 13
        jax_tpl = jax_profiles.from_template(tpl_dict)[1]
        rng = np.random.RandomState(8)
        grid = np.linspace(0, 1, 2048)
        rate = lambda p: profiles.curve(kind, tpl, torch.as_tensor(p)).numpy()  # noqa: E731
        peak = rate(grid).max() * 1.05
        acc = np.empty(0)
        while acc.size < 1000:
            cand = rng.uniform(0, 1, 4000)
            acc = np.concatenate([acc, cand[rng.uniform(0, peak, 4000) < rate(cand)]])
        x = acc[:1000].reshape(2, 500)
        mask = np.ones_like(x, dtype=bool)
        exposure = np.array([500.0 / float(tpl.norm)] * 2)
        phis = np.array([[-0.1, 0.05], [0.0, 0.12]])
        warm_vec = None
        if warm:
            base = np.asarray(general_sweep.flatten_template(tpl))
            warm_vec = np.stack([base * 1.02, base * 0.98])
        _against_jax(kind, tpl, jax_tpl, x, mask, exposure, phis,
                     dict(free_idx=spec[0], free_lo=spec[1], free_hi=spec[2], nm_iters=40), warm_vec)


def _quadratic(x, c):
    d = x - c[..., None, :]
    return (d ** 2).sum(-1) + 0.3 * d[..., 0] * d[..., 1]


def _kinked(x, c):
    """sqrt|d| with a ripple: its inside contractions fail, so it shrinks."""
    d = x - c[..., None, :]
    return torch.sqrt(torch.abs(d)).sum(-1) + 0.2 * torch.sin(30 * x[..., 0])


def _walk(fv: list, fc: list) -> tuple:
    """The decision tree read lazily, one problem: (step code, the
    candidate values it read)."""
    fr, reads = fc[0], 1
    if fr < fv[0]:
        reads += 1
        if fc[1] < fr:
            return 0, reads
    if fr < fv[-2]:
        return 1, reads
    if fr < fv[-1]:
        reads += 1
        if fc[2] <= fr:
            return 2, reads
    return (3 if fc[3] < fv[-1] else 4), reads + 1


class TestKernelOrderNelderMead:
    @pytest.mark.parametrize("objective,shrinks", [(_quadratic, False), (_kinked, True)], ids=["smooth", "shrinks"])
    def test_trace_is_the_decision_tree(self, objective, shrinks):
        c = torch.as_tensor(np.random.RandomState(0).standard_normal((8, 4)))
        x0 = torch.zeros(8, 4, dtype=torch.float64)
        want_x, want_f = optimize.nelder_mead(lambda p: objective(p, c), x0, init_scale=0.25, iters=150)
        trace = []
        got_x, got_f = optimize.nelder_mead(lambda p: objective(p, c), x0, init_scale=0.25, iters=150, trace=trace)
        assert torch.equal(got_x, want_x) and torch.equal(got_f, want_f)
        assert len(trace) == 150 and all(t["order"].shape == (8, 5) and t["f_c"].shape == (8, 4) for t in trace)
        for t in trace:
            walked = [_walk(fv, fc) for fv, fc in zip(t["fvals"].tolist(), t["f_c"].tolist())]
            assert t["step"].tolist() == [w[0] for w in walked]
            assert t["reads"].tolist() == [w[1] for w in walked]
        n_shrink = sum(int((t["step"] == 4).sum()) for t in trace)
        assert (n_shrink > 0) == shrinks
        assert all(1 <= int(t["reads"].min()) and int(t["reads"].max()) <= 3 for t in trace)

    # sorted values [0, 1, 2, 3]; candidates (reflect, expand, outside, inside)
    @pytest.mark.parametrize("f_c,reads", [
        ((-1.0, -2.0, 9.0, 9.0), 2),  # expand
        ((-1.0, 0.0, 9.0, 9.0), 2),  # reflect, its expand failed
        ((1.5, 9.0, 9.0, 9.0), 1),  # reflect
        ((2.5, 9.0, 2.0, 9.0), 2),  # outside contraction
        ((2.5, 9.0, 2.7, 1.0), 3),  # inside, the outside failed
        ((4.0, 9.0, 9.0, 1.0), 2),  # inside, the reflect no better than the worst
        ((4.0, 9.0, 9.0, 5.0), 2),  # shrink
        ((math.nan, 9.0, 9.0, 1.0), 2),  # a NaN reflect: inside
    ], ids=["expand", "reflect_after_expand", "reflect", "outside", "inside_after_outside", "inside", "shrink",
            "nan"])
    def test_candidate_reads(self, f_c, reads):
        fv = torch.tensor([0.0, 1.0, 2.0, 3.0], dtype=torch.float64)
        fc = torch.tensor(f_c, dtype=torch.float64)
        assert int(optimize.candidate_reads(fv, fc)) == reads == _walk(fv.tolist(), list(f_c))[1]

    def test_centroid_is_the_fixed_order_sum(self):
        s = torch.as_tensor(np.random.RandomState(1).standard_normal((3, 6, 5)))
        want = ((((s[:, 0] + s[:, 1]) + s[:, 2]) + s[:, 3]) + s[:, 4]) * (1.0 / 5)
        assert torch.equal(optimize.centroid(s), want)

    @pytest.mark.parametrize("kind", KINDS)
    def test_mirror_profile_is_bitwise_the_twin(self, kind):
        x, mask, exposure = _draws(kind, seed=9)
        idx, lo, hi = _spec(kind)
        cfg = toafit.ToAFitConfig(kind=kind, free_idx=idx, free_lo=lo, free_hi=hi, nm_iters=30)
        args = (kind, _port_tpl(_leaves(kind)), torch.as_tensor(x), torch.as_tensor(mask), torch.as_tensor(exposure),
                torch.as_tensor([[0.1, -0.2, 0.3], [0.0, 0.15, -0.05]]), cfg)
        ll, vecs = general_sweep.general_profile_reference(*args)
        ll_m, vecs_m, trace = general_sweep.mirror_profile(*args)
        assert torch.equal(ll, ll_m) and torch.equal(vecs, vecs_m) and len(trace) == 30


class TestBlockSum:
    @pytest.mark.parametrize("n", [1, 300, 512, 1500, 10000])
    def test_kernel_order(self, n):
        v = torch.as_tensor(np.random.RandomState(n).standard_normal((2, n)))
        padded = torch.nn.functional.pad(v, (0, (-n) % 512))
        per_thread = torch.zeros(2, 512, dtype=torch.float64)
        for c in range(padded.shape[1] // 512):
            per_thread = per_thread + padded[:, c * 512:(c + 1) * 512]
        warps = []
        for w in range(16):
            lanes = per_thread[:, 32 * w:32 * (w + 1)]
            for off in (16, 8, 4, 2, 1):
                lanes = lanes[:, :off] + lanes[:, off:2 * off]
            warps.append(lanes[:, 0])
        warps = torch.stack(warps, 1)
        for off in (8, 4, 2, 1):
            warps = warps[:, :off] + warps[:, off:2 * off]
        got = general_sweep.block_sum(v)
        assert torch.equal(got, warps[:, 0])
        np.testing.assert_allclose(got.numpy(), v.sum(-1).numpy(), rtol=1e-12, atol=1e-12)

    def test_a_row_does_not_depend_on_its_neighbours(self):
        v = torch.as_tensor(np.random.RandomState(2).standard_normal((64, 3000)))
        whole = general_sweep.block_sum(v)
        assert all(torch.equal(general_sweep.block_sum(v[r:r + 1])[0], whole[r]) for r in (0, 17, 63))


class TestPacking:
    def test_pack_is_the_twins_start(self):
        kind, tpl = profiles.from_template(template_io.read_template(TEMPLATE))
        spec = toafit.free_param_spec(kind, template_io.read_template(TEMPLATE))
        cfg = toafit.ToAFitConfig(kind=kind, free_idx=spec[0], free_lo=spec[1], free_hi=spec[2])
        warm = general_sweep.flatten_template(tpl).expand(3, -1).clone()
        warm[1, 0] *= 1.2
        for w in (None, warm):
            pk = general_sweep.pack(tpl, cfg, 3, w)
            base = general_sweep.flatten_template(tpl)
            assert torch.equal(pk["base"], base) and pk["base"].shape == (3 * tpl.n_comp + 2,)
            assert pk["free_idx"].dtype == torch.int32 and pk["free_idx"].tolist() == list(spec[0])
            tf = optimize.bounded_transform(spec[1], spec[2])
            assert torch.equal(pk["lo"], tf.lo) and torch.equal(pk["span"], tf.hi - tf.lo)
            start = base.expand(3, -1) if w is None else w
            assert torch.equal(pk["u0"], tf.to_unbounded(start[:, list(spec[0])]))
            assert all(t.is_contiguous() for k, t in pk.items() if k != "idx")
        # the bounded vectors round-trip the start; the free entries only change
        vec = general_sweep.vectors(pk, pk["u0"])
        free = list(spec[0])
        np.testing.assert_allclose(vec[:, free].numpy(), warm[:, free].numpy(), rtol=1e-9)
        fixed = [i for i in range(vec.shape[1]) if i not in free]
        assert torch.equal(vec[:, fixed], base.expand(3, -1)[:, fixed])

    def test_eval_entry_on_the_cpu_is_the_twins_values(self):
        kind = profiles.VONMISES
        x, mask, exposure = _draws(kind)
        idx, lo, hi = _spec(kind)
        cfg = toafit.ToAFitConfig(kind=kind, free_idx=idx, free_lo=lo, free_hi=hi)
        tpl = _port_tpl(_leaves(kind))
        u = torch.as_tensor(np.random.RandomState(4).standard_normal((2, 3, 5, len(idx))))
        phis = torch.as_tensor([[0.1, 0.2, 0.3], [0.0, -0.1, 0.4]])
        got = general_sweep.general_eval(kind, tpl, torch.as_tensor(x), torch.as_tensor(mask),
                                         torch.as_tensor(exposure), phis, cfg, u)
        # the same value as the package's extended likelihood at those vectors
        vec = general_sweep.vectors(general_sweep.pack(tpl, cfg, 2), u)
        p = toafit._unflatten_tpl(vec, tpl).replace(ph_shift=phis[:, :, None])
        want = -profiles.extended_loglik(kind, p, torch.as_tensor(x)[:, None, None, :],
                                         torch.as_tensor(exposure)[:, None, None],
                                         torch.as_tensor(mask)[:, None, None, :])
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12)


def _fit_inputs():
    kind = profiles.FOURIER
    x, mask, exposure = _draws(kind, n_rows=3, n=300, seed=12)
    idx, lo, hi = _spec(kind)
    return kind, _port_tpl(_leaves(kind)), x, mask, exposure, idx, lo, hi


class TestRouting:
    def test_free_idx_fit_launches_k6_for_every_profile(self, monkeypatch):
        kind, tpl, x, mask, exposure, idx, lo, hi = _fit_inputs()
        cfg = toafit.ToAFitConfig(kind=kind, ph_shift_res=200, n_brute=32, refine_iters=6, nm_iters=12, err_chunk=4,
                                  err_dense_window=2, free_idx=idx, free_lo=lo, free_hi=hi, n_free=len(idx))
        args = (kind, tpl, torch.as_tensor(x), torch.as_tensor(mask), torch.as_tensor(exposure), cfg)
        with torch.no_grad():
            plain = toafit.fit_segment(*args)
        calls = []

        def launcher(kind_, tpl_, x_, mask_, exposure_, phis_, cfg_, warm_vec=None, trace=False):
            calls.append((tuple(phis_.shape), warm_vec is not None))
            assert all(t.is_contiguous() for t in (x_, mask_, exposure_, phis_))
            ll, vec = general_sweep.general_profile_reference(kind_, tpl_, x_, mask_, exposure_, phis_, cfg_, warm_vec)
            zero = torch.zeros(phis_.shape, dtype=torch.int32)
            return ll, vec, zero, zero, None

        def golden(kind_, tpl_, x_, mask_, exposure_, lo_, hi_, cfg_, lib=None):
            calls.append(("golden", tuple(lo_.shape)))
            assert all(t.is_contiguous() for t in (x_, mask_, exposure_, lo_, hi_))
            phi, ll, vec = general_sweep.general_golden_reference(kind_, tpl_, x_, mask_, exposure_, lo_, hi_, cfg_)
            zero = torch.zeros(lo_.shape, dtype=torch.int32)
            return phi, ll, vec, zero, zero

        def refuse(*a, **k):
            raise AssertionError("a card fit ran the twin or K5")

        monkeypatch.setattr(toafit, "_on_card", lambda t: True)
        monkeypatch.setattr(general_sweep, "_launch_nm", launcher)
        monkeypatch.setattr(general_sweep, "_launch_golden", golden)
        monkeypatch.setattr(toafit, "_launch_profile", refuse)
        monkeypatch.setattr(toafit, "_launch_golden", refuse)
        with torch.no_grad():
            routed = toafit.fit_segment(*args)
        for key in plain:
            assert torch.equal(routed[key], plain[key]), key
        # the brute grid in one launch, the whole golden-section refine with
        # its refit vector in one, the dense window, then the fallback
        # passes, warm
        assert calls[0] == ((3, 32), False)
        assert calls[1] == ("golden", (3,))
        assert calls[2] == ((3, 4), True)
        assert all(warm and shape[1] == cfg.err_chunk for shape, warm in calls[3:])
        assert sum(c[0] == "golden" for c in calls) == 1

    def test_no_library_raises_kernel_error(self, monkeypatch):
        kind, tpl, x, mask, exposure, idx, lo, hi = _fit_inputs()
        cfg = toafit.ToAFitConfig(kind=kind, n_brute=8, nm_iters=4, free_idx=idx, free_lo=lo, free_hi=hi)

        def refuse(*a, **k):
            raise AssertionError("the twin ran for a card tensor")

        def no_nvcc(*a, **k):
            raise KernelError("nvcc not found: the Z^2 kernels need the CUDA toolkit")

        from crimp_tpu_torch.ops import z2_grid

        monkeypatch.setattr(toafit, "_on_card", lambda t: True)
        monkeypatch.setattr(general_sweep, "general_profile_reference", refuse)
        monkeypatch.setattr(general_sweep, "_LIB", None)
        monkeypatch.setattr(z2_grid, "build", no_nvcc)
        general_sweep.reset_launches()
        with pytest.raises(KernelError, match="nvcc"):
            toafit.fit_toas_batch(kind, tpl, x, mask, exposure, cfg, device="cpu")
        assert general_sweep.LAUNCHES == {"general_sweep": 0, "general_eval": 0, "general_golden": 0}

    @pytest.mark.parametrize("bad", ["kind", "components", "free", "dtype", "per_row"])
    def test_operands_k6_cannot_take_raise(self, bad):
        kind, tpl, x, mask, exposure, idx, lo, hi = _fit_inputs()
        cfg = toafit.ToAFitConfig(kind=kind, free_idx=idx, free_lo=lo, free_hi=hi)
        xt, mt, et = torch.as_tensor(x), torch.as_tensor(mask), torch.as_tensor(exposure)
        phis = torch.zeros(3, 2, dtype=torch.float64)
        if bad == "kind":
            kind = "gaussian"
        elif bad == "components":
            tpl = profiles.ProfileParams(norm=tpl.norm, amp=torch.ones(17, dtype=torch.float64),
                                         loc=torch.zeros(17, dtype=torch.float64),
                                         wid=torch.zeros(17, dtype=torch.float64), ph_shift=tpl.ph_shift,
                                         amp_shift=tpl.amp_shift)
        elif bad == "free":
            cfg = cfg._replace(free_idx=(0, 0), free_lo=(1.0, 1.0), free_hi=(2.0, 2.0))
        elif bad == "dtype":
            phis = phis.float()
        else:
            tpl = toafit.template_rows(profiles.ProfileParams(
                **{f: getattr(tpl, f).expand(3, *getattr(tpl, f).shape) for f in
                   ("norm", "amp", "loc", "wid", "ph_shift", "amp_shift")}), slice(None))
        with pytest.raises(KernelError):
            general_sweep._launch_nm(kind, tpl, xt, mt, et, phis, cfg)

    def test_cpu_tensors_take_the_twin(self, monkeypatch):
        def refuse(*a, **k):
            raise AssertionError("a CPU tensor launched K6")

        monkeypatch.setattr(general_sweep, "_launch_nm", refuse)
        kind, tpl, x, mask, exposure, idx, lo, hi = _fit_inputs()
        cfg = toafit.ToAFitConfig(kind=kind, nm_iters=5, free_idx=idx, free_lo=lo, free_hi=hi)
        general_sweep.reset_launches()
        ll, vecs = general_sweep.general_profile(kind, tpl, torch.as_tensor(x), torch.as_tensor(mask),
                                                 torch.as_tensor(exposure), torch.zeros(3, 2, dtype=torch.float64),
                                                 cfg)
        assert ll.shape == (3, 2) and vecs.shape == (3, 2, 8) and general_sweep.LAUNCHES["general_sweep"] == 0


class TestFullFit:
    @pytest.mark.parametrize("kind", [profiles.FOURIER, profiles.VONMISES])
    def test_readvaryparam_fit_matches_jax(self, kind):
        x, mask, exposure = _draws(kind, n_rows=2, n=400, seed=21)
        leaves = _leaves(kind)
        idx, lo, hi = _spec(kind)
        kw = dict(kind=kind, ph_shift_res=60, n_brute=16, refine_iters=10, nm_iters=30, err_chunk=4,
                  free_idx=idx, free_lo=lo, free_hi=hi, n_free=len(idx))
        got = toafit.fit_toas_batch(kind, _port_tpl(leaves), x, mask, exposure, toafit.ToAFitConfig(**kw),
                                    device="cpu")
        want = jax_toafit.fit_toas_batch(kind, _jax_tpl(leaves), x, mask, exposure, jax_toafit.ToAFitConfig(**kw))
        step = 2 * np.pi / kw["ph_shift_res"]
        np.testing.assert_allclose(got["phShift"].numpy(), np.asarray(want["phShift"]), rtol=0, atol=1e-6)
        for key in ("phShift_LL", "phShift_UL"):
            assert np.max(np.abs(got[key].numpy() - np.asarray(want[key]))) <= step * (1 + 1e-9)
        np.testing.assert_allclose(got["logLmax"].numpy(), np.asarray(want["logLmax"]), rtol=1e-10)
        np.testing.assert_allclose(got["theta_best"].numpy(), np.asarray(want["theta_best"]), rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(got["redChi2"].numpy(), np.asarray(want["redChi2"]), rtol=1e-6)


def _c_functions(src: str) -> dict:
    """extern "C" function name -> parameter count."""
    out = {}
    for m in re.finditer(r'extern "C" (?:int|long long) (\w+)\(([^)]*)\)', src):
        params = [p for p in m.group(2).split(",") if p.strip()]
        out[m.group(1)] = len(params)
    return out


class TestCInterface:
    def test_bound_symbols_exist_in_the_source(self, monkeypatch):
        from crimp_tpu_torch.ops import z2_grid

        class Symbol:
            pass

        class Library:  # stands in for the nvcc-built library: records what _lib() binds
            def __init__(self, path):
                assert path == "libtoafit_general.so"
                self.symbols = {}

            def __getattr__(self, name):
                return self.symbols.setdefault(name, Symbol())

        monkeypatch.setattr(z2_grid, "build", lambda: {"toafit_general": "libtoafit_general.so"})
        monkeypatch.setattr(general_sweep.ctypes, "CDLL", Library)
        monkeypatch.setattr(general_sweep, "_LIB", None)
        lib = general_sweep._lib()
        funcs = _c_functions(SRC.read_text())
        assert set(lib.symbols) == set(funcs) == {"toafit_general_nm", "toafit_general_eval",
                                                  "toafit_general_max_group", "toafit_general_golden",
                                                  "toafit_general_golden_room", "toafit_general_nm_room",
                                                  "toafit_general_nm_blocks"}
        for name, sym in lib.symbols.items():
            assert len(sym.argtypes) == funcs[name], name

    def test_source_limits_and_constants_are_the_wrapper(self):
        src = SRC.read_text()
        consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
        assert int(consts["THREADS"]) == general_sweep.THREADS and int(consts["MAX_COMP"]) == general_sweep.MAX_COMP
        assert int(consts["POS_GROUP"]) == general_sweep.POS_GROUP == 4
        assert int(consts["MAX_GROUP"]) == max(general_sweep.GROUPS) <= general_sweep.THREADS // 32  # a warp a problem
        assert general_sweep.GROUP in general_sweep.GROUPS
        assert re.search(r"enum Kind \{ FOURIER = 0, VONMISES = 1, CAUCHY = 2 \}", src)
        assert general_sweep._KIND_CODE == {profiles.FOURIER: 0, profiles.VONMISES: 1, profiles.CAUCHY: 2}
        steps = re.search(r"enum Step \{ EXPAND = 0, REFLECT = 1, OUTSIDE = 2, INSIDE = 3, SHRINK = 4 \}", src)
        assert steps and general_sweep.STEP_NAMES == ("expand", "reflect", "outside", "inside", "shrink")
        hexes = dict(re.findall(r"constexpr double (\w+) = (0x[0-9a-fp.+-]+);", src))
        assert float.fromhex(hexes["TWO_PI"]) == 2 * math.pi
        assert float.fromhex(hexes["INV_TWO_PI"]) == general_sweep.INV_TWO_PI
        assert "constexpr double INIT_SCALE = 0.25;" in src and general_sweep.INIT_SCALE == 0.25
        assert "toafit_general" in __import__("crimp_tpu_torch.ops.z2_grid", fromlist=["SOURCES"]).SOURCES


class TestCostRow:
    @pytest.mark.parametrize("kind,per_comp", [(profiles.FOURIER, 5), (profiles.VONMISES, 7), (profiles.CAUCHY, 6)])
    def test_k6_counts(self, kind, per_comp):
        # the evaluations the data needs: F + 1 a problem, the candidate
        # values read, F a shrink step
        got = costmodel.k6_counts(84, 128, 10000, 6, kind, 13, 2_000_000, 500)
        evals = 84 * 128 * 14 + 2_000_000 + 13 * 500
        assert got["evaluations"] == evals
        once = 84 * 10000 * 6 if kind == profiles.FOURIER else 0  # j 2 pi x, a (row, event, component)
        assert got["flops"] == evals * 10000 * (per_comp * 6 + 6) + once
        assert got["flops_dtype"] == "f64"
        D = 20
        assert got["bytes_accessed"] == (84 * 10000 * 9 + 84 * 8 + 84 * 128 * 8 + 84 * 13 * 8 + 8 * D
                                         + 84 * 128 * (8 + 8 * D + 8))

    def test_k6_counts_charge_the_reads_not_the_four_candidates(self):
        """A problem whose every step reflects reads one candidate a step:
        its count is F + 1 + nm_iters evaluations, not F + 1 + 4 nm_iters."""
        one = costmodel.k6_counts(1, 1, 1000, 2, profiles.VONMISES, 5, 150, 0)
        four = costmodel.k6_counts(1, 1, 1000, 2, profiles.VONMISES, 5, 600, 0)
        assert one["evaluations"] == 6 + 150 and four["evaluations"] == 6 + 600
        assert one["flops"] / four["flops"] == pytest.approx(156 / 606)

    def test_k6_row_is_held_to_the_f64_peak(self):
        import copy

        from crimp_tpu_torch.obs import roofline

        counts = costmodel.k6_counts(84, 32, 10000, 6, profiles.FOURIER, 13, 84 * 32 * 250, 0)
        doc = {"run_id": "k6", "name": "run",
               "platform": {"backend": "cuda", "devices": [{"id": 0, "kind": "NVIDIA H100 80GB HBM3"}]},
               "spans": [{"name": "toa_general_err_dense", "kind": "kernel", "t0_s": 0.0, "dur_s": 0.385,
                          "parent": None, "thread": 0, "attrs": {}}],
               "costmodel": {"toa_general_err_dense": {**counts, "span": "toa_general_err_dense"}}}
        row = roofline.analyze(copy.deepcopy(doc))["rows"][0]
        assert row["flops_dtype"] == "f64" and row["bound"] == "compute"
        assert row["pct_of_roof"] == pytest.approx(100 * counts["flops"] / 0.385 / 34e12, rel=1e-3)

    def test_general_sites(self):
        assert toafit.general_site("toa_sweep_brute") == "toa_general_brute"
        assert toafit.general_site("toa_sweep_err_loop") == "toa_general_err_loop"
        assert toafit.general_site("toa_profile_sweep") == "toa_general_sweep"
