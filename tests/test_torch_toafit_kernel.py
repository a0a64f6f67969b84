"""K5, the ToA fit's profile-likelihood sweep (crimp_tpu_torch/csrc/toafit.cu),
on the CPU: its plain twin against crimp_tpu, the wrapper's routing, and the
C interface the wrapper binds.

- ``profile_sweep_reference`` against JAX's ``profile_loglik_full`` on the
  same seeded segments (S = 3 rows of 500, 430 and 377 events padded to 500,
  P = 8 phases a row, K = 6 components), for the three template families
  and the three norm solves: LL within rtol 1e-12, A and b within rtol
  1e-10 (both packages run the same f64 arithmetic; the gap is the order of
  the event sums); the bf16 Fourier sweep against JAX's bf16 sweep within
  rtol 1e-5 (the f32 sums of bf16 products in another order).
- Per-row templates against a loop over the rows, each with its own
  template (rtol 1e-12: the rows' event sums are the same sums).
- The golden-section refine's plain version, ``golden_refine_reference``,
  bitwise ``golden_section`` over the twin's one-phase sweeps plus the
  twin's sweep at the optimum, whose LL is the refine's maximum, for the
  three families and the three norm solves; ``fit_segment`` on CPU tensors
  bitwise the composition it had before the refine was one launch (the
  golden section over ``profile_loglik``, then the nuisance sweep).
- The routing: with the wrapper's device predicate saying "card" and its
  launchers replaced by recorders that return the plain versions, a
  fit_segment of the north star's shape (n_brute 128, refine_iters 25)
  makes one sweep launch for the brute grid, one golden-refine launch (the
  refine and the nuisance solve), one sweep for the dense error window and
  one per pass of the error scan's fallback loop, with results bitwise the
  unpatched CPU run's.
- Every symbol the wrapper binds with ctypes is an ``extern "C"`` function
  of csrc/toafit.cu with as many parameters, and the source's limits,
  codes and golden-ratio constant are the wrapper's.
- K5's cost rows count f64 operations (the golden refine the one-phase
  sweeps it evaluates) and ``obs roofline`` holds them to the card's f64
  peak.
"""

import copy
import math
import re
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crimp_tpu.models import profiles as jax_profiles
from crimp_tpu.ops import toafit as jax_toafit
from crimp_tpu_torch.models import profiles
from crimp_tpu_torch.obs import costmodel, roofline
from crimp_tpu_torch.ops import optimize, toafit
from crimp_tpu_torch.resilience import KernelError

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parent.parent
KINDS = (profiles.FOURIER, profiles.VONMISES, profiles.CAUCHY)
MODES = {"newton": {}, "joint": {"vary_amps": True}, "fixed": {"fix_norm": True}}
COUNTS = (500, 430, 377)
N_PHIS, N_COMP = 8, 6


def _template(kind: str, rng) -> dict:
    """Seeded template leaves (numpy) of one family with N_COMP components."""
    if kind == profiles.FOURIER:
        return dict(norm=12.0, amp=rng.uniform(0.3, 2.0, N_COMP), loc=rng.uniform(-np.pi, np.pi, N_COMP),
                    wid=np.zeros(N_COMP), ph_shift=0.0, amp_shift=1.0)
    wid = rng.uniform(0.3, 0.9, N_COMP) if kind == profiles.VONMISES else rng.uniform(0.2, 0.6, N_COMP)
    return dict(norm=9.0, amp=rng.uniform(5.0, 15.0, N_COMP), loc=rng.uniform(0.5, 2 * np.pi - 0.5, N_COMP),
                wid=wid, ph_shift=0.0, amp_shift=1.0)


def _operands(kind: str, seed: int = 11):
    """(template leaves, x (S, N), mask, exposure (S,), phis (S, P)), numpy:
    ragged rows of uniform phases in the family's cycle."""
    rng = np.random.RandomState(seed)
    tpl = _template(kind, rng)
    cycle = 1.0 if kind == profiles.FOURIER else 2 * np.pi
    n_max = max(COUNTS)
    x = np.zeros((len(COUNTS), n_max))
    mask = np.zeros((len(COUNTS), n_max), dtype=bool)
    for r, n in enumerate(COUNTS):
        x[r, :n] = np.sort(rng.uniform(0.0, cycle, n))
        mask[r, :n] = True
    exposure = np.array([n / 14.0 for n in COUNTS])
    half = toafit._phase_range(kind)
    phis = np.linspace(-half, half, N_PHIS)[None, :] + rng.uniform(-0.05, 0.05, (len(COUNTS), N_PHIS))
    return tpl, x, mask, exposure, phis


def _port_tpl(leaves: dict) -> profiles.ProfileParams:
    return profiles.ProfileParams(**{k: torch.as_tensor(np.asarray(v, dtype=np.float64)) for k, v in leaves.items()})


def _jax_tpl(leaves: dict):
    return jax_profiles.ProfileParams(**{k: jnp.asarray(np.asarray(v, dtype=np.float64)) for k, v in leaves.items()})


def _port_sweep(kind, leaves, x, mask, exposure, phis, **cfg_kw):
    cfg = toafit.ToAFitConfig(kind=kind, **cfg_kw)
    out = toafit.profile_sweep_reference(kind, _port_tpl(leaves), torch.as_tensor(x), torch.as_tensor(mask),
                                         torch.as_tensor(exposure), torch.as_tensor(phis), cfg)
    return [t.numpy() for t in out]


def _jax_sweep(kind, leaves, x, mask, exposure, phis, **cfg_kw):
    """JAX's profile_loglik_full row by row (the fit vmaps it over rows)."""
    cfg = jax_toafit.ToAFitConfig(kind=kind, **cfg_kw)
    tpl = _jax_tpl(leaves)
    rows = [jax_toafit.profile_loglik_full(kind, tpl, jnp.asarray(x[r]), jnp.asarray(mask[r]),
                                           jnp.asarray(exposure[r]), jnp.asarray(phis[r]), cfg)
            for r in range(x.shape[0])]
    return [np.stack([np.asarray(row[i]) for row in rows]) for i in range(3)]


def _assert_sweeps(got, want, ll_rtol, ab_rtol):
    ll, a, b = got
    ll_w, a_w, b_w = want
    np.testing.assert_array_equal(np.isfinite(ll), np.isfinite(ll_w))
    fin = np.isfinite(ll_w)
    assert fin.any()
    np.testing.assert_allclose(ll[fin], ll_w[fin], rtol=ll_rtol, atol=0)
    np.testing.assert_allclose(a, a_w, rtol=ab_rtol, atol=0)
    np.testing.assert_allclose(b, b_w, rtol=ab_rtol, atol=0)


class TestTwinAgainstJax:
    @pytest.mark.parametrize("mode", sorted(MODES))
    @pytest.mark.parametrize("kind", KINDS)
    def test_sweep_matches_jax(self, kind, mode):
        ops = _operands(kind)
        got = _port_sweep(kind, *ops, **MODES[mode])
        want = _jax_sweep(kind, *ops, **MODES[mode])
        _assert_sweeps(got, want, ll_rtol=1e-12, ab_rtol=1e-10)
        if mode == "fixed":
            assert np.all(got[1] == ops[0]["norm"]) and np.all(got[2] == 1.0)
        if mode == "newton":
            assert np.all(got[2] == 1.0)

    def test_bf16_sweep_matches_jax_bf16(self):
        ops = _operands(profiles.FOURIER, seed=12)
        got = _port_sweep(profiles.FOURIER, *ops, mxu_bf16=1)
        want = _jax_sweep(profiles.FOURIER, *ops, mxu_bf16=1)
        _assert_sweeps(got, want, ll_rtol=1e-5, ab_rtol=1e-5)
        exact = _port_sweep(profiles.FOURIER, *ops, mxu_bf16=0)
        assert not np.array_equal(got[0], exact[0])  # the bf16 rounding took part


class TestPerRowTemplates:
    @pytest.mark.parametrize("kind", KINDS)
    def test_per_row_templates_match_a_row_loop(self, kind):
        _, x, mask, exposure, phis = _operands(kind, seed=13)
        rng = np.random.RandomState(14)
        leaves = [_template(kind, rng) for _ in COUNTS]
        for r, lv in enumerate(leaves):
            lv["amp_shift"] = 0.8 + 0.2 * r
        stacked = profiles.ProfileParams(**{k: torch.stack([getattr(_port_tpl(lv), k) for lv in leaves])
                                            for k in leaves[0]})
        cfg = toafit.ToAFitConfig(kind=kind, vary_amps=True)
        t = lambda v: torch.as_tensor(v)  # noqa: E731
        got = toafit.profile_sweep_reference(kind, stacked, t(x), t(mask), t(exposure), t(phis), cfg)
        for r, lv in enumerate(leaves):
            one = toafit.profile_sweep_reference(kind, _port_tpl(lv), t(x[r:r + 1]), t(mask[r:r + 1]),
                                                 t(exposure[r:r + 1]), t(phis[r:r + 1]), cfg)
            for g, w in zip(got, one):
                np.testing.assert_allclose(g[r].numpy(), w[0].numpy(), rtol=1e-12, atol=0)


def _fit_inputs(seed: int = 15):
    """Three pulsed segments of a Fourier template (1500, 1200, 900 events)."""
    rng = np.random.RandomState(seed)
    leaves = dict(norm=10.0, amp=np.array([3.0, 1.0, 0.5]), loc=np.array([0.2, -0.4, 1.0]),
                  wid=np.zeros(3), ph_shift=0.0, amp_shift=1.0)
    tpl = _port_tpl(leaves)
    segs = []
    for n in (1500, 1200, 900):
        cand = rng.uniform(0, 1, 4 * n)
        dens = 10.0 + sum(a * np.cos(2 * np.pi * (j + 1) * (cand - 0.03) + loc)
                          for j, (a, loc) in enumerate(zip(leaves["amp"], leaves["loc"])))
        segs.append(cand[rng.uniform(0, 15.5, cand.size) < dens][:n])
    phases, masks = toafit.pad_segments(segs)
    exposures = np.array([len(s) / 10.0 for s in segs])
    return tpl, torch.as_tensor(phases), torch.as_tensor(masks), torch.as_tensor(exposures)


class TestRouting:
    @pytest.mark.parametrize("window", [-1, 2])
    def test_fit_segment_launches_once_per_sweep(self, monkeypatch, window):
        tpl, x, mask, exposure = _fit_inputs()
        cfg = toafit.ToAFitConfig(kind=profiles.FOURIER, ph_shift_res=1000, n_brute=128, refine_iters=25,
                                  err_dense_window=window, err_chunk=4)
        with torch.no_grad():
            plain = toafit.fit_segment(profiles.FOURIER, tpl, x, mask, exposure, cfg)
        calls = []

        def operands_ok(kind, tpl_, x_, cfg_, events, *tensors):
            for t in (*tensors, *events.values()):
                assert t.is_contiguous()
            # the fit's operands, computed once, are the launch's own rows'
            for key, val in toafit.sweep_events(kind, tpl_, x_, cfg_).items():
                assert torch.equal(events[key], val), key

        def launcher(kind, tpl_, x_, mask_, exposure_, phis_, cfg_, events):
            calls.append(("sweep", tuple(phis_.shape)))
            operands_ok(kind, tpl_, x_, cfg_, events, x_, mask_, exposure_, phis_)
            return toafit.profile_sweep_reference(kind, tpl_, x_, mask_, exposure_, phis_, cfg_)

        def golden(kind, tpl_, x_, mask_, exposure_, lo, hi, cfg_, events):
            calls.append(("golden", tuple(lo.shape)))
            operands_ok(kind, tpl_, x_, cfg_, events, x_, mask_, exposure_, lo, hi)
            return toafit.golden_refine_reference(kind, tpl_, x_, mask_, exposure_, lo, hi, cfg_)

        monkeypatch.setattr(toafit, "_on_card", lambda t: True)
        monkeypatch.setattr(toafit, "_launch_profile", launcher)
        monkeypatch.setattr(toafit, "_launch_golden", golden)
        with torch.no_grad():
            routed = toafit.fit_segment(profiles.FOURIER, tpl, x, mask, exposure, cfg)
        for key in plain:
            assert torch.equal(routed[key], plain[key]), key

        # the fallback loop's passes a side: the largest over the rows of the
        # chunks it took past the dense window to reach that row's crossing
        step = 2 * math.pi / cfg.ph_shift_res
        W = toafit.DENSE_WINDOW_DEFAULT if window < 0 else window
        passes = 0
        for key in ("phShift_LL", "phShift_UL"):
            k_star = np.rint((plain[key].numpy() - step / 2) / step).astype(int) - 1
            passes += int(max(0, *(-(-(k - W) // cfg.err_chunk) for k in k_star)))
        assert (passes == 0) == (window < 0)
        # the brute grid in one sweep, the refine and its nuisance solve in
        # one launch, the dense window, then the fallback passes
        assert calls[:3] == [("sweep", (3, 128)), ("golden", (3,)), ("sweep", (3, 2 * W))]
        assert len(calls) == 3 + passes
        assert all(kind == "sweep" and shape[1] == cfg.err_chunk for kind, shape in calls[3:])

    def test_cpu_tensors_take_the_twin(self, monkeypatch):
        def refuse(*a, **k):
            raise AssertionError("a CPU tensor launched K5")

        monkeypatch.setattr(toafit, "_launch_profile", refuse)
        monkeypatch.setattr(toafit, "_launch_golden", refuse)
        toafit.reset_launches()
        tpl, x, mask, exposure = _fit_inputs()
        phis = torch.zeros(3, 2, dtype=torch.float64)
        ll, a, b = toafit.profile_sweep(profiles.FOURIER, tpl, x, mask, exposure, phis, toafit.ToAFitConfig())
        assert ll.shape == a.shape == b.shape == (3, 2) and toafit.LAUNCHES["profile_sweep"] == 0
        out = toafit.golden_refine(profiles.FOURIER, tpl, x, mask, exposure, phis[:, 0] - 0.1, phis[:, 0] + 0.1,
                                   toafit.ToAFitConfig(refine_iters=3))
        assert [t.shape for t in out] == [(3,)] * 4 and toafit.LAUNCHES == {"profile_sweep": 0, "golden_refine": 0}


class TestGoldenRefine:
    @pytest.mark.parametrize("mode", sorted(MODES))
    @pytest.mark.parametrize("kind", KINDS)
    def test_reference_is_golden_section_over_the_twin(self, kind, mode):
        leaves, x, mask, exposure, phis = (torch.as_tensor(v) if isinstance(v, np.ndarray) else v
                                           for v in _operands(kind, seed=16))
        tpl = _port_tpl(leaves)
        cfg = toafit.ToAFitConfig(kind=kind, refine_iters=9, **MODES[mode])
        lo, hi = phis[:, 3].clone(), phis[:, 4].clone()

        def ll_of(phi):
            return toafit.profile_sweep_reference(kind, tpl, x, mask, exposure, phi[:, None], cfg)[0][:, 0]

        phi_w, ll_w = optimize.golden_section(ll_of, lo, hi, iters=cfg.refine_iters)
        ll_at, a_w, b_w = toafit.profile_sweep_reference(kind, tpl, x, mask, exposure, phi_w[:, None], cfg)
        got = toafit.golden_refine_reference(kind, tpl, x, mask, exposure, lo, hi, cfg)
        for g, w in zip(got, (phi_w, ll_w, a_w[:, 0], b_w[:, 0])):
            assert torch.equal(g, w)
        # the optimum's (A, b) come from the evaluation that picked it: its LL
        # is the refine's maximum, and the optimum lies inside the bracket
        assert torch.equal(ll_at[:, 0], got[1]) and bool(torch.all((lo <= got[0]) & (got[0] <= hi)))
        assert bool(torch.all(torch.isfinite(got[1])))

    @pytest.mark.parametrize("mode", sorted(MODES))
    @pytest.mark.parametrize("kind", KINDS)
    def test_cpu_fit_is_the_composition_before_the_one_launch_refine(self, kind, mode):
        """fit_segment on CPU tensors against the steps it ran before the
        refine became ``golden_refine``: the golden section over
        ``profile_loglik``, then a one-phase nuisance sweep at its optimum."""
        cfg = toafit.ToAFitConfig(kind=kind, ph_shift_res=200, n_brute=48, brute_chunk=16, refine_iters=12,
                                  err_chunk=8, err_dense_window=6, **MODES[mode])
        if kind == profiles.FOURIER:
            tpl, x, mask, exposure = _fit_inputs(seed=17)
        else:
            leaves, x, mask, exposure, _ = _operands(kind, seed=17)
            tpl, x, mask, exposure = _port_tpl(leaves), *(torch.as_tensor(v) for v in (x, mask, exposure))
        with torch.no_grad():
            got = toafit.fit_segment(kind, tpl, x, mask, exposure, cfg)
            S, half = x.shape[0], toafit._phase_range(kind)
            brute = torch.as_tensor(np.linspace(-half, half, cfg.n_brute))
            ll_brute = torch.cat([toafit.profile_loglik(kind, tpl, x, mask, exposure, p.expand(S, cfg.brute_chunk),
                                                        cfg)[0] for p in brute.reshape(-1, cfg.brute_chunk)], dim=1)
            phi0 = brute[torch.argmax(ll_brute, dim=1)]
            step = 2 * half / (cfg.n_brute - 1)
            phi, ll_max = optimize.golden_section(
                lambda p: toafit.profile_loglik(kind, tpl, x, mask, exposure, p[:, None], cfg)[0][:, 0],
                phi0 - step, phi0 + step, iters=cfg.refine_iters)
            _, a, b = toafit.profile_loglik_full(kind, tpl, x, mask, exposure, phi[:, None], cfg)
            err_lo, err_hi, iters = toafit._error_scan(kind, tpl, x, mask, exposure, phi, ll_max, cfg)
            red = toafit._binned_chi2(kind, tpl, x, mask, exposure, phi, a[:, 0], b[:, 0], cfg)
        want = {"phShift": phi, "phShift_LL": err_lo, "phShift_UL": err_hi, "norm": a[:, 0], "ampShift": b[:, 0],
                "logLmax": ll_max, "redChi2": red, "errScanLoopIters": iters}
        for key, val in want.items():
            assert torch.equal(got[key], val), key
        assert torch.equal(got["theta_best"][:, 0], a[:, 0])


def _c_functions(src: str) -> dict:
    """extern "C" function name -> its parameter count."""
    out = {}
    for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', src):
        params = m.group(2).strip()
        out[m.group(1)] = 0 if not params else params.count(",") + 1
    return out


class TestCInterface:
    def test_bound_symbols_exist_in_the_source(self, monkeypatch):
        from crimp_tpu_torch.ops import z2_grid

        class Symbol:
            pass

        class Library:  # stands in for the nvcc-built library: records what _lib() binds
            def __init__(self, path):
                self.symbols = {}

            def __getattr__(self, name):
                return self.symbols.setdefault(name, Symbol())

        monkeypatch.setattr(z2_grid, "build", lambda: {"toafit": "libtoafit.so"})
        monkeypatch.setattr(toafit.ctypes, "CDLL", Library)
        monkeypatch.setattr(toafit, "_LIB", None)
        lib = toafit._lib()
        funcs = _c_functions((REPO / "crimp_tpu_torch" / "csrc" / "toafit.cu").read_text())
        assert set(lib.symbols) == {"toafit_profile", "toafit_golden", "toafit_smem_events"}
        for name, sym in lib.symbols.items():
            assert name in funcs, f"{name} is bound but csrc/toafit.cu has no extern \"C\" {name}"
            assert len(sym.argtypes) == funcs[name], name

    def test_source_limits_and_codes_are_the_wrapper(self):
        src = (REPO / "crimp_tpu_torch" / "csrc" / "toafit.cu").read_text()
        consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
        assert int(consts["MAX_COMP"]) == toafit.MAX_COMP
        kinds = re.search(r"enum Kind \{ FOURIER = 0, VONMISES = 1, CAUCHY = 2 \}", src)
        modes = re.search(r"enum NormMode \{ NORM_NEWTON = 0, NORM_JOINT = 1, NORM_FIXED = 2 \}", src)
        assert kinds and modes
        assert toafit._KIND_CODE == {profiles.FOURIER: 0, profiles.VONMISES: 1, profiles.CAUCHY: 2}
        assert (toafit.NORM_NEWTON, toafit.NORM_JOINT, toafit.NORM_FIXED) == (0, 1, 2)
        assert toafit.norm_mode(toafit.ToAFitConfig(vary_amps=True, fix_norm=True)) == toafit.NORM_JOINT
        assert "toafit" in __import__("crimp_tpu_torch.ops.z2_grid", fromlist=["SOURCES"]).SOURCES

    def test_golden_entry_limits_and_constants(self):
        """toafit_golden: a cluster of two blocks a row (so at most
        (2^31 - 1) // 2 rows on gridDim.x), no negative refine_iters, and the
        golden-ratio conjugate with the bits of optimize.PHI."""
        src = (REPO / "crimp_tpu_torch" / "csrc" / "toafit.cu").read_text()
        golden = src[src.index('extern "C" int toafit_golden('):]
        assert f"n_rows > {(2 ** 31 - 1) // 2}" in golden and "refine_iters < 0" in golden
        assert "gridDim = dim3(static_cast<unsigned>(2 * n_rows))" in golden
        assert "clusterDim.x = 2;" in golden and "cudaLaunchAttributeClusterDimension" in golden
        phi = re.search(r"constexpr double PHI = (0x[0-9a-fp.+-]+);", src).group(1)
        assert float.fromhex(phi) == optimize.PHI
        assert int(dict(re.findall(r"constexpr int (\w+) = (\d+);", src))["THREADS"]) == 512
        tpl, x, mask, exposure = _fit_inputs()
        with pytest.raises(KernelError, match="refine_iters"):
            toafit._launch_golden(profiles.FOURIER, tpl, x, mask, exposure, exposure * 0, exposure * 0 + 1,
                                  toafit.ToAFitConfig(refine_iters=-1))


class TestCostRow:
    def test_k5_counts_and_f64_roofline(self):
        counts = costmodel.k5_counts(84, 128, 10000, 6, profiles.FOURIER, toafit.NORM_NEWTON, 20)
        per_event = 4 * 6 + 1 + 5 * 20 + 6
        assert counts["flops"] == 84 * 128 * 10000 * per_event
        assert counts["flops_dtype"] == "f64"
        assert costmodel.k5_ops_per_event(6, profiles.FOURIER, toafit.NORM_JOINT, 20, bf16=True) == 1 + 12 * 40 + 6
        doc = {"run_id": "k5", "name": "run",
               "platform": {"backend": "cuda", "devices": [{"id": 0, "kind": "NVIDIA H100 80GB HBM3"}]},
               "spans": [{"name": "toa_sweep_brute", "kind": "kernel", "t0_s": 0.0, "dur_s": 0.002,
                          "parent": None, "thread": 0, "attrs": {}}],
               "costmodel": {"toa_sweep_brute": {**counts, "span": "toa_sweep_brute"}}}
        row = roofline.analyze(copy.deepcopy(doc))["rows"][0]
        assert row["flops_dtype"] == "f64" and row["bound"] == "compute"
        assert row["pct_of_roof"] == pytest.approx(100 * counts["flops"] / 0.002 / 34e12, rel=1e-3)
        del doc["costmodel"]["toa_sweep_brute"]["flops_dtype"]  # held to the f32 peak, it would read half
        assert roofline.analyze(doc)["rows"][0]["pct_of_roof"] == pytest.approx(row["pct_of_roof"] * 34 / 67,
                                                                              rel=1e-3)

    @pytest.mark.parametrize("mode", [toafit.NORM_NEWTON, toafit.NORM_JOINT, toafit.NORM_FIXED])
    def test_golden_counts_are_the_one_phase_sweeps_it_evaluates(self, mode):
        one = costmodel.k5_counts(84, 1, 9991.5, 6, profiles.FOURIER, mode, 20)
        got = costmodel.k5_golden_counts(84, 9991.5, 6, profiles.FOURIER, mode, 20, 25)
        assert got == {"flops": 52 * one["flops"], "bytes_accessed": 52 * one["bytes_accessed"],
                       "flops_dtype": "f64"}
