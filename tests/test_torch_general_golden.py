"""K6's golden-section refine (``csrc/toafit_general.cu``
``toafit_general_golden``, ``ops/general_sweep.py::general_golden``), the
readvaryparam fit's refine and refit vector at its optimum, on the CPU:

- ``general_golden`` on a CPU tensor is bit for bit the chain it stands
  for: ``optimize.golden_section`` over one-phase twins, then the twin at
  the optimum, for the three template families (a row whose profile is
  NaN included), and through ``general_golden_reference``'s ``sweep``;
- it holds against JAX's ``golden_section`` over ``profile_loglik`` and
  the refit at its optimum (``crimp_tpu/ops/toafit.py:640-660``), row by
  row: phi within 1e-9 rad, LL within rtol 1e-12, vectors within rtol 1e-8
  (tests/test_torch_general_sweep.py's tolerances for the profile);
- the readvaryparam fit of Cauchy rows against crimp_tpu's at
  ``TestFullFit``'s tolerances (that class covers Fourier and von Mises);
- the C entry point's signature is what the wrapper binds, its PHI is
  ``optimize.PHI``;
- a CPU tensor never launches, a "card" tensor with no nvcc raises
  ``KernelError`` and counts nothing, operands K6 cannot take raise;
- ``costmodel.k6_golden_counts`` counts the evaluations of its one-phase
  problems as ``k6_counts`` does, the Fourier j 2 pi x term once a row,
  its bytes the launch's own, its row held to the f64 peak.
"""

import copy
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crimp_tpu.ops import optimize as jax_optimize
from crimp_tpu.ops import toafit as jax_toafit
from crimp_tpu_torch.models import profiles
from crimp_tpu_torch.obs import costmodel
from crimp_tpu_torch.ops import general_sweep, optimize, toafit
from crimp_tpu_torch.resilience import KernelError
from tests.test_torch_general_sweep import _draws, _jax_tpl, _leaves, _port_tpl, _spec

torch.set_num_threads(2)

SRC = pathlib.Path(__file__).resolve().parent.parent / "crimp_tpu_torch" / "csrc" / "toafit_general.cu"
KINDS = (profiles.FOURIER, profiles.VONMISES, profiles.CAUCHY)


def _inputs(kind: str, nan_row: bool = False):
    """3 rows x 2000 events drawn from the family's template (the last row
    ragged), its every-parameter spec, brackets of one step of a 32-phase
    brute grid over the family's phase range about three phases in it,
    refine_iters 6, nm_iters 12."""
    x, mask, exposure = _draws(kind, n_rows=3, n=2000, seed=8)
    if nan_row:
        exposure[1] = np.nan
    idx, lo, hi = _spec(kind)
    cfg = toafit.ToAFitConfig(kind=kind, refine_iters=6, nm_iters=12, free_idx=idx, free_lo=lo, free_hi=hi,
                              n_free=len(idx))
    half = toafit._phase_range(kind)
    step = 2 * half / 31
    center = torch.tensor([0.3, -0.2, 0.05], dtype=torch.float64) * half
    args = (kind, _port_tpl(_leaves(kind)), torch.as_tensor(x), torch.as_tensor(mask), torch.as_tensor(exposure))
    return args, center - step, center + step, cfg


def _chain(kind, tpl, x, mask, exposure, lo, hi, cfg):
    """The chain a card fit ran before the refine was one launch, over the
    twin: golden_section over one-phase profiles, the profile at the optimum."""
    def at(phi):
        return general_sweep.general_profile_reference(kind, tpl, x, mask, exposure, phi[:, None].contiguous(), cfg)

    phi, ll = optimize.golden_section(lambda p: at(p)[0][:, 0], lo, hi, iters=cfg.refine_iters)
    return phi, ll, at(phi)[1][:, 0]


def _same_bits(got, want):
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert torch.equal(torch.isnan(a), torch.isnan(b))
        assert torch.equal(torch.nan_to_num(a, nan=0.0), torch.nan_to_num(b, nan=0.0))


class TestChain:
    @pytest.mark.parametrize("kind", KINDS)
    def test_cpu_golden_is_the_chain(self, kind):
        args, lo, hi, cfg = _inputs(kind)
        got = general_sweep.general_golden(*args, lo, hi, cfg)
        _same_bits(got, _chain(*args, lo, hi, cfg))
        assert got[2].shape == (3, 3 * args[1].n_comp + 2)
        assert torch.all((got[0] >= lo) & (got[0] <= hi))

    def test_nan_row_is_the_chain(self):
        args, lo, hi, cfg = _inputs(profiles.FOURIER, nan_row=True)
        got = general_sweep.general_golden(*args, lo, hi, cfg)
        _same_bits(got, _chain(*args, lo, hi, cfg))
        assert torch.isnan(got[1][1]) and not torch.isnan(got[1][0])

    def test_sweep_argument_chains_the_given_profile(self):
        args, lo, hi, cfg = _inputs(profiles.VONMISES)
        calls = []

        def sweep(*a, **k):
            calls.append(tuple(a[5].shape))
            return general_sweep.general_profile(*a, **k)

        got = general_sweep.general_golden_reference(*args, lo, hi, cfg, sweep=sweep)
        _same_bits(got, general_sweep.general_golden_reference(*args, lo, hi, cfg))
        assert calls == [(3, 1)] * (2 + 2 * cfg.refine_iters + 1)


def _jax_golden(kind, leaves, x, mask, exposure, lo, hi, cfg_kw):
    """JAX's refine and refit at the optimum (crimp_tpu/ops/toafit.py:640-660)
    for each row, vmapped."""
    jcfg = jax_toafit.ToAFitConfig(kind=kind, **cfg_kw)
    jtpl = _jax_tpl(leaves)

    def row(xr, mr, er, lo_r, hi_r):
        def ll_of(phi):
            return jax_toafit.profile_loglik(kind, jtpl, xr, mr, er, phi[None], jcfg)[0][0]

        phi, ll = jax_optimize.golden_section(ll_of, lo_r, hi_r, iters=jcfg.refine_iters)
        _, vecs = jax_toafit._general_profile_vecs(kind, jtpl, xr, mr, er, phi[None], jcfg)
        return phi, ll, vecs[0]

    out = jax.jit(jax.vmap(row))(jnp.asarray(x), jnp.asarray(mask), jnp.asarray(exposure), jnp.asarray(lo),
                                 jnp.asarray(hi))
    return [np.asarray(o) for o in out]


class TestAgainstJax:
    @pytest.mark.parametrize("kind", KINDS)
    def test_golden_refine_matches_jax(self, kind):
        args, lo, hi, cfg = _inputs(kind)
        kw = {k: getattr(cfg, k) for k in ("refine_iters", "nm_iters", "free_idx", "free_lo", "free_hi", "n_free")}
        phi, ll, vec = general_sweep.general_golden(*args, lo, hi, cfg)
        want = _jax_golden(kind, _leaves(kind), *(t.numpy() for t in args[2:]), lo.numpy(), hi.numpy(), kw)
        np.testing.assert_allclose(phi.numpy(), want[0], rtol=0, atol=1e-9)
        np.testing.assert_allclose(ll.numpy(), want[1], rtol=1e-12)
        np.testing.assert_allclose(vec.numpy(), want[2], rtol=1e-8, atol=1e-10)

    def test_cauchy_readvaryparam_fit_matches_jax(self):
        kind = profiles.CAUCHY
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


def _c_params(src: str, name: str) -> list:
    m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", src)
    return [" ".join(p.split()) for p in m.group(1).split(",")]


class TestCInterface:
    def test_signature_is_what_the_wrapper_binds(self):
        params = _c_params(SRC.read_text(), "toafit_general_golden")
        assert len(params) == len(general_sweep.GOLDEN_ARGTYPES) == 24
        for p, t in zip(params, general_sweep.GOLDEN_ARGTYPES):
            want = (general_sweep.ctypes.c_void_p if "*" in p else general_sweep.ctypes.c_longlong
                    if p.startswith("long long") else general_sweep.ctypes.c_int)
            assert t is want, p
        names = [p.split()[-1].lstrip("*") for p in params]
        assert names[:10] == ["x", "mask", "exposure", "lo_phi", "hi_phi", "base", "free_idx", "lo", "span", "u0"]
        assert names[10:18] == ["n_rows", "n_events", "n_comp", "kind", "n_free", "iters", "refine_iters", "n_stage"]
        assert names[18:] == ["phi_best", "ll_max", "vec", "shrinks", "reads", "stream"]

    def test_phi_is_optimize_phi(self):
        hexes = dict(re.findall(r"constexpr double (\w+) = (0x[0-9a-fp.+-]+);", SRC.read_text()))
        assert float.fromhex(hexes["PHI"]) == optimize.PHI == (5.0**0.5 - 1) / 2


class TestRouting:
    def test_cpu_tensors_take_the_chain(self, monkeypatch):
        def refuse(*a, **k):
            raise AssertionError("a CPU tensor launched K6")

        monkeypatch.setattr(general_sweep, "_launch_golden", refuse)
        monkeypatch.setattr(general_sweep, "_launch_nm", refuse)
        args, lo, hi, cfg = _inputs(profiles.FOURIER)
        general_sweep.reset_launches()
        general_sweep.general_golden(*args, lo, hi, cfg._replace(refine_iters=1, nm_iters=3))
        assert general_sweep.LAUNCHES["general_golden"] == 0

    def test_no_library_raises_kernel_error(self, monkeypatch):
        from crimp_tpu_torch.ops import z2_grid

        def refuse(*a, **k):
            raise AssertionError("the chain ran for a card tensor")

        def no_nvcc(*a, **k):
            raise KernelError("nvcc not found: the Z^2 kernels need the CUDA toolkit")

        args, lo, hi, cfg = _inputs(profiles.FOURIER)
        monkeypatch.setattr(toafit, "_on_card", lambda t: True)
        monkeypatch.setattr(general_sweep, "general_golden_reference", refuse)
        monkeypatch.setattr(general_sweep, "general_profile_reference", refuse)
        monkeypatch.setattr(general_sweep, "_LIB", None)
        monkeypatch.setattr(z2_grid, "build", no_nvcc)
        general_sweep.reset_launches()
        with pytest.raises(KernelError, match="nvcc"):
            general_sweep.general_golden(*args, lo, hi, cfg)
        assert general_sweep.LAUNCHES["general_golden"] == 0

    @pytest.mark.parametrize("bad", ["kind", "lo_dtype", "hi_shape", "refine_iters", "nm_iters", "free", "per_row"])
    def test_operands_k6_cannot_take_raise(self, bad):
        (kind, tpl, x, mask, exposure), lo, hi, cfg = _inputs(profiles.FOURIER)
        if bad == "kind":
            kind = "gaussian"
        elif bad == "lo_dtype":
            lo = lo.float()
        elif bad == "hi_shape":
            hi = hi[:2]
        elif bad == "refine_iters":
            cfg = cfg._replace(refine_iters=-1)
        elif bad == "nm_iters":
            cfg = cfg._replace(nm_iters=-1)
        elif bad == "free":
            cfg = cfg._replace(free_idx=(0, 0), free_lo=(1.0, 1.0), free_hi=(2.0, 2.0))
        else:
            tpl = toafit.template_rows(profiles.ProfileParams(
                **{f: getattr(tpl, f).expand(3, *getattr(tpl, f).shape) for f in
                   ("norm", "amp", "loc", "wid", "ph_shift", "amp_shift")}), slice(None))
        with pytest.raises(KernelError):
            general_sweep._launch_golden(kind, tpl, x, mask, exposure, lo, hi, cfg)


class TestCostRow:
    @pytest.mark.parametrize("kind", KINDS)
    def test_k6_counts_over_its_problems_pairs_once(self, kind):
        S, n_ev, K, F, iters = 84, 10000.0, 6, 13, 25
        rng = np.random.RandomState(3)
        problems = 2 + 2 * iters
        reads = rng.randint(150, 450, problems).astype(float)
        shrinks = rng.randint(0, 5, problems).astype(float)
        got = costmodel.k6_golden_counts(S, n_ev, K, kind, F, iters, float(reads.sum()), float(shrinks.sum()))
        each = [costmodel.k6_counts(S, 1, n_ev, K, kind, F, r, s) for r, s in zip(reads, shrinks)]
        # the phase-free j 2 pi x term is charged once a (row, event,
        # component), not once a problem as each lone k6_counts charges it
        pairs = S * n_ev * K * costmodel.K6_FOURIER_EVENT_OPS if kind == profiles.FOURIER else 0.0
        assert got["flops"] == pytest.approx(sum(c["flops"] for c in each) - (problems - 1) * pairs, rel=1e-14)
        assert got["flops"] == pytest.approx(
            sum(c["evaluations"] for c in each) * n_ev * costmodel.k6_ops_per_event(K, kind) + pairs, rel=1e-14)
        assert got["evaluations"] == sum(c["evaluations"] for c in each)
        D = 3 * K + 2
        assert got["bytes_accessed"] == (S * n_ev * 9 + S * 8 + 2 * S * 8 + S * F * 8 + 8 * D
                                         + S * (8 + 8 + 8 * D + 4 + 4))
        assert got["flops_dtype"] == "f64"

    def test_golden_row_is_held_to_the_f64_peak(self):
        from crimp_tpu_torch.obs import roofline

        counts = costmodel.k6_golden_counts(84, 10000, 6, profiles.FOURIER, 13, 25, 84 * 52 * 200, 100)
        doc = {"run_id": "k6g", "name": "run",
               "platform": {"backend": "cuda", "devices": [{"id": 0, "kind": "NVIDIA H100 80GB HBM3"}]},
               "spans": [{"name": "toa_general_refine", "kind": "kernel", "t0_s": 0.0, "dur_s": 0.19,
                          "parent": None, "thread": 0, "attrs": {}}],
               "costmodel": {"toa_general_refine": {**counts, "span": "toa_general_refine"}}}
        row = roofline.analyze(copy.deepcopy(doc))["rows"][0]
        assert row["flops_dtype"] == "f64" and row["bound"] == "compute"
        assert row["pct_of_roof"] == pytest.approx(100 * counts["flops"] / 0.19 / 34e12, rel=1e-3)

    def test_refine_site(self):
        assert toafit.general_site("toa_sweep_refine") == "toa_general_refine"
