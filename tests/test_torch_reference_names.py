"""The public reference names of crimp_tpu that the port carries too.

Each name is the port's own function (an alias or a thin delegate, never
crimp_tpu's object), and where it computes something it matches
crimp_tpu's on the CPU: ``crimp_tpu_torch.warmup``,
``measure_toas.measureToAs``/``TOA_COLUMNS``, ``tim_tools.phshiftTotimfile``,
``io.template.readPPtemplate``, ``binprofile.binphases``,
``search.harmonic_sums_uniform{,_2d,_3d}``, ``search.resolve_blocks`` with
``DEFAULT_EVENT_BLOCK``/``DEFAULT_TRIAL_BLOCK``, ``deltafold.resolve``.
"""

import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from crimp_tpu.io import template as jax_template
from crimp_tpu.ops import binprofile as jax_binprofile
from crimp_tpu.ops import deltafold as jax_deltafold
from crimp_tpu.ops import search as jax_search
from crimp_tpu.pipelines import measure_toas as jax_measure_toas
from crimp_tpu.pipelines import tim_tools as jax_tim_tools
import crimp_tpu_torch
from crimp_tpu_torch import aot
from crimp_tpu_torch.io import template
from crimp_tpu_torch.ops import autotune, binprofile, deltafold, search, z2_grid
from crimp_tpu_torch.pipelines import measure_toas, tim_tools

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parents[1]
DATA = REPO / "tests" / "data"
PAR, TEMPLATE, TOAS = str(DATA / "1e2259.par"), str(DATA / "1e2259_template.txt"), str(DATA / "ToAs_2259.txt")
SUM_TOL = dict(rtol=0, atol=0.05)  # f32 sums of a few thousand unit terms


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for name in ("DELTA_FOLD", "DELTA_FOLD_BUDGET", "GRID_BLOCKS", "POLY_TRIG"):
        monkeypatch.delenv(f"CRIMP_TORCH_{name}", raising=False)
        monkeypatch.delenv(f"CRIMP_TPU_{name}", raising=False)
    monkeypatch.setenv("CRIMP_TPU_AUTOTUNE", "0")
    monkeypatch.setenv("CRIMP_TORCH_AUTOTUNE", "0")


@pytest.fixture(scope="module")
def events():
    return np.sort(np.random.RandomState(23).uniform(-4000.0, 4000.0, 3000))


@pytest.mark.parametrize("alias,func", [
    (measure_toas.measureToAs, measure_toas.measure_toas),
    (tim_tools.phshiftTotimfile, tim_tools.phshift_to_timfile),
    (template.readPPtemplate, template.read_template),
    (binprofile.binphases, binprofile.bin_phases),
], ids=["measureToAs", "phshiftTotimfile", "readPPtemplate", "binphases"])
def test_aliases_are_the_ports_functions(alias, func):
    assert alias is func
    assert alias.__module__.startswith("crimp_tpu_torch.")


def test_toa_columns_are_the_ports_copy_of_jaxs():
    assert measure_toas.TOA_COLUMNS == jax_measure_toas.TOA_COLUMNS
    assert measure_toas.TOA_COLUMNS is not jax_measure_toas.TOA_COLUMNS


def test_read_pp_template_matches_jax():
    assert template.readPPtemplate(TEMPLATE) == jax_template.readPPtemplate(TEMPLATE)


def test_binphases_matches_jax():
    phases = np.random.RandomState(3).uniform(0.0, 1.0, 5000)
    got, want = binprofile.binphases(phases, 20), jax_binprofile.binphases(phases, 20)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(np.asarray(got[key]), np.asarray(want[key]), rtol=1e-12, atol=0)


def test_phshift_totimfile_matches_jax(tmp_path):
    from crimp_tpu.io import tim as jax_tim
    from crimp_tpu_torch.io import tim

    tim_tools.phshiftTotimfile(TOAS, PAR, str(tmp_path / "port"))
    jax_tim_tools.phshiftTotimfile(TOAS, PAR, str(tmp_path / "jax"))
    got, want = tim.read_tim(str(tmp_path / "port.tim")), jax_tim.read_tim(str(tmp_path / "jax.tim"))
    assert len(got["pulse_ToA"]) == len(want["pulse_ToA"]) == 84
    for col in ("pulse_ToA", "pulse_ToA_err"):
        np.testing.assert_allclose(np.asarray(got[col], dtype=float), np.asarray(want[col], dtype=float),
                                   rtol=1e-13, atol=0)


class TestHarmonicSumsUniform:
    def test_1d_matches_jax_and_the_port_grid(self, events):
        c, s = search.harmonic_sums_uniform(events, 0.25, 1e-5, 300, 3, device="cpu")
        jc, js = jax_search.harmonic_sums_uniform(events, 0.25, 1e-5, 300, 3)
        assert c.shape == (3, 300)
        np.testing.assert_allclose(c.numpy(), np.asarray(jc), **SUM_TOL)
        np.testing.assert_allclose(s.numpy(), np.asarray(js), **SUM_TOL)
        gc, gs, _ = search.harmonic_sums_2d_grid(events, 0.25, 1e-5, 300, [0.0], 3, device="cpu", mxu=False)
        assert torch.equal(c, gc[0]) and torch.equal(s, gs[0])

    def test_2d_matches_jax(self, events):
        fdots = np.array([-1e-9, 0.0])
        c, s = search.harmonic_sums_uniform_2d(events, 0.25, 1e-5, 300, fdots, 2, device="cpu")
        jc, js = jax_search.harmonic_sums_uniform_2d(events, 0.25, 1e-5, 300, fdots, 2)
        assert c.shape == (2, 2, 300)
        np.testing.assert_allclose(c.numpy(), np.asarray(jc), **SUM_TOL)
        np.testing.assert_allclose(s.numpy(), np.asarray(js), **SUM_TOL)

    def test_3d_matches_jax(self, events):
        fdots, fddots = np.array([-1e-9, 0.0]), np.array([0.0, 1e-13])
        c, s = search.harmonic_sums_uniform_3d(events, 0.25, 1e-5, 300, fdots, fddots, 2, device="cpu")
        jc, js = jax_search.harmonic_sums_uniform_3d(events, 0.25, 1e-5, 300, fdots, fddots, 2)
        assert c.shape == (2, 2, 2, 300)
        np.testing.assert_allclose(c.numpy(), np.asarray(jc), **SUM_TOL)
        np.testing.assert_allclose(s.numpy(), np.asarray(js), **SUM_TOL)

    def test_event_block_is_the_split_length_and_the_tile_is_fixed(self, events):
        c, _ = search.harmonic_sums_uniform(events, 0.25, 1e-5, 300, 2, event_block=1024, device="cpu")
        gc, _, _ = search.harmonic_sums_2d_grid(events, 0.25, 1e-5, 300, [0.0], 2, device="cpu", mxu=False,
                                                per_split=1024)
        assert torch.equal(c, gc[0])
        with pytest.raises(ValueError, match="trial tile"):
            search.harmonic_sums_uniform(events, 0.25, 1e-5, 300, 2, trial_block=128, device="cpu")


def test_resolve_blocks_and_default_blocks():
    assert (search.DEFAULT_EVENT_BLOCK, search.DEFAULT_TRIAL_BLOCK) == (
        jax_search.DEFAULT_EVENT_BLOCK, jax_search.DEFAULT_TRIAL_BLOCK) == (1 << 16, z2_grid.TRIAL_TILE)
    cpu = torch.device("cpu")
    assert search.resolve_blocks("grid", 10_000, 1000, device=cpu) == autotune.resolve_blocks(
        "grid", 10_000, 1000, device=cpu) == autotune.static_defaults("grid", 10_000, 1000, device=cpu)
    assert search.resolve_blocks("grid", 10_000, 1000, event_block=4096, device=cpu) == (4096, 256)


@pytest.mark.parametrize("env,args", [({}, {}), ({}, {"delta_fold": 1}), ({}, {"budget": 3e-9}),
                                      ({"DELTA_FOLD": "1", "DELTA_FOLD_BUDGET": "2e-9"}, {}),
                                      ({"DELTA_FOLD": "1"}, {"delta_fold": 0})])
def test_deltafold_resolve_matches_jax(monkeypatch, env, args):
    for suffix, value in env.items():
        monkeypatch.setenv(f"CRIMP_TORCH_{suffix}", value)
        monkeypatch.setenv(f"CRIMP_TPU_{suffix}", value)
    got = deltafold.resolve(50_000, device="cpu", **args)
    assert got == jax_deltafold.resolve(50_000, **args)
    assert (got["delta_fold"], got["budget"]) == deltafold.resolve_delta_fold(
        args.get("delta_fold"), args.get("budget"), 50_000, device="cpu")


def test_warmup_is_a_lazy_delegate(monkeypatch):
    seen = {}
    monkeypatch.setattr(aot, "warmup", lambda **kw: seen.update(kw) or {"ok": True})
    assert crimp_tpu_torch.warmup(n_events=8, n_trials=4, device="cpu") == {"ok": True}
    assert seen == {"n_events": 8, "n_trials": 4, "device": "cpu"}
    proc = subprocess.run([sys.executable, "-c", "import sys, crimp_tpu_torch; crimp_tpu_torch.warmup; "
                           "print('torch' in sys.modules)"], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "False", proc.stderr


@pytest.mark.parametrize("module", ["crimp_tpu_torch.ops.z2_grid", "crimp_tpu_torch.ops.z2_general",
                                    "crimp_tpu_torch.ops.deltafold"])
def test_a_kernel_module_imported_first_sees_the_block_constants(module):
    """z2_grid and search import each other: the search constants must not
    read z2_grid while it is half imported (the NCCL probe worker,
    ``utils/multihost_worker.py --nccl-probe``, imports z2_grid first)."""
    code = (f"import {module}\n"
            "from crimp_tpu_torch.ops import search, z2_grid\n"
            "assert search.DEFAULT_TRIAL_BLOCK == z2_grid.TRIAL_TILE\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
