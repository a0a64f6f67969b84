"""The staging plan of K6's golden-section refine (``csrc/toafit_general.cu``
``golden_kernel``: each Fourier row's first harmonic pair staged once in
shared memory), host code tested on the CPU:

- ``general_sweep.golden_stage_events`` fits the room beside the two
  simplices, is a multiple of ``STAGE_STEP`` or covers the row, is 0 where
  only the simplices fit, never falls as the room grows, and raises where
  not even the simplices fit;
- its byte counts are the source's (``dyn_bytes``, ``stage_offset``,
  ``golden_bytes``, ``STAGE_STEP``, read from the ``.cu``);
- ``_launch_golden`` hands the C entry the planned ``n_stage`` for a
  Fourier template and 0 for the others, an explicit stage as given, and
  raises ``KernelError`` where the entry refuses the stage or where the
  simplices do not fit, launching nothing.
"""

import ctypes
import pathlib
import re

import pytest
import torch

from crimp_tpu_torch.models import profiles
from crimp_tpu_torch.ops import general_sweep, toafit
from crimp_tpu_torch.resilience import KernelError
from tests.test_torch_general_golden import _inputs

torch.set_num_threads(2)

SRC = pathlib.Path(__file__).resolve().parent.parent / "crimp_tpu_torch" / "csrc" / "toafit_general.cu"
STEP = general_sweep.STAGE_STEP
H100_ROOM = 232448 - 6500  # the card's opt-in shared memory a block less about the kernel's static state


def _simplices(n_free: int) -> int:
    return -(-general_sweep.simplex_bytes(2, n_free) // 16) * 16


class TestPlan:
    @pytest.mark.parametrize("n_free", [1, 3, 13, 50])
    @pytest.mark.parametrize("n_events", [1, 2047, 2048, 10000, 16000, 100000])
    def test_fits_the_room_and_is_whole_steps_or_the_row(self, n_free, n_events):
        for room in range(_simplices(n_free), H100_ROOM + 1, 9973):
            n = general_sweep.golden_stage_events(n_free, n_events, room)
            assert 0 <= n <= n_events
            assert _simplices(n_free) + n * general_sweep.STAGE_EVENT_BYTES <= room
            assert n == n_events or n % STEP == 0
            if n < n_events:  # the largest such count: one more step would not fit or passes the row
                more = min(n + STEP, n_events)
                assert _simplices(n_free) + more * general_sweep.STAGE_EVENT_BYTES > room or more == n_events

    @pytest.mark.parametrize("n_free", [1, 13, 50])
    def test_only_the_simplices_fit(self, n_free):
        base = _simplices(n_free)
        assert general_sweep.golden_stage_events(n_free, 10000, base) == 0
        assert general_sweep.golden_stage_events(n_free, 10000, base + STEP * 17 - 1) == 0
        assert general_sweep.golden_stage_events(n_free, 10000, base + STEP * 17) == STEP

    @pytest.mark.parametrize("n_events", [5000, 10000, 16000, 40000])
    def test_never_falls_as_the_room_grows(self, n_events):
        last = 0
        for room in range(_simplices(13), H100_ROOM + 1, 211):
            n = general_sweep.golden_stage_events(13, n_events, room)
            assert n >= last
            last = n

    def test_north_star_rows(self):
        # 10 000 events a row stage whole; 16 000 stage 6 steps and compute the tail
        assert general_sweep.golden_stage_events(13, 10000, H100_ROOM) == 10000
        assert general_sweep.golden_stage_events(13, 16000, H100_ROOM) == 6 * STEP

    @pytest.mark.parametrize("n_free", [1, 13, 50])
    def test_raises_where_the_simplices_do_not_fit(self, n_free):
        with pytest.raises(KernelError, match="simplices"):
            general_sweep.golden_stage_events(n_free, 10000, _simplices(n_free) - 1)


class TestSourceCounts:
    def test_simplex_bytes_is_dyn_bytes(self):
        src = SRC.read_text()
        doubles = re.search(r"constexpr long long problem_doubles\(int F\) \{ return (.*?); \}", src).group(1)
        dyn = re.search(r"constexpr long long dyn_bytes\(int G, int F\) \{\s*return (.*?);\s*\}", src).group(1)
        for G in (1, 2, 4):
            for F in range(1, 51):
                per = eval(doubles.replace("LL", ""), {"F": F})
                got = eval(dyn.replace("LL", "").replace("problem_doubles(F)", str(per)), {"G": G, "F": F})
                assert got == general_sweep.simplex_bytes(G, F)

    def test_stage_bytes_and_step_are_the_sources(self):
        src = SRC.read_text()
        assert re.search(r"constexpr long long STAGE_STEP = 4 \* THREADS;", src)
        assert STEP == 4 * general_sweep.THREADS == 2048
        assert "return (dyn_bytes(2, F) + 15) / 16 * 16;" in src  # the stage after the simplices, 16-byte aligned
        assert "return stage_offset(F) + n_stage * static_cast<long long>(sizeof(double2) + 1);" in src
        assert general_sweep.STAGE_EVENT_BYTES == 16 + 1
        # every U of the staged loop divides the step's 4 events a thread
        u = re.search(r"static constexpr int U1 = (\d+), U2 = (\d+), U4 = (\d+);", src).groups()
        assert all(4 % int(v) == 0 for v in u)

    def test_room_entry_counts_golden_shared(self):
        src = SRC.read_text()
        assert 'extern "C" long long toafit_general_golden_room() { return smem_room(sizeof(GoldenShared)); }' in src
        assert "if (bytes > toafit_general_golden_room()) return static_cast<int>(cudaErrorInvalidValue);" in src


class _Lib:
    """Stands in for K6's library: records the n_stage of each golden call and
    returns ``rc``."""

    def __init__(self, room: int, rc: int = 0):
        self.room, self.rc, self.stages = room, rc, []

    def toafit_general_golden_room(self):
        return self.room

    def toafit_general_golden(self, *args):
        assert len(args) == len(general_sweep.GOLDEN_ARGTYPES)
        for a, t in zip(args, general_sweep.GOLDEN_ARGTYPES):
            assert t is ctypes.c_void_p or isinstance(a, int)
        self.stages.append(args[17])
        return self.rc


@pytest.fixture
def on_card(monkeypatch):
    """The wrapper's launch path on CPU tensors: the stream a placeholder, no
    card to make current."""
    import contextlib

    from crimp_tpu_torch.ops import z2_grid
    from crimp_tpu_torch.utils import profiling

    monkeypatch.setattr(z2_grid, "stream_of", lambda t: 0)
    monkeypatch.setattr(profiling, "launch_window", lambda device=None: contextlib.nullcontext())


class TestWrapperPlan:
    @pytest.mark.parametrize("kind", [profiles.FOURIER, profiles.VONMISES, profiles.CAUCHY])
    def test_planned_stage_is_handed_to_the_entry(self, on_card, kind):
        args, lo, hi, cfg = _inputs(kind)
        lib = _Lib(H100_ROOM)
        general_sweep.reset_launches()
        general_sweep._launch_golden(*args, lo, hi, cfg, lib=lib)
        want = general_sweep.golden_stage_events(len(cfg.free_idx), args[2].shape[1], H100_ROOM)
        assert lib.stages == [want if kind == profiles.FOURIER else 0]
        assert general_sweep.LAUNCHES["general_golden"] == 1

    def test_small_room_stages_whole_steps(self, on_card):
        args, lo, hi, cfg = _inputs(profiles.FOURIER)
        room = _simplices(len(cfg.free_idx)) + 1000 * general_sweep.STAGE_EVENT_BYTES
        lib = _Lib(room)
        general_sweep._launch_golden(*args, lo, hi, cfg, lib=lib)
        assert lib.stages == [0]  # 2000 events a row: not one whole step fits
        lib.room = _simplices(len(cfg.free_idx)) + 2000 * general_sweep.STAGE_EVENT_BYTES
        general_sweep._launch_golden(*args, lo, hi, cfg, lib=lib)
        assert lib.stages == [0, 2000]  # the whole row

    def test_pinned_stage_is_passed_as_given(self, on_card):
        args, lo, hi, cfg = _inputs(profiles.FOURIER)
        lib = _Lib(H100_ROOM)
        general_sweep._launch_golden(*args, lo, hi, cfg, lib=lib, stage=0)
        assert lib.stages == [0]

    def test_refused_stage_raises_kernel_error(self, on_card):
        args, lo, hi, cfg = _inputs(profiles.FOURIER)
        lib = _Lib(H100_ROOM, rc=1)  # cudaErrorInvalidValue, the entry's answer to a stage that does not fit
        general_sweep.reset_launches()
        with pytest.raises(KernelError, match="toafit_general_golden"):
            general_sweep._launch_golden(*args, lo, hi, cfg, lib=lib, stage=args[2].shape[1] + 1)
        assert general_sweep.LAUNCHES["general_golden"] == 0

    def test_no_room_for_the_simplices_raises_before_launching(self, on_card):
        args, lo, hi, cfg = _inputs(profiles.VONMISES)
        lib = _Lib(_simplices(len(cfg.free_idx)) - 16)
        general_sweep.reset_launches()
        with pytest.raises(KernelError, match="simplices"):
            general_sweep._launch_golden(*args, lo, hi, cfg, lib=lib)
        assert lib.stages == [] and general_sweep.LAUNCHES["general_golden"] == 0

    def test_cpu_route_ignores_the_plan(self, monkeypatch):
        def refuse(*a, **k):
            raise AssertionError("a CPU tensor planned a stage")

        monkeypatch.setattr(general_sweep, "golden_stage_events", refuse)
        args, lo, hi, cfg = _inputs(profiles.FOURIER)
        assert not toafit._on_card(args[2])
        got = general_sweep.general_golden(*args, lo, hi, cfg._replace(refine_iters=1, nm_iters=3))
        assert got[0].shape == (3,)
