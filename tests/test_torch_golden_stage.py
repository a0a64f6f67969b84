"""The staging plan of K6's staging launches (``csrc/toafit_general.cu``
``golden_kernel`` and ``nm_kernel<2, 4>``: each Fourier row's first harmonic
pair staged once a block in shared memory), host code tested on the CPU:

- ``general_sweep.stage_events`` fits the room beside G simplices (G 1, 2
  and 4), is a multiple of ``STAGE_STEP`` or covers the row, is 0 where
  only the simplices fit, never falls as the room grows, and raises where
  not even the simplices fit;
- its byte counts are the source's (``dyn_bytes``, ``stage_offset``,
  ``stage_bytes``, ``nm_bytes``, ``STAGE_STEP``, read from the ``.cu``),
  and the nm entry's signature is what the wrapper binds;
- ``_launch_golden`` and ``_launch_nm`` hand the C entry the planned
  ``n_stage`` for a Fourier template and 0 for the others (and for
  ``nm_kernel<1>``), an explicit stage as given, and raise ``KernelError``
  where the entry refuses the stage or where the simplices do not fit,
  launching nothing;
- inside an obs run the counters ``k6_staged_events`` and
  ``k6_fourier_events`` read the plan's share, Σ min(n_stage, n_row) /
  Σ n_row, of a Fourier launch.
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


def _simplices(n_free: int, group: int = 2) -> int:
    return -(-general_sweep.simplex_bytes(group, n_free) // 16) * 16


GROUPS = pytest.mark.parametrize("group", [1, 2, 4])  # nm_kernel<1> plans no stage, but the plan holds there too


class TestPlan:
    @GROUPS
    @pytest.mark.parametrize("n_free", [1, 3, 13, 50])
    @pytest.mark.parametrize("n_events", [1, 2047, 2048, 10000, 16000, 100000])
    def test_fits_the_room_and_is_whole_steps_or_the_row(self, n_free, n_events, group):
        base = _simplices(n_free, group)
        for room in range(base, H100_ROOM + 1, 9973):
            n = general_sweep.stage_events(group, n_free, n_events, room)
            assert 0 <= n <= n_events
            assert base + n * general_sweep.STAGE_EVENT_BYTES <= room
            assert n == n_events or n % STEP == 0
            if n < n_events:  # the largest such count: one more step would not fit or passes the row
                more = min(n + STEP, n_events)
                assert base + more * general_sweep.STAGE_EVENT_BYTES > room or more == n_events

    @GROUPS
    @pytest.mark.parametrize("n_free", [1, 13, 50])
    def test_only_the_simplices_fit(self, n_free, group):
        base = _simplices(n_free, group)
        assert general_sweep.stage_events(group, n_free, 10000, base) == 0
        assert general_sweep.stage_events(group, n_free, 10000, base + STEP * 17 - 1) == 0
        assert general_sweep.stage_events(group, n_free, 10000, base + STEP * 17) == STEP

    @GROUPS
    @pytest.mark.parametrize("n_events", [5000, 10000, 16000, 40000])
    def test_never_falls_as_the_room_grows(self, n_events, group):
        last = 0
        for room in range(_simplices(13, group), H100_ROOM + 1, 211):
            n = general_sweep.stage_events(group, 13, n_events, room)
            assert n >= last
            last = n

    @GROUPS
    def test_north_star_rows(self, group):
        # 10 000 events a row stage whole; 16 000 and the campaign's longest
        # row, 14 897, stage 6 steps and compute the tail
        assert general_sweep.stage_events(group, 13, 10000, H100_ROOM) == 10000
        assert general_sweep.stage_events(group, 13, 16000, H100_ROOM) == 6 * STEP
        assert general_sweep.stage_events(group, 13, 14897, H100_ROOM) == 6 * STEP

    @GROUPS
    @pytest.mark.parametrize("n_free", [1, 13, 50])
    def test_raises_where_the_simplices_do_not_fit(self, n_free, group):
        with pytest.raises(KernelError, match="simplices"):
            general_sweep.stage_events(group, n_free, 10000, _simplices(n_free, group) - 1)

    def test_more_simplices_leave_less_room(self):
        # at F 50 the four simplices take 87 kB: the stage beside them is the smaller
        got = [general_sweep.stage_events(g, 50, 100000, H100_ROOM) for g in (1, 2, 4)]
        assert got[0] >= got[1] > got[2] > 0


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

    def test_nm_stage_offset_is_the_plans_base(self):
        # nm_kernel's stage begins where stage_events puts it: G simplices rounded up to 16 bytes
        src = SRC.read_text()
        doubles = re.search(r"constexpr long long problem_doubles\(int F\) \{ return (.*?); \}", src).group(1)
        off = re.search(r"constexpr long long nm_stage_offset\(int F\) \{\s*return (.*?);\s*\}", src).group(1)
        for G in (2, 4):
            for F in range(1, 51):
                per = eval(doubles.replace("LL", ""), {"F": F})
                got = eval(off.replace("LL", "").replace("problem_doubles(F)", str(per)).replace("/", "//"),
                           {"G": G, "F": F})
                assert got == _simplices(F, G)
                assert general_sweep.nm_bytes(G, F, 100) == got + 100 * general_sweep.STAGE_EVENT_BYTES
                assert general_sweep.nm_bytes(1, F, 0) == general_sweep.simplex_bytes(1, F)  # G 1: no padding

    def test_stage_bytes_and_step_are_the_sources(self):
        src = SRC.read_text()
        assert re.search(r"constexpr long long STAGE_STEP = 4 \* THREADS;", src)
        assert STEP == 4 * general_sweep.THREADS == 2048
        assert "return (dyn_bytes(2, F) + 15) / 16 * 16;" in src  # the stage after the simplices, 16-byte aligned
        assert "return stage_offset(F) + n_stage * static_cast<long long>(sizeof(double2) + 1);" in src
        # nm_kernel<2, 4>: dyn_bytes(G, F) written out, rounded the same way
        assert "return (G * (problem_doubles(F) * 8 + (F + 1LL) * 4) + 15) / 16 * 16;" in src
        # nm_kernel<1> takes its simplices alone, <2, 4> the stage after them
        assert ("return G == 1 ? dyn_bytes(1, F) : nm_stage_offset<G>(F) + n_stage * static_cast<long long>(sizeof("
                "double2) + 1);") in src
        assert "if ((G == 1 && n_stage != 0) || bytes > smem_room() || blocks > 2147483647LL)" in src
        assert general_sweep.STAGE_EVENT_BYTES == 16 + 1
        # every U of the staged loop divides the step's 4 events a thread
        u = re.search(r"static constexpr int U1 = (\d+), U2 = (\d+), U4 = (\d+);", src).groups()
        assert all(4 % int(v) == 0 for v in u)

    def test_nm_signature_is_what_the_wrapper_binds(self):
        m = re.search(r'extern "C" int toafit_general_nm\(([^)]*)\)', SRC.read_text())
        params = [" ".join(p.split()) for p in m.group(1).split(",")]
        assert len(params) == len(general_sweep.NM_ARGTYPES) == 24
        for p, t in zip(params, general_sweep.NM_ARGTYPES):
            want = ctypes.c_void_p if "*" in p else ctypes.c_longlong if p.startswith("long long") else ctypes.c_int
            assert t is want, p
        names = [p.split()[-1].lstrip("*") for p in params]
        assert names[16:18] == ["group", "n_stage"] and general_sweep.STAGE_ARG == 17
        assert names[18:] == ["ll", "vec", "shrinks", "reads", "trace", "stream"]

    def test_room_entry_counts_golden_shared(self):
        src = SRC.read_text()
        assert 'extern "C" long long toafit_general_golden_room() { return smem_room(sizeof(GoldenShared)); }' in src
        assert "if (bytes > toafit_general_golden_room()) return static_cast<int>(cudaErrorInvalidValue);" in src


class _Lib:
    """Stands in for K6's library: records the n_stage of each golden and nm
    call (and the nm calls' group) and returns ``rc``; ``room`` is both
    launches' room."""

    def __init__(self, room: int, rc: int = 0):
        self.room, self.rc, self.stages, self.groups = room, rc, [], []

    def toafit_general_golden_room(self):
        return self.room

    def toafit_general_nm_room(self):
        return self.room

    @staticmethod
    def toafit_general_max_group(n_free):
        return 4

    def _call(self, argtypes, args):
        assert len(args) == len(argtypes)
        for a, t in zip(args, argtypes):
            assert t is ctypes.c_void_p or isinstance(a, int)
        self.stages.append(args[general_sweep.STAGE_ARG])
        return self.rc

    def toafit_general_golden(self, *args):
        return self._call(general_sweep.GOLDEN_ARGTYPES, args)

    def toafit_general_nm(self, *args):
        self.groups.append(args[16])
        return self._call(general_sweep.NM_ARGTYPES, args)


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
        want = general_sweep.stage_events(2, len(cfg.free_idx), args[2].shape[1], H100_ROOM)
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

        monkeypatch.setattr(general_sweep, "stage_events", refuse)
        args, lo, hi, cfg = _inputs(profiles.FOURIER)
        assert not toafit._on_card(args[2])
        got = general_sweep.general_golden(*args, lo, hi, cfg._replace(refine_iters=1, nm_iters=3))
        assert got[0].shape == (3,)


def _phis(n_rows: int, n_phis: int) -> torch.Tensor:
    return torch.linspace(-3.0, 3.0, n_phis, dtype=torch.float64).expand(n_rows, n_phis).contiguous()


class TestNmWrapperPlan:
    @pytest.mark.parametrize("kind", [profiles.FOURIER, profiles.VONMISES, profiles.CAUCHY])
    def test_planned_stage_is_handed_to_the_entry(self, on_card, kind):
        args, _, _, cfg = _inputs(kind)
        lib = _Lib(H100_ROOM)
        general_sweep.reset_launches()
        general_sweep._launch_nm(*args, _phis(3, 8), cfg, lib=lib)
        want = general_sweep.stage_events(4, len(cfg.free_idx), args[2].shape[1], H100_ROOM)
        assert lib.groups == [4] and lib.stages == [want if kind == profiles.FOURIER else 0]
        assert want == args[2].shape[1]  # 2000 events a row stage whole
        assert general_sweep.LAUNCHES["general_sweep"] == 1

    def test_one_phase_a_block_stages_nothing(self, on_card):
        args, _, _, cfg = _inputs(profiles.FOURIER)
        lib = _Lib(H100_ROOM)
        general_sweep._launch_nm(*args, _phis(3, 1), cfg, lib=lib)  # the fallback loop's one phase: G 1
        general_sweep._launch_nm(*args, _phis(3, 8), cfg, lib=lib, group=1)
        general_sweep._launch_nm(*args, _phis(3, 8), cfg, lib=lib, group=2)
        assert lib.groups == [1, 1, 2] and lib.stages == [0, 0, args[2].shape[1]]

    def test_small_room_stages_whole_steps(self, on_card):
        args, _, _, cfg = _inputs(profiles.FOURIER)
        F = len(cfg.free_idx)
        lib = _Lib(_simplices(F, 4) + 1000 * general_sweep.STAGE_EVENT_BYTES)
        general_sweep._launch_nm(*args, _phis(3, 8), cfg, lib=lib)
        lib.room = _simplices(F, 4) + 2000 * general_sweep.STAGE_EVENT_BYTES
        general_sweep._launch_nm(*args, _phis(3, 8), cfg, lib=lib)
        assert lib.stages == [0, 2000]  # not one whole step, then the whole row

    def test_pinned_stage_is_passed_as_given(self, on_card):
        args, _, _, cfg = _inputs(profiles.VONMISES)
        lib = _Lib(H100_ROOM)
        for stage in (0, STEP, 2000):
            general_sweep._launch_nm(*args, _phis(3, 8), cfg, lib=lib, stage=stage)
        assert lib.stages == [0, STEP, 2000]

    def test_refused_stage_raises_kernel_error(self, on_card):
        args, _, _, cfg = _inputs(profiles.FOURIER)
        lib = _Lib(H100_ROOM, rc=1)  # cudaErrorInvalidValue, the entry's answer to a stage it cannot take
        general_sweep.reset_launches()
        with pytest.raises(KernelError, match="toafit_general_nm"):
            general_sweep._launch_nm(*args, _phis(3, 8), cfg, lib=lib, stage=STEP + 1)
        assert general_sweep.LAUNCHES["general_sweep"] == 0

    def test_no_room_for_the_simplices_raises_before_launching(self, on_card):
        args, _, _, cfg = _inputs(profiles.FOURIER)
        lib = _Lib(_simplices(len(cfg.free_idx), 4) - 16)
        general_sweep.reset_launches()
        with pytest.raises(KernelError, match="simplices"):
            general_sweep._launch_nm(*args, _phis(3, 8), cfg, lib=lib)
        assert lib.stages == [] and general_sweep.LAUNCHES["general_sweep"] == 0


class TestStagedShareCounters:
    """The counters of a Fourier launch: its masked events and those below
    n_stage, Σ min(n_stage, n_row) over Σ n_row for rows packed from the
    front (as ``toafit.pad_segments`` packs them)."""

    ROWS = (6000, 4000, 1500)

    def _rows(self, kind):
        args, lo, hi, cfg = _inputs(kind)
        N = max(self.ROWS)
        x = torch.rand(len(self.ROWS), N, dtype=torch.float64, generator=torch.Generator().manual_seed(3))
        mask = torch.arange(N)[None, :] < torch.tensor(self.ROWS)[:, None]
        exposure = torch.tensor(self.ROWS, dtype=torch.float64) / 10.0
        return (kind, args[1], x, mask, exposure), lo, hi, cfg

    @pytest.fixture
    def run_on(self, monkeypatch, tmp_path):
        monkeypatch.setenv("CRIMP_TORCH_OBS", "1")
        monkeypatch.setenv("CRIMP_TORCH_OBS_DIR", str(tmp_path))
        monkeypatch.setenv("CRIMP_TORCH_OBS_EVENTS", "0")

    def test_counters_read_the_plans_share(self, on_card, run_on):
        from crimp_tpu_torch import obs

        args, lo, hi, cfg = self._rows(profiles.FOURIER)
        F = len(cfg.free_idx)
        lib = _Lib(_simplices(F, 4) + 2 * STEP * general_sweep.STAGE_EVENT_BYTES + 5)
        with obs.run("stage_share") as rec:
            general_sweep._launch_nm(*args, _phis(3, 8), cfg, lib=lib)
            assert lib.stages == [2 * STEP]
            share = rec.counters["k6_staged_events"] / rec.counters["k6_fourier_events"]
            assert share == sum(min(2 * STEP, n) for n in self.ROWS) / sum(self.ROWS)
            assert rec.counters["k6_fourier_events"] == sum(self.ROWS)
            general_sweep._launch_golden(*args, lo, hi, cfg, lib=lib)  # the golden launch adds its own
            golden = lib.stages[-1]
            assert golden == general_sweep.stage_events(2, F, max(self.ROWS), lib.room)
            assert rec.counters["k6_staged_events"] == sum(min(s, n) for s in (2 * STEP, golden) for n in self.ROWS)
            assert rec.counters["k6_fourier_events"] == 2 * sum(self.ROWS)

    @pytest.mark.parametrize("kind", [profiles.VONMISES, profiles.CAUCHY])
    def test_other_families_count_nothing(self, on_card, run_on, kind):
        from crimp_tpu_torch import obs

        args, lo, hi, cfg = self._rows(kind)
        lib = _Lib(H100_ROOM)
        with obs.run("stage_share") as rec:
            general_sweep._launch_nm(*args, _phis(3, 8), cfg, lib=lib, stage=STEP)
            general_sweep._launch_golden(*args, lo, hi, cfg, lib=lib)
            assert "k6_staged_events" not in rec.counters and "k6_fourier_events" not in rec.counters

    def test_no_run_counts_nothing(self, on_card, monkeypatch):
        from crimp_tpu_torch import obs

        monkeypatch.delenv("CRIMP_TORCH_OBS", raising=False)

        def refuse(*a, **k):
            raise AssertionError("a launch outside a run counted its stage")

        monkeypatch.setattr(obs, "counter_add", refuse)
        args, _, _, cfg = self._rows(profiles.FOURIER)
        general_sweep._launch_nm(*args, _phis(3, 8), cfg, lib=_Lib(H100_ROOM))
