"""The port's native event reader (crimp_tpu_torch.io.native) on the CPU.

The library is built from the repository's native/crimpio.cpp with g++
and native/Makefile's flags into build/native/libcrimpio.so (never into
native/). It is a host accelerator, so it is held bit for bit against the
port's pure reader (io/fitsio) and against crimp_tpu.io.native on the
bundled NICER observation: columns, ``filter_energy``, ``phase_histogram``
(with tests/test_io.py's edge case) and ``bin_phases`` above its native
threshold. Without the library every caller takes the pure path with the
same bits, and each fallback is counted (``native_fallbacks``) and logged.
"""

import numpy as np
import pytest
import torch

from crimp_tpu_torch.io import events, fitsio, native
from crimp_tpu_torch.ops import binprofile
from tests.conftest import FITS

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def lib():
    lib = native.load()
    if lib is None:
        pytest.skip(f"no g++ to build native/crimpio.cpp here ({native.BUILD_INFO.get('error')})")
    return lib


@pytest.fixture(scope="module")
def pure_columns():
    hdu = fitsio.read_fits(FITS)["EVENTS"]
    return {c: np.asarray(hdu.column(c), dtype=np.float64) for c in ("TIME", "PI")}


class TestReader:
    def test_builds_from_native_into_build_native(self, lib):
        root = native.ROOT
        assert native.SOURCE == root / "native" / "crimpio.cpp"
        assert native.BUILD_INFO["path"] == str(root / "build" / "native" / "libcrimpio.so")
        assert native.CXX_FLAGS == ["-O3", "-fPIC", "-shared", "-std=c++17", "-Wall"]
        makefile = (root / "native" / "Makefile").read_text()
        assert "CXXFLAGS ?= " + " ".join(native.CXX_FLAGS) in makefile

    def test_concurrent_builds_leave_one_whole_library(self, tmp_path, monkeypatch):
        """Several processes building at once (xdist workers) each compile to
        a name of their own and os.replace it: the library loads after."""
        import subprocess
        import sys

        monkeypatch.setattr(native, "LIB_PATH", tmp_path / "build" / "native" / "libcrimpio.so")
        code = ("import pathlib, sys; from crimp_tpu_torch.io import native; "
                "native.LIB_PATH = pathlib.Path(sys.argv[1]); print(native.build())")
        procs = [subprocess.Popen([sys.executable, "-c", code, str(native.LIB_PATH)], cwd=str(native.ROOT),
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE) for _ in range(3)]
        for proc in procs:
            out, err = proc.communicate(timeout=120)
            assert proc.returncode == 0, err.decode()
        import ctypes

        assert ctypes.CDLL(str(native.LIB_PATH)).cio_open is not None
        assert [p.name for p in native.LIB_PATH.parent.iterdir()] == ["libcrimpio.so"]

    def test_columns_bitwise_the_pure_reader(self, lib, pure_columns):
        cols = native.read_columns(FITS, "EVENTS", ["TIME", "PI"])
        for c in ("TIME", "PI"):
            assert cols[c].dtype == np.float64
            np.testing.assert_array_equal(cols[c], pure_columns[c])

    def test_columns_bitwise_crimp_tpu(self, lib):
        from crimp_tpu.io import native as jax_native

        want = jax_native.read_columns(FITS, "EVENTS", ["TIME", "PI"])
        if want is None:
            pytest.skip("crimp_tpu's native library is unavailable here")
        got = native.read_columns(FITS, "EVENTS", ["TIME", "PI"])
        for c in ("TIME", "PI"):
            np.testing.assert_array_equal(got[c], want[c])

    def test_missing_extension_or_column_is_none(self, lib, tmp_path):
        assert native.read_columns(FITS, "NO_SUCH_EXT", ["TIME"]) is None
        assert native.read_columns(FITS, "EVENTS", ["NO_SUCH_COLUMN"]) is None
        assert native.read_columns(str(tmp_path / "missing.fits"), "EVENTS", ["TIME"]) is None

    def test_event_file_reads_through_native_with_the_pure_bits(self, lib, monkeypatch):
        ef = events.EventFile(FITS).build_time_energy_df().filtenergy(1.0, 5.0)
        assert ef.reader == "native"
        monkeypatch.setattr(native, "load", lambda: None)
        pure = events.EventFile(FITS).build_time_energy_df().filtenergy(1.0, 5.0)
        assert pure.reader == "pure"
        for c in ("TIME", "PI"):
            np.testing.assert_array_equal(ef.time_energy_df[c], pure.time_energy_df[c])

    def test_event_table_matches_crimp_tpu(self, lib):
        from crimp_tpu.io.events import EventFile as JaxEventFile

        want = JaxEventFile(FITS).build_time_energy_df().filtenergy(1.0, 5.0).time_energy_df
        got = events.EventFile(FITS).build_time_energy_df().filtenergy(1.0, 5.0).time_energy_df
        for c in ("TIME", "PI"):
            np.testing.assert_array_equal(got[c], want[c].to_numpy())


class TestFilterAndHistogram:
    def test_filter_energy_bitwise_numpy_and_crimp_tpu(self, lib, pure_columns):
        from crimp_tpu.io import native as jax_native

        t, pi = pure_columns["TIME"], pure_columns["PI"]
        got_t, got_kev = native.filter_energy(t, pi, 0.01, 0.0, 1.0, 5.0)
        kev = pi * 0.01 + 0.0
        keep = (kev >= 1.0) & (kev <= 5.0)
        np.testing.assert_array_equal(got_t, t[keep])
        np.testing.assert_array_equal(got_kev, kev[keep])
        want = jax_native.filter_energy(t, pi, 0.01, 0.0, 1.0, 5.0)
        if want is not None:
            np.testing.assert_array_equal(got_t, want[0])
            np.testing.assert_array_equal(got_kev, want[1])

    def test_phase_histogram_matches_numpy(self, lib):
        ph = np.random.RandomState(1).uniform(0, 1, 20000)
        np.testing.assert_array_equal(native.phase_histogram(ph, 1.0, 32),
                                      np.histogram(ph, bins=32, range=(0.0, 1.0))[0])

    @pytest.mark.parametrize("upper,nbins", [(1.0, 15), (1.0, 32), (2 * np.pi, 15), (2 * np.pi, 7)])
    def test_phase_histogram_edge_semantics(self, lib, upper, nbins):
        """tests/test_io.py's adversarial edges: values on, just below and
        just above every linspace edge bin as numpy's explicit-edge
        histogram does, and as crimp_tpu's native histogram does."""
        from crimp_tpu.io import native as jax_native

        edges = np.linspace(0.0, upper, nbins + 1)
        adversarial = np.concatenate([
            edges,
            np.nextafter(edges, -np.inf)[1:],
            np.nextafter(edges, np.inf)[:-1],
            np.arange(nbins) * (upper / nbins),
            np.random.RandomState(2).uniform(0, upper, 50000),
        ])
        adversarial = adversarial[(adversarial >= 0) & (adversarial <= upper)]
        counts = native.phase_histogram(adversarial, upper, nbins)
        np.testing.assert_array_equal(counts, np.histogram(adversarial, bins=edges)[0])
        want = jax_native.phase_histogram(adversarial, upper, nbins)
        if want is not None:
            np.testing.assert_array_equal(counts, want)

    @pytest.mark.parametrize("upper", [1.0, 2 * np.pi])
    def test_bin_phases_native_path_equals_numpy(self, lib, upper, monkeypatch):
        ph = np.random.RandomState(3).uniform(0, upper, binprofile.NATIVE_MIN_PHASES)
        calls = []
        real = native.phase_histogram
        monkeypatch.setattr(native, "phase_histogram", lambda *a: calls.append(1) or real(*a))
        got = binprofile.bin_phases(ph, 15)
        assert calls
        edges = np.linspace(0, upper, 16)
        np.testing.assert_array_equal(got["ctsBins"], np.histogram(ph, bins=edges)[0])
        np.testing.assert_array_equal(got["ctsBinsErr"], np.sqrt(np.histogram(ph, bins=edges)[0]))

    def test_each_fallback_is_counted_and_logged(self, monkeypatch, tmp_path, caplog):
        from crimp_tpu_torch import obs

        monkeypatch.setenv("CRIMP_TORCH_OBS", "1")
        monkeypatch.setenv("CRIMP_TORCH_OBS_DIR", str(tmp_path))
        with obs.run("native_ok") as rec:
            events.EventFile(FITS).build_time_energy_df()
            ok = dict(rec.counters)
        assert ok.get("native_fallbacks", 0) == 0
        monkeypatch.setattr(native, "load", lambda: None)
        with caplog.at_level("WARNING"), obs.run("native_missing") as rec:
            events.EventFile(FITS).build_time_energy_df()
            binprofile.bin_phases(np.random.RandomState(6).uniform(0, 1, binprofile.NATIVE_MIN_PHASES), 15)
            missing = dict(rec.counters)
        assert missing["native_fallbacks"] == 2
        assert sum("native reader unavailable" in r.getMessage() for r in caplog.records) == 2

    def test_without_the_library_every_caller_takes_the_pure_path(self, monkeypatch):
        monkeypatch.setattr(native, "load", lambda: None)
        assert native.read_columns(FITS, "EVENTS", ["TIME"]) is None
        assert native.filter_energy(np.zeros(2), np.zeros(2), 1.0, 0.0, 0.0, 1.0) is None
        assert native.phase_histogram(np.zeros(2), 1.0, 4) is None
        ph = np.random.RandomState(4).uniform(0, 1, binprofile.NATIVE_MIN_PHASES)
        np.testing.assert_array_equal(binprofile.bin_phases(ph, 15)["ctsBins"],
                                      np.histogram(ph, bins=np.linspace(0, 1, 16))[0])
