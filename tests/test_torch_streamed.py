"""The port's streamed uniform grids on the CPU: bitwise the monolithic result.

tests/test_search.py::TestStreamedGrid pins crimp_tpu's streamed kernels
bitwise to its monolithic ones; the port meets the same pin against itself.
A streamed chunk is one K2 event split, so the streamed result equals the
monolithic one at ``per_split`` = the chunk length, bit for bit (exact path);
the factorized path feeds the same event blocks into the same f64 carry. The
streamed result is also held against crimp_tpu's streamed grid at
TestPallasZ2's tolerances. On the card the chunks are copied from pinned
memory on a side stream (tests/test_torch_gpu.py checks the same pins there).
"""

import numpy as np
import pytest
import torch

from crimp_tpu.ops import search as jax_search
from crimp_tpu_torch.ops import search

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def odd_times():
    """Deliberately not a multiple of the chunk, so a ragged tail chunk and
    whole chunks are both exercised."""
    rng = np.random.RandomState(11)
    return np.sort(rng.uniform(0.0, 350.0, 5000 + 123))


class TestStreamedBitwise:
    @pytest.mark.parametrize("poly", [True, False])
    def test_z2(self, odd_times, poly):
        mono = search.z2_power_grid(odd_times, 0.2, 1e-5, 300, 2, device="cpu", poly=poly,
                                    per_split=1024)
        strm = search.z2_power_grid_streamed(odd_times, 0.2, 1e-5, 300, 2, device="cpu", poly=poly,
                                             event_chunk=1024)
        assert torch.equal(strm, mono)

    def test_h(self, odd_times):
        mono = search.h_power_grid(odd_times, 0.2, 1e-5, 300, 5, device="cpu", per_split=2048)
        strm = search.h_power_grid_streamed(odd_times, 0.2, 1e-5, 300, 5, device="cpu",
                                            event_chunk=2048)
        assert torch.equal(strm, mono)

    def test_2d_and_3d(self, odd_times):
        fdots, fddots = np.linspace(-1e-9, 1e-9, 3), np.linspace(-1e-13, 1e-13, 2)
        mono = search.z2_power_2d_grid(odd_times, 0.2, 1e-5, 200, fdots, 2, device="cpu",
                                       per_split=1024)
        strm = search.z2_power_2d_grid_streamed(odd_times, 0.2, 1e-5, 200, fdots, 2, device="cpu",
                                                event_chunk=1024)
        assert torch.equal(strm, mono)
        mono3 = search.z2_power_3d_grid(odd_times, 0.2, 1e-5, 200, fdots[:2], fddots, 2,
                                        device="cpu", per_split=1024)
        strm3 = search.z2_power_3d_grid_streamed(odd_times, 0.2, 1e-5, 200, fdots[:2], fddots, 2,
                                                 device="cpu", event_chunk=1024)
        assert torch.equal(strm3, mono3)

    def test_factorized(self, odd_times):
        kw = dict(device="cpu", mxu=True)
        mono = search.z2_power_3d_grid(odd_times, 0.2, 1e-5, 200, [-1e-9, 1e-9], [0.0, 1e-13], 2, **kw)
        strm = search.z2_power_3d_grid_streamed(odd_times, 0.2, 1e-5, 200, [-1e-9, 1e-9],
                                                [0.0, 1e-13], 2, event_chunk=1, **kw)
        assert torch.equal(strm, mono)

    def test_single_chunk_and_chunk_rounding(self, odd_times):
        """One chunk (event_chunk >= n) is the monolithic run at one split; a
        chunk length is rounded down to whole 1024-event chunks."""
        mono = search.z2_power_grid(odd_times, 0.2, 1e-5, 100, 2, device="cpu", per_split=1 << 22)
        strm = search.z2_power_grid_streamed(odd_times, 0.2, 1e-5, 100, 2, device="cpu",
                                             event_chunk=1 << 22)
        assert torch.equal(strm, mono)
        assert search._stream_chunks(5123, 2048) == [(0, 2048), (2048, 4096), (4096, 5123)]
        a = search.z2_power_grid_streamed(odd_times, 0.2, 1e-5, 100, 2, device="cpu", event_chunk=3000)
        b = search.z2_power_grid_streamed(odd_times, 0.2, 1e-5, 100, 2, device="cpu", event_chunk=2048)
        assert torch.equal(a, b)


class TestStreamedAgainstJax:
    def test_2d_streamed_matches_jax_streamed(self, odd_times):
        fdots = np.linspace(-1e-9, 1e-9, 3)
        ref = np.asarray(jax_search.z2_power_2d_grid_streamed(
            odd_times, 0.2, 1e-5, 200, fdots, nharm=2, event_block=512, trial_block=64, poly=True,
            event_chunk=1024, mxu=False, reseed=64, mxu_bf16=False))
        got = search.z2_power_2d_grid_streamed(odd_times, 0.2, 1e-5, 200, fdots, 2, device="cpu",
                                               event_chunk=1024).numpy()
        np.testing.assert_allclose(got, ref, rtol=2e-3, atol=0.05)

    def test_stream_min_events(self):
        """The JAX knob's values (tests/test_search.py:571-582), taken as an
        argument instead of CRIMP_TPU_STREAM_MIN_EVENTS."""
        assert search.stream_min_events() == 1 << 22
        assert search.stream_min_events(0) is None
        assert search.stream_min_events("off") is None
        assert search.stream_min_events(None) is None
        assert search.stream_min_events("12345") == 12345
        with pytest.raises(ValueError, match="stream_min_events"):
            search.stream_min_events("lots")
