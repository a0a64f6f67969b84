"""The port's multi-process layer (crimp_tpu_torch.parallel.multihost).

The contract is crimp_tpu's (tests/test_multihost_smoke.py, docs/parity.md):
at a fixed shard layout every science output is bitwise the same at 1, 2
and 4 processes. Here the job has 4 CPU shards in all (4, 2 or 1 a
process): the survey fold over the global source mesh, the host-local ToA
fit on a fixed two-shard mesh, the K3 and K2 grids with trials across
processes, the K3 grid with its event axis across processes (partials
exchanged, added in shard order), the refold over every shard and a
4-source survey. Each configuration runs as real subprocess workers
(``crimp_tpu_torch/utils/multihost_worker.py``) joined through
``torch.distributed`` (gloo, brought up by ``CRIMP_TORCH_DIST``), the
1-process baseline included. The 2-process job is tier 1 under its own
time limit, which fails rather than skips; the 4-process matrix is also
marked slow. No worker imports JAX: each reports its ``sys.modules``.

The rest: bring-up parsing, the host meshes on stub slots, the row
bridges and ``fetch_global`` on one process.
"""

import json
import os
import socket
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from crimp_tpu_torch.parallel import mesh as pmesh
from crimp_tpu_torch.parallel import multihost

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOB_TIMEOUT_S = 240.0

_JOBS: dict = {}


def run_job(nproc: int, dev: str = "cpu", timeout_s: float = JOB_TIMEOUT_S, env_extra: dict | None = None) -> dict:
    """Launch an nproc-worker localhost job; return process 0's record."""
    key = (nproc, dev)
    if key in _JOBS:
        return _JOBS[key]
    with socket.socket() as s:  # a free port for the rendezvous
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    base = {k: v for k, v in os.environ.items() if not k.startswith("CRIMP_TORCH_")}
    base.update({"PYTHONPATH": ROOT + os.pathsep + base.get("PYTHONPATH", ""), "OMP_NUM_THREADS": "1",
                 # one split length at every process count: the tiling never depends on the job
                 "CRIMP_TORCH_GRID_BLOCKS": "1024,256", "CRIMP_TORCH_AUTOTUNE": "0"})
    base.update(env_extra or {})
    procs = []
    for k in range(nproc):
        env = dict(base, CRIMP_TORCH_DIST=f"127.0.0.1:{port},{nproc},{k}")
        procs.append(subprocess.Popen([sys.executable, "-m", "crimp_tpu_torch.utils.multihost_worker", dev],
                                      cwd=ROOT, env=env,
                                      stdout=subprocess.PIPE if k == 0 else subprocess.DEVNULL,
                                      stderr=subprocess.PIPE if k == 0 else subprocess.DEVNULL))
    try:
        out, err = procs[0].communicate(timeout=timeout_s)
        for p in procs[1:]:
            p.wait(timeout=60.0)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    rcs = [p.returncode for p in procs]
    assert not any(rcs), f"worker rcs {rcs}; rank-0 stderr tail: {(err or b'').decode(errors='replace')[-3000:]}"
    doc = None
    for line in (out or b"").decode(errors="replace").splitlines():
        if line.strip().startswith("{"):
            doc = json.loads(line)
    assert isinstance(doc, dict), "rank 0 printed no JSON record"
    _JOBS[key] = doc
    return doc


def assert_bitwise(ref: dict, cand: dict) -> None:
    for key in ("fold", "fit", "k3", "k3_events", "k2", "refold", "argmax", "survey", "n_batched"):
        assert cand[key] == ref[key], f"{key} diverged across processes"


@pytest.mark.multiproc
def test_two_process_bitwise_vs_single():
    ref = run_job(1)
    two = run_job(2)
    assert ref["pcount"] == 1 and ref["shards"] == 4 and ref["devices"] == 2 and ref["backend"] == "gloo"
    assert two["pcount"] == 2 and two["shards"] == 4 and two["devices"] == 4 and two["backend"] == "gloo"
    assert ref["jax"] == [] and two["jax"] == []
    assert ref["n_batched"] == 4
    assert_bitwise(ref, two)


@pytest.mark.multiproc
@pytest.mark.slow
def test_four_process_bitwise_vs_single():
    ref = run_job(1)
    four = run_job(4)
    assert four["pcount"] == 4 and four["shards"] == 4 and four["devices"] == 8
    assert_bitwise(ref, four)


@pytest.mark.gpu
@pytest.mark.multiproc
@pytest.mark.parametrize("nproc", [2, 4])
def test_ranks_on_their_own_cards_nccl_bitwise_vs_single(nproc):
    """N ranks, each on a card of its own under NCCL (the card machine with
    N or more cards), give the bits of one process on one card."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < nproc:
        pytest.skip(f"needs {nproc} CUDA cards: NCCL refuses two ranks on one card")
    ref = run_job(1, "cuda")
    many = run_job(nproc, "cuda")
    assert many["pcount"] == nproc and many["backend"] == "nccl" and many["devices"] == 2 * nproc
    assert ref["jax"] == [] and many["jax"] == []
    assert_bitwise(ref, many)


def slot(proc, idx):
    return pmesh.Slot(torch.device("cpu"), proc, idx)


class TestBringUp:
    def test_unset_or_off_is_single_process(self, monkeypatch):
        monkeypatch.delenv("CRIMP_TORCH_DIST", raising=False)
        assert multihost.ensure_distributed() == (0, 1)
        monkeypatch.setenv("CRIMP_TORCH_DIST", "off")
        assert multihost.ensure_distributed() == (0, 1)
        assert multihost.process_identity() == (0, 1)

    def test_malformed_spec_raises(self, monkeypatch):
        monkeypatch.setenv("CRIMP_TORCH_DIST", "localhost:1234,2")
        with pytest.raises(ValueError, match="host:port,num_processes,process_id"):
            multihost.ensure_distributed()

    def test_backend_choice(self, monkeypatch):
        with pmesh.virtual_devices(["cpu"] * 2):
            assert multihost._backend_for(2) == "gloo"
        assert multihost._backend_for(1) == "gloo"  # no card here
        # one card: NCCL for one rank whose shards live on it, gloo for two
        # ranks (NCCL refuses two ranks on one card)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        with pmesh.virtual_devices(["cuda:0"] * 4):
            assert multihost._backend_for(1) == "nccl"
            assert multihost._backend_for(2) == "gloo"
        with pmesh.virtual_devices(["cpu"] * 4):
            assert multihost._backend_for(1) == "gloo"

    def test_the_worker_defaults_to_the_card(self, monkeypatch):
        """With no DEVICE the worker runs on the card, as every entry point
        does, and raises without one rather than falling back to the CPU."""
        from crimp_tpu_torch.utils import multihost_worker

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        ran = []
        monkeypatch.setattr(multihost_worker, "worker", lambda dev: ran.append(dev))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            multihost_worker.main([])
        assert ran == []
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        assert multihost_worker.main([]) == 0 and ran == ["cuda"]


class TestHostMeshes:
    def test_hybrid_mesh_needs_several_processes(self):
        with pytest.raises(ValueError, match="multi-process"):
            multihost.hybrid_mesh(devices=[slot(0, i) for i in range(4)])
        with pmesh.virtual_devices(["cpu"] * 4):
            mesh = multihost.auto_global_mesh()
        assert dict(mesh.shape) == {"events": 4, "trials": 1}

    def test_hybrid_mesh_puts_trials_across_processes(self):
        slots = [slot(p, i) for p in range(4) for i in range(2)]
        mesh = multihost.hybrid_mesh(devices=slots)
        assert dict(mesh.shape) == {"events": 2, "trials": 4}
        grid = mesh.devices
        for t in range(grid.shape[1]):
            assert len({s.process_index for s in grid[:, t]}) == 1, "an event column crossed processes"
        with pytest.raises(ValueError, match="do not tile"):
            multihost.hybrid_mesh(event_parallel_per_slice=3, devices=slots)

    def test_host_major_grid_and_global_meshes(self):
        slots = [slot(p, i) for p in (1, 0) for i in (1, 0)]  # shuffled on purpose
        grid = multihost.host_device_grid(slots)
        assert [[(s.process_index, s.index) for s in row] for row in grid] == [[(0, 0), (0, 1)], [(1, 0), (1, 1)]]
        mesh = multihost.global_grid_mesh(slots)
        assert dict(mesh.shape) == {"events": 2, "trials": 2}
        np.testing.assert_array_equal(mesh.devices, grid.T)
        src = multihost.global_source_mesh(slots)
        assert [s.process_index for s in src.devices] == [0, 0, 1, 1]
        assert multihost.spans_processes(mesh) and not multihost.spans_processes(pmesh.build_mesh(["cpu"] * 2))
        with pytest.raises(ValueError, match="non-rectangular"):
            multihost.host_device_grid(slots + [slot(2, 0)])

    def test_topology_mesh_shape_contract(self):
        mesh = multihost.topology_mesh(["cpu"] * 8, event_parallel=4)
        assert dict(mesh.shape) == {"events": 4, "trials": 2}
        with pytest.raises(ValueError, match="do not tile"):
            multihost.topology_mesh(["cpu"] * 8, event_parallel=3)

    def test_stub_mesh_meshes_run_the_twins(self):
        rng = np.random.RandomState(2)
        t = np.sort(rng.uniform(-1e4, 1e4, 2000))
        freqs = np.linspace(0.1, 0.1002, 40)
        mesh = multihost.topology_mesh(["cpu"] * 4, event_parallel=2)
        got = pmesh.z2_sharded(t, freqs, 2, mesh, trig_dtype=torch.float64)
        from crimp_tpu_torch.ops import search

        want = search.z2_power(t, freqs, 2, trig_dtype=torch.float64, device="cpu").numpy()
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-9)


class TestRows:
    def test_process_local_rows_single_process(self):
        assert multihost.process_local_rows(12) == (0, 12)

    def test_global_and_replicated_arrays_fetch_back(self):
        rows = np.arange(24.0).reshape(8, 3)
        mesh = pmesh.source_mesh(["cpu"] * 4)
        g = multihost.global_array(rows, mesh, (pmesh.SOURCE_AXIS,))
        assert [(lo, hi) for _, lo, hi, _ in g.blocks] == [(0, 2), (2, 4), (4, 6), (6, 8)]
        np.testing.assert_array_equal(multihost.fetch_global(g), rows)
        r = multihost.replicated_array(rows, mesh, pmesh.REPLICATED)
        np.testing.assert_array_equal(multihost.fetch_global(r), rows)
        np.testing.assert_array_equal(multihost.fetch_global(torch.as_tensor(rows)), rows)
        with pytest.raises(ValueError, match="do not tile"):
            multihost.global_array(rows[:7], mesh, (pmesh.SOURCE_AXIS,))

    def test_shard_sources_and_map_blocks(self):
        mesh = pmesh.source_mesh(["cpu"] * 4)
        sh = pmesh.shard_sources(np.arange(16.0).reshape(8, 2), mesh)
        assert sh.spec == (pmesh.SOURCE_AXIS,)
        assert [(s.index, lo, hi) for s, lo, hi, _ in sh.blocks] == [(0, 0, 2), (1, 2, 4), (2, 4, 6), (3, 6, 8)]
        doubled = pmesh.map_blocks(lambda slot, blk: 2 * blk, sh)
        np.testing.assert_array_equal(torch.cat(doubled).numpy(), 2 * np.arange(16.0).reshape(8, 2))

    def test_gather_blocks_is_identity_on_one_process(self):
        x = torch.arange(6.0).reshape(2, 3)
        assert multihost.gather_blocks(x, 1) is x

    def test_shard_segments_on_a_2d_mesh_uses_trials(self):
        mesh = pmesh.build_mesh(["cpu"] * 4, event_parallel=2)
        sh = pmesh.shard_segments(np.arange(10.0), mesh)
        assert sh.spec == (pmesh.TRIAL_AXIS,) and [(lo, hi) for _, lo, hi, _ in sh.blocks] == [(0, 5), (5, 10)]
        assert pmesh.pad_batch_for_mesh(11, mesh, pmesh.TRIAL_AXIS) == 1
        padded, w = pmesh._pad_to(np.arange(5.0), 4)
        np.testing.assert_array_equal(w, [1, 1, 1, 1, 1, 0, 0, 0])

    def test_duck_typed_slots(self):
        stub = SimpleNamespace(process_index=3, id=0, device=torch.device("cpu"))
        assert pmesh.as_slot(stub) is stub
        s = pmesh.as_slot("cpu", 5)
        assert (s.device, s.process_index, s.id) == (torch.device("cpu"), 0, 5)


class TestCards:
    """Shards on distinct cards, on stubs of the CUDA calls: each hand-kernel
    launch runs with its tensors' card current (``profiling.launch_window``
    enters it), a timed block whose launches went to several cards keeps
    one event pair a card and spans the longest, and a rank of a job sees
    its own card only."""

    def test_a_launch_runs_on_its_card_and_a_span_keeps_a_window_a_card(self, monkeypatch):
        from crimp_tpu_torch import obs
        from crimp_tpu_torch.utils import profiling

        current, seen, spans, clock = [0], [], [], iter(range(100))

        class Device:
            def __init__(self, device):
                self.index = torch.device(device).index

            def __enter__(self):
                current.append(self.index)

            def __exit__(self, *exc):
                current.pop()

        class Event:
            def __init__(self, enable_timing=False):
                self.card = self.t = None

            def record(self):
                self.card, self.t = current[-1], next(clock)

            def elapsed_time(self, end):
                assert end.card == self.card, "an elapsed time across cards"
                return float(end.t - self.t)

            def query(self):
                return True

            def synchronize(self):
                pass

        monkeypatch.setattr(profiling, "_card_stream_live", lambda: True)
        monkeypatch.setattr(torch.cuda, "device", Device)
        monkeypatch.setattr(torch.cuda, "current_device", lambda: current[-1])
        monkeypatch.setattr(torch.cuda, "Event", Event)
        monkeypatch.setattr(obs, "record_device_span", lambda name, start, end, kind, **a: spans.append((start, end)))
        profiling.reset_kernel_times()
        # block start t0 on card 0; card 1 t1..t2, card 2 t3..t4, card 1 t5..t6
        with profiling.timed("sharded"):
            for card in (1, 2, 1):
                with profiling.launch_window(torch.device("cuda", card)):
                    seen.append(current[-1])
        assert seen == [1, 2, 1] and current == [0]
        (start, end), = spans
        assert isinstance(start, profiling.CardWindows) and start is end and start.query()
        assert start.elapsed_time(end) == 5.0  # card 1's t1..t6, longer than card 2's t3..t4
        assert profiling.kernel_times()["sharded"] == [0.005]
        with profiling.timed("one_card"):  # t8..t9 on card 3: the plain pair
            with profiling.launch_window(torch.device("cuda", 3)):
                pass
        start, end = spans[-1]
        assert isinstance(start, Event) and (start.card, end.card) == (3, 3) and start.elapsed_time(end) == 1.0

    def test_a_rank_of_a_job_sees_its_own_card(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
        monkeypatch.setattr(torch.cuda, "current_device", lambda: 2)
        assert pmesh.available_devices() == [torch.device("cuda", i) for i in range(4)]
        monkeypatch.setattr(multihost, "job_group", lambda: "WORLD")
        assert pmesh.available_devices() == [torch.device("cuda", 2)]
        with pmesh.virtual_devices(["cuda:0"] * 2):
            assert pmesh.available_devices() == [torch.device("cuda", 0)] * 2
        # four ranks on a four-card node: four shards, one a card, not 4 x 4
        monkeypatch.setattr(multihost, "process_identity", lambda: (2, 4))
        monkeypatch.setattr(multihost, "_GLOBAL_CACHE", {})

        def all_gather_object(out, obj, group=None):
            out[:] = [[f"cuda:{r}"] for r in range(len(out))]

        monkeypatch.setattr(multihost.dist, "all_gather_object", all_gather_object)
        slots = multihost.global_slots()
        assert [(s.process_index, str(s.device)) for s in slots] == [(r, f"cuda:{r}") for r in range(4)]

    def test_initialize_makes_the_ranks_card_current(self, monkeypatch):
        made, groups = [], []
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
        monkeypatch.setattr(torch.cuda, "set_device", made.append)
        monkeypatch.setattr(multihost.dist, "init_process_group", lambda **kw: groups.append(kw))
        assert multihost.initialize("127.0.0.1:1", 4, 3, backend="gloo") == "gloo"
        assert made == [1] and groups[0]["rank"] == 3 and groups[0]["world_size"] == 4
