"""One worker of a localhost multi-process job, and a one-rank NCCL probe.

    python -m crimp_tpu_torch.utils.multihost_worker [DEVICE]
    python -m crimp_tpu_torch.utils.multihost_worker --nccl-probe

The worker joins the job named by ``CRIMP_TORCH_DIST``
(``host:port,num_processes,process_id``; unset: one process) on DEVICE
("cpu", or "cuda:0" for every rank on one card: gloo; by default the card,
and no card raises), with ``LOCAL`` devices a process (JAX's multi-host
smoke fixes the per-process count the same way), runs one seeded workload,
and process 0 prints one JSON line of hashes:

- the survey fold (the source axis over the global source mesh, each
  process folding its own rows, ``fetch_global`` joining them);
- the segment-batched ToA fit, auto-sharded over each process's own
  devices (host-local, as in JAX);
- the K3 and K2 grids on a 2 x 2 (events x trials) mesh of ``SHARDS``
  shards laid host-major over the processes whatever their count (trials
  across processes), and the K3 grid on the transposed layout, whose event
  axis crosses processes (its partials exchanged and added in shard
  order);
- the sharded refold over an event mesh of the same shards;
- a 4-source survey (its fits auto-sharded host-locally).

At a fixed layout the results are bitwise the same at 1, 2 and 4
processes: 1 process with all 4 grid shards equals 2 processes with 2
each (``tests/test_torch_multihost.py`` runs it on gloo).

``--nccl-probe`` (on the card) brings up a one-rank NCCL group through
``CRIMP_TORCH_DIST`` and prints one JSON line: ``fetch_global`` through
the group's all-gather and one sharded 2-D scan on a global mesh of four
shards on the card (its partials exchanged through the group), each
against the same call without a group, and the K2 launches the scan made.
"""

from __future__ import annotations

import hashlib
import json
import sys
import time

import numpy as np

SHARDS = 4  # grid and refold shards in the whole job, at every process count
LOCAL = 2  # devices a process (its auto-sharded folds and fits)


def _sha(arrays) -> str:
    h = hashlib.sha1()
    for a in arrays:
        h.update(np.ascontiguousarray(np.asarray(a, dtype=np.float64)).tobytes())
    return h.hexdigest()


def _grid_events():
    t_ev = np.sort(np.random.RandomState(7).uniform(0.0, 20.0, 5000)) * 86400.0
    return t_ev - (t_ev[0] + t_ev[-1]) / 2


def worker(dev: str) -> dict | None:
    from crimp_tpu_torch.parallel import multihost

    t_start = time.perf_counter()
    pidx, pcount = multihost.ensure_distributed()
    if SHARDS % pcount:
        raise ValueError(f"{SHARDS} shards do not split over {pcount} processes")
    from crimp_tpu_torch.parallel import mesh as pmesh

    with pmesh.virtual_devices([dev] * LOCAL):
        import torch

        torch.set_num_threads(1)
        from crimp_tpu_torch.models.profiles import ProfileParams
        from crimp_tpu_torch.ops import anchored, deltafold, multisource, toafit
        from crimp_tpu_torch.pipelines import survey

        # SHARDS shards, host-major: shard k on process k * pcount // SHARDS
        per = SHARDS // pcount
        grid = np.empty(SHARDS, dtype=object)
        grid[:] = [pmesh.Slot(torch.device(dev), k // per, k % per) for k in range(SHARDS)]
        trials_across = pmesh.Mesh(grid.reshape(2, 2).T, (pmesh.EVENT_AXIS, pmesh.TRIAL_AXIS),
                                   group=multihost.job_group())
        events_across = pmesh.Mesh(grid.reshape(2, 2), (pmesh.EVENT_AXIS, pmesh.TRIAL_AXIS),
                                   group=multihost.job_group())

        # fold rows: the source axis spans processes on the global source mesh
        rng = np.random.RandomState(13)
        edges = np.linspace(58000.0, 58004.0, 3)
        tms, seg_lists = [], []
        for i in range(8):
            tms.append({"PEPOCH": 58000.0, "F0": 0.1 + 0.002 * i, "F1": -1e-13})
            seg_lists.append([np.sort(rng.uniform(lo + 1e-6, hi - 1e-6, 60))
                              for lo, hi in zip(edges[:-1], edges[1:])])
        phases, t_refs = multisource.fold_sources(tms, seg_lists, device=dev)
        fold_hash = _sha([p for ph in phases for p in ph] + t_refs)

        # fit columns: the segment-batched ToA fit, host-local on a fixed layout
        def f(v):
            return torch.tensor(v, dtype=torch.float64)

        tpl = ProfileParams(norm=f(10.0), amp=f([3.0]), loc=f([0.3]), wid=torch.zeros(1, dtype=torch.float64),
                            ph_shift=f(0.0), amp_shift=f(1.0))
        ph = np.mod(rng.vonmises(0.0, 2.0, (4, 128)) / (2 * np.pi) + 0.3, 1.0)
        fit = toafit.fit_toas_batch_auto("fourier", tpl, ph, np.ones_like(ph, dtype=bool), np.full(4, 12.8),
                                         toafit.ToAFitConfig(ph_shift_res=50, n_brute=8, refine_iters=3),
                                         device=dev)
        fit_hash = _sha([fit[k] for k in sorted(fit)])

        # grids: K3 on the literal frequencies, K2 on whole tiles (tile0); the
        # plan pinned so two splits fall on the two event shards
        t_ev = _grid_events()
        fdots = np.array([-2e-14, -1e-14])
        freqs = np.linspace(0.1430, 0.1436, 16)
        k3 = pmesh.z2_2d_sharded(t_ev, freqs, fdots, mesh=trials_across, use_fastpath=False, per_split=3072)
        k3_events = pmesh.z2_2d_sharded(t_ev, freqs, fdots, mesh=events_across, use_fastpath=False,
                                        per_split=3072)
        k2 = pmesh.z2_2d_sharded(t_ev, np.linspace(0.1430, 0.1436, 700), fdots, mesh=trials_across,
                                 per_split=3072)

        # the refold: the event axis over every shard of the job
        segs = [np.sort(58000.0 + 2.0 * i + rng.uniform(0.0, 1.5, 300)) for i in range(2)]
        tm = {"PEPOCH": 58000.0, "F0": 0.1432, "F1": -1e-14}
        ph_segs, t_ref = anchored.fold_segments(tm, segs, delta_fold=0, device=dev)
        anchor_idx = np.repeat(np.arange(2), [t.size for t in segs])
        delta = anchored.anchor_deltas(np.concatenate(segs), t_ref, anchor_idx)
        dp = np.zeros(deltafold.n_params(0))
        dp[0] = 3e-10
        refold = pmesh.delta_refold_sharded(tm, t_ref, np.concatenate(ph_segs), delta, anchor_idx, dp,
                                            mesh=pmesh.Mesh(grid, (pmesh.EVENT_AXIS,), group=multihost.job_group()))

        # the survey: fold, fit and H-test of 4 sources, per-process ownership
        specs = []
        for i in range(4):
            iv = {"ToA_tstart": edges[:-1], "ToA_tend": edges[1:], "ToA_exposure": np.full(2, 2.0 * 86400.0)}
            specs.append(survey.SourceSpec(
                name=f"s{i}", times=np.sort(rng.uniform(58000.0, 58004.0, 300)),
                timing_model={"PEPOCH": 58000.0, "F0": 0.15 + 0.002 * i, "F1": -1e-13},
                template={"model": "fourier", "nbrComp": 2, "norm": 1.0, "amp_1": 0.3, "amp_2": 0.1,
                          "ph_1": 0.2, "ph_2": 0.05},
                intervals=iv))
        frames = survey.survey_measure_toas(specs, phShiftRes=100, device=dev)
        survey_hash = _sha([fr[c] for fr in frames for c in survey.SURVEY_TOA_COLUMNS])
        backend = torch.distributed.get_backend() if torch.distributed.is_initialized() else None
        record = {
            "pcount": pcount, "shards": SHARDS, "devices": len(multihost.global_slots()), "backend": backend,
            "fold": fold_hash, "fit": fit_hash, "k3": _sha([k3]), "k3_events": _sha([k3_events]),
            "k2": _sha([k2]), "refold": _sha([refold]), "argmax": int(np.argmax(k3)), "survey": survey_hash,
            "n_batched": survey.last_survey_info()["n_batched"],
            "jax": sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "crimp_tpu."))),
            "wall_s": time.perf_counter() - t_start,
        }
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    return record if pidx == 0 else None


def nccl_probe() -> dict:
    """A one-rank NCCL group on the card: fetch_global and a sharded scan
    through it, each against the call without a group."""
    import torch

    from crimp_tpu_torch.ops import z2_grid
    from crimp_tpu_torch.parallel import mesh as pmesh
    from crimp_tpu_torch.parallel import multihost

    t_ev = _grid_events()
    fdots = np.array([-2e-14, -1e-14])
    freqs = np.linspace(0.1430, 0.1436, 2000)
    rows = np.arange(24.0).reshape(8, 3)
    with pmesh.virtual_devices(["cuda:0"] * SHARDS):
        plain_scan = pmesh.z2_2d_sharded(t_ev, freqs, fdots, mesh=pmesh.build_mesh(event_parallel=2),
                                         per_split=3072)
        plain_rows = multihost.fetch_global(pmesh.shard_sources(rows, pmesh.source_mesh()))
        pidx, pcount = multihost.ensure_distributed()
        backend = torch.distributed.get_backend()
        smesh = multihost.global_source_mesh()
        got_rows = multihost.fetch_global(multihost.global_array(rows, smesh, (pmesh.SOURCE_AXIS,)))
        gmesh = multihost.global_grid_mesh()
        gmesh = pmesh.Mesh(gmesh.devices.reshape(-1).reshape(2, 2), (pmesh.EVENT_AXIS, pmesh.TRIAL_AXIS),
                           group=gmesh.group)
        z2_grid.reset_launches()
        group_scan = pmesh.z2_2d_sharded(t_ev, freqs, fdots, mesh=gmesh, per_split=3072)
        k2 = z2_grid.LAUNCHES["z2_tile_sums"]
        torch.distributed.destroy_process_group()
    return {"backend": backend, "identity": [pidx, pcount], "group": gmesh.group is not None,
            "fetch_global_bitwise": bool(np.array_equal(got_rows, plain_rows) and np.array_equal(got_rows, rows)),
            "scan_bitwise": bool(np.array_equal(group_scan, plain_scan)), "k2_launches": k2}


def main(argv: list[str]) -> int:
    if argv[:1] == ["--nccl-probe"]:
        print(json.dumps(nccl_probe()), flush=True)
        return 0
    if argv:
        dev = argv[0]
    else:
        from crimp_tpu_torch.utils.device import resolve_device

        dev = str(resolve_device(None))
    record = worker(dev)
    if record is not None:
        print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
