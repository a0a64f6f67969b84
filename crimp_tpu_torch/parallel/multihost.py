"""Multi-process bring-up and host meshes on ``torch.distributed``.

Port of ``crimp_tpu/parallel/multihost.py``. ``parallel.mesh`` defines the
sharding semantics (the event axis reduced in a fixed shard order, the
trial, segment and source axes free of communication) on any mesh; this
module joins processes into one job and builds the meshes that span them.

How JAX's layout maps onto cards: a TPU slice maps to a node (one process,
or several on one node), and ICI, the links within a slice, maps to NVLink
between the node's cards; DCN, the network between slices, maps to the
``torch.distributed`` links between nodes. So "ici" in the registry's
collective estimate is the leg within a process and "dcn" the leg across
processes.

- :func:`initialize` / :func:`ensure_distributed` bring up a
  ``torch.distributed`` process group with ``dist.init_process_group``:
  NCCL when the ranks' tensors live on the card (every rank owns a card of
  its own: NCCL refuses two ranks on one card), gloo on the CPU.
  ``CRIMP_TORCH_DIST`` takes JAX's ``host:port,num_processes,process_id``.
- :func:`global_slots` is the job's shard list: every process's local
  devices (``mesh.available_devices()``: in a job, the rank's own card),
  gathered once, host-major.
- :func:`global_grid_mesh` puts the trial axis across processes and each
  process's shards on the event axis, so the event reduce never leaves a
  process; :func:`global_source_mesh` lays sources over every shard,
  host-major. Both carry the job's process group (``Mesh.group``).
- :func:`fetch_global` is the one all-gather (in rank order) that brings
  the rows of the trial or source axis back to every process;
  :func:`exchange` is the all-gather of Python objects that the sharded
  twins use for partials on a mesh with a group.

The multi-process contract is JAX's (docs/parity.md): at a fixed shard
layout the results are bitwise the same at 1, 2 and 4 processes, since
every reduce adds its partials in shard order whoever computed them.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from crimp_tpu_torch import knobs
from crimp_tpu_torch.parallel.registry import EVENT_AXIS, SOURCE_AXIS, TRIAL_AXIS


def process_identity() -> tuple[int, int]:
    """``(rank, world_size)`` of an initialized ``torch.distributed`` group,
    else the single-process identity ``(0, 1)``. Never initializes anything."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _backend_for(num_processes: int) -> str:
    """NCCL when the ranks' tensors live on the card (this process's devices,
    ``mesh.available_devices()``, are CUDA devices, repeats allowed) and each
    rank can own a card of its own (at least as many cards as ranks: NCCL
    refuses two ranks on one card), else gloo."""
    from crimp_tpu_torch.parallel import mesh

    local = mesh.available_devices()
    if (torch.cuda.is_available() and torch.cuda.device_count() >= num_processes and local
            and all(d.type == "cuda" for d in local)):
        return "nccl"
    return "gloo"


def initialize(coordinator_address: str, num_processes: int, process_id: int,
               backend: str | None = None, timeout_s: float = 300.0) -> str:
    """Join a ``torch.distributed`` job at ``tcp://coordinator_address``
    (``host:port``) as rank ``process_id`` of ``num_processes``; returns
    the backend. ``backend`` None picks NCCL or gloo (``_backend_for``).
    On a host with cards each rank takes card ``process_id % device_count``
    as its current device: its own card under NCCL, and the one its shards
    use (``mesh.available_devices``) under either backend."""
    import datetime

    backend = backend or _backend_for(int(num_processes))
    if torch.cuda.is_available() and torch.cuda.device_count():
        torch.cuda.set_device(int(process_id) % torch.cuda.device_count())
    dist.init_process_group(backend=backend, init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes), rank=int(process_id),
                            timeout=datetime.timedelta(seconds=timeout_s))
    return backend


_DIST_STARTED = False


def ensure_distributed() -> tuple[int, int]:
    """Knob-driven bring-up: honor ``CRIMP_TORCH_DIST``, return the identity.

    The value is ``host:port,num_processes,process_id``. Unset or an
    off-word means single-process: nothing is initialized. Idempotent:
    once a group is up (by this call or by the caller) it only reports the
    identity, so entry points may call it unconditionally."""
    global _DIST_STARTED

    spec = knobs.raw("CRIMP_TORCH_DIST")
    if not spec or knobs.parse_onoff(spec) is False:
        return process_identity()
    if _DIST_STARTED or (dist.is_available() and dist.is_initialized()):
        return process_identity()
    parts = [p.strip() for p in spec.split(",")]
    if len(parts) != 3:
        raise ValueError(f"CRIMP_TORCH_DIST={spec!r}: expected 'host:port,num_processes,process_id'")
    initialize(parts[0], int(parts[1]), int(parts[2]))
    _DIST_STARTED = True
    return process_identity()


# -- the job's slots ------------------------------------------------------------

_GLOBAL_CACHE: dict = {}


def global_slots() -> list:
    """Every slot of the job, host-major: this process's local devices
    (``mesh.available_devices()``) on a single process; on a multi-process
    job every process's, gathered once per (identity, local list) with one
    ``all_gather_object`` (a collective: every rank calls it alike)."""
    from crimp_tpu_torch.parallel import mesh

    pidx, pcount = process_identity()
    local = mesh.available_devices()
    if pcount <= 1:
        return [mesh.Slot(d, 0, i) for i, d in enumerate(local)]
    key = (pidx, pcount, tuple(str(d) for d in local))
    if key not in _GLOBAL_CACHE:
        lists: list = [None] * pcount
        dist.all_gather_object(lists, [str(d) for d in local])
        _GLOBAL_CACHE[key] = [mesh.Slot(torch.device(name), p, i)
                              for p, names in enumerate(lists) for i, name in enumerate(names)]
    return list(_GLOBAL_CACHE[key])


def topology_mesh(devices=None, event_parallel: int | None = None):
    """A 2-D (events x trials) mesh over this process's devices in index
    order. JAX asks ``mesh_utils`` for an ICI-ring order here; CUDA cards
    expose no ring topology to copy, so the order is the device index
    order, the same contract as ``mesh.build_mesh``."""
    from crimp_tpu_torch.parallel import mesh

    if devices is None:
        devices = mesh.available_devices()
    return mesh.build_mesh(devices, event_parallel=event_parallel)


def hybrid_mesh(event_parallel_per_slice: int | None = None, devices=None):
    """A multi-process (events x trials) mesh: trials across processes,
    events within each process. Raises ValueError on a single process, as
    JAX's does without a multi-slice job, so callers fall back to
    :func:`topology_mesh`."""
    from crimp_tpu_torch.parallel import mesh

    slots = [mesh.as_slot(d) for d in (global_slots() if devices is None else devices)]
    procs = sorted({s.process_index for s in slots})
    if len(procs) < 2:
        raise ValueError("hybrid_mesh needs a multi-process job; use topology_mesh on one process")
    grid = host_device_grid(slots)
    per_host = grid.shape[1]
    if event_parallel_per_slice is None:
        event_parallel_per_slice = per_host
    if per_host % event_parallel_per_slice != 0:
        raise ValueError(f"{per_host} devices per process do not tile into "
                         f"event_parallel_per_slice={event_parallel_per_slice}")
    blocks = [row.reshape(event_parallel_per_slice, -1) for row in grid]
    return mesh.Mesh(np.concatenate(blocks, axis=1), (EVENT_AXIS, TRIAL_AXIS), group=job_group())


def host_device_grid(devices=None) -> np.ndarray:
    """The job's slots as a (process_count, local_per_process) host-major
    grid: row k is process k's slots. Requires a rectangular job."""
    from crimp_tpu_torch.parallel import mesh

    slots = [mesh.as_slot(d) for d in (global_slots() if devices is None else devices)]
    slots = sorted(slots, key=lambda s: (int(getattr(s, "process_index", 0)), int(s.id)))
    counts: dict[int, int] = {}
    for s in slots:
        counts[int(s.process_index)] = counts.get(int(s.process_index), 0) + 1
    per_host = set(counts.values())
    if len(per_host) > 1:
        raise ValueError(f"non-rectangular job: per-host device counts {sorted(counts.items())}")
    grid = np.empty(len(slots), dtype=object)
    grid[:] = slots
    return grid.reshape(len(counts), per_host.pop())


def global_grid_mesh(devices=None):
    """The 2-D (events x trials) mesh of a multi-process job: the trial axis
    spans processes (its only traffic is the final all-gather), the event
    axis is each process's own slots, so the event reduce stays local."""
    from crimp_tpu_torch.parallel import mesh

    return mesh.Mesh(host_device_grid(devices).T, (EVENT_AXIS, TRIAL_AXIS), group=job_group())


def global_source_mesh(devices=None):
    """The 1-D source mesh of a multi-process job: sources over every slot
    of every process, host-major, so each process's source rows are one
    contiguous block (:func:`process_local_rows`)."""
    from crimp_tpu_torch.parallel import mesh

    return mesh.Mesh(host_device_grid(devices).reshape(-1), (SOURCE_AXIS,), group=job_group())


def process_local_rows(n_rows: int) -> tuple[int, int]:
    """This process's ``[lo, hi)`` block of a host-major leading axis
    (``n_rows`` a multiple of the process count: pad to the slot count)."""
    idx, count = process_identity()
    if n_rows % count:
        raise ValueError(f"{n_rows} rows do not tile across {count} processes")
    per = n_rows // count
    return idx * per, (idx + 1) * per


def global_array(local_rows, mesh, spec, global_shape=None):
    """This process's row block (``process_local_rows`` of the global batch)
    as a ``mesh.Sharded`` of the global array laid out by ``spec``: each
    local slot that owns a block holds it on its device; no process holds
    another's rows. On a single process the local rows are the array."""
    from crimp_tpu_torch.parallel import mesh as pmesh

    local_rows = np.asarray(local_rows)
    _, count = process_identity()
    if global_shape is None:
        global_shape = (local_rows.shape[0] * count,) + local_rows.shape[1:]
    lo, _ = process_local_rows(int(global_shape[0])) if count > 1 else (0, 0)
    return pmesh.Sharded.from_rows(local_rows, mesh, spec, tuple(global_shape), row0=lo)


def replicated_array(full, mesh, spec):
    """Host data every process holds in full, placed by ``spec``: each local
    slot that owns a block of it gets exactly that block."""
    from crimp_tpu_torch.parallel import mesh as pmesh

    full = np.asarray(full)
    return pmesh.Sharded.from_rows(full, mesh, spec, full.shape, row0=0, whole=True)


def job_group():
    """The job's process group (``dist.group.WORLD``) when one is up, else
    None: what the global meshes carry in ``Mesh.group``."""
    if dist.is_available() and dist.is_initialized():
        return dist.group.WORLD
    return None


def exchange(payload, group) -> list:
    """Every process's ``payload`` (picklable; tensors on the CPU), in rank
    order: one ``all_gather_object`` over ``group`` (a one-rank group too)."""
    out: list = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, payload, group=group)
    return out


def _mesh_processes(mesh) -> set:
    return {int(getattr(d, "process_index", 0)) for d in np.asarray(mesh.devices, dtype=object).ravel()}


def spans_processes(mesh) -> bool:
    """True when the mesh's slots live on more than one process."""
    return len(_mesh_processes(mesh)) > 1


def _collective_device(group=None) -> torch.device:
    """Where the group's collectives take their tensors: the CPU for gloo,
    this rank's card for NCCL."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def gather_blocks(local: torch.Tensor, dim: int = 0, group=None) -> torch.Tensor:
    """Concatenate every process's ``local`` block along ``dim`` in rank
    order (blocks may differ in length along ``dim``, nowhere else): one
    ``all_gather`` of the lengths and one of the padded blocks over
    ``group`` (the default group when None), on its backend, a one-rank
    group too. Without a process group, ``local`` itself."""
    if not (dist.is_available() and dist.is_initialized()):
        return local
    count = dist.get_world_size(group)
    dev = _collective_device(group)
    x = local.to(dev).contiguous()
    lengths = [torch.zeros(1, dtype=torch.int64, device=dev) for _ in range(count)]
    dist.all_gather(lengths, torch.tensor([x.shape[dim]], dtype=torch.int64, device=dev), group=group)
    sizes = [int(v.item()) for v in lengths]
    pad = max(sizes) - x.shape[dim]
    if pad:
        shape = list(x.shape)
        shape[dim] = pad
        x = torch.cat([x, torch.zeros(shape, dtype=x.dtype, device=dev)], dim=dim)
    parts = [torch.empty_like(x) for _ in range(count)]
    dist.all_gather(parts, x, group=group)
    return torch.cat([p.narrow(dim, 0, n) for p, n in zip(parts, sizes)], dim=dim).to(local.device)


def fetch_global(arr) -> np.ndarray:
    """Materialize a (possibly cross-process) array on every process as
    numpy, the multi-process twin of ``np.asarray(out)``: a
    ``mesh.Sharded`` joins its local blocks, then, on a mesh with a process
    group (a global mesh), gathers every process's rows with ``all_gather``
    in rank order (the trial/source axis's only traffic across processes);
    a tensor or an array converts directly."""
    from crimp_tpu_torch.parallel import mesh as pmesh

    if isinstance(arr, pmesh.Sharded):
        local = arr.local_rows()
        if arr.mesh.group is not None:
            local = gather_blocks(local, 0, arr.mesh.group)
        return local.cpu().numpy()
    if isinstance(arr, torch.Tensor):
        return arr.detach().cpu().numpy()
    return np.asarray(arr)


def auto_global_mesh(min_devices: int = 2):
    """The best mesh for this job, or None below ``min_devices`` slots: the
    host-major 2-D mesh on a multi-process job (trials across processes,
    events on each process's slots), else the single-process mesh of
    :func:`topology_mesh`."""
    slots = global_slots()
    if len(slots) < min_devices:
        return None
    _, count = process_identity()
    if count > 1:
        try:
            return global_grid_mesh(slots)
        except ValueError:
            pass  # non-rectangular job: fall through to the one-process layout
    try:
        return hybrid_mesh(devices=slots)
    except ValueError:
        return topology_mesh(devices=[s for s in slots if s.process_index == process_identity()[0]])


__all__ = [
    "initialize",
    "ensure_distributed",
    "process_identity",
    "global_slots",
    "topology_mesh",
    "hybrid_mesh",
    "host_device_grid",
    "global_grid_mesh",
    "global_source_mesh",
    "process_local_rows",
    "global_array",
    "replicated_array",
    "gather_blocks",
    "exchange",
    "job_group",
    "fetch_global",
    "spans_processes",
    "auto_global_mesh",
]
