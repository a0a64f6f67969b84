"""Device meshes and the sharded search twins (B10) on the hand kernels.

Port of ``crimp_tpu/parallel/mesh.py``. JAX runs its sharded twins as
``shard_map`` programs with a ``psum`` over ICI; here a mesh is a grid of
shards (:class:`Slot`: a ``torch.device`` and the process that owns it,
several shards possibly on one device), and a twin is a loop over the
shards this process owns, each running the port's own per-device path:

- the EVENT axis (the long one: 1e5..1e8 photon times) splits the events
  into contiguous shards. The launch plan (the event split length
  ``per_split`` of K2 or K3) is resolved once, for the whole problem, as
  the one-device call resolves it, and handed to every shard. Where there
  are at least as many splits as event shards, each shard takes whole
  splits; each shard hands back its per-split partials unreduced, and
  those are added across shards in split order, in the kernel's own
  accumulator type (f32 for K2, f64 for K3), exactly as the kernel's split
  reduce adds them. So such a layout is bitwise the one-device result at
  that plan. With fewer splits than shards the events are cut into near
  equal shards of whole 1024-event chunks, one split each, and the result
  agrees with the one-device call to the twins' tolerance. There is no
  ``dist.all_reduce``: its order belongs to the backend;
- the TRIAL axis splits the trials with no communication: a uniform grid
  by whole tiles of the global grid (K2's ``tile0``: a trial shard's
  columns are the monolithic kernel's bits), any other grid by contiguous
  blocks of the literal frequencies (K3's trials do not depend on the
  trials beside them). Trial sharding is bitwise (on the factorized grid,
  whose matrix products round with their row count, to its tolerance);
- the SEGMENT and SOURCE axes split batches of independent rows (ToA
  segments, survey sources, semi-coherent segments) with no communication
  but the semi-coherent stack's ordered sum;
- small state (the timing model, the template) is replicated.

On the card every shard launches K2, K3 or K4, or raises ``KernelError``:
no shard falls back to a twin and none moves to the CPU. Each launch makes
its shard's card current (``utils/profiling.launch_window``), so a mesh may
span the cards of a host whatever card the caller has current. Shards on
one device run one after another; shards on distinct cards launch without
a sync between them.

:func:`virtual_devices` sets a device list with repeats, the counterpart
of JAX's virtual host devices (``--xla_force_host_platform_device_count``),
for tests (``["cpu"] * 8``) and for driving the sharded code on one card
(``["cuda:0"] * 4``). Outside it the device list is the distinct CUDA
devices, so on one card :func:`auto_mesh` returns None and nothing
auto-shards.

Product integration: ``PeriodSearch``, ``ResumableScan``, the batched ToA
fit and the survey fold consult :func:`auto_mesh` / :func:`source_mesh`;
``CRIMP_TORCH_SHARD=0`` opts out. Mesh-shape invariance is pinned on an
8-shard CPU mesh (``tests/test_torch_parallel.py``).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import numpy as np
import torch

from crimp_tpu_torch import knobs, obs
from crimp_tpu_torch.obs import costmodel
from crimp_tpu_torch.parallel import multihost
from crimp_tpu_torch.parallel.registry import (  # noqa: F401 — the axis names are re-exported here
    EVENT_AXIS,
    REPLICATED,
    SEGMENT_AXIS,
    SOURCE_AXIS,
    TRIAL_AXIS,
    leading_axis_sharding,
    specs_for,
)

EVENT_ALIGN = 1024  # event shards of the near-equal cut are whole K2/K3 chunks
ROW_ALIGN = 64  # refold shards start on whole vector blocks of the CPU twin's elementwise ops

# ---------------------------------------------------------------------------
# Shards, meshes and the device list
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Slot:
    """One shard's place in a mesh: a device, the process that owns it,
    and its index in that process's device list."""

    device: torch.device
    process_index: int = 0
    index: int = 0

    @property
    def id(self) -> int:
        return self.index


def as_slot(d, index: int = 0):
    """A mesh entry: a :class:`Slot` (or any object with a
    ``process_index``, as test stubs are) as given; a device or a device
    string as a shard of this process."""
    if isinstance(d, Slot) or hasattr(d, "process_index"):
        return d
    return Slot(torch.device(d), multihost.process_identity()[0], index)


class Mesh:
    """An n-d grid of shards with named axes: ``devices`` (an object array
    of :class:`Slot`), ``axis_names``, ``shape`` (axis name -> size, in
    order) and ``group``, the ``torch.distributed`` process group its
    shards span (None for a mesh of this process alone)."""

    def __init__(self, devices, axis_names, group=None):
        arr = np.asarray(devices, dtype=object)
        flat = np.empty(arr.size, dtype=object)
        flat[:] = [as_slot(d, i) for i, d in enumerate(arr.ravel())]
        self.devices = flat.reshape(arr.shape)
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) != self.devices.ndim:
            raise ValueError(f"{self.devices.ndim}-d shard grid with axis names {self.axis_names}")
        self.shape = dict(zip(self.axis_names, self.devices.shape))
        self.group = group

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def cards(self) -> int:
        """Distinct devices under the mesh's shards (all processes)."""
        return len({(getattr(s, "process_index", 0), str(getattr(s, "device", s)))
                    for s in self.devices.ravel()})

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(s.device) for s in self.devices.ravel()]})"


_VIRTUAL: list[torch.device] | None = None


@contextlib.contextmanager
def virtual_devices(devices):
    """Make ``devices`` (devices or device strings, repeats allowed) the
    device list that :func:`available_devices`, and so :func:`auto_mesh`,
    :func:`build_mesh`, :func:`segment_mesh` and :func:`source_mesh`, see
    by default, inside the block: ``["cpu"] * 8`` in the tests,
    ``["cuda:0"] * 4`` to drive the sharded code on one card."""
    global _VIRTUAL
    prev = _VIRTUAL
    _VIRTUAL = [torch.device(d) for d in devices]
    try:
        yield list(_VIRTUAL)
    finally:
        _VIRTUAL = prev


def available_devices() -> list[torch.device]:
    """This process's device list: the :func:`virtual_devices` list inside
    one; else, in a ``torch.distributed`` job, this rank's own card (the one
    ``multihost.initialize`` made current: a process sees its local
    devices, as JAX's do, so N ranks on an N-card node take a card each
    and the job's shards are N, not N x N); else the distinct CUDA devices
    (none without a card)."""
    if _VIRTUAL is not None:
        return list(_VIRTUAL)
    if not torch.cuda.is_available():
        return []
    if multihost.job_group() is not None:
        return [torch.device("cuda", torch.cuda.current_device())]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def sharding_enabled() -> bool:
    """Global opt-out: CRIMP_TORCH_SHARD=0/off disables auto sharding.
    Anything that is not an explicit off-word (garbage included) leaves it
    on, as JAX's knob reads."""
    return knobs.parse_onoff(knobs.raw("CRIMP_TORCH_SHARD")) is not False


def _serves(devices, device) -> bool:
    """Whether shards on ``devices`` may take a call meant for ``device``:
    the same device type (a CPU call never shards onto cards, nor the
    reverse)."""
    from crimp_tpu_torch.utils.device import resolve_device

    kind = resolve_device(device).type
    return bool(devices) and all(torch.device(d).type == kind for d in devices)


def local_devices(mesh: Mesh) -> list[torch.device]:
    """The devices of this process's shards of ``mesh``, in grid order."""
    me = multihost.process_identity()[0]
    return [s.device for s in mesh.devices.ravel() if s.process_index == me]


def auto_mesh(min_devices: int = 2, device=None) -> Mesh | None:
    """An all-shards mesh when auto-sharding should kick in, else None:
    None when CRIMP_TORCH_SHARD is off, below ``min_devices`` shards (one
    card: None), or when this process's shards are of another device type
    than ``device`` (when given); else ``multihost.auto_global_mesh``."""
    if not sharding_enabled():
        return None
    mesh = multihost.auto_global_mesh(min_devices)
    if mesh is None or device is None:
        return mesh
    return mesh if _serves(local_devices(mesh), device) else None


def build_mesh(devices=None, event_parallel: int | None = None, axis_names=(EVENT_AXIS, TRIAL_AXIS)) -> Mesh:
    """A 2-D (events x trials) mesh over the given (or all the job's)
    shards; ``event_parallel`` fixes the event-axis size (default: every
    shard on the event axis)."""
    if devices is None:
        devices = multihost.global_slots()
    devices = list(devices)
    n = len(devices)
    if n == 0:
        raise ValueError("build_mesh: no devices (pass some, or use virtual_devices)")
    if event_parallel is None:
        event_parallel = n
    if n % event_parallel != 0:
        raise ValueError(f"{n} devices do not tile into event_parallel={event_parallel}")
    grid = _slot_array(devices).reshape(event_parallel, n // event_parallel)
    spans = len({int(getattr(s, "process_index", 0)) for s in grid.ravel()}) > 1
    return Mesh(grid, axis_names, group=multihost.job_group() if spans else None)


def _slot_array(devices) -> np.ndarray:
    devices = list(devices)
    if not devices:
        raise ValueError("a mesh needs at least one device (pass some, or use virtual_devices)")
    arr = np.empty(len(devices), dtype=object)
    arr[:] = [as_slot(d, i) for i, d in enumerate(devices)]
    return arr


def segment_mesh(devices=None) -> Mesh:
    """A 1-D mesh over this process's (or the given) devices for
    segment-batched fits and the semi-coherent stack."""
    return Mesh(_slot_array(available_devices() if devices is None else devices), (SEGMENT_AXIS,))


def source_mesh(devices=None) -> Mesh:
    """A 1-D mesh over this process's (or the given) devices for
    source-batched survey folds."""
    return Mesh(_slot_array(available_devices() if devices is None else devices), (SOURCE_AXIS,))


def default_dispatch_mesh() -> Mesh:
    """The mesh the twins dispatch on when the caller passes none: the
    host-major global (events x trials) mesh on a multi-process job, else
    every shard on the event axis."""
    if multihost.process_identity()[1] > 1:
        return multihost.global_grid_mesh()
    return build_mesh()


def _pad_to(x: np.ndarray, multiple: int, fill=0.0):
    """``x`` padded with ``fill`` to a multiple of ``multiple``, and 0/1
    weights marking the real entries (a padded entry weighs 0)."""
    n = len(x)
    padded_len = -(-n // multiple) * multiple
    if padded_len == n:
        return np.asarray(x), np.ones(n)
    out = np.full(padded_len, fill, dtype=np.asarray(x).dtype)
    out[:n] = x
    weights = np.zeros(padded_len)
    weights[:n] = 1.0
    return out, weights


def pad_batch_for_mesh(n: int, mesh: Mesh, axis_name: str = SEGMENT_AXIS) -> int:
    """Rows of padding needed so a leading batch axis tiles onto the mesh."""
    return (-n) % int(mesh.shape[axis_name])


# ---------------------------------------------------------------------------
# Leading-axis splits of host arrays (data parallelism)
# ---------------------------------------------------------------------------


def _owner_slots(mesh: Mesh, axis_name: str) -> list:
    """For each block of ``axis_name``, the shard that holds it: the first
    shard (in grid order) at that coordinate of the axis."""
    ax = mesh.axis_names.index(axis_name)
    moved = np.moveaxis(mesh.devices, ax, 0).reshape(mesh.devices.shape[ax], -1)
    return [moved[j, 0] for j in range(moved.shape[0])]


class Sharded:
    """A host array split along its leading axis by ``spec`` (leading entry
    a mesh axis) over ``mesh``: ``blocks`` holds this process's blocks as
    (slot, lo, hi, tensor on the slot's device), in row order; blocks of
    other processes are not held."""

    def __init__(self, mesh: Mesh, spec: tuple, global_shape: tuple, blocks: list):
        self.mesh, self.spec, self.global_shape, self.blocks = mesh, tuple(spec), tuple(global_shape), blocks

    @classmethod
    def from_rows(cls, rows: np.ndarray, mesh: Mesh, spec: tuple, global_shape: tuple, row0: int = 0,
                  whole: bool = False) -> "Sharded":
        """Place ``rows`` (global rows [row0, row0 + len(rows)), or the whole
        array with ``whole``) on the local shards that own blocks of them."""
        axis = spec[0] if len(spec) else None
        n = int(global_shape[0])
        me = multihost.process_identity()[0]
        if axis is None:  # replicated: one copy on the first local shard
            local = [s for s in mesh.devices.ravel() if s.process_index == me]
            return cls(mesh, spec, global_shape, [(local[0], 0, n, torch.as_tensor(rows).to(local[0].device))])
        owners = _owner_slots(mesh, axis)
        if n % len(owners):
            raise ValueError(f"{n} rows do not tile over the {len(owners)} shards of axis {axis!r}; "
                             "pad first (pad_batch_for_mesh)")
        per = n // len(owners)
        blocks = []
        for j, slot in enumerate(owners):
            if slot.process_index != me:
                continue
            lo, hi = j * per, (j + 1) * per
            src = rows[lo:hi] if whole else rows[lo - row0:hi - row0]
            blocks.append((slot, lo, hi, torch.as_tensor(np.ascontiguousarray(src)).to(slot.device)))
        return cls(mesh, spec, global_shape, blocks)

    def local_rows(self) -> torch.Tensor:
        """This process's blocks joined in row order, on the first block's device."""
        dev = self.blocks[0][3].device
        return torch.cat([b[3].to(dev) for b in self.blocks])


def shard_sources(array, mesh: Mesh) -> Sharded:
    """A stacked (source-major) host array with its leading axis split over
    the source axis: pure data parallelism, bitwise the single-device rows."""
    arr = np.asarray(array)
    placement = leading_axis_sharding(mesh, SOURCE_AXIS)
    return Sharded.from_rows(arr, mesh, placement.spec, arr.shape, whole=True)


def shard_segments(array, mesh: Mesh, axis_name: str | None = None) -> Sharded:
    """A batched (segment-major) host array with its leading axis split over
    the segment axis of a 1-D segment mesh, or over the trial axis of a 2-D
    (events x trials) mesh."""
    if axis_name is None:
        axis_name = SEGMENT_AXIS if SEGMENT_AXIS in mesh.axis_names else TRIAL_AXIS
    arr = np.asarray(array)
    return Sharded.from_rows(arr, mesh, leading_axis_sharding(mesh, axis_name).spec, arr.shape, whole=True)


def map_blocks(fn, *arrays: Sharded) -> list:
    """``fn(slot, *blocks)`` for each local block of equally split arrays,
    in row order, every call issued before any result is read."""
    return [fn(parts[0][0], *(p[3] for p in parts)) for parts in zip(*(a.blocks for a in arrays))]


# ---------------------------------------------------------------------------
# Shard layout and the ordered reduce
# ---------------------------------------------------------------------------


def _event_trial_grid(mesh: Mesh) -> np.ndarray:
    """The mesh's shards as an (events, trials) grid; a missing axis has size 1."""
    names = mesh.axis_names
    if not set(names) <= {EVENT_AXIS, TRIAL_AXIS}:
        raise ValueError(f"the search twins take an (events x trials) mesh, got axes {names}")
    grid = mesh.devices
    if names == (TRIAL_AXIS, EVENT_AXIS):
        grid = grid.T
    elif names == (EVENT_AXIS,):
        grid = grid[:, None]
    elif names == (TRIAL_AXIS,):
        grid = grid[None, :]
    return grid


def whole_splits(n: int, k: int, per_split: int | None) -> bool:
    """Whether k event shards of n events take whole splits of the plan
    ``per_split`` (at least k splits): the layout whose ordered reduce is
    bitwise the one-device call."""
    return per_split is not None and -(-n // per_split) >= k


def event_bounds(n: int, k: int, per_split: int | None) -> list[tuple[int, int]]:
    """The k event shards of n events under the launch plan ``per_split``:
    whole splits, as evenly as they go, when :func:`whole_splits`; else
    JAX's padded partition without the padding, k shards of ceil(n / k)
    events rounded up to whole 1024-event chunks (trailing shards may be
    short or empty)."""
    if whole_splits(n, k, per_split):
        n_split = -(-n // per_split)
        edges = [(i * n_split) // k for i in range(k + 1)]
    else:
        chunks = -(-(-(-n // k)) // EVENT_ALIGN)
        per_split, edges = chunks * EVENT_ALIGN, list(range(k + 1))
    return [(min(n, edges[i] * per_split), min(n, edges[i + 1] * per_split)) for i in range(k)]


def _tile_columns(n_tiles: int, k: int) -> list[tuple[int, int]]:
    """k contiguous blocks of whole trial tiles [lo, hi), as evenly as they
    go (the first n_tiles % k one tile longer); empty when k > n_tiles."""
    edges = [(i * n_tiles) // k if n_tiles >= k else min(i, n_tiles) for i in range(k + 1)]
    return [(edges[i], edges[i + 1]) for i in range(k)]


def ordered_sum(parts: list[torch.Tensor]) -> torch.Tensor:
    """The partials added in list order in their own dtype, on the first
    one's device: ``acc = parts[0]``, then ``acc = acc + p`` (each sum
    rounded on its own, as a kernel's split reduce adds)."""
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p.to(acc.device)
    return acc


def home_device(mesh: Mesh) -> torch.device:
    """Where a twin's result lands: this process's first shard's device."""
    return local_devices(mesh)[0]


def _reduce_columns(mesh: Mesh, jobs: dict, home: torch.device) -> dict:
    """Reduce each trial column's partials over its event shards in shard
    order. ``jobs[(e, t)]`` is a list of this process's partials of event
    shard e, trial column t (in split order). On a mesh with a process
    group the partials of every process are exchanged first (each column
    reduced locally when one process holds all of it), so every process
    ends with every column; returns {t: reduced tensor on ``home``}."""
    _need_group(mesh)
    by_col: dict = {}
    for (e, t), parts in sorted(jobs.items()):
        by_col.setdefault(t, []).append((e, parts))
    if mesh.group is None:
        return {t: ordered_sum([p for _, parts in cols for p in parts]).to(home) for t, cols in by_col.items()}
    grid = _event_trial_grid(mesh)
    payload = {}
    for t, cols in by_col.items():
        if len({s.process_index for s in grid[:, t]}) == 1:
            payload[t] = ("reduced", ordered_sum([p for _, parts in cols for p in parts]).cpu())
        else:
            payload[t] = ("parts", [(e, [p.cpu() for p in parts]) for e, parts in cols])
    merged: dict = {}
    for got in multihost.exchange(payload, mesh.group):
        for t, (kind, data) in got.items():
            if kind == "reduced":
                merged[t] = ("reduced", data)
            else:
                merged.setdefault(t, ("parts", []))[1].extend(data)
    out = {}
    for t, (kind, data) in merged.items():
        if kind == "reduced":
            out[t] = data.to(home)
        else:
            out[t] = ordered_sum([p.to(home) for _, parts in sorted(data, key=lambda x: x[0]) for p in parts])
    return out


def _need_group(mesh: Mesh) -> None:
    """A mesh whose shards span processes exchanges through its group."""
    if mesh.group is None and multihost.spans_processes(mesh):
        raise ValueError("a mesh whose shards span processes needs the job's process group "
                         "(multihost.global_grid_mesh / global_source_mesh carry it)")


def _events_on(times: np.ndarray, dev: torch.device, cache: dict) -> torch.Tensor:
    """The f64 events on ``dev``, copied once per device (shards slice it)."""
    key = str(dev)
    if key not in cache:
        cache[key] = torch.as_tensor(times).to(dev)
    return cache[key]


def _owned(slot) -> bool:
    return slot.process_index == multihost.process_identity()[0]


def _k2_out(n_rows: int, n_tiles: int, nharm: int) -> torch.Tensor:
    """A shape-only stand-in for K2's f32 output (its bytes, for the counts)."""
    from crimp_tpu_torch.ops import z2_grid

    return torch.empty((2, n_rows, n_tiles, nharm, z2_grid.TRIAL_TILE), dtype=torch.float32, device="meta")


def _per_shard_counts(total: dict, devices: int) -> dict:
    """A whole call's counts as the mean per shard (JAX's cost rows are per
    device); the roofline scales them back by the shards per card."""
    return {k: (v / devices if isinstance(v, (int, float)) else v) for k, v in total.items()}


# ---------------------------------------------------------------------------
# The sharded trig-sum twins (K2 / K3 per shard, ordered reduce)
# ---------------------------------------------------------------------------


def grid_sums_sharded(times, f0: float, df: float, n_freq: int, fdots, fddots, nharm: int, mesh: Mesh,
                      poly: bool = False, use_mxu: bool | None = None, reseed: int | None = None,
                      mxu_bf16: bool | None = None, per_split: int | None = None, tile0: int = 0,
                      mxu_blocks: tuple[int, int] | None = None):
    """(c, s) of shape (n_fddot, n_fdot, nharm, n_freq) f64 over the trials
    [tile0 * T, tile0 * T + n_freq) of the uniform grid f0 + j*df (T the
    trial tile), events sharded over the mesh's event axis and whole tiles
    over its trial axis; ``fddots`` None is the 2-D grid (n_fddot = 1).

    The plan resolves as the one-device grid dispatch resolves it, for the
    whole problem: the factorized path (``use_mxu``, ...) through
    ``search.resolve_grid_mxu``, then K2's ``per_split`` (or the factorized
    path's ``mxu_blocks``) through ``autotune.resolve_blocks``; explicit
    values pin them. Each shard launches K2 with the global f0 and its
    first tile and hands back its per-split f32 partials, which add in
    split order across the event shards; the tiles join in grid order, so
    the result is laid out as the one-device call's. On the factorized path
    each shard's f64 carry sums its own event blocks, and its f32 matrix
    products round with the shard's row count, so that path agrees with
    the one-device call to the factorized tolerance, not bit for bit."""
    from crimp_tpu_torch.ops import autotune, search, z2_grid

    times = np.ascontiguousarray(np.asarray(times, dtype=np.float64).reshape(-1))
    n = times.shape[0]
    grid = _event_trial_grid(mesh)
    ev, tr = grid.shape
    fdots = np.atleast_1d(np.asarray(fdots, dtype=np.float64))
    cube = fddots is not None
    fdd = np.atleast_1d(np.asarray(fddots, dtype=np.float64)) if cube else None
    n_rows = len(fdots) * (len(fdd) if cube else 1)
    n_freq = int(n_freq)
    if nharm < 1:
        raise ValueError(f"nharm must be >= 1, got {nharm}")
    home = home_device(mesh)
    obs.counter_add("mesh_sharded_calls")
    obs.gauge_set("mesh_devices", ev * tr)
    mx, rs, b16 = search.resolve_grid_mxu(use_mxu, reseed, mxu_bf16, n, n_freq * (n_rows if cube else 1), poly,
                                          cube, device=home)
    if mx:
        if mxu_blocks is None:
            mxu_blocks = autotune.resolve_blocks("grid_mxu", n, n_freq * n_rows, poly, device=home)
        eb, unit = (int(b) for b in mxu_blocks)
        plan_split = None
    else:
        if nharm > z2_grid.MAX_NHARM:
            raise ValueError(f"the uniform-grid kernel takes nharm <= {z2_grid.MAX_NHARM}")
        if per_split is None:
            per_split, _ = autotune.resolve_blocks("grid3d" if cube else "grid", n, n_freq * n_rows, poly,
                                                   n_rows=n_rows, nharm=nharm, device=home)
        unit, plan_split = z2_grid.TRIAL_TILE, int(per_split)
    n_tiles = -(-n_freq // unit)
    columns = _tile_columns(n_tiles, tr)
    bounds = event_bounds(n, ev, plan_split)
    name = "sharded_sums_grid3d" if cube else "sharded_sums_grid"
    jobs, on = {}, {}
    with costmodel.kernel_span(name):
        for t, (a, b) in enumerate(columns):
            if b <= a:
                continue
            width = min(n_freq, b * unit) - a * unit
            for e, (lo, hi) in enumerate(bounds):
                slot = grid[e, t]
                if hi <= lo or not _owned(slot):
                    continue
                dev = slot.device
                tt = _events_on(times, dev, on)[lo:hi]
                if mx:
                    carry = search.MxuCarry(f0, df, width, fdots, fdd, nharm, poly, rs, b16, dev, eb, unit,
                                             tile0=tile0 + a)
                    carry.feed(tt, None)
                    jobs[(e, t)] = [torch.stack([carry.c, carry.s])]
                else:
                    half, sixth = search.row_coeffs(fdots, fdd, dev)
                    parts = z2_grid.z2_tile_sums(tt, f0, df, half, b - a, nharm, sixth_fddots=sixth, poly=poly,
                                                 per_split=plan_split, tile0=tile0 + a, splits=True)
                    jobs[(e, t)] = list(parts.unbind(0))
        cols = _reduce_columns(mesh, jobs, home)
    if mx:
        # (2, nharm, rows = (fddot, fdot, tile), TB) per column: join the
        # tiles in grid order, then the one-device carry's layout
        shape = (1 if fdd is None else len(fdd), len(fdots))
        joined = torch.cat([cols[t].reshape(2, nharm, *shape, -1, unit) for t in sorted(cols)], dim=-2)
        carry = search.MxuCarry(f0, df, n_freq, fdots, fdd, nharm, poly, rs, b16, home, eb, unit, tile0=tile0)
        carry.c, carry.s = (x.reshape(nharm, -1, unit) for x in joined.unbind(0))
        c, s = carry.result()
    else:
        cs = torch.cat([cols[t] for t in sorted(cols)], dim=-3)  # the tile axis of K2's layout
        cs = search.tiles_to_freqs(cs, n_freq)
        c, s = cs[0], cs[1]
    plan = specs_for(name, mesh)
    costmodel.capture(name, None, times, f0, df, n_freq, fdots, fdd, nharm, poly=poly, mxu=mx,
                      per_split=plan_split, out=[c[0] if fdd is None else c, s[0] if fdd is None else s],
                      plan=plan, counts=lambda: _per_shard_counts(
                          costmodel.k2_counts(n, n_freq, n_rows, nharm, _k2_out(n_rows, n_tiles, nharm)), mesh.size))
    return c, s


def general_sums_sharded(times, freqs, fdots, fddots, nharm: int, mesh: Mesh, trig_dtype=None,
                         poly: bool = False, per_split: int | None = None):
    """(c, s) of shape (n_fddot, n_fdot, nharm, n_freq) f64 for arbitrary
    frequencies: events sharded over the event axis, the literal frequency
    list in contiguous blocks over the trial axis, K3 on each shard with
    the plan ``per_split`` (resolved once for the whole problem, as
    ``search.general_harmonic_sums`` resolves it, when None); the per-split
    f64 partials add in split order across the event shards."""
    from crimp_tpu_torch.ops import autotune, search, z2_general

    trig = torch.float32 if trig_dtype is None else trig_dtype
    times = np.ascontiguousarray(np.asarray(times, dtype=np.float64).reshape(-1))
    freqs = np.ascontiguousarray(np.asarray(freqs, dtype=np.float64).reshape(-1))
    n = times.shape[0]
    grid = _event_trial_grid(mesh)
    ev, tr = grid.shape
    fdots = np.atleast_1d(np.asarray(fdots, dtype=np.float64))
    fddots = np.atleast_1d(np.asarray(fddots, dtype=np.float64))
    n_rows = len(fdots) * len(fddots)
    home = home_device(mesh)
    obs.counter_add("mesh_sharded_calls")
    obs.gauge_set("mesh_devices", ev * tr)
    if per_split is None:
        per_split, _ = autotune.resolve_blocks("general", n, len(freqs) * n_rows, poly, n_rows=n_rows,
                                               nharm=int(nharm), trig_dtype=trig, device=home)
    per_split = int(per_split)
    edges = [(i * len(freqs)) // tr for i in range(tr + 1)]
    bounds = event_bounds(n, ev, per_split)
    jobs, on = {}, {}
    with costmodel.kernel_span("sharded_sums_general"):
        for t in range(tr):
            lo_f, hi_f = edges[t], edges[t + 1]
            if hi_f <= lo_f:
                continue
            for e, (lo, hi) in enumerate(bounds):
                slot = grid[e, t]
                if hi <= lo or not _owned(slot):
                    continue
                dev = slot.device
                half, sixth = search.row_coeffs(fdots, fddots, dev)
                parts = z2_general.general_sums(_events_on(times, dev, on)[lo:hi], search.as_f64(freqs[lo_f:hi_f], dev),
                                                half, sixth, int(nharm), trig, poly, per_split=per_split,
                                                splits=True)
                jobs[(e, t)] = list(parts.unbind(0))
        cols = _reduce_columns(mesh, jobs, home)
    cs = torch.cat([cols[t] for t in sorted(cols)], dim=-1)
    c, s = cs[0], cs[1]
    plan = specs_for("sharded_sums_general", mesh)
    has_d = bool(np.any(fdots != 0) or np.any(fddots != 0))
    costmodel.capture("sharded_sums_general", None, times, freqs, fdots, fddots, int(nharm), trig, poly=poly,
                      per_split=per_split, out=[c[0], s[0]], plan=plan,
                      counts=lambda: _per_shard_counts(
                          costmodel.k3_counts(n, len(freqs), n_rows, int(nharm), trig, poly, has_d=has_d), mesh.size))
    return c, s


def _sharded_sums_nd(times, freqs, fdots, nharm, mesh, trig_dtype, use_fastpath, poly=False, use_mxu=None,
                     reseed=None, mxu_bf16=None, per_split=None, tile0=0):
    """(c, s, uniform) with c, s of shape (n_fdot, nharm, n_freq): the
    uniform-grid twin (K2) when the fast path applies (trig_dtype None, the
    fast path on, a uniform grid), else the general twin (K3)."""
    from crimp_tpu_torch.ops import search

    grid = None
    if trig_dtype is None and search.grid_fastpath_enabled(nharm, use_fastpath):
        grid = search.uniform_grid(freqs)
    if grid is not None:
        c, s = grid_sums_sharded(times, grid[0], grid[1], len(freqs), fdots, None, nharm, mesh, poly, use_mxu,
                                 reseed, mxu_bf16, per_split, tile0)
        return c[0], s[0], True
    c, s = general_sums_sharded(times, freqs, fdots, (0.0,), nharm, mesh, trig_dtype, poly, per_split)
    return c[0], s[0], False


def _materialize(x: torch.Tensor) -> np.ndarray:
    from crimp_tpu_torch.ops import z2_grid

    return z2_grid.to_host(x, "sharded twin")


def z2_sharded(times, freqs, nharm: int = 2, mesh: Mesh | None = None, trig_dtype=None,
               use_fastpath: bool | None = None, poly: bool = False, use_mxu: bool | None = None,
               reseed: int | None = None, mxu_bf16: bool | None = None,
               per_split: int | None = None, tile0: int = 0) -> np.ndarray:
    """Z^2_n over the frequency grid (times pre-centered), events and trials
    sharded across the mesh -> (n_freq,). ``per_split`` pins the launch
    plan and ``tile0`` offsets a uniform grid by whole tiles, as in the
    one-device wrappers."""
    from crimp_tpu_torch.ops import search

    mesh = default_dispatch_mesh() if mesh is None else mesh
    c, s, _ = _sharded_sums_nd(times, freqs, (0.0,), nharm, mesh, trig_dtype, use_fastpath, poly, use_mxu,
                               reseed, mxu_bf16, per_split, tile0)
    return _materialize(torch.sum(search.z2_from_sums(c[0], s[0], np.shape(times)[0]), dim=0))  # graftlint: disable=GL005 (sums the replicated nharm axis, not the sharded event axis; per-trial order is fixed and the 8-device bitwise pin covers it)


def h_sharded(times, freqs, nharm: int = 20, mesh: Mesh | None = None, trig_dtype=None,
              use_fastpath: bool | None = None, poly: bool = False, use_mxu: bool | None = None,
              reseed: int | None = None, mxu_bf16: bool | None = None,
              per_split: int | None = None, tile0: int = 0) -> np.ndarray:
    """H-test over the frequency grid, events and trials sharded across the
    mesh -> (n_freq,)."""
    from crimp_tpu_torch.ops import search

    mesh = default_dispatch_mesh() if mesh is None else mesh
    c, s, _ = _sharded_sums_nd(times, freqs, (0.0,), nharm, mesh, trig_dtype, use_fastpath, poly, use_mxu,
                               reseed, mxu_bf16, per_split, tile0)
    return _materialize(search.h_from_sums(c[0], s[0], np.shape(times)[0], dim=0))


def z2_2d_sharded(times, freqs, fdots, nharm: int = 2, mesh: Mesh | None = None, trig_dtype=None,
                  use_fastpath: bool | None = None, poly: bool = False, use_mxu: bool | None = None,
                  reseed: int | None = None, mxu_bf16: bool | None = None,
                  per_split: int | None = None, tile0: int = 0) -> np.ndarray:
    """Z^2_n over the (fdot, freq) grid -> (n_fdot, n_freq), events sharded
    across the mesh (fdots replicated, frequencies over the trial axis);
    ``fdots`` are signed Hz/s."""
    from crimp_tpu_torch.ops import search

    mesh = default_dispatch_mesh() if mesh is None else mesh
    c, s, _ = _sharded_sums_nd(times, freqs, fdots, nharm, mesh, trig_dtype, use_fastpath, poly, use_mxu,
                               reseed, mxu_bf16, per_split, tile0)
    return _materialize(torch.sum(search.z2_from_sums(c, s, np.shape(times)[0]), dim=1))  # graftlint: disable=GL005 (sums the replicated nharm axis, not the sharded event axis; per-trial order is fixed and the 8-device bitwise pin covers it)


def z2_3d_sharded(times, freqs, fdots, fddots, nharm: int = 2, mesh: Mesh | None = None,
                  use_fastpath: bool | None = None, poly: bool = False, use_mxu: bool | None = None,
                  reseed: int | None = None, mxu_bf16: bool | None = None,
                  per_split: int | None = None, tile0: int = 0) -> np.ndarray:
    """Z^2_n over the (fddot, fdot, freq) cube -> (n_fddot, n_fdot, n_freq),
    events sharded across the mesh. Needs the uniform-grid path; a
    non-uniform frequency list falls back to the one-device general cube
    (K3 on this process's first shard's device) and bumps
    ``mesh_grid3d_fallbacks``, as in JAX."""
    from crimp_tpu_torch.ops import search

    mesh = default_dispatch_mesh() if mesh is None else mesh
    grid = search.uniform_grid(freqs) if search.grid_fastpath_enabled(nharm, use_fastpath) else None
    if grid is None:
        obs.counter_add("mesh_grid3d_fallbacks")
        return _materialize(search.z2_power_3d(np.asarray(times, dtype=np.float64),
                                               np.asarray(freqs, dtype=np.float64), fdots, fddots, nharm,
                                               poly=poly, device=home_device(mesh), per_split=per_split))
    c, s = grid_sums_sharded(times, grid[0], grid[1], len(freqs), fdots, fddots, nharm, mesh, poly, use_mxu,
                             reseed, mxu_bf16, per_split, tile0)
    return _materialize(torch.sum(search.z2_from_sums(c, s, np.shape(times)[0]), dim=2))  # graftlint: disable=GL005 (sums the replicated nharm axis, not the sharded event axis; per-trial order is fixed and the 8-device bitwise pin covers it)


def semicoherent_stack_sharded(seg_times, seg_weights, f0: float, df: float, n_freq: int, fdots, fddots,
                               nharm: int, mesh: Mesh | None = None, poly: bool = False,
                               per_split: int | None = None, tile0: int = 0) -> torch.Tensor:
    """Incoherently stacked per-segment Z^2 over the cube, segments sharded
    across a 1-D segment mesh -> (n_fddot, n_fdot, n_freq) f64 on this
    process's first shard's device.

    ``seg_times``/``seg_weights`` are (S, Nmax) zero-weight-padded rows, S
    a multiple of the mesh size (callers pad with all-zero rows, whose term
    is exactly +0.0, so they are skipped). Each shard runs the one-device
    per-segment term, K2 with the row's weights under the plan
    ``per_split``, for its rows and sums them in segment order; the shard
    partials then add in f64 in shard order. Only the cross-segment
    grouping differs from the one-device loop, so parity with it is
    reduction-order tolerance (bitwise with one segment a shard)."""
    from crimp_tpu_torch.ops import autotune, search, z2_grid

    mesh = segment_mesh() if mesh is None else mesh
    if mesh.axis_names != (SEGMENT_AXIS,):
        raise ValueError(f"semicoherent_stack_sharded takes a 1-D segment mesh, got axes {mesh.axis_names}")
    seg_times = np.asarray(seg_times, dtype=np.float64)
    seg_weights = np.asarray(seg_weights, dtype=np.float64)
    slots = list(mesh.devices.ravel())
    n_seg = seg_times.shape[0]
    if n_seg % len(slots):
        raise ValueError(f"{n_seg} segment rows do not tile over {len(slots)} shards; pad with zero rows")
    if nharm > z2_grid.MAX_NHARM:
        raise ValueError(f"the uniform-grid kernel takes nharm <= {z2_grid.MAX_NHARM}")
    per = n_seg // len(slots)
    counts = seg_weights.sum(axis=1)  # graftlint: disable=GL005 (exact integer-valued total of the 0/1 weight mask; order-insensitive at the bit level)
    fdots = np.atleast_1d(np.asarray(fdots, dtype=np.float64))
    fddots = np.atleast_1d(np.asarray(fddots, dtype=np.float64))
    n_rows = len(fdots) * len(fddots)
    home = home_device(mesh)
    if per_split is None:
        per_split, _ = autotune.resolve_blocks("semicoherent", seg_times.shape[1], int(n_freq) * n_rows, poly,
                                               n_rows=n_rows, nharm=nharm, device=home)
    obs.counter_add("mesh_sharded_calls")
    obs.gauge_set("mesh_devices", len(slots))
    jobs = {}
    with costmodel.kernel_span("semicoherent_stack"):
        for k, slot in enumerate(slots):
            if not _owned(slot):
                continue
            dev, local = slot.device, None
            half, sixth = search.row_coeffs(fdots, fddots, dev)
            for i in range(k * per, (k + 1) * per):
                if counts[i] == 0.0:
                    continue  # an empty or pad row's term is exactly +0.0
                cs = z2_grid.z2_tile_sums(search.as_f64(seg_times[i], dev), f0, df, half,
                                          -(-int(n_freq) // z2_grid.TRIAL_TILE), nharm, sixth_fddots=sixth,
                                          weights=search.as_weights(seg_weights[i], dev), poly=poly,
                                          per_split=per_split, tile0=tile0)
                cs = search.tiles_to_freqs(cs, n_freq)
                term = torch.sum(search.z2_from_sums(cs[0], cs[1], max(float(counts[i]), 1.0)), dim=2)  # graftlint: disable=GL005 (sums the replicated nharm axis inside one segment, not the sharded segment axis)
                local = term if local is None else local + term
            if local is not None:
                jobs[(0, k)] = [local]
        # each shard's partial is one "column" of a one-event-shard layout;
        # the stack adds them in shard order
        cols = _reduce_columns(Mesh(mesh.devices[None, :], (EVENT_AXIS, TRIAL_AXIS), group=mesh.group), jobs,
                               home)
        if cols:
            out = ordered_sum([cols[k] for k in sorted(cols)])
        else:
            out = torch.zeros(len(fddots), len(fdots), int(n_freq), dtype=torch.float64, device=home)
    costmodel.capture("semicoherent_stack", None, seg_times, seg_weights, f0, df, int(n_freq), fdots, fddots,
                      nharm, poly=poly, per_split=per_split, out=[out], plan=specs_for("semicoherent_stack", mesh),
                      counts=lambda: _per_shard_counts(
                          costmodel.k2_counts(int(np.count_nonzero(counts)) * seg_times.shape[1], int(n_freq),
                                              n_rows, nharm, _k2_out(n_rows, -(-int(n_freq) // z2_grid.TRIAL_TILE),
                                                                      nharm)), mesh.size))
    return out


# ---------------------------------------------------------------------------
# Sharded delta-fold refold (basis built shard-local, K4 per shard)
# ---------------------------------------------------------------------------


def delta_refold_sharded(tm, t_ref_mjd, folded, delta, anchor_idx, dp, mesh: Mesh | None = None,
                         wave_in_f0: bool = True) -> np.ndarray:
    """frac(folded + B @ dp) with events sharded across the mesh's event axis.

    Each shard builds its events' basis rows (``deltafold.basis_rows`` is
    per-event) and refolds them with K4; the (N, 13+5G) basis never forms
    on one device and there is no collective (each row's dot runs over the
    replicated dp). Bitwise the monolithic refold: sharding splits the
    event axis, not any reduction."""
    from crimp_tpu_torch.ops import deltafold

    if mesh is None:
        mesh = Mesh(_slot_array(multihost.global_slots()), (EVENT_AXIS,), group=multihost.job_group()
                    if multihost.process_identity()[1] > 1 else None)
    if EVENT_AXIS not in mesh.axis_names:
        raise ValueError(f"delta_refold_sharded needs an events axis, got axes {mesh.axis_names}")
    _need_group(mesh)
    slots = list(_event_trial_grid(mesh)[:, 0])
    folded = np.ascontiguousarray(np.asarray(folded, dtype=np.float64))
    delta = np.ascontiguousarray(np.asarray(delta, dtype=np.float64))
    anchor_idx = np.ascontiguousarray(np.asarray(anchor_idx, dtype=np.int64))
    dp = np.asarray(dp, dtype=np.float64)
    n = len(folded)
    obs.counter_add("mesh_sharded_calls")
    obs.gauge_set("mesh_devices", len(slots))
    spec = deltafold.basis_spec(tm, t_ref_mjd)
    # JAX's padded partition: equal shards, each a whole number of ROW_ALIGN
    # rows; the padding rows (anchor 0, delta 0) are refolded and dropped
    folded_p, _ = _pad_to(folded, len(slots) * ROW_ALIGN)
    delta_p, _ = _pad_to(delta, len(slots) * ROW_ALIGN)
    idx_p, _ = _pad_to(anchor_idx, len(slots) * ROW_ALIGN, fill=0)
    per = len(folded_p) // len(slots)
    jobs = {}
    with costmodel.kernel_span("delta_refold_sharded"):
        for e, slot in enumerate(slots):
            lo, hi = e * per, (e + 1) * per
            if hi <= lo or not _owned(slot):
                continue
            dev = slot.device
            b = deltafold.basis_rows(spec.to(dev), torch.as_tensor(delta_p[lo:hi]).to(dev),
                                     torch.as_tensor(idx_p[lo:hi]).to(dev), wave_in_f0=wave_in_f0)
            jobs[e] = deltafold.refold(torch.as_tensor(folded_p[lo:hi]).to(dev), b.contiguous(),
                                       torch.as_tensor(dp).to(dev))
        if mesh.group is not None:
            rows = {}
            for got in multihost.exchange({e: r.cpu() for e, r in jobs.items()}, mesh.group):
                rows.update(got)
        else:
            rows = jobs
        out = (np.concatenate([_materialize(rows[e]) for e in sorted(rows)])[:n] if rows
               else np.zeros(0, dtype=np.float64))
    costmodel.capture("delta_refold_sharded", None, folded, delta, anchor_idx, dp, out=[torch.as_tensor(out)],
                      plan=specs_for("delta_refold_sharded", mesh),
                      counts=lambda: _per_shard_counts(costmodel.k4_counts(1, n, len(dp)), mesh.size))
    return out
