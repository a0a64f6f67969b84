"""Declarative sharding registry: kernel/param regex -> split-spec rules.

Port of ``crimp_tpu/parallel/registry.py``. The sharded twins of
``parallel/mesh.py`` read how each kernel's inputs split over a mesh from
this table instead of writing it at the call site, and ``obs/costmodel.py``
reads the same rule for its accounting:

- a twin asks for ``.spec(param)`` / ``.in_specs(...)`` / ``.out_specs``;
- a placement asks for ``.named(param)`` (or :func:`leading_axis_sharding`
  for the leading-axis data-parallel placements): the spec bound to the mesh;
- the cost model asks for ``.device_count()`` and
  ``.collective_bytes(outs)``, the bytes the kernel's cross-shard reduce
  moves per shard.

``PartitionSpec`` has no torch counterpart: a spec here is a plain tuple
with one entry per dimension, a mesh axis name (or a tuple of names, or
None for "not split"); dimensions past its end are not split, as JAX reads
a PartitionSpec, and ``()`` replicates. Axis names and the seven rules are
JAX's.

The two legs of the collective estimate keep JAX's field names. In the
port "ici" is the leg within one process (one node: a TPU slice maps to a
node, and ICI to NVLink between its cards, or to the card's own memory
when several shards share one card), and "dcn" the leg across processes
(``torch.distributed`` between nodes). The byte figure is JAX's ring
all-reduce model, 2(k - 1)/k of the per-shard reduced buffer per shard,
so a manifest of either package reads the same.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

# Mesh axis names, defined here (the bottom of the parallel/ import graph);
# mesh.py re-exports them.
EVENT_AXIS = "events"
TRIAL_AXIS = "trials"
SEGMENT_AXIS = "segments"
SOURCE_AXIS = "sources"

REPLICATED: tuple = ()


@dataclass(frozen=True)
class KernelRule:
    """One registry row: which kernels it covers and how they shard.

    ``kernel`` and the param patterns are ``re.search`` regexes.
    ``params`` maps param-name patterns to in-specs (first match wins);
    ``outs`` is the output-spec tuple in output order; ``reduce_axes``
    names the mesh axes the kernel's partials are reduced over (the
    collective the cost model accounts for)."""

    kernel: str
    params: tuple[tuple[str, tuple], ...]
    outs: tuple[tuple, ...]
    reduce_axes: tuple[str, ...] = ()
    note: str = ""


RULES: tuple[KernelRule, ...] = (
    KernelRule(
        kernel=r"^sharded_sums_general$",
        params=(
            (r"^(times|weights)$", (EVENT_AXIS,)),
            (r"^freqs$", (TRIAL_AXIS,)),
            (r"^fdots$", (None,)),
        ),
        outs=((None, None, TRIAL_AXIS), (None, None, TRIAL_AXIS)),
        reduce_axes=(EVENT_AXIS,),
        note="arbitrary-grid trig sums (K3 per shard): events reduced in order, freqs "
             "embarrassingly parallel over the trial axis",
    ),
    KernelRule(
        kernel=r"^sharded_sums_grid$",
        params=(
            (r"^(times|weights)$", (EVENT_AXIS,)),
            (r"^fdots$", (None,)),
        ),
        outs=((None, None, TRIAL_AXIS), (None, None, TRIAL_AXIS)),
        reduce_axes=(EVENT_AXIS,),
        note="uniform-grid path (K2 per shard): each trial shard's frequencies are whole "
             "tiles of the global grid (tile0), so only events/weights are array inputs",
    ),
    KernelRule(
        kernel=r"^sharded_sums_grid3d$",
        params=(
            (r"^(times|weights)$", (EVENT_AXIS,)),
            (r"^(fdots|fddots)$", (None,)),
        ),
        outs=((None, None, None, TRIAL_AXIS), (None, None, None, TRIAL_AXIS)),
        reduce_axes=(EVENT_AXIS,),
        note="uniform-grid (f, fdot, fddot) cube: trial shards as the 2-D grid, fdot/fddot "
             "replicated, events reduced exactly like the 2-D grid",
    ),
    KernelRule(
        kernel=r"^semicoherent_stack$",
        params=(
            (r"^seg_(times|weights)$", (SEGMENT_AXIS,)),
            (r"^(fdots|fddots)$", (None,)),
        ),
        outs=((None, None, None),),
        reduce_axes=(SEGMENT_AXIS,),
        note="semi-coherent cube stack: zero-weight-padded segment rows are data parallel "
             "over the segment axis; the incoherent sum of per-segment Z^2 is the one reduce",
    ),
    KernelRule(
        kernel=r"^delta_refold",
        params=(
            (r"^(folded|delta|anchor_idx)$", (EVENT_AXIS,)),
            (r"^(spec|dp)$", REPLICATED),
        ),
        outs=((EVENT_AXIS,),),
        reduce_axes=(),
        note="per-event basis build + refold (K4 per shard); no collective (each row's dot "
             "runs over the replicated dp)",
    ),
    KernelRule(
        kernel=r"^(stacked_fold|toa_fit_batch_multi|source_batch)",
        params=((r".*", (SOURCE_AXIS,)),),
        outs=((SOURCE_AXIS,),),
        reduce_axes=(),
        note="multisource engine: pure data parallelism over the stacked source axis; "
             "leading-axis split, no collectives",
    ),
    KernelRule(
        kernel=r"^segment_batch",
        params=((r".*", (SEGMENT_AXIS,)),),
        outs=((SEGMENT_AXIS,),),
        reduce_axes=(),
        note="segment-batched ToA fits: data parallel over segments",
    ),
)


def _mesh_axis_size(mesh, axis) -> int:
    """Size of one spec entry's mesh extent (str or tuple of str)."""
    if axis is None:
        return 1
    if isinstance(axis, str):
        return int(mesh.shape[axis])
    return int(math.prod(int(mesh.shape[a]) for a in axis))


def process_grid(mesh) -> np.ndarray:
    """The process index of every shard of ``mesh``, in the mesh's shape.
    Duck-typed over ``mesh.devices`` (``process_index`` attributes, 0 when
    absent), so stub meshes and real multi-process meshes both classify."""
    devs = np.asarray(mesh.devices, dtype=object)
    out = np.zeros(devs.shape, dtype=np.int64)
    for idx, d in np.ndenumerate(devs):
        out[idx] = int(getattr(d, "process_index", 0))
    return out


class KernelSharding:
    """A :class:`KernelRule` bound to a concrete mesh: the lookup result."""

    def __init__(self, rule: KernelRule, mesh):
        self.rule = rule
        self.mesh = mesh

    # -- specs for dispatch --------------------------------------------------

    def spec(self, param: str, leaf=None) -> tuple:
        """The in-spec for one parameter (first regex match wins).

        With ``leaf`` given, 0-d leaves fall back to replication before an
        unmatched name raises."""
        for pat, sp in self.rule.params:
            if re.search(pat, param):
                return sp
        if leaf is not None and np.ndim(leaf) == 0:
            return REPLICATED
        raise KeyError(
            f"sharding registry: kernel rule {self.rule.kernel!r} has no "
            f"spec for param {param!r} on mesh {dict(self.mesh.shape)} "
            f"(add a row or pass a scalar leaf)")

    def in_specs(self, *names: str) -> tuple[tuple, ...]:
        return tuple(self.spec(n) for n in names)

    @property
    def out_specs(self):
        """A lone spec for a single-output kernel, the tuple otherwise."""
        outs = self.rule.outs
        return outs[0] if len(outs) == 1 else outs

    def named(self, param: str, leaf=None) -> "Placement":
        """The in-spec bound to this mesh (where JAX hands back a
        ``NamedSharding`` for ``jax.device_put``)."""
        return Placement(self.mesh, self.spec(param, leaf))

    # -- accounting for the cost model ---------------------------------------

    def device_count(self) -> int:
        return int(math.prod(int(s) for s in self.mesh.shape.values()))

    def reduce_size(self) -> int:
        """Shards taking part in the kernel's reduce (1 = no collective)."""
        return int(math.prod(int(self.mesh.shape[a]) for a in self.rule.reduce_axes)) or 1

    def dcn_axes(self) -> tuple[str, ...]:
        """Mesh axes whose shards span more than one process (on the
        host-major global mesh: the trial/source axis)."""
        procs = process_grid(self.mesh)
        out = []
        for ax, name in enumerate(tuple(self.mesh.axis_names)):
            moved = np.moveaxis(procs, ax, 0).reshape(procs.shape[ax], -1)
            if any(len(set(moved[:, col].tolist())) > 1 for col in range(moved.shape[1])):
                out.append(name)
        return tuple(out)

    def _reduced_buffer_bytes(self, out_info) -> float:
        """Per-shard reduced-buffer size B: the sum over outputs of global
        bytes / out-spec mesh extent."""
        total = 0.0
        for out, out_spec in zip(out_info, self.rule.outs):
            nbytes = math.prod(int(d) for d in out.shape) * _itemsize(out.dtype)
            shards = math.prod(_mesh_axis_size(self.mesh, ax) for ax in out_spec) or 1
            total += nbytes / shards
        return total

    def collective_bytes(self, out_info) -> float:
        """Estimated PER-SHARD bytes the kernel's cross-shard reduce moves
        (both legs): JAX's ring all-reduce model, 2(k - 1)/k * B over k
        shards, B the per-shard reduced-buffer size (each global output's
        bytes over the mesh extent of its sharded out-spec axes). The port
        reduces by an ordered gather, which moves at most this much.
        ``out_info``: objects with ``.shape``/``.dtype`` (tensors or
        arrays), one per output, in ``outs`` order. 0.0 when the rule
        reduces over nothing or one shard."""
        split = self.collective_bytes_split(out_info)
        return split["ici"] + split["dcn"]

    def collective_bytes_split(self, out_info) -> dict[str, float]:
        """The reduce's per-shard bytes split into the leg within a process
        ("ici") and the leg across processes ("dcn"): each reduce axis
        contributes its own ring leg, 2(k - 1)/k * B, on "dcn" when the
        axis spans processes. On the host-major global mesh the event
        reduce stays within a process, so its bytes land on "ici"."""
        out = {"ici": 0.0, "dcn": 0.0}
        if self.reduce_size() <= 1:
            return out
        buf = self._reduced_buffer_bytes(out_info)
        dcn = set(self.dcn_axes())
        for axis in self.rule.reduce_axes:
            k = _mesh_axis_size(self.mesh, axis)
            if k <= 1:
                continue
            out["dcn" if axis in dcn else "ici"] += 2.0 * (k - 1) / k * buf
        return out


def _itemsize(dtype) -> int:
    if isinstance(dtype, torch.dtype):
        return int(dtype.itemsize)
    return int(np.dtype(dtype).itemsize)


def specs_for(kernel: str, mesh) -> KernelSharding:
    """The first rule whose regex matches ``kernel``, bound to ``mesh``.
    Raises ``KeyError`` for unregistered kernels: a sharded dispatch with
    no registry row is a bug, not a default."""
    for rule in RULES:
        if re.search(rule.kernel, kernel):
            return KernelSharding(rule, mesh)
    raise KeyError(
        f"sharding registry: no rule matches kernel {kernel!r}; add a "
        f"KernelRule to crimp_tpu_torch/parallel/registry.py")


class Placement(NamedTuple):
    """A spec bound to a mesh: the port's stand-in for JAX's
    ``NamedSharding`` (``mesh.shard_segments`` / ``shard_sources`` place
    host arrays by it)."""

    mesh: object
    spec: tuple


def leading_axis_sharding(mesh, axis_name: str) -> Placement:
    """Leading-axis data-parallel placement: ``(axis_name,)`` on ``mesh``.
    A spec shorter than the array's rank leaves the trailing dimensions
    whole, so this is the ``(axis, None, ..., None)`` of any rank."""
    return Placement(mesh, (axis_name,))
