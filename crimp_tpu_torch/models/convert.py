"""Carry parameters across from the JAX package's dataclasses.

Each function takes a dict of numpy arrays keyed by the JAX dataclass
fields (``crimp_tpu.models.timing.TimingParams``,
``crimp_tpu.models.profiles.ProfileParams`` and
``crimp_tpu.ops.multisource.StackedAnchoredModel``), so the same parameters can
run through both packages. This module imports nothing of the JAX package:
callers build the dict, e.g.
``{f.name: np.asarray(getattr(obj, f.name)) for f in dataclasses.fields(obj)}``.
"""

from __future__ import annotations

from dataclasses import fields

import numpy as np
import torch

from crimp_tpu_torch.models.profiles import KINDS, ProfileParams
from crimp_tpu_torch.models.timing import TimingParams


def _build(cls, d: dict, device):
    names = [f.name for f in fields(cls)]
    missing = [n for n in names if n not in d]
    if missing:
        raise KeyError(f"{cls.__name__} fields missing from the dict: {missing}")
    return cls(**{
        n: torch.tensor(np.asarray(d[n], dtype=np.float64), device=device)
        for n in names
    })


def timing_from_arrays(d: dict, device="cpu") -> TimingParams:
    """A port ``TimingParams`` (float64 tensors on ``device``) from field arrays."""
    return _build(TimingParams, d, device)


def profile_from_arrays(kind: str, d: dict, device="cpu") -> ProfileParams:
    """A port ``ProfileParams`` for template family ``kind`` from field arrays."""
    if kind not in KINDS:
        raise ValueError(f"unknown template kind {kind!r}; expected one of {KINDS}")
    return _build(ProfileParams, d, device)


def to_arrays(obj) -> dict:
    """Field dict of numpy arrays from a port dataclass (the inverse)."""
    return {f.name: getattr(obj, f.name).detach().cpu().numpy() for f in fields(obj)}


def stacked_from_arrays(d: dict, device="cpu"):
    """A port ``ops.multisource.StackedAnchoredModel`` (float64 tensors on
    ``device``) from the field arrays of the JAX package's
    ``StackedAnchoredModel``, so both packages can fold the same stacked
    model."""
    from crimp_tpu_torch.ops.multisource import StackedAnchoredModel

    return _build(StackedAnchoredModel, d, device)
