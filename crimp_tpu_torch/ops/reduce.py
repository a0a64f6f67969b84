"""The event-axis sum of the ToA fit's plain twin and the per-ToA H-test,
defined once. On the card the fit's event sums are K5's
(``csrc/toafit.cu``), in a fixed order, so there a source's fit columns
from a batched survey are its solo run's bits; what follows holds for the
twin on the CPU and for the H-test.

``torch.sum`` over the last axis picks its CUDA launch configuration (and
on the CPU its parallel split) from the whole tensor's shape, so a row's
sum can round differently when the same row is reduced beside more rows.
A source's ToAs from a batched survey therefore agree with its solo run to
the rounding of these sums (phShift within 1e-6 rad, the H power within
its f32 sums), not bit for bit; the fold, elementwise, stays bitwise.

A sum in a fixed order (a tree of zero-padded blocks of 32) would give the
same bits beside any rows, at the price of a few more kernels per sum:
``chip_smoke.py`` swaps ``utils/reduce_probe.tree_sum`` in for this
function and times the survey both ways on the card (PERF.md): it about
doubles the survey's wall, which is why the port keeps ``torch.sum``.
"""

from __future__ import annotations

import torch


def event_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last (event) axis -> x.shape[:-1]."""
    return torch.sum(x, dim=-1)
