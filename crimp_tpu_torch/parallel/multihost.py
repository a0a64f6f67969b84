"""Multi-host identity: which process of a job this is.

Port of ``crimp_tpu/parallel/multihost.py::process_identity`` alone; the
rest of the module (bring-up, host meshes, global arrays) is not ported.
"""

from __future__ import annotations

import torch.distributed as dist


def process_identity() -> tuple[int, int]:
    """``(rank, world_size)`` of an initialized ``torch.distributed`` group,
    else the single-process identity ``(0, 1)``. Never initializes anything."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1
