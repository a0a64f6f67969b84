"""K3's share of its roofline over the period-stepped search window's scans:
the device time of its launches against ``counts/k3.py``."""

from portbench import readers


def is_k3(name: str) -> bool:
    """K3's launches: the general kernel and its split reduction."""
    return "general_kernel" in name or "general_reduce_splits" in name


def read(ctx):
    return readers.roofline_pct(ctx, "k3", is_k3)
