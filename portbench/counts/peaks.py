"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, no sparsity).

They assume the card's full 700 W power limit; the harness prints the
card's ``power.limit`` beside every run, and each roofline share is read
against these figures whatever the limit.
"""

FLOPS = {"f32": 67e12, "f64": 34e12}  # outside the tensor cores
HBM_BYTES_PER_S = 3.35e12


def bound_seconds(counts: dict) -> float:
    """The least time the chip could take: operations at the peak of their
    type or bytes at the HBM rate, whichever is longer."""
    return max(counts["flops"] / FLOPS[counts["dtype"]], counts["bytes"] / HBM_BYTES_PER_S)
