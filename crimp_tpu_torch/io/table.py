"""Whitespace-separated text tables as dicts of numpy columns.

The port's stand-in for ``pd.read_csv(path, sep=r"\\s+", comment="#")``
on the interval and ToA tables: the first line names the columns, ``#``
starts a comment, and each column keeps the type numpy infers for it
(integers stay integers, as pandas keeps them).
"""

from __future__ import annotations

import numpy as np


def read_columns(path: str) -> dict[str, np.ndarray]:
    """Read a headed whitespace table into ``{name: column}``."""
    arr = np.atleast_1d(
        np.genfromtxt(path, names=True, dtype=None, encoding=None, comments="#")
    )
    return {name: np.asarray(arr[name]) for name in arr.dtype.names}
