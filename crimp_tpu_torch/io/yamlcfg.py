"""YAML configuration: fit initial guesses / box priors, and plot lists.

The port's own copy of ``crimp_tpu/io/yamlcfg.py`` (schema of CRIMP's
utilities_fittoas.py:314-390): per parameter either ``[low, high]``
(bounds), a bare number (guess), or ``{low, high, guess}``; with the global
consistency rules (bounds for one => bounds for all; guess for one =>
guess for all). ``yaml`` is imported only when a file is read.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Prior:
    """Uniform box priors + optional initial guesses."""

    bounds: dict
    initial_guess: dict

    def log_prior(self, theta: np.ndarray, keys: list[str]) -> float:
        for value, name in zip(theta, keys):
            if name in self.bounds:
                lo, hi = self.bounds[name]
                if not (lo < value < hi):
                    return -np.inf
        return 0.0


def load_yaml(path: str):
    """A YAML file's document (``yaml.safe_load``; ``{}`` for an empty file),
    e.g. the plot list of ``pulseprofile_plots``."""
    import yaml

    with open(path, "r") as fh:
        return yaml.safe_load(fh) or {}


def load_prior(path: str) -> Prior:
    """Parse the YAML prior/guess file with consistency validation."""
    import yaml

    with open(path, "r") as fh:
        data = yaml.safe_load(fh)
    if not isinstance(data, dict):
        raise ValueError("YAML must map parameter -> prior/guess")

    bounds: dict = {}
    guesses: dict = {}
    for key, value in data.items():
        if isinstance(value, (list, tuple)):
            if len(value) != 2:
                raise ValueError(f"{key}: expected [low, high]")
            lo, hi = map(float, value)
            if not lo < hi:
                raise ValueError(f"{key}: low < high required")
            bounds[key] = (lo, hi)
        elif isinstance(value, dict):
            has_lo, has_hi = "low" in value, "high" in value
            if has_lo != has_hi:
                raise ValueError(f"{key}: need both 'low' and 'high' for bounds")
            if has_lo:
                lo, hi = float(value["low"]), float(value["high"])
                if not lo < hi:
                    raise ValueError(f"{key}: low < high required")
                bounds[key] = (lo, hi)
            if "guess" in value:
                guesses[key] = float(value["guess"])
        elif isinstance(value, (int, float)):
            guesses[key] = float(value)
        else:
            raise ValueError(f"{key}: unsupported value {value!r}")

    if bounds:
        missing = [k for k in data if k not in bounds]
        if missing:
            raise ValueError(
                "Bounds provided for some parameters but missing for others: " + ", ".join(missing)
            )
    if guesses:
        missing = [k for k in data if k not in guesses]
        if missing:
            raise ValueError(
                "Initial guesses provided for some parameters but missing for others: "
                + ", ".join(missing)
            )
    return Prior(bounds=bounds, initial_guess=guesses)


# Reference-named alias (utilities_fittoas.py:314).
initguess_prior_from_yaml = load_prior
