"""Plain readers and the spin-down phase model, in numpy longdouble.

The benchmark's own copy of what a pulsar-timing user's inputs mean, kept
apart from the program under test: a ``.par`` file's Taylor spin model
(F0, F1, F2, ... about PEPOCH), a Fourier template file, and a headed
table of ToA intervals. Phases are taken in longdouble (a 64-bit mantissa:
~1e-12 cycles at the 7e6 cycles the 1E 2259+586 model reaches), so
nothing here needs the anchored split the program uses.
"""

from __future__ import annotations

import math
import re

import numpy as np

SECONDS_PER_DAY = 86400.0
_LD = np.longdouble


def read_par(path: str) -> dict:
    """{'pepoch': float, 'f': [F0, F1, ...]} from a ``.par`` file. Raises on
    a model term this plain reference does not evaluate (glitches, waves,
    binary orbits), so it can never judge a run by a model it dropped."""
    values: dict[str, str] = {}
    with open(path) as fh:
        for line in fh:
            tokens = line.split()
            if len(tokens) >= 2:
                values[tokens[0].upper()] = tokens[1]
    unsupported = [k for k in values if re.match(r"^(GL|WAVE|BINARY|PB|A1|ECC)", k)]
    if unsupported:
        raise ValueError(f"{path}: terms {unsupported} are outside the plain reference's model")
    f = []
    while f"F{len(f)}" in values:
        f.append(float(values[f"F{len(f)}"]))
    if not f or "PEPOCH" not in values:
        raise ValueError(f"{path}: needs PEPOCH and F0")
    return {"pepoch": float(values["PEPOCH"]), "f": f}


def read_template(path: str) -> dict:
    """{'norm', 'amp' (K,), 'ph' (K,)} of a Fourier template file, whose
    rate is norm + sum_k amp_k cos(2 pi k x + ph_k)."""
    model, values = None, {}
    with open(path) as fh:
        for line in fh:
            tokens = line.split()
            if not tokens:
                continue
            if tokens[0] == "model":
                model = tokens[1].lower()
            elif len(tokens) >= 2 and re.match(r"^(norm|amp_\d+|ph_\d+)$", tokens[0]):
                values[tokens[0]] = float(tokens[1])
    if model != "fourier":
        raise ValueError(f"{path}: only Fourier templates are modelled here, not {model!r}")
    k = 1
    while f"amp_{k}" in values:
        k += 1
    return {"norm": values["norm"],
            "amp": np.array([values[f"amp_{j}"] for j in range(1, k)]),
            "ph": np.array([values[f"ph_{j}"] for j in range(1, k)])}


def read_table(path: str) -> dict:
    """A headed whitespace table as {column: float64 array}."""
    with open(path) as fh:
        names = fh.readline().split()
        rows = [line.split() for line in fh if line.strip()]
    data = np.array(rows, dtype=np.float64)
    return {name: data[:, i].copy() for i, name in enumerate(names)}


def _dt_seconds(par: dict, t_mjd) -> np.ndarray:
    return (np.asarray(t_mjd, dtype=_LD) - _LD(par["pepoch"])) * _LD(SECONDS_PER_DAY)


def phase(par: dict, t_mjd) -> np.ndarray:
    """Model phase in cycles (longdouble): sum_n F_n dt^(n+1) / (n+1)!."""
    dt = _dt_seconds(par, t_mjd)
    acc = np.zeros_like(dt)
    for n in range(len(par["f"]) - 1, -1, -1):
        acc = (acc + _LD(par["f"][n]) / _LD(math.factorial(n + 1))) * dt
    return acc


def frequency(par: dict, t_mjd) -> np.ndarray:
    """Spin frequency (Hz, float64): sum_n F_n dt^n / n!."""
    dt = _dt_seconds(par, t_mjd)
    acc = np.zeros_like(dt)
    for n in range(len(par["f"]) - 1, -1, -1):
        acc = acc * dt + _LD(par["f"][n]) / _LD(math.factorial(n))
    return acc.astype(np.float64)


def folded(par: dict, t_mjd) -> np.ndarray:
    """Phases folded into [0, 1), float64."""
    ph = phase(par, t_mjd)
    return (ph - np.floor(ph)).astype(np.float64)


def integer_rotation(par: dict, t_mjd, tol: float = 1e-10, iters: int = 10) -> tuple[np.ndarray, np.ndarray]:
    """(epochs, frequencies): for each time, the latest epoch at or before
    it with a whole number of rotations, by Newton steps on the phase."""
    t = np.atleast_1d(np.asarray(t_mjd, dtype=np.float64)).copy()
    target = np.floor(phase(par, t))
    for _ in range(iters):
        err = (phase(par, t) - target).astype(np.float64)
        if np.all(np.abs(err) < tol):
            break
        t = np.where(np.abs(err) < tol, t, t - (err / frequency(par, t)) / SECONDS_PER_DAY)
    return t, frequency(par, t)
