"""Timing model as a frozen dataclass of float64 tensors.

Port of ``crimp_tpu/models/timing.py``: F0..F12 as a (13,) vector, glitches
as padded (G,) columns, whitening waves as padded (W,) A/B vectors.

Padding conventions (mask-safe):
- unused glitch rows have GLEP = +inf (the ``t >= GLEP`` mask is never true)
  and GLTD = 1 (avoids 0/0 in the recovery term);
- unused wave harmonics have A = B = 0.

The tensors are built on the CPU: the precision-critical host paths
(``ops.anchored``'s longdouble anchors, ``ops.ephem``'s host twins) read
them exactly from there. ``.to(device)`` moves a copy to the card.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, fields

import numpy as np
import torch

from crimp_tpu_torch.io.parfile import get_parameter_value, read_timing_model

N_FREQ_TERMS = 13  # F0..F12


@dataclass(frozen=True)
class TimingParams:
    """Dense timing model: Taylor spin terms + glitches + waves."""

    pepoch: torch.Tensor  # scalar, MJD
    f: torch.Tensor  # (13,) frequency and derivatives F0..F12
    glep: torch.Tensor  # (G,) glitch epochs, MJD (+inf padding)
    glph: torch.Tensor  # (G,) phase jumps
    glf0: torch.Tensor  # (G,) frequency jumps
    glf1: torch.Tensor  # (G,) fdot jumps
    glf2: torch.Tensor  # (G,) fddot jumps
    glf0d: torch.Tensor  # (G,) decaying frequency jumps
    gltd: torch.Tensor  # (G,) recovery timescales, days (1.0 padding)
    wave_epoch: torch.Tensor  # scalar, MJD
    wave_om: torch.Tensor  # scalar, wave fundamental (rad/day)
    wave_a: torch.Tensor  # (W,) sine coefficients (0 padding)
    wave_b: torch.Tensor  # (W,) cosine coefficients (0 padding)

    @property
    def n_glitch(self) -> int:
        return int(self.glep.shape[-1])

    @property
    def n_wave(self) -> int:
        return int(self.wave_a.shape[-1])

    def to(self, device) -> "TimingParams":
        return TimingParams(**{f.name: getattr(self, f.name).to(device) for f in fields(self)})

    def numpy(self, name: str) -> np.ndarray:
        """One field as a host float64 array (exact copy)."""
        return getattr(self, name).detach().cpu().numpy()


def _value(entry) -> float:
    return float(get_parameter_value(entry))


def from_dict(params: dict, n_glitch: int | None = None, n_wave: int | None = None) -> TimingParams:
    """Build a TimingParams from a reference-style parameter dict.

    Accepts both dict shapes ({key: value} and {key: {'value','flag'}}).
    ``n_glitch``/``n_wave`` set padded sizes.
    """
    f = np.zeros(N_FREQ_TERMS)
    for i in range(N_FREQ_TERMS):
        if f"F{i}" in params:
            f[i] = _value(params[f"F{i}"])
    pepoch = _value(params.get("PEPOCH", 0.0))

    gids = []
    for key in params:
        match = re.match(r"GLEP_(\S+)$", key)
        if match:
            gids.append(match.group(1))
    G = max(n_glitch if n_glitch is not None else 0, len(gids))
    glitch_cols = {
        "glep": np.full(G, np.inf),
        "glph": np.zeros(G),
        "glf0": np.zeros(G),
        "glf1": np.zeros(G),
        "glf2": np.zeros(G),
        "glf0d": np.zeros(G),
        "gltd": np.ones(G),
    }
    base_to_col = {
        "GLEP": "glep",
        "GLPH": "glph",
        "GLF0": "glf0",
        "GLF1": "glf1",
        "GLF2": "glf2",
        "GLF0D": "glf0d",
        "GLTD": "gltd",
    }
    for j, gid in enumerate(gids):
        for base, col in base_to_col.items():
            key = f"{base}_{gid}"
            if key in params:
                glitch_cols[col][j] = _value(params[key])

    # Wave harmonics k = 1..N where N is the number of WAVEk entries.
    wave_ks = sorted(
        int(m.group(1)) for key in params if (m := re.match(r"WAVE(\d+)$", key))
    )
    W = max(n_wave if n_wave is not None else 0, len(wave_ks))
    wave_a = np.zeros(W)
    wave_b = np.zeros(W)
    for idx, k in enumerate(wave_ks):
        entry = params[f"WAVE{k}"]
        pair = entry["value"] if isinstance(entry, dict) and "value" in entry else entry
        wave_a[idx] = float(pair["A"])
        wave_b[idx] = float(pair["B"])
    wave_epoch = _value(params.get("WAVEEPOCH", 0.0))
    wave_om = _value(params.get("WAVE_OM", 0.0))

    t64 = lambda x: torch.as_tensor(np.asarray(x, dtype=np.float64))
    return TimingParams(
        pepoch=t64(pepoch),
        f=t64(f),
        glep=t64(glitch_cols["glep"]),
        glph=t64(glitch_cols["glph"]),
        glf0=t64(glitch_cols["glf0"]),
        glf1=t64(glitch_cols["glf1"]),
        glf2=t64(glitch_cols["glf2"]),
        glf0d=t64(glitch_cols["glf0d"]),
        gltd=t64(glitch_cols["gltd"]),
        wave_epoch=t64(wave_epoch),
        wave_om=t64(wave_om),
        wave_a=t64(wave_a),
        wave_b=t64(wave_b),
    )


def from_par(path: str, n_glitch: int | None = None, n_wave: int | None = None) -> TimingParams:
    """Read a .par file into a TimingParams."""
    values, _, _ = read_timing_model(path)
    return from_dict(values, n_glitch=n_glitch, n_wave=n_wave)


def resolve(timMod) -> TimingParams:
    """Accept a TimingParams, a parameter dict, or a .par path."""
    if isinstance(timMod, TimingParams):
        return timMod
    if isinstance(timMod, dict):
        return from_dict(timMod)
    return from_par(str(timMod))
