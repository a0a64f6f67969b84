"""tempo2/PINT-style ``.par`` timing-model files: parse and patch-in-place.

The port's own copy of ``crimp_tpu/io/parfile.py`` (numpy only).
Behavioral parity with CRIMP's reader/patcher (readtimingmodel.py):

- spin model: PEPOCH + F0..F12 (missing terms default to 0), 0/1 fit flags;
- glitch blocks per id: GLEP/GLPH/GLF0/GLF1/GLF2/GLF0D/GLTD (GLTD defaults
  to 1 to avoid a divide-by-zero in the recovery term);
- whitening waves: WAVEEPOCH, WAVE_OM (the only wave key with a fit flag),
  WAVEk -> {A, B} pairs;
- TRACK is attached to the model dict when it equals -2 (pulse-number
  tracking mode);
- fit statistics (CHI2R [+dof], NTOA, TRES) and miscellaneous keys;
- patching writes a new .par preserving the original formatting of
  untouched fields.

The dictionaries exchanged here use the same two shapes as the reference:
``{key: value}`` (values-only) and ``{key: {"value": v, "flag": 0|1}}``.
"""

from __future__ import annotations

import re

import numpy as np

TAYLOR_KEYS = ["PEPOCH"] + [f"F{i}" for i in range(13)]
GLITCH_BASES = ["GLEP", "GLPH", "GLF0", "GLF1", "GLF2", "GLF0D", "GLTD"]
_GLITCH_DEFAULTS = {base: 0.0 for base in GLITCH_BASES}
_GLITCH_DEFAULTS["GLTD"] = 1.0

MISC_SCHEMA = {
    "PSR": str,
    "RAJ": str,
    "DECJ": str,
    "POSEPOCH": float,
    "DMEPOCH": float,
    "START": float,
    "FINISH": float,
    "TZRMJD": float,
    "TZRFRQ": float,
    "TZRSITE": str,
    "CLK": str,
    "UNITS": str,
    "EPHEM": str,
    "TRACK": float,
}


def _to_float(token: str) -> float:
    try:
        return float(token)
    except ValueError:
        return complex(token).real


def _to_flag(token: str | None) -> int:
    if token is None:
        return 0
    try:
        flag = int(float(token))
    except (ValueError, OverflowError):
        return 0
    return flag if flag in (0, 1) else 0


def _iter_lines(path: str):
    with open(path, "r") as fh:
        for raw in fh:
            tokens = raw.split()
            if tokens:
                yield tokens


def get_parameter_value(entry):
    """Value of a parameter whether stored plain or as {'value','flag'}."""
    if isinstance(entry, dict) and "value" in entry and "flag" in entry:
        return entry["value"]
    return entry


def read_taylor(path: str):
    """PEPOCH + F0..F12 -> (values, flags, both)."""
    values = {k: np.float64(0) for k in TAYLOR_KEYS}
    flags = {k: 0 for k in TAYLOR_KEYS}
    for tokens in _iter_lines(path):
        key = tokens[0]
        if key in values and len(tokens) >= 2:
            values[key] = np.float64(_to_float(tokens[1]))
            flags[key] = _to_flag(tokens[2] if len(tokens) > 2 else None)
    both = {k: {"value": values[k], "flag": flags[k]} for k in TAYLOR_KEYS}
    return values, flags, both


def glitch_ids(path: str) -> list[str]:
    """Glitch identifiers, in order of their GLEP_<id> lines."""
    ids = []
    for tokens in _iter_lines(path):
        match = re.match(r"GLEP_(\S+)$", tokens[0])
        if match and match.group(1) not in ids:
            ids.append(match.group(1))
    return ids


def read_glitches(path: str):
    """Glitch parameter blocks -> (values, flags, both)."""
    ids = glitch_ids(path)
    values: dict = {}
    flags: dict = {}
    for gid in ids:
        for base in GLITCH_BASES:
            values[f"{base}_{gid}"] = np.float64(_GLITCH_DEFAULTS[base])
            flags[f"{base}_{gid}"] = 0
    if ids:
        wanted = set(values)
        for tokens in _iter_lines(path):
            key = tokens[0]
            if key in wanted and len(tokens) >= 2:
                values[key] = np.float64(_to_float(tokens[1]))
                flags[key] = _to_flag(tokens[2] if len(tokens) > 2 else None)
    both = {k: {"value": values[k], "flag": flags[k]} for k in values}
    return values, flags, both


def read_waves(path: str):
    """WAVEEPOCH / WAVE_OM / WAVEk {A,B} -> (values, flags, both)."""
    values: dict = {}
    flags: dict = {}
    both: dict = {}
    for tokens in _iter_lines(path):
        key = tokens[0]
        if key == "WAVEEPOCH" and len(tokens) >= 2:
            values[key] = _to_float(tokens[1])
            both[key] = {"value": values[key], "flag": None}
        elif key == "WAVE_OM" and len(tokens) >= 2:
            values[key] = _to_float(tokens[1])
            flags[key] = _to_flag(tokens[2] if len(tokens) > 2 else None)
            both[key] = {"value": values[key], "flag": flags[key]}
        elif re.match(r"WAVE\d+$", key) and len(tokens) >= 3:
            pair = {"A": _to_float(tokens[1]), "B": _to_float(tokens[2])}
            values[key] = pair
            both[key] = {"value": pair, "flag": None}
    return values, flags, both


def read_statistics(path: str) -> dict:
    stats = {"CHI2R": None, "CHI2R_DOF": None, "NTOA": None, "TRES": None}
    for tokens in _iter_lines(path):
        key = tokens[0].upper()
        try:
            if key == "CHI2R":
                stats["CHI2R"] = float(tokens[1])
                if len(tokens) > 2:
                    stats["CHI2R_DOF"] = int(tokens[2])
            elif key == "NTOA":
                stats["NTOA"] = int(tokens[1])
            elif key == "TRES":
                stats["TRES"] = float(tokens[1])
        except (ValueError, IndexError):
            pass
    return stats


def read_miscellaneous(path: str) -> dict:
    misc = {k: None for k in MISC_SCHEMA}
    for tokens in _iter_lines(path):
        key = tokens[0].upper()
        if key in MISC_SCHEMA and len(tokens) >= 2:
            try:
                misc[key] = MISC_SCHEMA[key](tokens[1])
            except ValueError:
                pass
    return misc


def read_timing_model(path: str):
    """Full timing model -> (values, flags, both), TRACK=-2 included if set."""
    te_v, te_f, te_b = read_taylor(path)
    gl_v, gl_f, gl_b = read_glitches(path)
    wv_v, wv_f, wv_b = read_waves(path)
    values = {**te_v, **gl_v, **wv_v}
    flags = {**te_f, **gl_f, **wv_f}
    both = {**te_b, **gl_b, **wv_b}
    track = read_miscellaneous(path).get("TRACK")
    if track == -2:
        values["TRACK"] = track
        both["TRACK"] = {"value": track, "flag": 0}
    return values, flags, both


class ReadTimingModel:
    """Compatibility shim mirroring the reference class API
    (readtimingmodel.py:20): ``ReadTimingModel(par).readfulltimingmodel()``."""

    def __init__(self, timMod: str):
        self.timMod = str(timMod)

    def readtaylorexpansion(self):
        return read_taylor(self.timMod)

    def readglitches(self):
        return read_glitches(self.timMod)

    def readwaves(self):
        return read_waves(self.timMod)

    def readfulltimingmodel(self):
        return read_timing_model(self.timMod)

    def readstatistics(self):
        return read_statistics(self.timMod)

    def readmiscellaneous(self):
        return read_miscellaneous(self.timMod)


# ---------------------------------------------------------------------------
# Formatting-preserving patchers
# ---------------------------------------------------------------------------

_FLOAT_RE = re.compile(r"^[+-]?(?:\d+(?:\.\d*)?|\.\d+)(?:[eEdD][+-]?\d+)?$")


def add_pntrack_parfile(pardict: dict, parfile: str) -> None:
    """Attach TRACK to ``pardict`` when the .par carries TRACK -2
    (pulse-number tracking; reference readtimingmodel.py:324-332). Handles
    both dict-of-dicts (value/flag) and plain-value dictionaries in place.
    """
    track = read_miscellaneous(parfile).get("TRACK")
    if track == -2:
        if pardict and isinstance(next(iter(pardict.values())), dict):
            pardict["TRACK"] = {"value": track, "flag": 0}
        else:
            pardict["TRACK"] = track


def _split_preserving(line: str) -> list[str]:
    """Split a line into alternating whitespace/token chunks (lossless)."""
    return re.findall(r"\s+|\S+", line)


def _unwrap(value):
    if isinstance(value, dict) and "value" in value:
        return value["value"]
    return value


def patch_par_values(
    in_path: str,
    out_path: str,
    *,
    new_values: dict,
    float_fmt: str = ".15g",
    uncertainties: dict | None = None,
    uncertainty_fmt: str = ".6g",
) -> None:
    """Rewrite parameter values in a .par, preserving untouched formatting.

    Lines look like ``KEY value [flag] [uncertainty] [tail]``; WAVEk lines are
    ``WAVEk A B``. Only the value (and optionally the uncertainty when the fit
    flag is present) is replaced.
    """
    with open(in_path, "r") as fh:
        lines = fh.readlines()

    out_lines = []
    for line in lines:
        chunks = _split_preserving(line.rstrip("\n"))
        tokens = [c for c in chunks if not c.isspace()]
        if not tokens:
            out_lines.append(line)
            continue
        key = tokens[0]

        if re.match(r"WAVE\d+$", key):
            value = _unwrap(new_values.get(key))
            if isinstance(value, dict) and "A" in value and "B" in value:
                a = format(float(value["A"]), float_fmt)
                b = format(float(value["B"]), float_fmt)
                out_lines.append(f"{key} {a} {b}\n")
            else:
                out_lines.append(line)
            continue

        value = _unwrap(new_values.get(key))
        if value is None or isinstance(value, dict) or len(tokens) < 2:
            out_lines.append(line)
            continue

        # Locate token positions within the chunk list.
        token_idx = [i for i, c in enumerate(chunks) if not c.isspace()]
        chunks[token_idx[1]] = format(float(value), float_fmt)

        has_flag = len(tokens) > 2 and tokens[2] in ("0", "1")
        if has_flag:
            unc_pos = token_idx[3] if len(tokens) > 3 and _FLOAT_RE.match(tokens[3]) else None
            if uncertainties is not None and key in uncertainties:
                unc_str = format(float(uncertainties[key]), uncertainty_fmt)
                if unc_pos is not None:
                    chunks[unc_pos] = unc_str
                else:
                    chunks.insert(token_idx[2] + 1, " ")
                    chunks.insert(token_idx[2] + 2, unc_str)
        out_lines.append("".join(chunks) + "\n")

    with open(out_path, "w") as fh:
        fh.writelines(out_lines)


def patch_statistics(in_path: str, out_path: str, new_stats: dict) -> None:
    """Update CHI2R/NTOA/TRES lines; append missing ones at the end."""
    with open(in_path, "r") as fh:
        lines = fh.readlines()

    def render(key: str) -> str | None:
        if key == "CHI2R" and new_stats.get("CHI2R") is not None:
            dof = new_stats.get("CHI2R_DOF")
            tail = f" {int(dof)}" if dof is not None else ""
            return f"CHI2R          {new_stats['CHI2R']}{tail}\n"
        if key == "NTOA" and new_stats.get("NTOA") is not None:
            return f"NTOA           {int(new_stats['NTOA'])}\n"
        if key == "TRES" and new_stats.get("TRES") is not None:
            return f"TRES           {new_stats['TRES']}\n"
        return None

    seen = set()
    out_lines = []
    for line in lines:
        tokens = line.split()
        key = tokens[0].upper() if tokens else ""
        replacement = render(key) if key in ("CHI2R", "NTOA", "TRES") else None
        if replacement is not None:
            out_lines.append(replacement)
            seen.add(key)
        else:
            out_lines.append(line)

    for key in ("CHI2R", "NTOA", "TRES"):
        if key not in seen:
            replacement = render(key)
            if replacement is not None:
                if out_lines and not out_lines[-1].endswith("\n"):
                    out_lines.append("\n")
                out_lines.append(replacement)

    with open(out_path, "w") as fh:
        fh.writelines(out_lines)


def patch_miscellaneous(in_path: str, out_path: str, new_misc: dict) -> None:
    """Update or append miscellaneous keys (None values are skipped)."""
    with open(in_path, "r") as fh:
        lines = fh.readlines()

    wanted = {k.upper(): v for k, v in new_misc.items() if v is not None}
    seen = set()
    out_lines = []
    for line in lines:
        tokens = line.split()
        key = tokens[0].upper() if tokens else ""
        if key in wanted:
            out_lines.append(f"{key:<15}{wanted[key]}\n")
            seen.add(key)
        else:
            out_lines.append(line)

    for key, value in wanted.items():
        if key not in seen:
            if out_lines and not out_lines[-1].endswith("\n"):
                out_lines.append("\n")
            out_lines.append(f"{key:<15}{value}\n")

    with open(out_path, "w") as fh:
        fh.writelines(out_lines)
